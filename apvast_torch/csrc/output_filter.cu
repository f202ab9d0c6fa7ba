// K5: output synthesis: J-tap circular filter bank + synthesis window +
// tail-form overlap-add; and K11, the same circular filter bank unfused.
//
// K5 replaces apvast_tpu/ops/pallas/output_filter.py::circular_filter_overlap_pallas.
//   y[z, r, n]   = window[n] * sum_t filt[z, r, t] * x[z, (n - t) mod block]
//   v[z, r, n]   = y[z, r, n] + (n < block - hop ? tail[z, r, n] : 0)
//   emit[z, r, n]           = v[z, r, n]      for n <  hop
//   new_tail[z, r, n - hop] = v[z, r, n]      for n >= hop
// which is both branches of the TPU kernel (hop >= block - hop and
// hop < block - hop) in one expression.
//
// Bound: bytes. At the north-star shapes (z=2, rows=V*S=800, J=50,
// block=1600, hop=800) the tail read and the emit and new-tail writes are
// ~15.7 MB against 0.26 GFLOP.
// Design: one block per (zone, 16-row tile, 128-sample tile). It stages
// the circularly extended input slice (128 + J - 1 samples) and the tile's
// filter rows in shared memory; each thread owns one sample and 8 rows,
// does J FMAs per output (filter taps are warp-wide broadcasts, input
// samples consecutive), applies the window, adds the tail and writes emit
// or new tail directly. The full (rows, block) synthesis tile never
// reaches device memory.
//
// K11 replaces apvast_tpu/ops/pallas/output_filter.py::circular_filter_pallas:
//   out[z, r, n] = sum_t filt[z, r, t] * x[z, (n - t) mod block]
// It is the kOverlap = false form of the same kernel: the window and the
// overlap-add are switched off and the whole (rows, block) tile is written.
// Bound: operations at small tap counts ((2, 1600) x (2, 800, 50): 0.26
// GFLOP against 10.6 MB of output), bytes once the output dominates.

#include <cuda_runtime.h>

namespace {

constexpr int kRowTile = 16;
constexpr int kSampleTile = 128;
constexpr int kThreads = 256;  // 128 samples x 2 row groups
constexpr int kRowsPerThread = kRowTile / (kThreads / kSampleTile);

template <bool kOverlap>
__global__ void __launch_bounds__(kThreads)
output_filter_kernel(const float* __restrict__ xin,
                     const float* __restrict__ filt,
                     const float* __restrict__ window,
                     const float* __restrict__ tail,
                     float* __restrict__ emit,
                     float* __restrict__ new_tail,
                     int rows, int taps, int block, int hop) {
  extern __shared__ float sm[];
  float* fs = sm;                      // (kRowTile, taps)
  float* es = sm + kRowTile * taps;    // (kSampleTile + taps - 1)
  const int z = blockIdx.z;
  const int r0 = blockIdx.y * kRowTile;
  const int n0 = blockIdx.x * kSampleTile;
  const float* xz = xin + (size_t)z * block;

  for (int i = threadIdx.x; i < kRowTile * taps; i += kThreads) {
    const int r = i / taps, t = i % taps;
    fs[i] = (r0 + r < rows) ? filt[((size_t)z * rows + r0 + r) * taps + t] : 0.f;
  }
  // es[u] = x[(n0 - (taps - 1) + u) mod block]
  for (int u = threadIdx.x; u < kSampleTile + taps - 1; u += kThreads) {
    int g = (n0 - (taps - 1) + u) % block;
    if (g < 0) g += block;
    es[u] = xz[g];
  }
  __syncthreads();

  const int tx = threadIdx.x % kSampleTile;
  const int ty = threadIdx.x / kSampleTile;
  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;
  for (int t = 0; t < taps; ++t) {
    const float xv = es[tx + taps - 1 - t];  // x[(n - t) mod block]
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
      acc[i] = fmaf(fs[(ty + 2 * i) * taps + t], xv, acc[i]);
  }

  const int n = n0 + tx;
  if (n >= block) return;
  if constexpr (!kOverlap) {  // K11: emit is the (z, rows, block) output
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = r0 + ty + 2 * i;
      if (r < rows) emit[((size_t)z * rows + r) * block + n] = acc[i];
    }
    return;
  }
  const float wv = window[n];
  const int bh = block - hop;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = r0 + ty + 2 * i;
    if (r >= rows) continue;
    const size_t row = (size_t)z * rows + r;
    float v = acc[i] * wv;
    if (n < bh) v += tail[row * bh + n];
    if (n < hop)
      emit[row * hop + n] = v;
    else
      new_tail[row * bh + (n - hop)] = v;
  }
}

template <bool kOverlap>
int launch(const float* xin, const float* filt, const float* window,
           const float* tail, float* emit, float* new_tail, int z, int rows,
           int taps, int block, int hop, cudaStream_t stream) {
  const size_t smem = (size_t)(kRowTile * taps + kSampleTile + taps - 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        output_filter_kernel<kOverlap>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((block + kSampleTile - 1) / kSampleTile,
                  (rows + kRowTile - 1) / kRowTile, z);
  output_filter_kernel<kOverlap><<<grid, kThreads, smem, stream>>>(
      xin, filt, window, tail, emit, new_tail, rows, taps, block, hop);
  return (int)cudaGetLastError();
}

}  // namespace

// K5. xin (z, block), filt (z, rows, taps), window (block), tail (z, rows,
// block - hop) -> emit (z, rows, hop), new_tail (z, rows, block - hop);
// float32, contiguous, 0 < hop < block, taps <= block.
extern "C" int output_filter_launch(const float* xin, const float* filt,
                                    const float* window, const float* tail,
                                    float* emit, float* new_tail, int z,
                                    int rows, int taps, int block, int hop,
                                    cudaStream_t stream) {
  return launch<true>(xin, filt, window, tail, emit, new_tail, z, rows, taps,
                      block, hop, stream);
}

// K11. xin (z, block), filt (z, rows, taps) -> out (z, rows, block);
// float32, contiguous, taps <= block.
extern "C" int circular_filter_launch(const float* xin, const float* filt,
                                      float* out, int z, int rows, int taps,
                                      int block, cudaStream_t stream) {
  return launch<false>(xin, filt, nullptr, nullptr, out, nullptr, z, rows,
                       taps, block, block, stream);
}
