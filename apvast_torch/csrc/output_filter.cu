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
// ~15.7 MB (4.7 us) against 0.26 GFLOP of fp32 FMA (3.8 us at the fp32
// peak): SIMT FMA suffices.
// The first design gave a thread 1 sample x 8 rows: 9 shared loads for 8
// FMAs a tap, so its loop was bound by the shared-memory pipe, and it read
// the tail only after the loop.
// Design: one block of 4 warps per (zone, 32-row tile, 128-sample tile); a
// thread owns 8 rows x 4 consecutive samples. The block stages the
// tile's filter rows (taps padded to a multiple of 4 with zeros) and the
// circularly extended input slice in shared memory, and issues the tile's
// tail loads (cp.async) before the FMA loop, so that they land while it
// runs. A step of the loop takes 4 taps: two float4 loads of input give
// the thread's sliding window of 7 samples, and one float4 load of a row's
// 4 taps (a warp-wide broadcast) feeds 16 FMAs: 10 loads for 128 FMAs. The
// taps past the last multiple of 4 take a guarded step, so a padded tap
// never multiplies a sample (0 x NaN). Sums run in tap order. The
// epilogue applies the window, adds the staged tail and writes emit or
// new tail as float4 where hop and block are multiples of 4; the full
// (rows, block) synthesis tile never reaches device memory.
//
// K11 replaces apvast_tpu/ops/pallas/output_filter.py::circular_filter_pallas:
//   out[z, r, n] = sum_t filt[z, r, t] * x[z, (n - t) mod block]
// It is the kOverlap = false form of the same kernel: the window and the
// overlap-add are switched off and the whole (rows, block) tile is written.
// Bound: operations at small tap counts ((2, 1600) x (2, 800, 50): 0.26
// GFLOP against 10.6 MB of output), bytes once the output dominates.

#include <cuda_runtime.h>

#include <cstdint>

#include "cp_async.cuh"

#ifndef STAGE_STAMP
#define STAGE_STAMP(kind)  // timer stamps: only tools/k3_k5_stages.py's build has them
#define STAGE_BLOCK(kind)  // every block's start and end, likewise
#endif

namespace {

constexpr int kRows = 8;     // rows of a thread's tile
constexpr int kSamples = 4;  // consecutive samples of a thread's tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowTile = kRows * kWarps;   // 32 rows a block
constexpr int kSampleTile = kSamples * 32;  // 128 samples a block
constexpr int kSmemLimit = 227 * 1024;

// Shared memory in floats: filter rows, input slice, tail tile (K5 only).
__host__ __device__ constexpr int smem_floats(int taps4, bool overlap) {
  return kRowTile * taps4 + kSampleTile + taps4 + (overlap ? kRowTile * kSampleTile : 0);
}

template <int kTaps>  // kTaps = 4: a whole step; fewer: the last, guarded
__device__ __forceinline__ void taps_step(const float* es, const float* fw, int taps4,
                                          int t0, int ntaps, float (&acc)[kRows][kSamples]) {
  // w[m] = x[n0 + 4 lane + m - 3 - t0]: x[(n - t0 - k) mod block] is w[3 + s - k].
  const float4 xa = *reinterpret_cast<const float4*>(es);
  const float4 xb = *reinterpret_cast<const float4*>(es + 4);
  const float w[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float4 f = *reinterpret_cast<const float4*>(fw + i * taps4 + t0);
    const float fk[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (kTaps < 4 && k >= ntaps) break;
#pragma unroll
      for (int s = 0; s < kSamples; ++s) acc[i][s] = fmaf(fk[k], w[3 + s - k], acc[i][s]);
    }
  }
}

template <bool kOverlap>
__global__ void __launch_bounds__(kThreads)
output_filter_kernel(const float* __restrict__ xin,
                     const float* __restrict__ filt,
                     const float* __restrict__ window,
                     const float* __restrict__ tail,
                     float* __restrict__ emit,
                     float* __restrict__ new_tail,
                     int rows, int taps, int block, int hop, bool vec) {
  extern __shared__ __align__(16) float sm[];
  const int taps4 = (taps + 3) & ~3;
  const int pad = taps4 - 1;  // es[u] = x[(n0 - pad + u) mod block]
  float* fs = sm;                                 // (kRowTile, taps4)
  float* es = fs + kRowTile * taps4;              // (kSampleTile + taps4)
  float* ts = es + kSampleTile + taps4;           // (kRowTile, kSampleTile), K5
  const int z = blockIdx.z;
  const int r0 = blockIdx.y * kRowTile;
  const int n0 = blockIdx.x * kSampleTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = block - hop;
  STAGE_STAMP(0);
  STAGE_BLOCK(0);

  for (int i = 0; i < kRows; ++i) {  // a warp stages the rows it sums
    const int r = warp * kRows + i;
    const float* fr = filt + ((size_t)z * rows + r0 + r) * taps;
    for (int t = lane; t < taps4; t += 32) {
      const bool ok = r0 + r < rows && t < taps;
      cp_async::copy4(fs + r * taps4 + t, ok ? fr + t : filt, ok);
    }
  }
  const float* xz = xin + (size_t)z * block;
  for (int u = tid; u < kSampleTile + taps4; u += kThreads) {
    int g = (n0 - pad + u) % block;
    if (g < 0) g += block;
    cp_async::copy4(es + u, xz + g, true);
  }
  cp_async::copy_commit();
  if constexpr (kOverlap) {  // the tail tile, zero past the tail: lands during the loop
    const float* tz = tail + ((size_t)z * rows + r0) * bh;
    if (vec) {
      for (int q = tid; q < kRowTile * kSampleTile / 4; q += kThreads) {
        const int r = q / (kSampleTile / 4), s = (q % (kSampleTile / 4)) * 4;
        const bool ok = r0 + r < rows && n0 + s < bh;
        cp_async::copy16(ts + r * kSampleTile + s, ok ? tz + (size_t)r * bh + n0 + s : tail, ok);
      }
    } else {
      for (int q = tid; q < kRowTile * kSampleTile; q += kThreads) {
        const int r = q / kSampleTile, s = q % kSampleTile;
        const bool ok = r0 + r < rows && n0 + s < bh;
        cp_async::copy4(ts + q, ok ? tz + (size_t)r * bh + n0 + s : tail, ok);
      }
    }
    cp_async::copy_commit();
    cp_async::copy_wait<1>();  // the filters and the input slice, not the tail
  } else {
    cp_async::copy_wait<0>();
  }
  STAGE_STAMP(1);
  __syncthreads();
  STAGE_STAMP(2);

  float acc[kRows][kSamples] = {};
  const float* fw = fs + warp * kRows * taps4;
  const float* ew = es + kSamples * lane + pad - 3;  // minus t0 at each step
  const int whole = taps & ~3;
  int t0 = 0;
  for (; t0 < whole; t0 += 4) taps_step<4>(ew - t0, fw, taps4, t0, 4, acc);
  if (t0 < taps) taps_step<3>(ew - t0, fw, taps4, t0, taps - t0, acc);
  STAGE_STAMP(3);

  if constexpr (kOverlap) {
    cp_async::copy_wait<0>();
    __syncthreads();
  }
  STAGE_STAMP(8);
  const int n = n0 + kSamples * lane;  // the thread's first sample
  if (n >= block) return;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = r0 + warp * kRows + i;
    if (r >= rows) break;
    const size_t row = (size_t)z * rows + r;
    if constexpr (!kOverlap) {  // K11: emit is the (z, rows, block) output
      float* o = emit + row * block + n;
      if (vec) {
        *reinterpret_cast<float4*>(o) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
#pragma unroll
        for (int s = 0; s < kSamples; ++s)
          if (n + s < block) o[s] = acc[i][s];
      }
    } else {
      const float* tv = ts + (warp * kRows + i) * kSampleTile + kSamples * lane;
      if (vec) {  // the 4 samples lie on one side of hop and of block - hop
        const float4 wv = __ldg(reinterpret_cast<const float4*>(window + n));
        const float4 t4 = *reinterpret_cast<const float4*>(tv);
        // Window, then tail: two roundings, as the plain version (no FMA).
        const float4 v = make_float4(__fmul_rn(acc[i][0], wv.x) + t4.x,
                                     __fmul_rn(acc[i][1], wv.y) + t4.y,
                                     __fmul_rn(acc[i][2], wv.z) + t4.z,
                                     __fmul_rn(acc[i][3], wv.w) + t4.w);
        float* o = n < hop ? emit + row * hop + n : new_tail + row * bh + (n - hop);
        *reinterpret_cast<float4*>(o) = v;
      } else {
#pragma unroll
        for (int s = 0; s < kSamples; ++s) {
          const int m = n + s;
          if (m >= block) break;
          const float v = __fmul_rn(acc[i][s], window[m]) + tv[s];
          if (m < hop)
            emit[row * hop + m] = v;
          else
            new_tail[row * bh + (m - hop)] = v;
        }
      }
    }
  }
  STAGE_STAMP(9);
  STAGE_BLOCK(1);
}

template <bool kOverlap>
int launch(const float* xin, const float* filt, const float* window,
           const float* tail, float* emit, float* new_tail, int z, int rows,
           int taps, int block, int hop, cudaStream_t stream) {
  const size_t smem = (size_t)smem_floats((taps + 3) & ~3, kOverlap) * sizeof(float);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        output_filter_kernel<kOverlap>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const uintptr_t ptrs = (uintptr_t)window | (uintptr_t)tail | (uintptr_t)emit |
                         (uintptr_t)new_tail;
  const bool vec = hop % 4 == 0 && block % 4 == 0 && ptrs % 16 == 0;
  const dim3 grid((block + kSampleTile - 1) / kSampleTile,
                  (rows + kRowTile - 1) / kRowTile, z);
  output_filter_kernel<kOverlap><<<grid, kThreads, smem, stream>>>(
      xin, filt, window, tail, emit, new_tail, rows, taps, block, hop, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// K5. xin (z, block), filt (z, rows, taps), window (block), tail (z, rows,
// block - hop) -> emit (z, rows, hop), new_tail (z, rows, block - hop);
// float32, contiguous, 0 < hop < block, taps <= block; returns
// cudaErrorInvalidValue past 227 KB of shared memory.
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
