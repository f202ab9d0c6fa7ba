// K1: streaming FIR bank for stage 1 of the hop (RIR convolution).
//
// Replaces apvast_tpu/ops/pallas/streaming_conv.py::streaming_conv_pallas.
//   out[z, r, h] = sum_k kern[z, r, k] * seg[z, hist + h - k],  hist = seg_len - hop
// i.e. the `hop` valid outputs of each FIR row over the carried history
// plus the new hop samples.
//
// Bound: operations. At the north-star shapes (z=2, rows=561, taps=2400,
// hop=800) it is 4.31 GFLOP of fp32 FMA against ~14.4 MB of traffic.
// Design: the TPU kernel built a (taps, hop) sliding-window matrix in VMEM
// for its matrix unit; here no window matrix exists. Each block owns a
// (signal, 32-row tile, 128-output tile), walks the taps in chunks of 64,
// stages the chunk's kernel taps and the matching segment slice in shared
// memory, and every thread keeps a 4x4 register tile of outputs (4 rows x
// 4 outputs). Kernel taps are read as warp-wide broadcasts, segment samples
// at consecutive addresses. Plain fp32 FMA; no tensor cores, no TF32.

#include <cuda_runtime.h>

namespace {

constexpr int kRowTile = 32;   // rows per block
constexpr int kOutTile = 128;  // outputs per block
constexpr int kTapChunk = 64;  // taps staged per step
constexpr int kThreads = 256;  // 32 (outputs) x 8 (row groups)

__global__ void __launch_bounds__(kThreads)
streaming_conv_kernel(const float* __restrict__ seg,
                      const float* __restrict__ kern,
                      float* __restrict__ out,
                      int seg_len, int rows, int taps, int hop) {
  __shared__ float ks[kRowTile][kTapChunk];
  __shared__ float ss[kOutTile + kTapChunk - 1];

  const int z = blockIdx.z;
  const int r0 = blockIdx.y * kRowTile;
  const int h0 = blockIdx.x * kOutTile;
  const int hist = seg_len - hop;
  const float* segz = seg + (size_t)z * seg_len;
  const float* kz = kern + (size_t)z * rows * taps;
  const int tx = threadIdx.x & 31;  // output column group
  const int ty = threadIdx.x >> 5;  // row group (one warp)

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;

  for (int k0 = 0; k0 < taps; k0 += kTapChunk) {
    for (int i = threadIdx.x; i < kRowTile * kTapChunk; i += kThreads) {
      const int r = i / kTapChunk, c = i % kTapChunk;
      const int gr = r0 + r, gk = k0 + c;
      ks[r][c] = (gr < rows && gk < taps) ? kz[(size_t)gr * taps + gk] : 0.f;
    }
    // ss[u] = seg[base + u]; output h0+hh at tap k0+c reads
    // seg[hist + h0 + hh - k0 - c] = ss[kTapChunk - 1 + hh - c].
    const int base = hist + h0 - k0 - (kTapChunk - 1);
    for (int u = threadIdx.x; u < kOutTile + kTapChunk - 1; u += kThreads) {
      const int g = base + u;
      ss[u] = (g >= 0 && g < seg_len) ? segz[g] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTapChunk; ++c) {
      float kv[4], sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) kv[i] = ks[ty * 4 + i][c];
#pragma unroll
      for (int q = 0; q < 4; ++q) sv[q] = ss[kTapChunk - 1 + tx + 32 * q - c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(kv[i], sv[q], acc[i][q]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= rows) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int h = h0 + tx + 32 * q;
      if (h < hop) out[((size_t)z * rows + r) * hop + h] = acc[i][q];
    }
  }
}

}  // namespace

// seg (z, seg_len), kern (z, rows, taps) -> out (z, rows, hop); float32,
// contiguous, seg_len - hop >= taps - 1 (checked by the Python wrapper).
extern "C" int streaming_conv_launch(const float* seg, const float* kern,
                                     float* out, int z, int seg_len, int rows,
                                     int taps, int hop, cudaStream_t stream) {
  const dim3 grid((hop + kOutTile - 1) / kOutTile,
                  (rows + kRowTile - 1) / kRowTile, z);
  streaming_conv_kernel<<<grid, kThreads, 0, stream>>>(seg, kern, out, seg_len,
                                                       rows, taps, hop);
  return (int)cudaGetLastError();
}
