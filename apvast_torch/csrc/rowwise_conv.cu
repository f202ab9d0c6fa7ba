// K8: per-(zone, mic) circular convolution of the response rows, as
// overlap-save frames against a transposed Toeplitz matrix.
//
// Replaces apvast_tpu/ops/pallas/rowwise_conv.py::rowwise_circular_conv_pallas.
//   xp[q]            = x[(q - h) mod N]                  (h = T / 2)
//   out[p, m, s, f*B + o] = sum_{u < U} xp[p, m, s, f*B + u] * k_t[z, m, o, u]
//   z = p mod 2 (path = 2 * signal + zone), U = B + T - 1, f < N / B.
// Every frame is contracted over its full depth U against the given k_t,
// as the TPU kernel does, so the result holds for any k_t, banded or not.
//
// Bound: operations. At the north-star shapes (x (4, 17, 16, 1600), T=257,
// B=160) it is 2 * 2*17 * 32 rows * 1600 * 416 = 1.45 GFLOP of fp32 FMA
// against 23 MB of x, k_t and output.
// Design: the TPU kernel kept one (zone, mic)'s 2S rows in VMEM and ran one
// (rows, U) x (U, B) product per frame. Here one block owns one (zone, mic,
// frame, 32-output tile): it walks the depth U in chunks of 32, staging the
// circularly wrapped window samples of up to 32 rows and the tile's k_t
// columns in shared memory; a warp owns 4 rows, a lane one output, so the
// window samples are warp-wide broadcasts and the k_t reads consecutive.
// No sum crosses blocks (no atomics; results repeat run to run), fp32
// throughout. A band-only depth (the T taps that a banded k_t holds per
// output) would cut the work U / T-fold and is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kOutTile = 32;   // outputs per block (one per lane)
constexpr int kRowTile = 32;   // rows per pass (8 warps x 4 rows)
constexpr int kDepth = 32;     // depth chunk
constexpr int kThreads = 256;
constexpr int kRowsPerWarp = kRowTile / (kThreads / 32);

__global__ void __launch_bounds__(kThreads)
rowwise_conv_kernel(const float* __restrict__ x, const float* __restrict__ k_t,
                    float* __restrict__ out, int m, int s, int n, int taps,
                    int b) {
  __shared__ float xs[kRowTile][kDepth];
  __shared__ float ks[kDepth][kOutTile + 1];

  const int h = taps / 2;
  const int u_len = b + taps - 1;
  const int o0 = blockIdx.x * kOutTile;
  const int f = blockIdx.y;
  const int z = blockIdx.z / m;
  const int mi = blockIdx.z % m;
  const int rows = 2 * s;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const float* kz = k_t + ((size_t)z * m + mi) * b * u_len;

  for (int r0 = 0; r0 < rows; r0 += kRowTile) {
    float acc[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) acc[i] = 0.f;
    for (int u0 = 0; u0 < u_len; u0 += kDepth) {
      for (int i = threadIdx.x; i < kRowTile * kDepth; i += kThreads) {
        const int r = r0 + i / kDepth, u = u0 + i % kDepth;
        float v = 0.f;
        if (r < rows && u < u_len) {
          // Row r of this (zone, mic): signal r / S, source r % S.
          const int p = 2 * (r / s) + z;
          int g = f * b + u - h;
          if (g < 0) g += n;
          else if (g >= n) g -= n;
          v = x[(((size_t)p * m + mi) * s + r % s) * n + g];
        }
        xs[i / kDepth][i % kDepth] = v;
      }
      for (int i = threadIdx.x; i < kOutTile * kDepth; i += kThreads) {
        const int o = i / kDepth, u = u0 + i % kDepth;
        ks[i % kDepth][o] =
            (o0 + o < b && u < u_len) ? kz[(size_t)(o0 + o) * u_len + u] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int uu = 0; uu < kDepth; ++uu) {
        const float kv = ks[uu][lane];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
          acc[i] = fmaf(xs[w + 8 * i][uu], kv, acc[i]);
      }
      __syncthreads();
    }
    const int o = o0 + lane;
    if (o < b) {
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = r0 + w + 8 * i;
        if (r >= rows) continue;
        const int p = 2 * (r / s) + z;
        out[(((size_t)p * m + mi) * s + r % s) * n + f * b + o] = acc[i];
      }
    }
  }
}

}  // namespace

// x (4, m, s, n), k_t (2, m, b, b + taps - 1) -> out (4, m, s, n); float32,
// contiguous, taps odd, taps / 2 < n, b divides n.
extern "C" int rowwise_conv_launch(const float* x, const float* k_t, float* out,
                                   int m, int s, int n, int taps, int b,
                                   cudaStream_t stream) {
  const dim3 grid((b + kOutTile - 1) / kOutTile, n / b, 2 * m);
  rowwise_conv_kernel<<<grid, kThreads, 0, stream>>>(x, k_t, out, m, s, n, taps, b);
  return (int)cudaGetLastError();
}
