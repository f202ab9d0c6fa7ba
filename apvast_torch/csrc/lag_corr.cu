// K2: mic-summed windowed lag correlations of the lag statistics.
//
// Replaces apvast_tpu/ops/pallas/lag_corr.py::lag_corr_pallas.
//   C0[p, s1, s2, l] = sum_m sum_{t<K} x[p, m, s1, t] * x[p, m, s2, t + l],
//   l < J, K = N - J + 1.
//
// Bound: operations. At the north-star shapes (x (4, 17, 17, 999), J=50,
// the target riding as row 17) it is 1.87 GFLOP of fp32 FMA over 4.6 MB
// of input.
// Design: the TPU kernel walked the mics as a sequential grid axis and
// added into a revisited output block. Blocks here run in no order, so
// each block owns a whole output tile (path, s2, 32 rows of s1, 32 lags)
// and runs the mic sum and the t loop inside: no atomics, and the result
// repeats run to run. Per mic and 256-sample chunk it stages the tile's
// s1 rows and the s2 row (chunk + 31 samples) in shared memory; a warp
// owns 32 consecutive lags (one per lane) and 4 rows of s1, so the s1
// samples are warp-wide broadcasts and the s2 samples consecutive. fp32
// throughout (the TPU kernel's bf16 shift stack was a TPU artefact).

#include <cuda_runtime.h>

namespace {

constexpr int kLagTile = 32;   // lags per block (one per lane)
constexpr int kRowTile = 32;   // s1 rows per block (8 warps x 4 rows)
constexpr int kTimeChunk = 256;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
lag_corr_kernel(const float* __restrict__ x, float* __restrict__ out,
                int m, int s, int n, int j) {
  __shared__ float x1[kRowTile][kTimeChunk];
  __shared__ float x2[kTimeChunk + kLagTile - 1];

  const int k = n - j + 1;
  const int l0 = blockIdx.x * kLagTile;
  const int s2 = blockIdx.y % s;
  const int s10 = (blockIdx.y / s) * kRowTile;
  const int p = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int mi = 0; mi < m; ++mi) {
    const float* xp = x + (size_t)(p * m + mi) * s * n;
    for (int t0 = 0; t0 < k; t0 += kTimeChunk) {
      for (int i = threadIdx.x; i < kRowTile * kTimeChunk; i += kThreads) {
        const int r = i / kTimeChunk, c = i % kTimeChunk;
        const int gs = s10 + r, gt = t0 + c;
        x1[r][c] = (gs < s && gt < k) ? xp[(size_t)gs * n + gt] : 0.f;
      }
      for (int u = threadIdx.x; u < kTimeChunk + kLagTile - 1; u += kThreads) {
        const int g = t0 + l0 + u;
        x2[u] = (g < n) ? xp[(size_t)s2 * n + g] : 0.f;
      }
      __syncthreads();
      const int tmax = min(kTimeChunk, k - t0);
      for (int c = 0; c < tmax; ++c) {
        const float v2 = x2[c + lane];  // x[s2, t0 + c + l0 + lane]
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] = fmaf(x1[w + 8 * i][c], v2, acc[i]);
      }
      __syncthreads();
    }
  }

  const int l = l0 + lane;
  if (l >= j) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s1 = s10 + w + 8 * i;
    if (s1 < s) out[(((size_t)p * s + s1) * s + s2) * j + l] = acc[i];
  }
}

}  // namespace

// x (p4, m, s, n) -> out (p4, s, s, j); float32, contiguous, j <= n.
extern "C" int lag_corr_launch(const float* x, float* out, int p4, int m,
                               int s, int n, int j, cudaStream_t stream) {
  const dim3 grid((j + kLagTile - 1) / kLagTile,
                  s * ((s + kRowTile - 1) / kRowTile), p4);
  lag_corr_kernel<<<grid, kThreads, 0, stream>>>(x, out, m, s, n, j);
  return (int)cudaGetLastError();
}
