// K6: the framed covariance and cross-correlation of the dense statistics.
//
// Replaces apvast_tpu/ops/pallas/statistics.py::covariance_pallas and its
// two large-SJ variants (_covariance_pallas_packed, _covariance_pallas_panels):
// three VMEM tilings on the TPU of one function, which one kernel computes
// here for any SJ.
//   Y_pm[sv*J + i, t] = buf[p, m, sv, J-1-i + t]        (t < K = N - J + 1)
//   R[p, a, b]        = sum_m sum_t Y_pm[a, t] Y_pm[b, t]
//   r_cross[p, a, z]  = sum_m sum_t Y_pm[a, t] d[z, m, t]
// The window rows are never formed in device memory: row a of Y is a
// shifted slice of one buffer row, so neighbouring rows of one source read
// neighbouring addresses (a Hankel structure) and a tile of rows loads
// coalesced along either axis.
//
// Bound: operations. At the north-star shapes (buffers (4, 17, 16, 999),
// J=50, SJ=800, K=950) the symmetric Gram needs 2 * 4 * 17 * (800 * 801 / 2)
// * 950 = 41.4 GFLOP of fp32 FMA, against 14.7 MB of buffers, targets and
// output.
// Design: the TPU kernel walked the mics as a sequential grid axis and
// added into a resident output tile. Blocks here run in no order, so one
// block owns one lower-triangle 64 x 64 tile pair (bi >= bj) of one path
// and runs the mic sum and the time loop inside: no atomics, and the result
// repeats run to run. Per mic and 32-sample chunk it stages both tiles'
// window rows in shared memory, gathered straight from the buffer; each of
// 256 threads accumulates a 4 x 4 register tile (two 16-byte shared loads
// per 16 FMAs). The epilogue stages the tile in shared memory and writes it
// and, off the diagonal, its mirror, both coalesced, so R comes out exactly
// symmetric. The cross vector rides in the same launch: the diagonal
// blocks, whose tile holds rows a0..a0+63 once, also stage the two targets'
// chunk and accumulate r_cross for those rows on 128 of their threads.
// Full fp32 FMA; no tensor cores (TF32 would lose the precision the GEVD
// needs).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kDepth = 32;      // time chunk
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kThreads)
statistics_kernel(const float* __restrict__ buf, const float* __restrict__ d,
                  float* __restrict__ r_mats, float* __restrict__ r_cross,
                  int m, int s, int n, int j) {
  __shared__ __align__(16) float as[kDepth][kTile];
  __shared__ __align__(16) float bs[kDepth][kTile];
  __shared__ float ds[2][kDepth];
  __shared__ float cs[kTile][kTile + 1];

  const int sj = s * j;
  const int k = n - j + 1;
  const int p = blockIdx.y;
  // Lower-triangle tile pair number blockIdx.x -> (bi, bj), bj <= bi.
  const int t = blockIdx.x;
  int bi = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while ((bi + 1) * (bi + 2) / 2 <= t) ++bi;
  while (bi * (bi + 1) / 2 > t) --bi;
  const int bj = t - bi * (bi + 1) / 2;
  const bool diag = bi == bj;
  const int a0 = bi * kTile, b0 = bj * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
  float cross = 0.f;  // diagonal blocks: row a0 + tid / 2 against target tid % 2

  for (int mi = 0; mi < m; ++mi) {
    const float* bp = buf + ((size_t)p * m + mi) * s * n;
    for (int t0 = 0; t0 < k; t0 += kDepth) {
      // Window row a at time t0 + c: buffer row a / J at J-1 - a % J + t0 + c.
      for (int i = threadIdx.x; i < kTile * kDepth; i += kThreads) {
        const int r = i % kTile, c = i / kTile, tt = t0 + c;
        const int a = a0 + r;
        as[c][r] = (a < sj && tt < k) ? bp[(size_t)(a / j) * n + (j - 1 - a % j) + tt] : 0.f;
        if (!diag) {
          const int b = b0 + r;
          bs[c][r] = (b < sj && tt < k) ? bp[(size_t)(b / j) * n + (j - 1 - b % j) + tt] : 0.f;
        }
      }
      if (diag && threadIdx.x < 2 * kDepth) {
        const int z = threadIdx.x / kDepth, c = threadIdx.x % kDepth;
        ds[z][c] = (t0 + c < k) ? d[((size_t)z * m + mi) * k + t0 + c] : 0.f;
      }
      __syncthreads();
      const float(*bsel)[kTile] = diag ? as : bs;
#pragma unroll 4
      for (int c = 0; c < kDepth; ++c) {
        const float4 av = *reinterpret_cast<const float4*>(&as[c][ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&bsel[c][tx * 4]);
        const float a4[4] = {av.x, av.y, av.z, av.w};
        const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(a4[i], b4[q], acc[i][q]);
      }
      if (diag && threadIdx.x < 2 * kTile) {
        const int r = threadIdx.x >> 1, z = threadIdx.x & 1;
        for (int c = 0; c < kDepth; ++c) cross = fmaf(as[c][r], ds[z][c], cross);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) cs[ty * 4 + i][tx * 4 + q] = acc[i][q];
  __syncthreads();
  float* rp = r_mats + (size_t)p * sj * sj;
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile, c = i % kTile;  // along the row of R
    if (a0 + r < sj && b0 + c < sj) rp[(size_t)(a0 + r) * sj + b0 + c] = cs[r][c];
  }
  if (!diag) {
    for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
      const int r = i % kTile, c = i / kTile;  // the mirror, along its row
      if (a0 + r < sj && b0 + c < sj) rp[(size_t)(b0 + c) * sj + a0 + r] = cs[r][c];
    }
  } else if (threadIdx.x < 2 * kTile && a0 + (threadIdx.x >> 1) < sj) {
    r_cross[((size_t)p * sj + a0) * 2 + threadIdx.x] = cross;
  }
}

}  // namespace

// buf (p4, m, s, n), d (2, m, n - j + 1) -> r_mats (p4, s*j, s*j),
// r_cross (p4, s*j, 2); float32, contiguous, 0 < j <= n.
extern "C" int statistics_launch(const float* buf, const float* d, float* r_mats,
                                 float* r_cross, int p4, int m, int s, int n, int j,
                                 cudaStream_t stream) {
  const int tiles = (s * j + kTile - 1) / kTile;
  const dim3 grid(tiles * (tiles + 1) / 2, p4);
  statistics_kernel<<<grid, kThreads, 0, stream>>>(buf, d, r_mats, r_cross, m, s, n, j);
  return (int)cudaGetLastError();
}
