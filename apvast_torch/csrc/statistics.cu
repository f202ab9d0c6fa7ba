// K6: the framed covariance and cross-correlation of the dense statistics.
//
// Replaces apvast_tpu/ops/pallas/statistics.py::covariance_pallas and its
// two large-SJ variants (_covariance_pallas_packed, _covariance_pallas_panels):
// three VMEM tilings on the TPU of one function, which one kernel computes
// here for any SJ.
//   Y_pm[sv*J + i, t] = buf[p, m, sv, J-1-i + t]        (t < K = N - J + 1)
//   R[p, a, b]        = sum_m sum_t Y_pm[a, t] Y_pm[b, t]
//   r_cross[p, a, z]  = sum_m sum_t Y_pm[a, t] d[z, m, t]
// The window rows are never formed in device memory: the rows of one
// source are one buffer row shifted by a sample each (a Hankel structure).
//
// Bound: operations. At the north-star shapes (buffers (4, 17, 16, 999),
// J=50, SJ=800, K=950) the symmetric Gram needs 2 * 4 * 17 * (800 * 801 / 2)
// * 950 = 41.4 GFLOP, against 14.7 MB of buffers, targets and output:
// 0.621 ms at 67 TFLOP/s of fp32 FMA, 0.251 ms as the 3 x 41.4 GFLOP of
// 3xTF32 at 495 TFLOP/s.
// Design: the TPU kernel walked the mics as a sequential grid axis and
// added into a resident output tile. Blocks here run in no order, so one
// block owns one lower-triangle 64 x 64 tile pair (bi >= bj) of one path
// (91 pairs x 4 paths = 364 blocks at the north star) and runs the mic sum
// and the time loop inside: no atomics, and the result repeats run to run.
// The Gram runs on the tensor cores in 3xTF32 (tf32x3.cuh), which holds
// fp32 accuracy: 4 warps of 32 x 32 (2 x 4 m16n8 tiles), 8-sample k-steps.
// Per mic and 64-sample chunk, each operand tile is staged compressed: the
// rows of one source in the tile need one buffer slice of (rows + 63)
// samples, so a tile is at most ceil(64 / J) + 1 slices (3 at J = 50: 253
// floats against 4096 expanded), copied with 4-byte cp.async (zero-filled
// past the buffer) into a raw buffer, double-buffered: the next chunk's
// copies run under this chunk's MMAs. Once landed, the block splits each
// staged sample once into its TF32 (hi, lo) pair, so the MMA loop loads a
// fragment value as one 8-byte shared load and does no conversion
// arithmetic (a warp's loads touch 11 consecutive pairs: no bank
// conflict). Chunks of 64 samples halve the staging, splitting and barrier
// work per sample against 32. Each fragment row's offset into the slices is
// computed once, before the loop: no division in it. In the last chunk of
// each mic both operands, and the cross vector's samples, are zeroed past
// K: the staged samples there are real ones that the row's window does not
// hold, and a NaN among them must not reach R or r. A diagonal block stages one operand;
// its warp 1, whose tile lies above the diagonal, computes the cross
// vector instead, in fp32 FMA on the CUDA cores from the raw samples (rows
// a0 + lane and a0 + lane + 32 against both targets, four interleaved FMA
// chains each). Every 32 samples' sums, Gram or cross, are added to an fp32
// total with round-to-nearest adds (the cross vector's with Kahan
// compensation): the tensor core's accumulator does not round to nearest,
// so a long sum left in it drifts from fp32 accuracy. Shared memory is
// sized by J (16.6 KB, the epilogue tile, at J = 50; 129 KB at J = 1). The epilogue stages the tile
// in shared memory and writes it and, off the diagonal, its mirror, both
// coalesced; a diagonal block writes its lower triangle and mirrors it, so
// R comes out exactly symmetric.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "cp_async.cuh"
#include "tf32x3.cuh"

namespace {

using namespace cp_async;
using namespace tf32x3;

constexpr int kTile = 64;
constexpr int kChunk = 64;     // time samples per staged chunk
constexpr int kPromote = 32;   // samples per sum added to the fp32 totals
constexpr int kThreads = 128;  // 2 x 2 warps of 32 x 32
static_assert(2 * kChunk <= kThreads, "one thread stages one target sample");
constexpr int kEpilogue = kTile * (kTile + 1);  // the output tile, floats
constexpr int kMaxDevices = 64;

// Floats of one compressed operand tile: the 64 rows touch at most
// 63 / J + 2 sources (and at most 64), each staged as its rows plus
// kChunk - 1 samples; even, so the (hi, lo) pairs stay 8-byte aligned.
__host__ __device__ constexpr int operand_floats(int j) {
  const int nsrc = (kTile - 1) / j + 2 < kTile ? (kTile - 1) / j + 2 : kTile;
  return (kTile + nsrc * (kChunk - 1) + 1) & ~1;
}

// Shared memory: the (hi, lo) pairs of both operands (4 cap floats), then
// two raw buffers of A, B and the targets' chunk (2 cap + 2 kChunk each);
// the epilogue tile reuses it from the start.
__host__ __device__ constexpr int smem_floats(int cap) {
  return 8 * cap + 4 * kChunk > kEpilogue ? 8 * cap + 4 * kChunk : kEpilogue;
}
constexpr size_t kMaxSmem = smem_floats(operand_floats(1)) * sizeof(float);

// The tile rows [x0, x0 + kTile) touch sources sv0 .. sv0 + nsrc - 1. Source
// q's rows lo..hi are staged as buf[sv, J-1 - (hi - sv*J) + t0 + pos],
// pos < hi - lo + kChunk, at offset lo - x0 + q * (kChunk - 1).
struct Rows {
  int x0, last, sv0, nsrc;
};

__device__ __forceinline__ Rows tile_rows(int x0, int sj, int j) {
  const int last = min(x0 + kTile, sj) - 1;
  return Rows{x0, last, x0 / j, last / j - x0 / j + 1};
}

// Floats of the staged slices of rows rw.
__device__ __forceinline__ int staged(const Rows& rw) {
  return rw.last - rw.x0 + 1 + rw.nsrc * (kChunk - 1);
}

// Offset of row a's sample t0 in the staged slices (0 for a padding row,
// whose sums are discarded).
__device__ __forceinline__ int row_offset(const Rows& rw, int a, int j) {
  if (a > rw.last) return 0;
  const int sv = a / j;
  const int lo = max(rw.x0, sv * j), hi = min(rw.last, sv * j + j - 1);
  return lo - rw.x0 + (sv - rw.sv0) * (kChunk - 1) + (hi - a);
}

// Stage samples t0 .. t0 + kChunk - 1 of rows rw of mic buffer bp (s, n):
// warp w copies sources w, w + 4, ...
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ bp,
                                           const Rows& rw, int j, int n, int t0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int q = warp; q < rw.nsrc; q += kThreads / 32) {
    const int sv = rw.sv0 + q;
    const int lo = max(rw.x0, sv * j), hi = min(rw.last, sv * j + j - 1);
    const int start = j - 1 - (hi - sv * j) + t0;
    const float* src = bp + (size_t)sv * n;
    float* d = dst + lo - rw.x0 + q * (kChunk - 1);
    for (int pos = lane; pos < hi - lo + kChunk; pos += 32) {
      const bool ok = start + pos < n;
      copy4(d + pos, ok ? src + start + pos : src, ok);
    }
  }
}

// One chunk of the warp's 32 x 32 Gram tile: 8-sample k-steps, 8 m16n8
// tiles, 3xTF32 from the (hi, lo) pairs, each kPromote samples' sums added
// to the fp32 total acc. a_off / b_off: each fragment row's offset plus t.
// MASK: the chunk passes K; columns at or past lim = K - t0 are zero in
// both operands (the staged samples there are real, and 0 * NaN is not 0),
// by an AND mask: a select there made ptxas spill at the 168-register cap.
template <bool MASK>
__device__ __forceinline__ void gram_chunk(float (&acc)[2][4][4], const uint2* pa,
                                           const uint2* pb, const int (&a_off)[2][2],
                                           const int (&b_off)[4], int t, int lim) {
#pragma unroll 1
  for (int h0 = 0; h0 < kChunk; h0 += kPromote) {
    float part[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][jn][e] = 0.f;
#pragma unroll
    for (int q = 0; q < kPromote / 8; ++q) {
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = h0 + 8 * q + 4 * (e >> 1);  // a[0], a[1] at t; a[2], a[3] at t + 4
          const uint32_t m = MASK && col + t >= lim ? 0u : ~0u;
          const uint2 v = pa[a_off[mt][e & 1] + col];
          ah[mt][e] = v.x & m, al[mt][e] = v.y & m;
        }
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = h0 + 8 * q + 4 * e;  // b[0] at t, b[1] at t + 4
          const uint32_t m = MASK && col + t >= lim ? 0u : ~0u;
          const uint2 v = pb[b_off[jn] + col];
          bh[jn][e] = v.x & m, bl[jn][e] = v.y & m;
        }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) mma_3xtf32(part[mt][jn], ah[mt], al[mt], bh[jn], bl[jn]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][jn][e] += part[mt][jn][e];
  }
}

__global__ void __launch_bounds__(kThreads, 3)
statistics_kernel(const float* __restrict__ buf, const float* __restrict__ d,
                  float* __restrict__ r_mats, float* __restrict__ r_cross,
                  int m, int s, int n, int j, int cap) {
  extern __shared__ __align__(16) float smem[];

  const int sj = s * j;
  const int k = n - j + 1;
  const int p = blockIdx.y;
  // Lower-triangle tile pair number blockIdx.x -> (bi, bj), bj <= bi.
  const int tp = blockIdx.x;
  int bi = (int)((sqrtf(8.f * tp + 1.f) - 1.f) * 0.5f);
  while ((bi + 1) * (bi + 2) / 2 <= tp) ++bi;
  while (bi * (bi + 1) / 2 > tp) --bi;
  const int bj = tp - bi * (bi + 1) / 2;
  const bool diag = bi == bj;
  const int a0 = bi * kTile, b0 = bj * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const bool cross_warp = diag && warp == 1;  // its Gram tile is above the diagonal

  // The pairs: A, then B at + cap (a diagonal block reads A twice). Raw
  // buffer r: A at r * raw_stride, B at + cap, targets at + 2 cap.
  uint2* pa = reinterpret_cast<uint2*>(smem);
  uint2* pb = diag ? pa : pa + cap;
  float* raw = smem + 4 * cap;
  const int raw_stride = 2 * cap + 2 * kChunk;

  const Rows ra = tile_rows(a0, sj, j), rb = tile_rows(b0, sj, j);
  const int used_a = staged(ra), used_b = diag ? 0 : staged(rb);
  int a_off[2][2], b_off[4], c_off[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) a_off[mt][h] = row_offset(ra, a0 + wm * 32 + mt * 16 + g + 8 * h, j) + t;
#pragma unroll
  for (int jn = 0; jn < 4; ++jn) b_off[jn] = row_offset(rb, b0 + wn * 32 + 8 * jn + g, j) + t;
#pragma unroll
  for (int h = 0; h < 2; ++h) c_off[h] = row_offset(ra, a0 + lane + 32 * h, j);

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][jn][e] = 0.f;
  float cross[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [row half][target]
  float comp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};   // their Kahan compensation

  auto stage = [&](int r, int mi, int t0) {
    float* st = raw + r * raw_stride;
    const float* bp = buf + ((size_t)p * m + mi) * s * n;
    stage_rows(st, bp, ra, j, n, t0);
    if (!diag) stage_rows(st + cap, bp, rb, j, n, t0);
    if (diag && threadIdx.x < 2 * kChunk) {
      const int z = threadIdx.x / kChunk, c = threadIdx.x % kChunk;
      const bool ok = t0 + c < k;
      copy4(st + 2 * cap + threadIdx.x, ok ? d + ((size_t)z * m + mi) * k + t0 + c : d, ok);
    }
    copy_commit();
  };
  // Split raw buffer r into the pairs, once per staged sample.
  auto convert = [&](int r) {
    const float* st = raw + r * raw_stride;
    for (int e = threadIdx.x; e < used_a + used_b; e += kThreads) {
      uint32_t hi, lo;
      split_tf32(e < used_a ? st[e] : st[cap + e - used_a], hi, lo);
      pa[e < used_a ? e : cap + e - used_a] = make_uint2(hi, lo);
    }
  };

  // Chunk c (mic c / per_mic, samples from t0) is staged in raw buffer c % 2.
  const int per_mic = (k + kChunk - 1) / kChunk;
  const int chunks = m * per_mic;
  int smi = 0, st0 = 0;  // the next chunk to stage
  auto stage_next = [&](int r) {
    stage(r, smi, st0);
    st0 += kChunk;
    if (st0 >= k) st0 = 0, ++smi;
  };
  stage_next(0);
  copy_wait<0>();
  __syncthreads();
  convert(0);
  __syncthreads();
  int t0 = 0;  // chunk c's first sample
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) stage_next((c + 1) & 1);
    if (cross_warp) {
      const float* st = raw + (c & 1) * raw_stride;
      const float* ds = st + 2 * cap;
      const int lim = k - t0;  // the targets are zero past K, the samples not
      for (int h0 = 0; h0 < kChunk; h0 += kPromote) {
        float pc[2][2][4] = {};  // four interleaved FMA chains a sum
#pragma unroll 8
        for (int kk = h0; kk < h0 + kPromote; ++kk) {
          const float d0 = ds[kk], d1 = ds[kChunk + kk];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float y = kk < lim ? st[c_off[h] + kk] : 0.f;
            pc[h][0][kk & 3] = fmaf(y, d0, pc[h][0][kk & 3]);
            pc[h][1][kk & 3] = fmaf(y, d1, pc[h][1][kk & 3]);
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int z = 0; z < 2; ++z) {
            const float part = (pc[h][z][0] + pc[h][z][1]) + (pc[h][z][2] + pc[h][z][3]);
            const float y = part - comp[h][z];
            const float sum = cross[h][z] + y;
            comp[h][z] = (sum - cross[h][z]) - y;
            cross[h][z] = sum;
          }
      }
    } else if (t0 + kChunk <= k) {
      gram_chunk<false>(acc, pa, pb, a_off, b_off, t, k - t0);
    } else {
      gram_chunk<true>(acc, pa, pb, a_off, b_off, t, k - t0);
    }
    copy_wait<0>();
    __syncthreads();  // the next chunk has landed; the pairs are free
    if (c + 1 < chunks) {
      convert((c + 1) & 1);
      __syncthreads();
    }
    t0 += kChunk;
    if (t0 >= k) t0 = 0;
  }

  // Epilogue: the tile through shared memory (the staging buffers).
  float(*cs)[kTile + 1] = reinterpret_cast<float(*)[kTile + 1]>(smem);
  if (!cross_warp) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cs[wm * 32 + mt * 16 + g + 8 * (e >> 1)][wn * 32 + 8 * jn + 2 * t + (e & 1)] =
              acc[mt][jn][e];
  }
  __syncthreads();
  float* rp = r_mats + (size_t)p * sj * sj;
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile, c = i % kTile;  // along the row of R
    if (a0 + r < sj && b0 + c < sj)
      rp[(size_t)(a0 + r) * sj + b0 + c] = (diag && r < c) ? cs[c][r] : cs[r][c];
  }
  if (!diag) {
    for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
      const int r = i % kTile, c = i / kTile;  // the mirror, along its row
      if (a0 + r < sj && b0 + c < sj) rp[(size_t)(b0 + c) * sj + a0 + r] = cs[r][c];
    }
  } else if (cross_warp) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int a = a0 + lane + 32 * h;
      if (a < sj) {
        r_cross[((size_t)p * sj + a) * 2] = cross[h][0];
        r_cross[((size_t)p * sj + a) * 2 + 1] = cross[h][1];
      }
    }
  }
}

}  // namespace

// buf (p4, m, s, n), d (2, m, n - j + 1) -> r_mats (p4, s*j, s*j),
// r_cross (p4, s*j, 2); float32, contiguous, 0 < j <= n.
extern "C" int statistics_launch(const float* buf, const float* d, float* r_mats,
                                 float* r_cross, int p4, int m, int s, int n, int j,
                                 cudaStream_t stream) {
  // Raise the kernel's dynamic shared-memory limit to its largest size (J = 1),
  // once per device.
  static std::atomic<bool> raised[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices || !raised[dev].load()) {
    e = cudaFuncSetAttribute(statistics_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) raised[dev].store(true);
  }
  const int cap = operand_floats(j);
  const int tiles = (s * j + kTile - 1) / kTile;
  const dim3 grid(tiles * (tiles + 1) / 2, p4);
  statistics_kernel<<<grid, kThreads, smem_floats(cap) * sizeof(float), stream>>>(
      buf, d, r_mats, r_cross, m, s, n, j, cap);
  return (int)cudaGetLastError();
}
