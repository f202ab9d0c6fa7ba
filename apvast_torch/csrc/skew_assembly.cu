// K3: lag tables -> source-major covariance rows, full or half form.
//
// Replaces apvast_tpu/ops/pallas/skew_assembly.py::lag_skew_assemble, both
// values of half_scaled. The TPU kernel ran the tap band a as a sequential
// grid axis, carrying acc_a = shift_left(acc_{a-1}) + lhsT[a] . rhs in
// scratch, with acc_0 = c0. Unrolled, the recursion is a running sum
// along each lane diagonal D = t2 + a of a source block:
//   out[p, s1, J-1-a, s2*J + D-a] = c0_sm[p, s1, s2*J + D]
//                                   + sum_{i<=a} T[i, s2*J + D-i],
//   T[i, w] = lhsT[p, i*S1+s1, :] . rhs[p, :, w],
// for a <= D (the valid lanes t2 <= t1 of row t1 = J-1-a). Diagonals never
// cross a source block, so each (p, s1, s2) J x J tile is independent.
//
// Bound: bytes. At the north-star shapes (P=4, S=16, J=50, C=2M=34) the
// 10.24 MB output dominates ~11.3 MB of traffic (3.4 us); the product is
// ~0.17 GFLOP of fp32 FMA (2.6 us at the fp32 peak).
// The first design ran one thread per (p, s1, lane diagonal) through the J
// steps, each a C-long dot product with two loads per FMA (one from shared
// memory, one through L1/L2) and no reuse, in 448 blocks of 4 warps: its
// load -> FMA chains were latency-bound, and its zero lanes diverged.
// Design: a block owns one (p, s1) and a group of G source blocks s2, G*J
// lanes with G*J a multiple of 4 (the wrapper's plan), so that its rows
// store as float4. It stages its rhs columns (C x G*J) once with cp.async
// and walks T in row bands of `band` rows (the whole J x J tile when it
// fits; the wrapper picks the band from the shared memory it needs):
//  1. stage the band's lhs rows, transposed (C x band);
//  2. the band of T, a (band x C) . (C x G*J) product in 4 x 4 register
//     tiles (two float4 shared loads for 16 FMAs), into shared memory;
//     only the tiles that hold a valid entry (i + t2 <= J-1, about half)
//     are listed and computed;
//  3. the diagonal sums in place: one thread per lane diagonal (s2, D)
//     carries its sum over the bands (in `sums`), adding T[i, D-i] for
//     i = i0, i0+1, ... in the plain version's order (four loads at a
//     time in flight) and writing each partial sum back over the T entry
//     it consumed; neighbouring threads touch neighbouring words;
//  4. stream the band's output rows out whole and coalesced: the valid
//     lanes from the tile, the strict-upper-tap lanes 0 and, in the half
//     form, the tap-diagonal lanes x 0.5 (an exact scaling).
// The form is a template parameter. Arithmetic is plain fp32 FMA.

#include <cuda_runtime.h>

#include <cstdint>

#include "cp_async.cuh"

#ifndef STAGE_STAMP
#define STAGE_STAMP(kind)  // timer stamps: only tools/k3_k5_stages.py's build has them
#define STAGE_BLOCK(kind)  // every block's start and end, likewise
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kSmemLimit = 227 * 1024;

struct Args {
  const float* lhs_t;
  const float* rhs;
  const float* c0;
  float* out;
  int s1n, j, c, w;
  int g;      // source blocks of a block's group
  int band;   // rows of T a band (a multiple of 4)
  int ld;     // g * j lanes: row stride of the staged rhs and T band
  bool vec;   // rhs and out rows on 16 bytes: float4 copies and stores
};

template <bool kHalf>
__global__ void __launch_bounds__(kThreads) skew_assembly_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  float* rs = sm;                   // (c, ld): rhs columns of the group
  float* ts = rs + a.c * a.ld;      // (band, ld): a band of T, then its sums
  float* ls = ts + a.band * a.ld;   // (c, band): the band's lhs rows, transposed
  float* sums = ls + a.c * a.band;  // (ld): each diagonal's running sum
  int* tiles = reinterpret_cast<int*>(sums + a.ld);  // a band's tiles with a valid entry
  int* ntiles = tiles + (a.band / 4) * (a.ld / 4);   // and their count
  const int p = blockIdx.z, s1 = blockIdx.y;
  const int lane0 = blockIdx.x * a.g * a.j;
  const int lanes = min(a.ld, a.w - lane0);  // lanes of this group
  const int tid = threadIdx.x;
  STAGE_STAMP(0);
  STAGE_BLOCK(0);
  if (tid == 0) *ntiles = 0;

  const float* rp = a.rhs + (size_t)p * a.c * a.w + lane0;
  if (a.vec) {  // lanes is a multiple of 4 too: w and lane0 are
    const int q4 = a.ld / 4;
    for (int q = tid; q < a.c * q4; q += kThreads) {
      const int cc = q / q4, col = (q % q4) * 4;
      const bool ok = col < lanes;
      cp_async::copy16(rs + cc * a.ld + col, ok ? rp + (size_t)cc * a.w + col : a.rhs, ok);
    }
  } else {
    for (int q = tid; q < a.c * a.ld; q += kThreads) {
      const int cc = q / a.ld, col = q % a.ld;
      const bool ok = col < lanes;
      cp_async::copy4(rs + q, ok ? rp + (size_t)cc * a.w + col : a.rhs, ok);
    }
  }
  const float* cp = a.c0 + ((size_t)p * a.s1n + s1) * a.w + lane0;
  for (int d = tid; d < lanes; d += kThreads) sums[d] = cp[d];

  const float* lp = a.lhs_t + ((size_t)p * a.j * a.s1n + s1) * a.c;
  float* op = a.out + ((size_t)p * a.s1n + s1) * a.j * a.w + lane0;
  for (int i0 = 0; i0 < a.j; i0 += a.band) {
    const int rows = min(a.band, a.j - i0);
    // 1. lhs rows i0 .. i0+rows-1 of source s1, zero past them.
    for (int q = tid; q < a.band * a.c; q += kThreads) {
      const int r = q / a.c, cc = q % a.c;
      const bool ok = r < rows;
      cp_async::copy4(ls + cc * a.band + r,
                      ok ? lp + (size_t)(i0 + r) * a.s1n * a.c + cc : a.lhs_t, ok);
    }
    cp_async::copy_commit();
    cp_async::copy_wait<0>();
    STAGE_STAMP(1);
    __syncthreads();
    STAGE_STAMP(2);

    // 2. T[i0 + r, col] in 4 x 4 register tiles, those with an entry
    //    i + t2 <= J-1 (a quad that crosses into the next source block
    //    holds t2 = 0), listed in any order: each tile's sums are fixed.
    const int cq = a.ld / 4;
    for (int q = tid; q < (a.band / 4) * cq; q += kThreads) {
      const int i = i0 + (q / cq) * 4, col = (q % cq) * 4, u = col % a.j;
      if (col < lanes && i + (u + 3 >= a.j ? 0 : u) <= a.j - 1) tiles[atomicAdd(ntiles, 1)] = q;
    }
    __syncthreads();
    const int n = *ntiles;
    for (int k = tid; k < n; k += kThreads) {
      const int q = tiles[k];
      const int r4 = (q / cq) * 4, c4 = (q % cq) * 4;
      float t[4][4] = {};
      const float* lq = ls + r4;
      const float* rq4 = rs + c4;
#pragma unroll 4
      for (int cc = 0; cc < a.c; ++cc) {
        const float4 l = *reinterpret_cast<const float4*>(lq + cc * a.band);
        const float4 r = *reinterpret_cast<const float4*>(rq4 + cc * a.ld);
        const float lv[4] = {l.x, l.y, l.z, l.w};
        const float rv[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) t[x][y] = fmaf(lv[x], rv[y], t[x][y]);
      }
#pragma unroll
      for (int x = 0; x < 4; ++x)
        *reinterpret_cast<float4*>(ts + (r4 + x) * a.ld + c4) =
            make_float4(t[x][0], t[x][1], t[x][2], t[x][3]);
    }
    STAGE_STAMP(3);
    __syncthreads();
    STAGE_STAMP(4);

    // 3. Diagonal d = s2*J + D adds T[i, s2*J + D-i], i = i0 .. min(D, last
    //    row of the band), and leaves each partial sum in its place.
    for (int d = tid; d < lanes; d += kThreads) {
      const int dd = d % a.j;
      const int last = min(i0 + rows - 1, dd);
      if (last < i0) continue;
      float acc = sums[d];
      float* e = ts + d - i0;  // T[i, s2*J + D-i] at e + (i - i0) * step
      const int step = a.ld - 1;
      int i = i0;
      for (; i + 3 <= last; i += 4, e += 4 * step) {  // four loads in flight
        const float v0 = e[0], v1 = e[step], v2 = e[2 * step], v3 = e[3 * step];
        acc += v0;
        e[0] = acc;
        acc += v1;
        e[step] = acc;
        acc += v2;
        e[2 * step] = acc;
        acc += v3;
        e[3 * step] = acc;
      }
      for (; i <= last; ++i, e += step) {
        acc += *e;
        *e = acc;
      }
      sums[d] = acc;
    }
    STAGE_STAMP(6);
    __syncthreads();
    STAGE_STAMP(7);

    // 4. Output row t1 = J-1-i of each band row i.
    if (a.vec) {
      const int q4 = lanes / 4;
      for (int q = tid; q < rows * q4; q += kThreads) {
        const int r = q / q4, col = (q % q4) * 4, i = i0 + r;
        const float4 v = *reinterpret_cast<const float4*>(ts + r * a.ld + col);
        float o[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int diag = i + (col + k) % a.j;  // D = a + t2
          o[k] = diag > a.j - 1 ? 0.f : (kHalf && diag == a.j - 1 ? 0.5f * o[k] : o[k]);
        }
        *reinterpret_cast<float4*>(op + (size_t)(a.j - 1 - i) * a.w + col) =
            make_float4(o[0], o[1], o[2], o[3]);
      }
    } else {
      for (int q = tid; q < rows * lanes; q += kThreads) {
        const int r = q / lanes, col = q % lanes, i = i0 + r;
        const int diag = i + col % a.j;
        const float v = ts[r * a.ld + col];
        op[(size_t)(a.j - 1 - i) * a.w + col] =
            diag > a.j - 1 ? 0.f : (kHalf && diag == a.j - 1 ? 0.5f * v : v);
      }
    }
    if (tid == 0) *ntiles = 0;
    STAGE_STAMP(5);
    __syncthreads();  // the next band overwrites ls, ts and the tile list
  }
  STAGE_BLOCK(1);
}

}  // namespace

// Shared memory of a block of the plan (g, band), in bytes (the wrapper's
// skew_smem_bytes).
static long smem_bytes(int j, int c, int g, int band) {
  const long ld = (long)g * j;
  return 4 * (c * ld + band * ld + (long)c * band + ld + (band / 4) * (ld / 4) + 1);
}

// lhs_t (p, j*s1, c), rhs (p, c, w), c0 (p, s1, w) -> out (p, s1, j, w),
// w = s2*j; float32, contiguous; half != 0 halves the tap-diagonal lanes.
// The plan (ops/kernels/skew_assembly.py::skew_plan): g source blocks a
// block, g*j a multiple of 4; T walked in bands of `band` rows, a multiple
// of 4. Returns cudaErrorInvalidValue for a plan that breaks those rules
// or needs more than 227 KB of shared memory.
extern "C" int skew_assembly_launch(const float* lhs_t, const float* rhs,
                                    const float* c0, float* out, int p, int s1,
                                    int j, int c, int w, int half, int g, int band,
                                    cudaStream_t stream) {
  const long smem = smem_bytes(j, c, g, band);
  if (g <= 0 || band <= 0 || (g * j) % 4 || band % 4 || smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  auto kernel = half ? skew_assembly_kernel<true> : skew_assembly_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  Args a{lhs_t, rhs, c0, out, s1, j, c, w, g, band, g * j,
         w % 4 == 0 && ((uintptr_t)rhs | (uintptr_t)out) % 16 == 0};
  const int s2 = w / j;
  const dim3 grid((s2 + g - 1) / g, s1, p);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
