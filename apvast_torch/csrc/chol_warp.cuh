// Blocked Cholesky factor and lower-triangular inverse of a small SPD
// matrix held in shared memory, by one thread block. A tool of K9
// (subspace.cu, the k x k Gram matrices of CholeskyQR2), K10a (whiten.cu,
// the 128 x 128 panels) and the tracker's Rayleigh-Ritz solve
// (tracked_rr.cu, its pencil and Gram matrices), not a kernel.
//
// The matrix is cut into 32-wide sub-panels. For each sub-panel:
//  1. one warp factors the 32 x 32 diagonal block in registers (lane r
//     holds row r; the pivot goes lane to lane by a shuffle, the column
//     through shared memory: no block barrier inside the 32 column steps);
//  2. the warps solve the strip below it, four rows a warp at a time (lane
//     c holds column c), while one more warp inverts the diagonal block by
//     forward substitution (lane c holds column c of the inverse);
//  3. the block subtracts the strip's outer product from the trailing
//     lower triangle, in 4 x 4 register tiles.
// Inside a sub-panel every entry of L sees the operations of the
// right-looking column algorithm (ops/trisolve.py::clamped_cholesky,
// pivot rsqrt(max(p, 1e-30)) with a NaN passed through) in its order; a
// sub-panel's update of the trailing matrix is its block product, summed
// first and subtracted once, as the torch form takes it with a matmul
// (the sequential chain of the column algorithm is ~2x further from
// float64 at n = 128). The inverse's off-diagonal blocks follow
// by the merge tree of apvast_tpu/ops/pallas/whiten.py::_merge_tri,
// X21 = -X22 (L21 X11), each product over the nonzero range of its
// triangular operand. Block barriers: 3 per sub-panel but the last (2),
// and 2 per merge level: 15 at n = 128, against 256 for the column
// algorithms (one per column step of the factor and of the inverse).
//
// The torch form of the same algorithm is
// apvast_torch/ops/kernels/whiten.py::blocked_chol_inverse.

#pragma once

#include <math.h>

#ifndef STAGE_STAMP
#define STAGE_STAMP(kind)  // timer stamps: only tools/k9_k10a_stages.py's build has them
#endif

namespace chol_warp {

constexpr int kSub = 32;
constexpr unsigned kFull = 0xffffffffu;

// max(x, 1e-30) that propagates a NaN, as jnp.maximum and clamp_min do.
__device__ __forceinline__ float clamp_pivot(float x) { return x < 1e-30f ? 1e-30f : x; }

// Shared scratch of one factorization (floats, on 16 bytes): a column of
// the diagonal block being factored, and the block's rows on 16 bytes.
constexpr int kRowLd = kSub + 4;
constexpr int kScratch = kSub + kSub * kRowLd;

// One warp: L of the 32 x 32 diagonal block at (c0, c0) of A (row stride
// ld, its trailing updates applied), in place, with zeros above the
// diagonal; isr[c0 + c] = the column scales rsqrt(max(pivot, 1e-30)); its
// rows also to scratch + kSub (stride kRowLd) for invert_diag. Lane r holds
// row r; each column goes to the other lanes through shared memory (one
// store, then vector loads every lane reads alike). Where fail is given, a
// pivot that is not > 0 (a NaN included: where cholesky_ex reports
// info > 0) sets *fail to 1; the clamp runs all the same.
__device__ __forceinline__ void factor_diag(float* A, int ld, int c0, float* isr,
                                            float* scratch, int* fail = nullptr) {
  const int lane = threadIdx.x & 31;
  float* row = A + (c0 + lane) * ld + c0;
  float* col = scratch;
  float d[kSub];
#pragma unroll
  for (int m = 0; m < kSub; ++m) d[m] = row[m];
#pragma unroll
  for (int c = 0; c < kSub; ++c) {
    const float p = __shfl_sync(kFull, d[c], c);
    if (fail != nullptr && lane == c && !(p > 0.f)) *fail = 1;
    const float s = 1.f / sqrtf(clamp_pivot(p));
    const float l = d[c] * s;  // L[lane][c] for lane >= c
    d[c] = l;
    if (lane == c) isr[c0 + c] = s;
    if (c + 1 < kSub) {
      col[lane] = l;
      __syncwarp();
#pragma unroll
      for (int q = 0; q < kSub / 4; ++q) {
        if (4 * q + 3 > c) {
          const float4 v = reinterpret_cast<const float4*>(col)[q];
          const float lm[4] = {v.x, v.y, v.z, v.w};  // L[4q + t][c]
          // Lanes r < m update d[m] too: above the diagonal, never read.
#pragma unroll
          for (int t = 0; t < 4; ++t)
            if (4 * q + t > c) d[4 * q + t] = fmaf(-l, lm[t], d[4 * q + t]);
        }
      }
      __syncwarp();
    }
  }
  float* rows = scratch + kSub + lane * kRowLd;
#pragma unroll
  for (int m = 0; m < kSub; ++m) {
    const float v = m <= lane ? d[m] : 0.f;
    row[m] = v;
    rows[m] = v;
  }
}

// One warp: X[c0:c0+32, c0:c0+32] = the inverse of the diagonal block that
// factor_diag left in scratch, by forward substitution (lane c holds column
// c; each row's sum times the reciprocal of its diagonal entry), zeros
// above. Row i is read with vector loads every lane reads alike.
__device__ __forceinline__ void invert_diag(const float* scratch, int c0, float* X, int ldx) {
  const int lane = threadIdx.x & 31;
  float x[kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const float4* li = reinterpret_cast<const float4*>(scratch + kSub + i * kRowLd);
    float lv[kSub];
#pragma unroll
    for (int q = 0; q <= i / 4; ++q) {
      const float4 v = li[q];
      lv[4 * q] = v.x;
      lv[4 * q + 1] = v.y;
      lv[4 * q + 2] = v.z;
      lv[4 * q + 3] = v.w;
    }
    const float rcp = 1.f / lv[i];
    float s = i == lane ? 1.f : 0.f;
    // x[m] = 0 for m < lane: those terms add nothing to a finite row, and a
    // row with a non-finite entry has a non-finite diagonal entry too.
#pragma unroll
    for (int m = 0; m < i; ++m) s = fmaf(-lv[m], x[m], s);
    x[i] = i >= lane ? s * rcp : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kSub; ++i) X[(c0 + i) * ldx + c0 + lane] = x[i];
}

// Warp `warp` of `nwarps`: the strip rows [r_begin, r_end) of sub-panel
// c0 become L's, x_c = (d_c - sum_{m<c} x_m L[c0+c][c0+m]) * isr_c, kRows
// rows at a time (lane c holds column c; the rows' chains interleave).
constexpr int kRows = 4;
__device__ __forceinline__ void solve_strip(float* A, int ld, int c0, int r_begin, int r_end,
                                            const float* isr, int warp, int nwarps) {
  const int lane = threadIdx.x & 31;
  float lrow[kSub];  // L[c0 + lane][c0 + m], read for m < lane
#pragma unroll
  for (int m = 0; m < kSub; ++m) lrow[m] = A[(c0 + lane) * ld + c0 + m];
  const float s = isr[c0 + lane];
  for (int r = r_begin + kRows * warp; r < r_end; r += kRows * nwarps) {
    float d[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) d[j] = r + j < r_end ? A[(r + j) * ld + c0 + lane] : 0.f;
#pragma unroll
    for (int c = 0; c < kSub; ++c) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float x = __shfl_sync(kFull, d[j] * s, c);
        if (lane > c) d[j] = fmaf(-x, lrow[c], d[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      if (r + j < r_end) A[(r + j) * ld + c0 + lane] = d[j] * s;
  }
}

// The block: A[r][c] -= sum_{m<32} L[r][c0+m] L[c][c0+m] (the sum taken
// first, in column order), for c0 + 32 <= c <= r < n, in 4 x 4 register
// tiles.
__device__ __forceinline__ void trailing_update(float* A, int ld, int c0, int n) {
  const int c1 = c0 + kSub, q = (n - c1) / 4;
  for (int t = threadIdx.x; t < q * q; t += blockDim.x) {
    const int bi = t / q, bj = t % q;
    if (bj > bi) continue;
    const int r = c1 + 4 * bi, c = c1 + 4 * bj;
    float acc[4][4] = {};
#pragma unroll 4
    for (int m = c0; m < c1; ++m) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = A[(r + i) * ld + m];
        b[i] = A[(c + i) * ld + m];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (r + i >= c + j) A[(r + i) * ld + c + j] -= acc[i][j];
  }
}

// One product of the merge tree: C (m x m) = sign * P Q over the nonzero
// range of the triangular operand, entry by entry: Q lower (sum over
// l >= column) when q_lower, else P lower (sum over l <= row).
struct Product {
  const float* p;
  int ldp;
  const float* q;
  int ldq;
  float* c;
  int ldc;
  int m;
  bool q_lower;
  float sign;
};

// The block: one or two products of the same level (njobs), in 4 x 4 tiles.
__device__ __forceinline__ void products(const Product j0, const Product j1, int njobs) {
  const int tiles0 = (j0.m / 4) * (j0.m / 4);
  const int total = tiles0 + (njobs > 1 ? (j1.m / 4) * (j1.m / 4) : 0);
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const Product w = t < tiles0 ? j0 : j1;
    const int u = t < tiles0 ? t : t - tiles0;
    const int q4 = w.m / 4, r = 4 * (u / q4), c = 4 * (u % q4);
    const int lo = w.q_lower ? c : 0, hi = w.q_lower ? w.m : r + 4;
    // The tile's first (q lower) or last (p lower) three indices take only
    // the terms over the triangular operand's nonzero range: a non-finite
    // entry of the other operand meets no structural zero. The others run
    // unmasked, four indices at a time.
    const int edge_lo = w.q_lower ? c : r + 1, edge_hi = edge_lo + 3;
    float acc[4][4] = {};
    auto step = [&](int l, bool edge) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = w.p[(r + i) * w.ldp + l];
        b[i] = w.q[l * w.ldq + c + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (!edge || (w.q_lower ? l >= c + k : l <= r + i))
            acc[i][k] = fmaf(a[i], b[k], acc[i][k]);
    };
    if (w.q_lower) {
      for (int l = lo; l < edge_hi; ++l) step(l, true);
#pragma unroll 4
      for (int l = edge_hi; l < hi; ++l) step(l, false);
    } else {
#pragma unroll 4
      for (int l = lo; l < edge_lo; ++l) step(l, false);
      for (int l = edge_lo; l < hi; ++l) step(l, true);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) w.c[(r + i) * w.ldc + c + k] = w.sign * acc[i][k];
  }
}

// One level of the merge tree: for each pair of inverted diagonal ranges
// [lo, mid), [mid, mid + w) with mid = lo + w (lo = 0, and lo = 2 w where
// n = 4 w), X[mid:mid+w, lo:mid] = -X22 (L21 X11), through T.
__device__ __forceinline__ void merge_level(const float* A, int ld, float* X, int ldx, float* T,
                                            int w, int n) {
  Product first[2], second[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int lo = 2 * w * j, mid = lo + w;
    float* t = T + j * w * (w + 1);
    first[j] = {A + mid * ld + lo, ld, X + lo * ldx + lo, ldx, t, w + 1, w, true, 1.f};
    second[j] = {X + mid * ldx + mid, ldx, t, w + 1, X + mid * ldx + lo, ldx, w, false, -1.f};
  }
  const int njobs = n / (2 * w);
  products(first[0], first[1], njobs);
  __syncthreads();
  products(second[0], second[1], njobs);
  __syncthreads();
}

// The block, first half: on entry A (n x n, row stride ld; n = 32, 64 or
// 128) holds an SPD matrix in its lower triangle; on return it holds L in
// its lower triangle with zeros above the diagonal inside the diagonal
// blocks (the rest of the upper triangle is left as it was), and X (row
// stride ldx) holds the inverses of L's diagonal blocks, zeros elsewhere
// above the block diagonal. isr holds n floats, scratch kScratch (on 16
// bytes). Needs at least two warps;
// ld, ldx odd keep a warp's column reads free of bank conflicts. fail, where
// given, is factor_diag's. With X null no diagonal block is inverted (L
// alone: invert must not follow) and every warp takes strip rows.
__device__ __forceinline__ void factor(float* A, int ld, float* X, int ldx, float* isr,
                                       float* scratch, int n, int* fail = nullptr) {
  const int warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  const bool inverse = X != nullptr;
  for (int e = threadIdx.x; inverse && e < n * n; e += blockDim.x) {
    const int r = e / n, c = e % n;
    if (c / kSub > r / kSub) X[r * ldx + c] = 0.f;
  }
  for (int c0 = 0; c0 < n; c0 += kSub) {
    if (warp == 0) factor_diag(A, ld, c0, isr, scratch, fail);
    __syncthreads();
    STAGE_STAMP(9);
    if (inverse && warp == nwarps - 1) {
      invert_diag(scratch, c0, X, ldx);
    } else if (c0 + kSub < n) {
      solve_strip(A, ld, c0, c0 + kSub, n, isr, warp, inverse ? nwarps - 1 : nwarps);
    }
    __syncthreads();
    STAGE_STAMP(10);
    if (c0 + kSub < n) {
      trailing_update(A, ld, c0, n);
      __syncthreads();
      STAGE_STAMP(11);
    }
  }
}

// The block, second half: X = L^-1 from its diagonal blocks by the merge
// tree, level by level over neighbouring inverted ranges of width w. T
// holds (n / 2) * (n / 2 + 1) floats.
__device__ __forceinline__ void invert(const float* A, int ld, float* X, int ldx, float* T,
                                       int n) {
  for (int w = kSub; w < n; w *= 2) merge_level(A, ld, X, ldx, T, w, n);
}

}  // namespace chol_warp
