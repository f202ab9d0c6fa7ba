// K10b: fused Cholesky factorization and triangular inverse, X = L^-1 with
// L L^T = B, of a batch of SPD matrices (n <= 1024 after padding).
//
// Replaces apvast_tpu/ops/pallas/whiten.py::chol_tri_inverse_pallas (body
// _kernel, whiten.py:309-385). Contract: X lower-triangular with exact zeros
// above the diagonal; B's lower triangle is read; B is padded to a multiple
// of 128 with an identity block (chol(blkdiag(B, I)) = blkdiag(chol(B), I)),
// done here while the input is copied into the workspace. The pivot rule is
// the TPU kernel's, rsqrt(max(pivot, 1e-30)) (whiten.py:87-104): a pivot
// <= 0 scales its column by 1e15 and the factor overflows, so a non-PD
// matrix gives non-finite output, as in JAX. Built without fast math and
// with denormals kept, so 1e-30 stays a normal float; the clamp lets a NaN
// pivot through.
//
// Algorithm (ops/kernels/whiten.py::chol_tri_inverse_plain repeats it in
// torch), right-looking over 128-wide panels p:
//  F  factor the diagonal block: four 32-wide sub-panels, each factored by
//     one warp in registers (lane r holds row r; the pivot column is
//     broadcast by shuffles, no block barrier per column), inverted by the
//     TPU kernel's exact Neumann doubling with two Newton steps
//     (_neumann_inv_sub), the rows below it in the panel solved by that
//     inverse with one refinement step, then the in-panel trailing update;
//     the panel inverse by the merge tree X21 = -X22 (L21 X11) (_merge_tri);
//  S  the panel solve L21 = A21 Lp^-T with one refinement step,
//     L21 += (A21 - L21 Lp^T) Lp^-T, in 16-row tiles; and, beside it, block
//     row p of the inverse, X_pj = -Lp^-1 S, S = sum_k L_pk X_kj, refined
//     once, x += Lp^-1 (-S - Lp x) (whiten.py:374-385), in 16-column tiles
//     (X's rows < p are final, so the inverse needs no phase of its own);
//  U  the trailing update A22 -= L21 L21^T, block-lower triangle only, in
//     64 x 64 tiles.
// Every product is a full fp32 FMA sum, no tensor cores, so a non-finite
// entry spreads as it does through the plain version's matmuls.
//
// Bound on the H100: operations. The factor and the inverse, each counted as
// triangular, are 2 x 2 n^3 / 3 flops a matrix: 0.68 GFLOP at (2, 800, 800),
// 0.010 ms at 67 TFLOP/s, against 10.2 MB read and written (0.003 ms). The
// dependent chain is the latency: 3 grid-wide barriers and one block's
// panel factorization per panel.
// Design: one persistent cooperative launch, grid = the resident blocks
// (one 512-thread block per SM, 168 KB of shared memory), both matrices of
// the batch in one grid. The matrix, its factor (in place), X and the
// panel inverses live in a workspace that the wrapper allocates, 2 npad^2 +
// 128 npad floats a matrix (6.9 MB at npad = 896), resident in the 50 MB L2.
// Phase F runs in one block per matrix (the others wait at the barrier);
// S and U spread their tiles over the grid, each block a contiguous range
// of tiles, so it loads a panel's Lp and Lp^-1 into shared memory once.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kP = 128;           // panel width
constexpr int kSub = 32;          // sub-panel width: one warp
constexpr int kLd = kP + 1;       // shared row stride of a panel
constexpr int kSubLd = kSub + 1;  // shared row stride of a sub-panel or a chunk
constexpr int kThreads = 512;
constexpr int kSolveRows = 16;    // rows of a panel-solve tile
constexpr int kInvCols = 16;      // columns of an inverse tile
constexpr int kInvLd = kInvCols + 1;
constexpr int kTile = 64;         // trailing-update tile
constexpr int kMergeLd = 64 + 1;
constexpr int kMaxPad = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPanelFloats = kP * kLd;
// Scratch: the largest of phase F's sub-panel solve (2 x 96 x 33), phase S's
// solve tile (3 x 16 x 129) and inverse tile (128 x 33 + 32 x 16 + 2 x
// 128 x 17), phase U's two 64 x 33 chunks.
constexpr int kScratchFloats = kP * kSubLd + kSub * kInvCols + 2 * kP * kInvLd;
constexpr size_t kSmem = (2 * kPanelFloats + kScratchFloats) * sizeof(float);

struct Args {
  const float* in;
  float* out;
  float* ws;
  int bz, n, npad;
};

__device__ __forceinline__ float* mat(const Args& a, int b) {
  return a.ws + (size_t)b * (2 * (size_t)a.npad * a.npad + (size_t)kP * a.npad);
}
__device__ __forceinline__ float* inv_of(const Args& a, int b) {
  return mat(a, b) + (size_t)a.npad * a.npad;
}
__device__ __forceinline__ float* panel_inv(const Args& a, int b, int p) {
  return inv_of(a, b) + (size_t)a.npad * a.npad + (size_t)p * kP * kP;
}

// max(x, 1e-30) that propagates a NaN (torch.clamp_min does).
__device__ __forceinline__ float clamp_pivot(float x) { return x < 1e-30f ? 1e-30f : x; }

// Cholesky of the 32 x 32 block g (row stride kLd, lower triangle read), in
// place with exact zeros above the diagonal, by warp 0: lane r holds row r;
// step c scales column c by 1 / sqrt(max(pivot, 1e-30)) and subtracts its
// outer product. A lane above the pivot row updates entries it zeroes later.
__device__ void chol_sub_warp(float* g) {
  const int r = threadIdx.x;
  float row[kSub];
#pragma unroll
  for (int k = 0; k < kSub; ++k) row[k] = k <= r ? g[r * kLd + k] : 0.f;
#pragma unroll
  for (int c = 0; c < kSub; ++c) {
    const float isr = 1.f / sqrtf(clamp_pivot(__shfl_sync(kFull, row[c], c)));
    const float lc = row[c] * isr;
#pragma unroll
    for (int k = c + 1; k < kSub; ++k) row[k] -= lc * __shfl_sync(kFull, lc, k);
    row[c] = r >= c ? lc : 0.f;
  }
#pragma unroll
  for (int k = 0; k < kSub; ++k) g[r * kLd + k] = row[k];
}

// Rows t / 32 and t / 32 + 16, column t % 32 of the 32 x 32 product A B
// (row strides lda, ldb), for the block's 512 threads.
__device__ __forceinline__ void prod32(const float* A, int lda, const float* B, int ldb,
                                       float c[2]) {
  const int j = threadIdx.x % kSub, i = threadIdx.x / kSub;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
  for (int k = 0; k < kSub; ++k) {
    const float bk = B[k * ldb + j];
    s0 += A[i * lda + k] * bk;
    s1 += A[(i + 16) * lda + k] * bk;
  }
  c[0] = s0;
  c[1] = s1;
}

// The inverse x (row stride kLd) of the 32 x 32 lower factor l (row stride
// kLd) by exact Neumann doubling, ops/trisolve.neumann_tri_inverse with two
// Newton steps: L = D (I - M), (I - M)^-1 = prod_j (I + M^(2^j)), four
// doublings at width 32. Scratch: m and t (32 x kSubLd), dinv (32).
__device__ void neumann_sub(const float* l, float* x, float* m, float* t, float* dinv) {
  const int tid = threadIdx.x;
  const int j = tid % kSub, i = tid / kSub, i2 = i + 16;
  if (tid < kSub) {
    const float d = l[tid * kLd + tid];
    dinv[tid] = 1.f / (d == 0.f ? 1.f : d);  // the zero-diagonal guard
  }
  __syncthreads();
  for (int e = tid; e < kSub * kSub; e += kThreads) {
    const int r = e / kSub, c = e % kSub;
    const float mrc = (r == c ? 1.f : 0.f) - dinv[r] * l[r * kLd + c];
    m[r * kSubLd + c] = mrc;  // p = m
    x[r * kLd + c] = (r == c ? 1.f : 0.f) + mrc;
  }
  __syncthreads();
  float c2[2];
  for (int it = 0; it < 4; ++it) {
    prod32(m, kSubLd, m, kSubLd, c2);  // p <- p p
    __syncthreads();
    m[i * kSubLd + j] = c2[0];
    m[i2 * kSubLd + j] = c2[1];
    __syncthreads();
    prod32(x, kLd, m, kSubLd, c2);  // x <- x + x p
    __syncthreads();
    x[i * kLd + j] += c2[0];
    x[i2 * kLd + j] += c2[1];
    __syncthreads();
  }
  x[i * kLd + j] *= dinv[j];
  x[i2 * kLd + j] *= dinv[j];
  __syncthreads();
  for (int it = 0; it < 2; ++it) {  // x <- x + x (I - l x)
    prod32(l, kLd, x, kLd, c2);
    t[i * kSubLd + j] = (i == j ? 1.f : 0.f) - c2[0];
    t[i2 * kSubLd + j] = (i2 == j ? 1.f : 0.f) - c2[1];
    __syncthreads();
    prod32(x, kLd, t, kSubLd, c2);
    __syncthreads();
    x[i * kLd + j] += c2[0];
    x[i2 * kLd + j] += c2[1];
    __syncthreads();
  }
}

// X21 = -X22 (L21 X11) for the s x s blocks at (off, off) of the panel's
// factor D and its inverse I; U is s x kMergeLd scratch.
__device__ void merge(const float* D, float* I, float* U, int off, int s) {
  for (int e = threadIdx.x; e < s * s; e += kThreads) {
    const int i = e / s, j = e % s;
    float acc = 0.f;
    for (int k = 0; k < s; ++k)
      acc += D[(off + s + i) * kLd + off + k] * I[(off + k) * kLd + off + j];
    U[i * kMergeLd + j] = acc;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < s * s; e += kThreads) {
    const int i = e / s, j = e % s;
    float acc = 0.f;
    for (int k = 0; k < s; ++k) acc += I[(off + s + i) * kLd + off + s + k] * U[k * kMergeLd + j];
    I[(off + s + i) * kLd + off + j] = -acc;
  }
  __syncthreads();
}

// Phase F for matrix b, panel p: Lp into the workspace's diagonal block,
// Lp^-1 into the panel inverses and into X's diagonal block.
__device__ void factor_panel(const Args& a, int b, int p, float* smem) {
  float* D = smem;
  float* I = D + kPanelFloats;
  float* S = I + kPanelFloats;
  const int tid = threadIdx.x, np = a.npad, lo = p * kP;
  float* A = mat(a, b);
  for (int e = tid; e < kP * kP; e += kThreads) {
    const int r = e / kP, c = e % kP;
    D[r * kLd + c] = c <= r ? A[(size_t)(lo + r) * np + lo + c] : 0.f;
    I[r * kLd + c] = 0.f;
  }
  __syncthreads();
  for (int g0 = 0; g0 < kP; g0 += kSub) {
    const int g1 = g0 + kSub, m = kP - g1;
    if (tid < kSub) chol_sub_warp(D + g0 * kLd + g0);
    __syncthreads();
    const float* ls = D + g0 * kLd + g0;
    const float* is = I + g0 * kLd + g0;
    neumann_sub(ls, I + g0 * kLd + g0, S, S + kSub * kSubLd, S + 2 * kSub * kSubLd);
    if (m == 0) break;
    // The rows below in the panel: l21 = a21 Is^T, refined once.
    float* t1 = S;
    float* t2 = S + (kP - kSub) * kSubLd;
    for (int e = tid; e < m * kSub; e += kThreads) {
      const int r = e / kSub, c = e % kSub;
      float acc = 0.f;
      for (int k = 0; k < kSub; ++k) acc += D[(g1 + r) * kLd + g0 + k] * is[c * kLd + k];
      t1[r * kSubLd + c] = acc;
    }
    __syncthreads();
    for (int e = tid; e < m * kSub; e += kThreads) {
      const int r = e / kSub, c = e % kSub;
      float acc = 0.f;
      for (int k = 0; k < kSub; ++k) acc += t1[r * kSubLd + k] * ls[c * kLd + k];
      t2[r * kSubLd + c] = D[(g1 + r) * kLd + g0 + c] - acc;
    }
    __syncthreads();
    for (int e = tid; e < m * kSub; e += kThreads) {
      const int r = e / kSub, c = e % kSub;
      float acc = 0.f;
      for (int k = 0; k < kSub; ++k) acc += t2[r * kSubLd + k] * is[c * kLd + k];
      D[(g1 + r) * kLd + g0 + c] = t1[r * kSubLd + c] + acc;
    }
    __syncthreads();
    // In-panel trailing update, lower triangle only.
    for (int e = tid; e < m * m; e += kThreads) {
      const int r = e / m, c = e % m;
      if (c > r) continue;
      float acc = 0.f;
      for (int k = 0; k < kSub; ++k) acc += D[(g1 + r) * kLd + g0 + k] * D[(g1 + c) * kLd + g0 + k];
      D[(g1 + r) * kLd + g1 + c] -= acc;
    }
    __syncthreads();
  }
  merge(D, I, S, 0, kSub);
  merge(D, I, S, 2 * kSub, kSub);
  merge(D, I, S, 0, 2 * kSub);
  float* P = panel_inv(a, b, p);
  float* X = inv_of(a, b);
  for (int e = tid; e < kP * kP; e += kThreads) {
    const int r = e / kP, c = e % kP;
    const float iv = I[r * kLd + c];
    A[(size_t)(lo + r) * np + lo + c] = D[r * kLd + c];
    P[e] = iv;
    X[(size_t)(lo + r) * np + lo + c] = iv;
  }
}

// Lp and Lp^-1 of matrix b, panel p, into shared memory (phase S).
__device__ void load_panel(const Args& a, int b, int p, float* D, float* I) {
  const float* A = mat(a, b);
  const float* P = panel_inv(a, b, p);
  const int lo = p * kP;
  for (int e = threadIdx.x; e < kP * kP; e += kThreads) {
    const int r = e / kP, c = e % kP;
    D[r * kLd + c] = A[(size_t)(lo + r) * a.npad + lo + c];
    I[r * kLd + c] = P[e];
  }
  __syncthreads();
}

// Phase S, panel solve: rows r0 .. r0 + 15 of L21 = A21 Lp^-T, refined once.
// Thread t: column t % 128 of rows t / 128 + 4 q.
__device__ void solve_tile(const Args& a, int b, int lo, int r0, const float* D,
                           const float* I, float* S) {
  float* sa = S;
  float* sl = sa + kSolveRows * kLd;
  float* sr = sl + kSolveRows * kLd;
  float* A = mat(a, b);
  const int np = a.npad, tid = threadIdx.x, c = tid % kP, rq = tid / kP;
  for (int e = tid; e < kSolveRows * kP; e += kThreads) {
    const int r = e / kP, cc = e % kP;
    sa[r * kLd + cc] = A[(size_t)(r0 + r) * np + lo + cc];
  }
  __syncthreads();
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < kP; ++k) {
    const float w = I[c * kLd + k];
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] += sa[(rq + 4 * q) * kLd + k] * w;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) sl[(rq + 4 * q) * kLd + c] = acc[q];
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] = 0.f;
  for (int k = 0; k < kP; ++k) {
    const float w = D[c * kLd + k];
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] += sl[(rq + 4 * q) * kLd + k] * w;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = rq + 4 * q;
    sr[r * kLd + c] = sa[r * kLd + c] - acc[q];
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] = 0.f;
  for (int k = 0; k < kP; ++k) {
    const float w = I[c * kLd + k];
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] += sr[(rq + 4 * q) * kLd + k] * w;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = rq + 4 * q;
    A[(size_t)(r0 + r) * np + lo + c] = sl[r * kLd + c] + acc[q];
  }
  __syncthreads();
}

// Phase S, inverse: columns c0 .. c0 + 15 (< lo) of block row p of X,
// x = -Lp^-1 S with S = L[p, j0:lo] X[j0:lo, cols] (the blocks above
// strip j0 / 128 are zero), then x += Lp^-1 (-S - Lp x).
// Thread t: column t % 16 of rows t / 16 + 32 q.
__device__ void inverse_tile(const Args& a, int b, int lo, int c0, const float* D,
                             const float* I, float* S) {
  float* lc = S;                     // 128 x kSubLd chunk of L's block row
  float* xc = lc + kP * kSubLd;      // 32 x 16 chunk of X
  float* ss = xc + kSub * kInvCols;  // S, then the residual
  float* sx = ss + kP * kInvLd;      // x
  const float* A = mat(a, b);
  float* X = inv_of(a, b);
  const int np = a.npad, tid = threadIdx.x, c = tid % kInvCols, rq = tid / kInvCols;
  const int j0 = c0 / kP * kP;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = j0; k0 < lo; k0 += kSub) {
    for (int e = tid; e < kP * kSub; e += kThreads) {
      const int r = e / kSub, k = e % kSub;
      lc[r * kSubLd + k] = A[(size_t)(lo + r) * np + k0 + k];
    }
    for (int e = tid; e < kSub * kInvCols; e += kThreads) {
      const int k = e / kInvCols, cc = e % kInvCols;
      xc[e] = X[(size_t)(k0 + k) * np + c0 + cc];
    }
    __syncthreads();
    for (int k = 0; k < kSub; ++k) {
      const float xv = xc[k * kInvCols + c];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] += lc[(rq + 32 * q) * kSubLd + k] * xv;
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) ss[(rq + 32 * q) * kInvLd + c] = acc[q];
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = rq + 32 * q;
    float s = 0.f;
    for (int k = 0; k < kP; ++k) s += I[r * kLd + k] * ss[k * kInvLd + c];
    sx[r * kInvLd + c] = -s;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = rq + 32 * q;
    float s = 0.f;
    for (int k = 0; k < kP; ++k) s += D[r * kLd + k] * sx[k * kInvLd + c];
    ss[r * kInvLd + c] = -ss[r * kInvLd + c] - s;  // each thread its own entries
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = rq + 32 * q;
    float s = 0.f;
    for (int k = 0; k < kP; ++k) s += I[r * kLd + k] * ss[k * kInvLd + c];
    X[(size_t)(lo + r) * np + c0 + c] = sx[r * kInvLd + c] + s;
  }
  __syncthreads();
}

// Phase U: the 64 x 64 tile (r0, c0) of A22 -= L21 L21^T over the panel's
// 128 columns. Thread t: rows t / 16 (+ 32), columns t % 16 + 16 q.
__device__ void update_tile(const Args& a, int b, int lo, int r0, int c0, float* S) {
  float* lr = S;
  float* lcol = lr + kTile * kSubLd;
  float* A = mat(a, b);
  const int np = a.npad, tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[2][4] = {};
  for (int k0 = 0; k0 < kP; k0 += kSub) {
    for (int e = tid; e < kTile * kSub; e += kThreads) {
      const int r = e / kSub, k = e % kSub;
      lr[r * kSubLd + k] = A[(size_t)(r0 + r) * np + lo + k0 + k];
      lcol[r * kSubLd + k] = A[(size_t)(c0 + r) * np + lo + k0 + k];
    }
    __syncthreads();
    for (int k = 0; k < kSub; ++k) {
      const float a0 = lr[ty * kSubLd + k], a1 = lr[(ty + 32) * kSubLd + k];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float w = lcol[(tx + 16 * q) * kSubLd + k];
        acc[0][q] += a0 * w;
        acc[1][q] += a1 * w;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      A[(size_t)(r0 + ty + 32 * h) * np + c0 + tx + 16 * q] -= acc[h][q];
}

// This block's contiguous share [first, last) of n items.
__device__ __forceinline__ void share(int n, int& first, int& last) {
  first = (int)((long long)blockIdx.x * n / gridDim.x);
  last = (int)((long long)(blockIdx.x + 1) * n / gridDim.x);
}

__global__ void __launch_bounds__(kThreads) chol_tri_inverse_kernel(Args a) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  float* D = smem;
  float* I = D + kPanelFloats;
  float* S = I + kPanelFloats;
  const int np = a.npad, n = a.n, panels = np / kP;
  const size_t nn = (size_t)np * np;
  const size_t stride = (size_t)gridDim.x * kThreads;
  // The padded input blkdiag(B, I) into the workspace.
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < a.bz * nn; e += stride) {
    const int b = (int)(e / nn), r = (int)(e % nn / np), c = (int)(e % np);
    mat(a, b)[(size_t)r * np + c] =
        r < n && c < n ? a.in[((size_t)b * n + r) * n + c] : (r == c ? 1.f : 0.f);
  }
  grid.sync();
  for (int p = 0; p < panels; ++p) {
    const int lo = p * kP, hi = lo + kP;
    for (int b = blockIdx.x; b < a.bz; b += gridDim.x) {
      factor_panel(a, b, p, smem);
      __syncthreads();
    }
    grid.sync();
    const int solves = (np - hi) / kSolveRows, per = solves + lo / kInvCols;
    int first, last, loaded = -1;
    share(a.bz * per, first, last);
    for (int it = first; it < last; ++it) {
      const int b = it / per, k = it % per;
      if (b != loaded) {
        load_panel(a, b, p, D, I);
        loaded = b;
      }
      if (k < solves) {
        solve_tile(a, b, lo, hi + k * kSolveRows, D, I, S);
      } else {
        inverse_tile(a, b, lo, (k - solves) * kInvCols, D, I, S);
      }
    }
    grid.sync();
    if (hi == np) break;
    const int t = (np - hi) / kTile, tiles = t * (t + 1) / 2;
    share(a.bz * tiles, first, last);
    for (int it = first; it < last; ++it) {
      const int b = it / tiles, k = it % tiles;
      int ti = (int)((sqrtf(8.f * k + 1.f) - 1.f) / 2.f);
      while ((ti + 1) * (ti + 2) / 2 <= k) ++ti;
      while (ti * (ti + 1) / 2 > k) --ti;
      const int tj = k - ti * (ti + 1) / 2;
      update_tile(a, b, lo, hi + ti * kTile, hi + tj * kTile, S);
      __syncthreads();
    }
    grid.sync();
  }
  // X's n x n corner, exact zeros above the diagonal.
  const size_t out_n = (size_t)n * n;
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < a.bz * out_n; e += stride) {
    const int b = (int)(e / out_n), r = (int)(e % out_n / n), c = (int)(e % n);
    a.out[e] = c <= r ? inv_of(a, b)[(size_t)r * np + c] : 0.f;
  }
}

}  // namespace

// b (bz, n, n) SPD, float32, contiguous -> x (bz, n, n) = L^-1, lower
// triangular; npad = ceil128(n) <= 1024. ws holds bz (2 npad^2 + 128 npad)
// floats.
extern "C" int chol_tri_inverse_launch(const float* b, float* x, float* ws, int bz, int n,
                                       int npad, cudaStream_t stream) {
  if (bz < 1 || n < 1 || npad % kP || npad < n || npad - n >= kP || npad > kMaxPad)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(chol_tri_inverse_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chol_tri_inverse_kernel,
                                                         kThreads, kSmem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // The most tiles any phase has: the first panel's solve and update.
  const int t = (npad - kP) / kTile;
  int most = (npad - kP) / kSolveRows;
  if (t * (t + 1) / 2 > most) most = t * (t + 1) / 2;
  if (most < 1) most = 1;
  int grid = per_sm * sms;
  if ((long long)grid > (long long)bz * most) grid = bz * most;
  Args args{b, x, ws, bz, n, npad};
  void* kargs[] = {&args};
  e = cudaLaunchCooperativeKernel((void*)chol_tri_inverse_kernel, grid, kThreads, kargs, kSmem,
                                  stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
