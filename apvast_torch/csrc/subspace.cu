// K9: fused subspace iteration of the 'invert' GEVD solver.
//
// Replaces apvast_tpu/ops/pallas/subspace.py::subspace_iterate_pallas (the
// kernel body _kernel, subspace.py:96-127). Per pencil b of the batch:
//   iters x [ y = Li (A (Li^T q));  q = CholeskyQR2(y) ],
//   small = sym(q^T Li A Li^T q),
// where each CholeskyQR2 pass is the TPU kernel's own: Gram G = y^T y,
// G += (jitter_rel * trace(G) / k + 1e-30) I, the clamped column Cholesky
// (pivot rsqrt(max(p, 1e-30))), the lower-triangular inverse by exact
// Neumann doubling (floor(log2(k - 1)) doublings, zero-diagonal guard) with
// two Newton refinements, then y <- y L^-T. Every product is an fp32 FMA
// in this file: no library call, no tensor cores.
//
// Bound on the H100: operations. Per pencil (iters + 1) applications of
// Li A Li^T to an (n x k) block, 4 n^2 k flops with Li triangular (this file
// multiplies Li as dense: 6 n^2 k), plus (4 iters + 1) n k^2 for the
// symmetric Grams and the triangular L^-T products: 1.04 GFLOP at
// (2, 800, 64), iters 2 (15.6 us at 67 TFLOP/s), against 11.1 MB of
// operands (3.3 us at 3.35 TB/s).
// Design: one persistent cooperative launch (grid = the resident blocks,
// capped at the number of row tiles) with grid-wide barriers between the
// dependent stages, so no stage boundary returns to the host:
//  - a skinny product is tiled by 16 output rows, both pencils in one grid;
//    a block of 1024 threads stages 32-wide chunks of the matrix rows (or
//    columns, for Li^T) and of the (32 x k) operand in shared memory and
//    keeps its <= 2 outputs per thread in registers;
//  - a Gram matrix (y^T y, and q^T (Li A Li^T q) at the end) is reduced in
//    two passes: each tile writes its (k x k) partial to the workspace, and
//    after the barrier block b sums pencil b's partials in tile order, so
//    the result is the same on every run;
//  - the k x k Cholesky and Neumann inverse run in one block per pencil
//    (the other blocks wait at the next barrier), in shared memory with a
//    padded row stride; they are latency-bound, hence the 1024 threads; the Neumann and Newton products multiply lower-
//    triangular matrices, so their sums run over the nonzero range only
//    (the same sums as the full products for finite values);
//  - L^-T goes to the workspace and every tile applies it to its rows.
// Workspace (allocated by the wrapper): three (bz, n, k) operands, the
// (bz, tiles, k, k) Gram partials and the (bz, k, k) L^-T.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;  // 32 warps: the small factorizations are latency-bound
constexpr int kTileRows = 16;
constexpr int kChunk = 32;
constexpr int kChunkLd = kChunk + 1;
constexpr int kMaxK = 112;  // four k x (k + 1) matrices in 227 KB of shared memory
constexpr int kMaxOut = (kTileRows * kMaxK + kThreads - 1) / kThreads;

struct Args {
  const float* a;
  const float* li;
  const float* q0;
  float* q;
  float* small;
  float* t1;
  float* t2;
  float* y;
  float* part;
  float* wt;
  int bz, n, k, iters, tiles;
  float jitter_rel;
};

// max(x, 1e-30) that propagates a NaN, as jnp.maximum does.
__device__ __forceinline__ float clamp_pivot(float x) { return x < 1e-30f ? 1e-30f : x; }

// acc[i] = sum_l A(r, l) B[l, c] for the thread's outputs o = tid + i * kThreads
// (r = o / k, c = o % k) of the rows [r0, r0 + rows) of one pencil: A(r, l)
// = A[r * lda + l], or A[l * lda + r] when trans; B row-major (inner x k).
__device__ void tile_product(const float* A, int lda, bool trans, const float* B, int inner,
                             int k, int r0, int rows, float* sA, float* sB,
                             float (&acc)[kMaxOut]) {
  const int tid = threadIdx.x;
  const int nout = kTileRows * k;
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) acc[i] = 0.f;
  for (int l0 = 0; l0 < inner; l0 += kChunk) {
    const int lc = min(kChunk, inner - l0);
    for (int e = tid; e < kTileRows * kChunk; e += kThreads) {
      int r, l;
      if (trans) {
        l = e / kTileRows;
        r = e % kTileRows;
      } else {
        r = e / kChunk;
        l = e % kChunk;
      }
      float v = 0.f;
      if (r < rows && l < lc)
        v = trans ? A[(size_t)(l0 + l) * lda + r0 + r] : A[(size_t)(r0 + r) * lda + l0 + l];
      sA[r * kChunkLd + l] = v;
    }
    for (int e = tid; e < lc * k; e += kThreads) sB[e] = B[(size_t)l0 * k + e];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxOut; ++i) {
      const int o = tid + i * kThreads;
      if (o < nout) {
        const int r = o / k, c = o % k;
        float s = acc[i];
        for (int l = 0; l < lc; ++l) s = fmaf(sA[r * kChunkLd + l], sB[l * k + c], s);
        acc[i] = s;
      }
    }
    __syncthreads();
  }
}

enum Gram { kNoGram, kGramSelf, kGramWithQ };

// out = A-operand times B over every row tile of every pencil (blocks loop
// over the tiles). With a Gram mode, the tile's (k x k) partial of out^T out
// (kGramSelf) or qg^T out (kGramWithQ, qg's rows of the tile) goes to the
// partials; copy_q also copies qg's rows to q (the iters = 0 output).
__device__ void product_stage(const Args& p, const float* A, size_t a_stride, int lda,
                              int inner, bool trans, const float* B, size_t b_stride,
                              float* out, Gram gram, const float* qg, bool copy_q,
                              float* smem) {
  const int n = p.n, k = p.k, tid = threadIdx.x;
  const size_t nk = (size_t)n * k, kk = (size_t)k * k;
  float* sA = smem;
  float* sB = sA + kTileRows * kChunkLd;
  float* sY = sB + kChunk * k;
  float* sQ = sY + kTileRows * k;
  float acc[kMaxOut];
  for (int tau = blockIdx.x; tau < p.bz * p.tiles; tau += gridDim.x) {
    const int b = tau / p.tiles, t = tau % p.tiles;
    const int r0 = t * kTileRows, rows = min(kTileRows, n - r0);
    tile_product(A + b * a_stride, lda, trans, B + b * b_stride, inner, k, r0, rows, sA, sB,
                 acc);
#pragma unroll
    for (int i = 0; i < kMaxOut; ++i) {
      const int o = tid + i * kThreads;
      if (o < kTileRows * k) {
        const int r = o / k, c = o % k;
        if (r < rows) out[b * nk + (size_t)(r0 + r) * k + c] = acc[i];
        sY[o] = r < rows ? acc[i] : 0.f;
      }
    }
    if (gram == kNoGram) continue;
    const float* sU = sY;
    if (gram == kGramWithQ) {
      for (int e = tid; e < kTileRows * k; e += kThreads) {
        const int r = e / k;
        const float v = r < rows ? qg[b * nk + (size_t)r0 * k + e] : 0.f;
        sQ[e] = v;
        if (copy_q && r < rows) p.q[b * nk + (size_t)r0 * k + e] = v;
      }
      sU = sQ;
    }
    __syncthreads();
    float* dst = p.part + ((size_t)b * p.tiles + t) * kk;
    for (int e = tid; e < k * k; e += kThreads) {
      const int i = e / k, j = e % k;
      float s = 0.f;
      for (int r = 0; r < rows; ++r) s = fmaf(sU[r * k + i], sY[r * k + j], s);
      dst[e] = s;
    }
    __syncthreads();
  }
}

// G = sum over pencil b's tiles, in tile order, of the Gram partials. A
// thread carries kReduceWidth entries at once, so their loads overlap.
constexpr int kReduceWidth = 8;
__device__ void reduce_parts(const Args& p, int b, float* G, int ld) {
  const int k = p.k, kk = k * k;
  const float* src = p.part + (size_t)b * p.tiles * kk;
  for (int e0 = threadIdx.x; e0 < kk; e0 += kThreads * kReduceWidth) {
    float s[kReduceWidth];
#pragma unroll
    for (int m = 0; m < kReduceWidth; ++m) s[m] = 0.f;
#pragma unroll 5
    for (int t = 0; t < p.tiles; ++t) {
#pragma unroll
      for (int m = 0; m < kReduceWidth; ++m) {
        const int e = e0 + m * kThreads;
        if (e < kk) s[m] += src[(size_t)t * kk + e];
      }
    }
#pragma unroll
    for (int m = 0; m < kReduceWidth; ++m) {
      const int e = e0 + m * kThreads;
      if (e < kk) G[(e / k) * ld + e % k] = s[m];
    }
  }
  __syncthreads();
}

// C = A B for lower-triangular A, B (k x k, row stride ld); with sub_from_eye,
// C = I - A B. Each sum runs over the nonzero range l = j..i.
__device__ void tri_mm(const float* A, const float* B, float* C, int k, int ld,
                       bool sub_from_eye) {
  for (int e = threadIdx.x; e < k * k; e += kThreads) {
    const int i = e / k, j = e % k;
    float s = 0.f;
    for (int l = j; l <= i; ++l) s = fmaf(A[i * ld + l], B[l * ld + j], s);
    C[i * ld + j] = sub_from_eye ? (i == j ? 1.f : 0.f) - s : s;
  }
  __syncthreads();
}

// One CholeskyQR pass's small factorization for pencil b: the jittered Gram
// of the partials, its clamped Cholesky factor L and L^-1 by Neumann
// doubling and two Newton steps; writes wt[b] = L^-T.
__device__ void cholqr_factor(const Args& p, int b, float* smem) {
  const int k = p.k, ld = k + 1, tid = threadIdx.x;
  float* L = smem;  // the Gram matrix, factored in place
  float* X = L + k * ld;
  float* P = X + k * ld;
  float* T = P + k * ld;
  float* dinv = T + k * ld;
  float* scalar = dinv + k;
  reduce_parts(p, b, L, ld);
  if (tid == 0) {
    float tr = 0.f;
    for (int i = 0; i < k; ++i) tr += L[i * ld + i];
    scalar[0] = p.jitter_rel * tr / k + 1e-30f;
  }
  __syncthreads();
  for (int i = tid; i < k; i += kThreads) L[i * ld + i] += scalar[0];
  __syncthreads();

  // Clamped column Cholesky, in place on the lower triangle. Step c reads
  // column c and updates the trailing lower triangle (columns > c); the
  // scaling of column c waits for step c + 1, which does not read it.
  float isr_prev = 0.f;
  for (int c = 0; c <= k; ++c) {
    if (c > 0)
      for (int i = c - 1 + tid; i < k; i += kThreads) L[i * ld + c - 1] *= isr_prev;
    if (c < k) {
      const float isr = 1.f / sqrtf(clamp_pivot(L[c * ld + c]));
      const int m = k - c - 1;  // the trailing square, rows and columns > c
      for (int e = tid; e < m * m; e += kThreads) {
        const int i = c + 1 + e / m, j = c + 1 + e % m;
        if (i >= j) L[i * ld + j] -= (L[i * ld + c] * isr) * (L[j * ld + c] * isr);
      }
      isr_prev = isr;
    }
    __syncthreads();
  }

  // Neumann doubling: L = D (I - M), M strictly lower, (I - M)^-1 =
  // prod_j (I + M^(2^j)); P = M = I - D^-1 L, X = I + M.
  for (int i = tid; i < k; i += kThreads) {
    const float dv = L[i * ld + i];
    dinv[i] = 1.f / (dv == 0.f ? 1.f : dv);
  }
  __syncthreads();
  for (int e = tid; e < k * k; e += kThreads) {
    const int i = e / k, j = e % k;
    if (j > i) L[i * ld + j] = 0.f;
    const float m = j > i ? 0.f : (i == j ? 1.f : 0.f) - dinv[i] * L[i * ld + j];
    P[i * ld + j] = m;
    X[i * ld + j] = (i == j ? 1.f : 0.f) + m;
  }
  __syncthreads();
  int steps = 0;
  for (int v = k - 1; v > 1; v >>= 1) ++steps;  // bit_length(k - 1) - 1
  for (int s = 0; s < steps; ++s) {
    tri_mm(P, P, T, k, ld, false);
    float* tmp = P;
    P = T;
    T = tmp;
    tri_mm(X, P, T, k, ld, false);
    for (int e = tid; e < k * k; e += kThreads) X[(e / k) * ld + e % k] += T[(e / k) * ld + e % k];
    __syncthreads();
  }
  for (int e = tid; e < k * k; e += kThreads) X[(e / k) * ld + e % k] *= dinv[e % k];
  __syncthreads();
  for (int it = 0; it < 2; ++it) {
    tri_mm(L, X, T, k, ld, true);  // T = I - L X
    tri_mm(X, T, P, k, ld, false);
    for (int e = tid; e < k * k; e += kThreads) X[(e / k) * ld + e % k] += P[(e / k) * ld + e % k];
    __syncthreads();
  }
  float* wt = p.wt + (size_t)b * k * k;
  for (int e = tid; e < k * k; e += kThreads) wt[e] = X[(e % k) * ld + e / k];
}

__global__ void __launch_bounds__(kThreads) subspace_kernel(Args p) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int n = p.n, k = p.k;
  const size_t nn = (size_t)n * n, nk = (size_t)n * k, kk = (size_t)k * k;
  const float* qin = p.q0;
  for (int it = 0; it < p.iters; ++it) {
    product_stage(p, p.li, nn, n, n, true, qin, nk, p.t1, kNoGram, nullptr, false, smem);
    grid.sync();
    product_stage(p, p.a, nn, n, n, false, p.t1, nk, p.t2, kNoGram, nullptr, false, smem);
    grid.sync();
    product_stage(p, p.li, nn, n, n, false, p.t2, nk, p.y, kGramSelf, nullptr, false, smem);
    grid.sync();
    for (int pass = 0; pass < 2; ++pass) {
      for (int b = blockIdx.x; b < p.bz; b += gridDim.x) cholqr_factor(p, b, smem);
      grid.sync();
      // y <- y L^-T in place (a tile reads only its own rows), q on the last pass.
      product_stage(p, p.y, nk, k, k, false, p.wt, kk, pass == 0 ? p.y : p.q,
                    pass == 0 ? kGramSelf : kNoGram, nullptr, false, smem);
      grid.sync();
    }
    qin = p.q;
  }
  product_stage(p, p.li, nn, n, n, true, qin, nk, p.t1, kNoGram, nullptr, false, smem);
  grid.sync();
  product_stage(p, p.a, nn, n, n, false, p.t1, nk, p.t2, kNoGram, nullptr, false, smem);
  grid.sync();
  product_stage(p, p.li, nn, n, n, false, p.t2, nk, p.y, kGramWithQ, qin, p.iters == 0, smem);
  grid.sync();
  for (int b = blockIdx.x; b < p.bz; b += gridDim.x) {
    const int ld = k + 1;
    reduce_parts(p, b, smem, ld);
    float* out = p.small + (size_t)b * kk;
    for (int e = threadIdx.x; e < k * k; e += kThreads) {
      const int i = e / k, j = e % k;
      out[e] = 0.5f * (smem[i * ld + j] + smem[j * ld + i]);
    }
    __syncthreads();
  }
}

size_t smem_bytes(int k) {
  const size_t product = kTileRows * kChunkLd + kChunk * k + 2 * kTileRows * k;
  const size_t small = 4 * (size_t)k * (k + 1) + k + 1;
  return (product > small ? product : small) * sizeof(float);
}

}  // namespace

// a, li (bz, n, n), q0 (bz, n, k) -> q (bz, n, k), small (bz, k, k); float32,
// contiguous; k a multiple of 8, <= 112. ws holds ws_floats >= 3 bz n k +
// bz ceil(n / 16) k^2 + bz k^2 floats.
extern "C" int subspace_iterate_launch(const float* a, const float* li, const float* q0,
                                       float* q, float* small, float* ws, int ws_floats,
                                       int bz, int n, int k, int iters, float jitter_rel,
                                       cudaStream_t stream) {
  if (bz < 1 || n < 1 || k < 8 || k > kMaxK || k % 8 || iters < 0)
    return (int)cudaErrorInvalidValue;
  const int tiles = (n + kTileRows - 1) / kTileRows;
  const size_t nk = (size_t)bz * n * k, kk = (size_t)k * k;
  if ((size_t)ws_floats < 3 * nk + (size_t)bz * tiles * kk + bz * kk)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(k);
  cudaError_t e = cudaFuncSetAttribute(subspace_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, subspace_kernel,
                                                         kThreads, smem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  int grid = per_sm * sms;
  if (grid > bz * tiles) grid = bz * tiles;
  Args args{a, li, q0, q, small, ws, ws + nk, ws + 2 * nk, ws + 3 * nk,
            ws + 3 * nk + (size_t)bz * tiles * kk, bz, n, k, iters, tiles, jitter_rel};
  void* kargs[] = {&args};
  e = cudaLaunchCooperativeKernel((void*)subspace_kernel, grid, kThreads, kargs, smem,
                                  stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
