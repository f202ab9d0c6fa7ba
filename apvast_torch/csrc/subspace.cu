// K9: fused subspace iteration of the 'invert' GEVD solver.
//
// Replaces apvast_tpu/ops/pallas/subspace.py::subspace_iterate_pallas (the
// kernel body _kernel, subspace.py:96-127). Per pencil b of the batch:
//   iters x [ y = Li (A (Li^T q));  q = CholeskyQR2(y) ],
//   small = sym(q^T Li A Li^T q),
// where each CholeskyQR2 pass is the TPU kernel's own: Gram G = y^T y,
// G += (jitter_rel * trace(G) / k + 1e-30) I, the clamped Cholesky factor
// (pivot rsqrt(max(p, 1e-30)), a NaN passed through), then y <- y L^-T.
// Li is read as lower triangular: its entries above the diagonal are not
// read. Every product is an fp32 FMA in this file: no library call, no
// tensor cores.
//
// Bound on the H100: operations. Per pencil (iters + 1) applications of
// Li A Li^T to an (n x k) block, 4 n^2 k flops with Li triangular, plus
// (4 iters + 1) n k^2 for the symmetric Grams and the triangular L^-T
// products: 1.04 GFLOP at (2, 800, 64), iters 2 (15.6 us at 67 TFLOP/s),
// against 11.1 MB of operands (3.3 us at 3.35 TB/s).
//
// Design: one persistent cooperative launch (grid = the resident blocks,
// at most the number of 16-row tiles of both pencils), 512 threads a
// block. The first design spent 0.61 ms of its 1.32 in products
// that loaded two floats from shared memory per multiply-add, 0.53 ms in
// k x k factorizations that one block per pencil ran while the others
// waited, and 0.14 ms in Gram reductions that one block per pencil ran
// (tools/k9_k10a_stages.py). Here:
//  - a skinny product tile (16 rows x k) is a 4 x 4 register tile per
//    thread, the inner depth split over up to 16 warp groups (each takes
//    every groups-th index of a 128-deep chunk) and summed over the groups
//    in a fixed order, so the result repeats bit for bit; chunks are staged
//    through registers into two shared buffers, one barrier a chunk; Li's
//    zero half is skipped (Li^T x sums rows >= r, Li x columns <= r);
//  - the Gram partials of a stage (one k x k per tile) are summed by every
//    block of the grid after the barrier, each entry over the tiles in
//    tile order;
//  - every block that needs L^-T for its tile factors the jittered Gram
//    itself (identity-padded to kp = 32, 64 or 128) with chol_warp.cuh: by
//    warps, 32 columns at a time, and the merge tree for the inverse; no
//    block waits at a barrier for another's factorization;
//  - the second pass's L^-T is folded into the next product:
//    Li^T (y L^-T) = (Li^T y) L^-T, applied to each tile after its product,
//    with q = y L^-T written on the way where it is an output.
// Grid-wide barriers: 6 per iteration and 3 for the projection, 15 at
// iters = 2 (17 in the first design).
// Workspace (allocated by the wrapper): three (bz, n, k) operands, the
// (bz, tiles, k, k) Gram partials and the (bz, k, k) Gram matrices.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "chol_warp.cuh"
#include "cp_async.cuh"

namespace cg = cooperative_groups;

// The dynamic shared memory, declared once so that every function, inlined
// or not, addresses it as shared memory.
extern __shared__ __align__(16) float smem[];

namespace {

constexpr int kThreads = 512;
constexpr int kTileRows = 16;
constexpr int kChunk = 128;            // inner indices staged per step
constexpr int kALd = kTileRows + 4;    // row stride of the staged A operand, 16-byte rows
constexpr int kMaxK = 112;
constexpr int kMaxGroups = 16;
constexpr int kAPer = kChunk * kTileRows / kThreads;
// Stage kinds of the timer stamps: what the stage just ended did.
constexpr int kStampProducts = 1, kStampReduce = 2, kStampFactor = 3, kStampTile = 12,
              kBarrier = 16;

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
  float* gram;
  int bz, n, k, kp, iters, tiles, groups;
  float jitter_rel;
};

// Dynamic shared memory: W (k x k, the current pencil's L^-T), then one
// work area used either by a product tile or by a factorization.
struct Smem {
  float *w, *sa, *sb, *red, *sy, *sq, *so;  // product tile
  float *fscratch, *fl, *fx, *ft, *fisr;    // factorization
};

__host__ __device__ inline size_t product_floats(int k, int groups) {
  return 2 * kChunk * kALd + 2 * kChunk * k + (size_t)groups * kTileRows * k + kTileRows * k;
}

__host__ __device__ inline size_t factor_floats(int kp) {
  return chol_warp::kScratch + 2 * (size_t)kp * (kp + 1) + (kp / 2) * (kp / 2 + 1) + kp;
}

__device__ inline Smem carve(float* base, int k, int kp, int groups) {
  Smem s;
  s.w = base;
  float* work = base + k * k;
  s.sa = work;
  s.sb = s.sa + 2 * kChunk * kALd;
  s.red = s.sb + 2 * kChunk * k;
  s.sy = s.red + groups * kTileRows * k;
  s.sq = s.red;  // the epilogue's operands, in the groups' partials (dead by then)
  s.so = s.red + kTileRows * k;
  s.fscratch = work;  // on 16 bytes
  s.fl = work + chol_warp::kScratch;
  s.fx = s.fl + kp * (kp + 1);
  s.ft = s.fx + kp * (kp + 1);
  s.fisr = s.ft + (kp / 2) * (kp / 2 + 1);
  return s;
}

enum Mode { kRowsDense, kRowsLower, kColsLower };

// The A operand of a tile product: element (r, l) = M[r0 + r][l] (rows;
// kRowsLower reads l <= r0 + r only) or M[l][r0 + r] (kColsLower, Li^T:
// l >= r0 + r only), staged as sa[l][r]; zeros outside the tile.
template <Mode mode>
__device__ __forceinline__ void load_a(const float* M, int n, int r0, int rows,
                                       int l0, int le, float (&ra)[kAPer]) {
#pragma unroll
  for (int i = 0; i < kAPer; ++i) {
    const int e = threadIdx.x + i * kThreads;
    int r, l;
    if (mode == kColsLower) {
      l = l0 + e / kTileRows;
      r = e % kTileRows;
    } else {
      r = e / kChunk;
      l = l0 + e % kChunk;
    }
    bool ok = r < rows && l < le;
    if (mode == kRowsLower) ok = ok && l <= r0 + r;
    if (mode == kColsLower) ok = ok && l >= r0 + r;
    ra[i] = !ok ? 0.f
            : mode == kColsLower ? M[(size_t)l * n + r0 + r] : M[(size_t)(r0 + r) * n + l];
  }
}

template <Mode mode>
__device__ __forceinline__ void store_a(float* sa, const float (&ra)[kAPer]) {
#pragma unroll
  for (int i = 0; i < kAPer; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (mode == kColsLower) {
      sa[(e / kTileRows) * kALd + e % kTileRows] = ra[i];
    } else {
      sa[(e % kChunk) * kALd + e / kChunk] = ra[i];
    }
  }
}

// The B operand: rows [l0, l0 + kChunk) of x (n x k, contiguous) into sb
// by cp.async, 16 bytes a copy where x starts on 16 bytes (k is a multiple
// of 8), else 4; zeros from row le on.
__device__ __forceinline__ void copy_b(const float* x, int k, int l0, int le, bool al16,
                                       float* sb) {
  const float* src = x + (size_t)l0 * k;
  if (al16) {
    for (int e = threadIdx.x; e < kChunk * k / 4; e += kThreads) {
      const bool ok = l0 + 4 * e / k < le;
      cp_async::copy16(sb + 4 * e, ok ? src + 4 * e : x, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kChunk * k; e += kThreads) {
      const bool ok = l0 + e / k < le;
      cp_async::copy4(sb + e, ok ? src + e : x, ok);
    }
  }
  cp_async::copy_commit();
}

// sy (16 x k) = the tile's rows [r0, r0 + rows) of Aop x, Aop as `mode`
// reads M. Thread tid < groups * k holds the 4 x 4 tile (rows 4 rq, columns
// 4 cq) of group g, which takes the inner indices g, g + groups, ... of
// each chunk; the groups' sums are added in group order. Chunk ch + 1 is
// staged while chunk ch is multiplied: B by cp.async, A through registers
// (transposed). Not inlined: its registers are allocated apart from the
// factorization's.
template <Mode mode>
__device__ __noinline__ void tile_product(int n, int k, int kp, int groups,
                                          const float* M, const float* x, int r0, int rows) {
  const Smem s = carve(smem, k, kp, groups);
  const int tid = threadIdx.x, cols4 = k / 4;
  const int g = tid / k, mt = tid % k, rq = mt / cols4, cq = mt % cols4;
  const bool active = g < groups;
  const bool al16 = (reinterpret_cast<size_t>(x) & 15) == 0;
  const int lb = mode == kColsLower ? r0 : 0;
  const int le = mode == kRowsLower ? min(n, r0 + rows) : n;
  const int chunks = (le - lb + kChunk - 1) / kChunk;
  float acc[4][4] = {};
  float ra[kAPer];
  copy_b(x, k, lb, le, al16, s.sb);
  load_a<mode>(M, n, r0, rows, lb, le, ra);
  store_a<mode>(s.sa, ra);
  cp_async::copy_wait<0>();
  __syncthreads();
  for (int ch = 0; ch < chunks; ++ch) {
    const int buf = ch & 1;
    const bool next = ch + 1 < chunks;
    if (next) {
      copy_b(x, k, lb + (ch + 1) * kChunk, le, al16, s.sb + (buf ^ 1) * kChunk * k);
      load_a<mode>(M, n, r0, rows, lb + (ch + 1) * kChunk, le, ra);
    }
    if (active) {
      const float* sa = s.sa + buf * kChunk * kALd + rq * 4;
      const float* sb = s.sb + buf * kChunk * k + cq * 4;
#pragma unroll 4
      for (int l = g; l < kChunk; l += groups) {
        const float4 av = *reinterpret_cast<const float4*>(sa + l * kALd);
        const float4 bv = *reinterpret_cast<const float4*>(sb + l * k);
        const float a4[4] = {av.x, av.y, av.z, av.w}, b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a4[i], b4[j], acc[i][j]);
      }
    }
    if (next) store_a<mode>(s.sa + (buf ^ 1) * kChunk * kALd, ra);
    cp_async::copy_wait<0>();
    __syncthreads();
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(s.red + (g * kTileRows + rq * 4 + i) * k + cq * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  __syncthreads();
  for (int e = tid; e < kTileRows * k; e += kThreads) {
    float v = 0.f;
    for (int gg = 0; gg < groups; ++gg) v += s.red[gg * kTileRows * k + e];
    s.sy[e] = v;
  }
  __syncthreads();
  STAGE_STAMP(kStampTile);
}

// out (16 x k) = in (16 x k) W (k x k), in shared memory.
__device__ void times_w(const Smem& s, int k, const float* in, float* out) {
  for (int e = threadIdx.x; e < kTileRows * (k / 4); e += kThreads) {
    const int r = e / (k / 4), c = (e % (k / 4)) * 4;
    float acc[4] = {};
    for (int l = 0; l < k; ++l) {
      const float a = in[r * k + l];
      const float4 w = *reinterpret_cast<const float4*>(s.w + l * k + c);
      acc[0] = fmaf(a, w.x, acc[0]);
      acc[1] = fmaf(a, w.y, acc[1]);
      acc[2] = fmaf(a, w.z, acc[2]);
      acc[3] = fmaf(a, w.w, acc[3]);
    }
    *reinterpret_cast<float4*>(out + r * k + c) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
  __syncthreads();
}

// Tile rows [r0, r0 + rows) between global (n x k) and shared (16 x k).
__device__ void rows_in(const float* src, int k, int r0, int rows, float* dst) {
  for (int e = threadIdx.x; e < kTileRows * k; e += kThreads)
    dst[e] = e / k < rows ? src[(size_t)r0 * k + e] : 0.f;
  __syncthreads();
}

__device__ void rows_out(const float* src, int k, int r0, int rows, float* dst) {
  for (int e = threadIdx.x; e < rows * k; e += kThreads) dst[(size_t)r0 * k + e] = src[e];
}

// The tile's Gram partial u^T v (k x k) over its rows, to part[b][t].
__device__ void gram_partial(const Args& p, int b, int t, int rows, const float* u,
                             const float* v) {
  const int k = p.k;
  float* dst = p.part + ((size_t)b * p.tiles + t) * k * k;
  for (int e = threadIdx.x; e < k * (k / 4); e += kThreads) {
    const int i = e / (k / 4), j = (e % (k / 4)) * 4;
    float acc[4] = {};
    for (int r = 0; r < rows; ++r) {
      const float a = u[r * k + i];
      const float4 w = *reinterpret_cast<const float4*>(v + r * k + j);
      acc[0] = fmaf(a, w.x, acc[0]);
      acc[1] = fmaf(a, w.y, acc[1]);
      acc[2] = fmaf(a, w.z, acc[2]);
      acc[3] = fmaf(a, w.w, acc[3]);
    }
    *reinterpret_cast<float4*>(dst + i * k + j) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

// W = L^-T of pencil b's jittered Gram (ensure_w: unless W holds it). Not
// inlined: its registers are allocated apart from the products'.
__device__ __noinline__ void factor_w(const Args p, int b) {
  const Smem s = carve(smem, p.k, p.kp, p.groups);
  const int k = p.k, kp = p.kp, ld = kp + 1;
  const float* g = p.gram + (size_t)b * k * k;
  for (int e = threadIdx.x; e < kp * kp; e += kThreads) {
    const int i = e / kp, j = e % kp;
    s.fl[i * ld + j] = i < k && j < k ? g[i * k + j] : (i == j ? 1.f : 0.f);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float tr = 0.f;
    for (int i = 0; i < k; ++i) tr += s.fl[i * ld + i];
    const float jitter = p.jitter_rel * tr / k + 1e-30f;
    for (int i = 0; i < k; ++i) s.fl[i * ld + i] += jitter;
  }
  __syncthreads();
  chol_warp::factor(s.fl, ld, s.fx, ld, s.fisr, s.fscratch, kp);
  chol_warp::invert(s.fl, ld, s.fx, ld, s.ft, kp);
  for (int e = threadIdx.x; e < k * k; e += kThreads) s.w[e] = s.fx[(e % k) * ld + e / k];
  __syncthreads();
  STAGE_STAMP(kStampFactor);
}

__device__ __forceinline__ void ensure_w(const Args& p, int b, int& w_pencil) {
  if (w_pencil == b) return;
  factor_w(p, b);
  w_pencil = b;
}

// t1 = Li^T x; with have_w, x = y and t1 = (Li^T y) W, q = y W where
// write_q; without, q = x (= q0) where write_q.
__device__ void stage_li_t(const Args& p, const float* x, bool have_w,
                           bool write_q, int& w_pencil) {
  const Smem s = carve(smem, p.k, p.kp, p.groups);
  const int n = p.n, k = p.k;
  const size_t nn = (size_t)n * n, nk = (size_t)n * k;
  for (int tau = blockIdx.x; tau < p.bz * p.tiles; tau += gridDim.x) {
    const int b = tau / p.tiles, t = tau % p.tiles;
    const int r0 = t * kTileRows, rows = min(kTileRows, n - r0);
    if (have_w) ensure_w(p, b, w_pencil);
    tile_product<kColsLower>(n, k, p.kp, p.groups, p.li + b * nn, x + b * nk, r0, rows);
    if (have_w) {
      times_w(s, k, s.sy, s.so);
      rows_out(s.so, k, r0, rows, p.t1 + b * nk);
    } else {
      rows_out(s.sy, k, r0, rows, p.t1 + b * nk);
    }
    if (write_q) {
      rows_in(x + b * nk, k, r0, rows, s.sq);
      if (have_w) {
        times_w(s, k, s.sq, s.so);
        rows_out(s.so, k, r0, rows, p.q + b * nk);
      } else {
        rows_out(s.sq, k, r0, rows, p.q + b * nk);
      }
    }
    __syncthreads();
  }
}

// t2 = A t1.
__device__ void stage_a(const Args& p) {
  const Smem s = carve(smem, p.k, p.kp, p.groups);
  const int n = p.n, k = p.k;
  const size_t nn = (size_t)n * n, nk = (size_t)n * k;
  for (int tau = blockIdx.x; tau < p.bz * p.tiles; tau += gridDim.x) {
    const int b = tau / p.tiles, t = tau % p.tiles;
    const int r0 = t * kTileRows, rows = min(kTileRows, n - r0);
    tile_product<kRowsDense>(n, k, p.kp, p.groups, p.a + b * nn, p.t1 + b * nk, r0, rows);
    rows_out(s.sy, k, r0, rows, p.t2 + b * nk);
    __syncthreads();
  }
}

// y = Li t2 and the tiles' Gram partials, y^T y or (with_q) q^T y.
__device__ void stage_li(const Args& p, bool with_q) {
  const Smem s = carve(smem, p.k, p.kp, p.groups);
  const int n = p.n, k = p.k;
  const size_t nn = (size_t)n * n, nk = (size_t)n * k;
  for (int tau = blockIdx.x; tau < p.bz * p.tiles; tau += gridDim.x) {
    const int b = tau / p.tiles, t = tau % p.tiles;
    const int r0 = t * kTileRows, rows = min(kTileRows, n - r0);
    tile_product<kRowsLower>(n, k, p.kp, p.groups, p.li + b * nn, p.t2 + b * nk, r0, rows);
    rows_out(s.sy, k, r0, rows, p.y + b * nk);
    if (with_q) rows_in(p.q + b * nk, k, r0, rows, s.sq);
    gram_partial(p, b, t, rows, with_q ? s.sq : s.sy, s.sy);
    __syncthreads();
  }
}

// y <- y W (in place: a tile reads and writes its own rows) and the tiles'
// Gram partials of the new y.
__device__ void stage_apply(const Args& p, int& w_pencil) {
  const Smem s = carve(smem, p.k, p.kp, p.groups);
  const int n = p.n, k = p.k;
  const size_t nk = (size_t)n * k;
  for (int tau = blockIdx.x; tau < p.bz * p.tiles; tau += gridDim.x) {
    const int b = tau / p.tiles, t = tau % p.tiles;
    const int r0 = t * kTileRows, rows = min(kTileRows, n - r0);
    ensure_w(p, b, w_pencil);
    rows_in(p.y + b * nk, k, r0, rows, s.sq);
    times_w(s, k, s.sq, s.sy);
    rows_out(s.sy, k, r0, rows, p.y + b * nk);
    gram_partial(p, b, t, rows, s.sy, s.sy);
    __syncthreads();
  }
}

// gram[b] = the sum of pencil b's partials in tile order, every block of
// the grid taking its share of the entries.
__device__ void reduce_grams(const Args& p) {
  const int kk = p.k * p.k;
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < p.bz * kk; e += gridDim.x * kThreads) {
    const float* src = p.part + (size_t)(e / kk) * p.tiles * kk + e % kk;
    float v = 0.f;
#pragma unroll 10
    for (int t = 0; t < p.tiles; ++t) v += src[(size_t)t * kk];
    p.gram[e] = v;
  }
}

// small[b][i][j] = (G[i][j] + G[j][i]) / 2 of G = q^T y summed in tile order.
__device__ void reduce_small(const Args& p) {
  const int k = p.k, kk = k * k;
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < p.bz * kk; e += gridDim.x * kThreads) {
    const int b = e / kk, i = (e % kk) / k, j = e % k;
    const float* src = p.part + (size_t)b * p.tiles * kk;
    float gij = 0.f, gji = 0.f;
    for (int t = 0; t < p.tiles; ++t) {
      gij += src[(size_t)t * kk + i * k + j];
      gji += src[(size_t)t * kk + j * k + i];
    }
    p.small[e] = 0.5f * (gij + gji);
  }
}

__global__ void __launch_bounds__(kThreads) subspace_kernel(Args p) {
  cg::grid_group grid = cg::this_grid();
  STAGE_STAMP(0);
  int w_pencil = -1;  // the pencil whose L^-T W holds
  const float* x = p.q0;
  bool have_w = false;
  for (int it = 0; it < p.iters; ++it) {
    stage_li_t(p, x, have_w, false, w_pencil);
    grid.sync();
    STAGE_STAMP(kStampProducts + kBarrier);
    stage_a(p);
    grid.sync();
    STAGE_STAMP(kStampProducts + kBarrier);
    stage_li(p, false);
    grid.sync();
    STAGE_STAMP(kStampProducts + kBarrier);
    reduce_grams(p);  // CholeskyQR2, first pass
    grid.sync();
    STAGE_STAMP(kStampReduce + kBarrier);
    w_pencil = -1;
    stage_apply(p, w_pencil);
    grid.sync();
    STAGE_STAMP(kStampProducts + kBarrier);
    reduce_grams(p);  // second pass: applied by the next stage_li_t
    grid.sync();
    STAGE_STAMP(kStampReduce + kBarrier);
    w_pencil = -1;
    x = p.y;
    have_w = true;
  }
  stage_li_t(p, x, have_w, true, w_pencil);
  grid.sync();
  STAGE_STAMP(kStampProducts + kBarrier);
  stage_a(p);
  grid.sync();
  STAGE_STAMP(kStampProducts + kBarrier);
  stage_li(p, true);
  grid.sync();
  STAGE_STAMP(kStampProducts + kBarrier);
  reduce_small(p);
  STAGE_STAMP(kStampReduce);
}

int padded_width(int k) { return k <= 32 ? 32 : k <= 64 ? 64 : 128; }

int groups_for(int k) { return kThreads / k < kMaxGroups ? kThreads / k : kMaxGroups; }

size_t smem_bytes(int k) {
  const size_t prod = product_floats(k, groups_for(k)), fact = factor_floats(padded_width(k));
  return ((size_t)k * k + (prod > fact ? prod : fact)) * sizeof(float);
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
  const size_t bytes = smem_bytes(k);
  cudaError_t e = cudaFuncSetAttribute(subspace_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, subspace_kernel,
                                                         kThreads, bytes)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  int grid = per_sm * sms;
  if (grid > bz * tiles) grid = bz * tiles;
  Args args{a,  li,          q0, q, small, ws, ws + nk, ws + 2 * nk, ws + 3 * nk,
            ws + 3 * nk + (size_t)bz * tiles * kk, bz, n, k, padded_width(k), iters, tiles,
            groups_for(k), jitter_rel};
  void* kargs[] = {&args};
  e = cudaLaunchCooperativeKernel((void*)subspace_kernel, grid, kThreads, kargs, bytes,
                                  stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
