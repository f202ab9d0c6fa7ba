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
//     one warp in registers, inverted by the TPU kernel's exact Neumann
//     doubling with two Newton steps (_neumann_inv_sub), the rows below it
//     in the panel solved by that inverse with one refinement step, then
//     the in-panel trailing update; the panel inverse by the merge tree
//     X21 = -X22 (L21 X11) (_merge_tri);
//  S  the panel solve L21 = A21 Lp^-T with one refinement step,
//     L21 += (A21 - L21 Lp^T) Lp^-T;
//  U  the trailing update A22 -= L21 L21^T, block-lower triangle only;
//  I  block row p of the inverse, X_pj = -Lp^-1 S, S = sum_k L_pk X_kj,
//     refined once, x += Lp^-1 (-S - Lp x) (whiten.py:374-385).
// Every product is a full fp32 FMA sum over the same range as the plain
// version's matmul (no tensor cores, structural zeros included), so a
// non-finite entry spreads as it does there: the non-finite pattern of the
// output's lower triangle is the plain version's.
//
// Bound on the H100: operations. The factor and the inverse, each counted as
// triangular, are 2 x 2 n^3 / 3 flops a matrix: 0.68 GFLOP at (2, 800, 800),
// 0.010 ms at 67 TFLOP/s, against 10.2 MB read and written (0.003 ms). The
// time is the dependent chain: per panel F, then the solve of the next
// panel's rows, then their update, then the next F; the first design ran
// each phase behind a grid-wide barrier and F as one block's scalar loops
// (1.66 ms, of which F 0.98).
// Design: one persistent cooperative launch (every block resident, so a
// spin-wait cannot deadlock), one block per SM, tasks joined by ready
// counters in the workspace (release / acquire at GPU scope) in place of
// grid barriers:
//  - role F, one block a matrix: F(0), F(1), ... in turn. Its products run
//    in register tiles fed by float4 shared loads; a warp factors each 32 x
//    32 diagonal block four columns at a time (the columns' entries by
//    shuffle inside a group, one broadcast a group); the Neumann
//    doubling's p <- p p and x <- x + x p of successive steps share a
//    barrier;
//  - role C, 16 blocks a matrix, the look-ahead: for panel p, the solve of
//    row block p+1 (an 8-row band each) and then the update of the diagonal
//    tile (p+1, p+1) (an 8-row band each), all F(p+1) waits for;
//  - the pool, the other blocks: the rest of the solves, the updates in
//    64 x 64 sub-tiles in order of need (the column the next solves read,
//    then the next diagonal tile), and the inverse tiles of block row p+1
//    (16 columns each, deepest first), which sum S while F(p+1) runs and
//    apply Lp^-1 after it. Tickets come from one counter, in an order in
//    which every task's inputs come earlier.
// Each tile's sums keep a fixed order whatever block takes the tile, so two
// launches give the same bits. The counters are zeroed inside the launch
// (then one grid barrier), so a launch needs no host step besides itself.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

#ifndef STAGE_STAMP
#define STAGE_STAMP(kind)  // timer stamps: only tools/k10b_stages.py's build has them
#endif
#ifndef STAGE_ANY
#define STAGE_ANY(kind)
#endif
#ifndef STAGE_BLOCK
#define STAGE_BLOCK(kind)
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kP = 128;            // panel width
constexpr int kSub = 32;           // sub-panel width: one warp
constexpr int kThreads = 512;
constexpr int kLd = kP + 4;        // shared row stride of a 128-wide block
constexpr int kSLd = kSub + 4;     // of a 32-wide block (both = 4 mod 32: rows
                                   // on 16 bytes, lanes on successive rows
                                   // read float4s without bank conflicts)
constexpr int kBand = 8;           // rows of a solve task and of a look-ahead update band
constexpr int kBands = kP / kBand;  // role-C blocks a matrix
constexpr int kCols = 16;          // columns of an inverse tile
constexpr int kColLd = kCols + 4;
constexpr int kHalf = 64;          // rows and columns of a pool update sub-tile
constexpr int kChunk = 32;         // depth of an inverse tile's streamed chunk
constexpr int kMaxPad = 1024;
constexpr int kMaxPanels = kMaxPad / kP;
constexpr int kMaxTiles = kMaxPad / kCols;
constexpr unsigned kFull = 0xffffffffu;

// Ready counters, per matrix (unsigned): F(p) done; S(p, q) bands done;
// U tasks done on tile (q, r), counted over all panels; inverse tile (p, j).
constexpr int kCntF = 0;
constexpr int kCntS = kCntF + kMaxPanels;
constexpr int kCntU = kCntS + kMaxPanels * kMaxPanels;
constexpr int kCntI = kCntU + kMaxPanels * kMaxPanels;
constexpr int kCounters = 1024;  // >= kCntI + kMaxPanels * kMaxTiles
constexpr int kGlobalCounters = 32;  // [0]: the pool's ticket
static_assert(kCntI + kMaxPanels * kMaxTiles <= kCounters, "counter layout");

// Shared memory (floats), the largest of the roles' layouts.
constexpr int kBlockFloats = kP * kLd;
constexpr int kFScratch = 2 * 96 * kSLd + 4 * kSub * kSLd + 5 * kSub;
constexpr int kFFloats = 2 * kBlockFloats + kFScratch;
constexpr int kSFloats = 2 * kBlockFloats + 3 * kBand * kLd + 3 * kBand * kP;
constexpr int kUBandFloats = kBlockFloats + kBand * kLd + 3 * kBand * kP;
constexpr int kIFloats = 2 * kBlockFloats + 3 * kP * kColLd + kP * kCols;
constexpr int kUFloats = 2 * kHalf * kLd + kHalf * kHalf;
constexpr int kMax2(int x, int y) { return x > y ? x : y; }
constexpr int kSmemFloats =
    kMax2(kMax2(kMax2(kFFloats, kSFloats), kMax2(kIFloats, kUFloats)), kUBandFloats);
constexpr size_t kSmem = (size_t)kSmemFloats * sizeof(float);

struct Args {
  const float* in;
  float* out;
  float* ws;
  unsigned* cnt;
  int bz, n, npad;
  bool vec;  // n % 4 == 0 and in, out on 16 bytes
};

__device__ __forceinline__ float* mat(const Args& a, int b) {
  return a.ws + (size_t)b * 2 * a.npad * a.npad;
}
__device__ __forceinline__ float* inv_of(const Args& a, int b) {
  return mat(a, b) + (size_t)a.npad * a.npad;
}
__device__ __forceinline__ unsigned* counters(const Args& a, int b) {
  return a.cnt + kGlobalCounters + b * kCounters;
}

// max(x, 1e-30) that propagates a NaN (torch.clamp_min does).
__device__ __forceinline__ float clamp_pivot(float x) { return x < 1e-30f ? 1e-30f : x; }

// ---- ready counters -------------------------------------------------------

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Thread 0 spins until *p >= need (the block then passes a barrier). A wait
// that outlasts 2^22 polls (a second or more; a launch takes well under a
// millisecond) can only be a broken schedule: it traps, so the launch
// fails instead of holding the card.
__device__ __forceinline__ void spin_ge(const unsigned* p, unsigned need) {
  for (unsigned polls = 0; ld_acquire(p) < need; ++polls) {
    if (polls == (1u << 22)) __trap();
    __nanosleep(32);
  }
}

// The block's global writes are done: add one to *p, with release order.
__device__ __forceinline__ void publish(unsigned* p) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(p) : "memory");
  }
}

// ---- products in register tiles --------------------------------------------
// A thread's tile: rows r0 .. r0 + TM - 1, columns c0 + j cs (j < TN). P is
// row-major, read as float4 along k (rows on 16 bytes, k0 and k1 multiples
// of 4); each sum runs over k in order from 0.

__device__ __forceinline__ float f4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc[i][j] += sum_k P[r0 + i][k] QT[c0 + j cs][k]  (P Q^T; QT row-major).
template <int TM, int TN>
__device__ __forceinline__ void mma_nt(const float* P, int ldp, const float* QT, int ldq, int r0,
                                       int c0, int cs, int k0, int k1, float (&acc)[TM][TN]) {
  constexpr int kUnroll = TM * TN >= 16 ? 1 : 2;  // loads in flight within the registers
#pragma unroll kUnroll
  for (int k = k0; k < k1; k += 4) {
    float4 x[TM], y[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) x[i] = *reinterpret_cast<const float4*>(P + (r0 + i) * ldp + k);
#pragma unroll
    for (int j = 0; j < TN; ++j)
      y[j] = *reinterpret_cast<const float4*>(QT + (c0 + j * cs) * ldq + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(f4(x[i], kk), f4(y[j], kk), acc[i][j]);
  }
}

// acc[i][j] += sum_k P[r0 + i][k] Q[k][c0 + j cs]  (P Q; Q row-major).
template <int TM, int TN>
__device__ __forceinline__ void mma_nn(const float* P, int ldp, const float* Q, int ldq, int r0,
                                       int c0, int cs, int k0, int k1, float (&acc)[TM][TN]) {
  constexpr int kUnroll = TM * TN >= 16 ? 1 : 2;
#pragma unroll kUnroll
  for (int k = k0; k < k1; k += 4) {
    float4 x[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) x[i] = *reinterpret_cast<const float4*>(P + (r0 + i) * ldp + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float y[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) y[j] = Q[(k + kk) * ldq + c0 + j * cs];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(f4(x[i], kk), y[j], acc[i][j]);
    }
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// Split-K: the k-groups g > 0 hand their partial tiles to group 0 through
// red, which adds them in group order. Group g has `per` threads; call with
// the block's barrier count balanced (every thread calls it).
template <int TM, int TN>
__device__ __forceinline__ void reduce_groups(float (&acc)[TM][TN], float* red, int groups,
                                              int per) {
  const int g = threadIdx.x / per, t = threadIdx.x % per;
  if (g > 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) red[((g - 1) * TM * TN + i * TN + j) * per + t] = acc[i][j];
  }
  __syncthreads();
  if (g == 0) {
    for (int h = 1; h < groups; ++h)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += red[((h - 1) * TM * TN + i * TN + j) * per + t];
  }
}

// ---- staging -----------------------------------------------------------------

// rows x cols (cols a multiple of 4) from global (row stride lds, on 16
// bytes) to shared (row stride ldd), by cp.async through the L2 only (the
// rows were written by other blocks in this launch); not waited on.
__device__ __forceinline__ void stage(float* dst, int ldd, const float* src, size_t lds, int rows,
                                      int cols) {
  const int per_row = cols / 4;
  for (int e = threadIdx.x; e < rows * per_row; e += kThreads) {
    const int r = e / per_row, c = 4 * (e % per_row);
    cp_async::copy16(dst + r * ldd + c, src + r * lds + c, true);
  }
}

__device__ __forceinline__ void stage_wait() {
  cp_async::copy_commit();
  cp_async::copy_wait<0>();
  __syncthreads();
}

// ---- F: the panel factorization, one block -------------------------------

// One warp: the Cholesky factor of the 32 x 32 block g (row stride kLd,
// lower triangle; the upper triangle zero), in place with zeros above the
// diagonal, by the column algorithm: lane r holds row r; step c scales
// column c by rsqrt(max(pivot, 1e-30)) (correctly rounded) and subtracts
// its outer product from the columns right of it, in column order. Four
// columns at a time: inside a group, each lane takes the entries of its
// group's columns from the pivot rows by shuffle; the group's four columns
// then go to the rest of the row at once through shared memory (col4, 32
// float4s), two warp barriers a group.
__device__ __forceinline__ void factor32(float* g, float4* col4) {
  const int lane = threadIdx.x & 31;
  float* row = g + lane * kLd;
  float d[kSub];
#pragma unroll
  for (int q = 0; q < kSub / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(row)[q];
    d[4 * q] = v.x;
    d[4 * q + 1] = v.y;
    d[4 * q + 2] = v.z;
    d[4 * q + 3] = v.w;
  }
  float piv = __shfl_sync(kFull, d[0], 0);
#pragma unroll
  for (int c0 = 0; c0 < kSub; c0 += 4) {
    float lg[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int c = c0 + t;
      const float l = d[c] * __frsqrt_rn(clamp_pivot(piv));  // L[lane][c] for lane >= c
      d[c] = l;
      lg[t] = l;
#pragma unroll
      for (int u = t + 1; u < 4; ++u)
        d[c0 + u] = fmaf(-l, __shfl_sync(kFull, l, c0 + u), d[c0 + u]);
      if (t < 3) piv = __shfl_sync(kFull, d[c + 1], c + 1);
    }
    if (c0 + 4 < kSub) {
      col4[lane] = make_float4(lg[0], lg[1], lg[2], lg[3]);
      __syncwarp();
      // Lanes r < m update d[m] too: above the diagonal, never kept.
#pragma unroll
      for (int m = c0 + 4; m < kSub; ++m) {
        const float4 v = col4[m];
        d[m] = fmaf(-lg[0], v.x, d[m]);
        d[m] = fmaf(-lg[1], v.y, d[m]);
        d[m] = fmaf(-lg[2], v.z, d[m]);
        d[m] = fmaf(-lg[3], v.w, d[m]);
      }
      __syncwarp();
      piv = __shfl_sync(kFull, d[c0 + 4], c0 + 4);
    }
  }
#pragma unroll
  for (int q = 0; q < kSub / 4; ++q)
    reinterpret_cast<float4*>(row)[q] =
        make_float4(4 * q <= lane ? d[4 * q] : 0.f, 4 * q + 1 <= lane ? d[4 * q + 1] : 0.f,
                    4 * q + 2 <= lane ? d[4 * q + 2] : 0.f, 4 * q + 3 <= lane ? d[4 * q + 3] : 0.f);
}

// The inverse of the 32 x 32 lower factor l (row stride kLd) into x (row
// stride kLd) by exact Neumann doubling, ops/trisolve.neumann_tri_inverse
// with two Newton steps: L = D (I - M), (I - M)^-1 = prod_j (I + M^(2^j)),
// four doublings at width 32. A product alone takes the block (rows
// 2 warp, 2 warp + 1, column lane); each step's x <- x + x p and the next
// step's p <- p p run side by side (half the block each, rows 4 (warp % 8)
// + 0..3). x, p and t alternate between buffers, so a stage needs one
// barrier. A stage takes ~0.75 us on the card, bound by shared-memory
// passes (a broadcast float4 load costs four). Tried there and no faster:
// 8-row tiles on four warps a product; split-K over the block (two
// barriers a stage); 4 x 4 tiles shared by quarter-warps, on two warps a
// product and on eight in four k-groups.
// Scratch: p0, p1, xb, t (32 x kSLd each), dinv (32).
__device__ void neumann32(const float* l, float* x, float* p0, float* p1, float* xb, float* t,
                          float* dinv) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  for (int e = tid; e < kSub * kSub; e += kThreads) {
    const int r = e / kSub, c = e % kSub;
    const float dd = l[r * kLd + r];
    const float dr = 1.f / (dd == 0.f ? 1.f : dd);  // the zero-diagonal guard
    if (c == 0) dinv[r] = dr;
    const float m = (r == c ? 1.f : 0.f) - dr * l[r * kLd + c];
    p0[r * kSLd + c] = m;
    x[r * kLd + c] = (r == c ? 1.f : 0.f) + m;
  }
  __syncthreads();
  const int r2 = 2 * warp;
  float a2[2][1];
  // p1 = p0 p0
  zero(a2);
  mma_nn<2, 1>(p0, kSLd, p0, kSLd, r2, lane, 0, 0, kSub, a2);
  p1[r2 * kSLd + lane] = a2[0][0];
  p1[(r2 + 1) * kSLd + lane] = a2[1][0];
  STAGE_STAMP(22);
  __syncthreads();
  STAGE_STAMP(23);
  // Three stages: x_i = x_{i-1} + x_{i-1} p_i beside p_{i+1} = p_i p_i;
  // x alternates x -> xb -> x -> xb, p alternates p1 -> p0 -> p1 -> p0.
  const int half = warp / 8, r4 = 4 * (warp % 8);
  const float* xs[4] = {x, xb, x, xb};
  const int xld[4] = {kLd, kSLd, kLd, kSLd};
  float* ps[4] = {p1, p0, p1, p0};
#pragma unroll
  for (int it = 0; it < 3; ++it) {
    const float* xi = xs[it];
    float* xo = const_cast<float*>(xs[it + 1]);
    float a4[4][1];
    zero(a4);
    if (half == 0) {
      mma_nn<4, 1>(xi, xld[it], ps[it], kSLd, r4, lane, 0, 0, kSub, a4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        xo[(r4 + i) * xld[it + 1] + lane] = xi[(r4 + i) * xld[it] + lane] + a4[i][0];
    } else {
      mma_nn<4, 1>(ps[it], kSLd, ps[it], kSLd, r4, lane, 0, 0, kSub, a4);
#pragma unroll
      for (int i = 0; i < 4; ++i) ps[it + 1][(r4 + i) * kSLd + lane] = a4[i][0];
    }
    STAGE_STAMP(22);
    __syncthreads();
    STAGE_STAMP(23);
  }
  // x4 = (x3 + x3 p4) dinv[column], into x (x3 is in xb, p4 in p0).
  zero(a2);
  mma_nn<2, 1>(xb, kSLd, p0, kSLd, r2, lane, 0, 0, kSub, a2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float v = xb[(r2 + i) * kSLd + lane] + a2[i][0];
    x[(r2 + i) * kLd + lane] = v * dinv[lane];
  }
  STAGE_STAMP(22);
  __syncthreads();
  STAGE_STAMP(23);
  // Two Newton steps x <- x + x (I - l x): x -> xb -> x, through t.
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const float* xi = it == 0 ? x : xb;
    const int li = it == 0 ? kLd : kSLd;
    float* xo = it == 0 ? xb : x;
    const int lo_ = it == 0 ? kSLd : kLd;
    zero(a2);
    mma_nn<2, 1>(l, kLd, xi, li, r2, lane, 0, 0, kSub, a2);
#pragma unroll
    for (int i = 0; i < 2; ++i) t[(r2 + i) * kSLd + lane] = (r2 + i == lane ? 1.f : 0.f) - a2[i][0];
    STAGE_STAMP(22);
    __syncthreads();
    STAGE_STAMP(23);
    zero(a2);
    mma_nn<2, 1>(xi, li, t, kSLd, r2, lane, 0, 0, kSub, a2);
#pragma unroll
    for (int i = 0; i < 2; ++i) xo[(r2 + i) * lo_ + lane] = xi[(r2 + i) * li + lane] + a2[i][0];
    STAGE_STAMP(22);
    __syncthreads();
    STAGE_STAMP(23);
  }
}

// The m = 16 TM rows below sub-panel g0 in the panel (D, its inverse in XI):
// l21 = a21 inv^T, refined once, l21 += (a21 - l21 ls^T) inv^T; then the
// in-panel update D[g1:, g1:] -= l21 l21^T, lower triangle. Thread: rows
// TM warp .. + TM - 1, columns lane (+ 32 j in the update).
template <int TM>
__device__ void strip_and_update(float* D, const float* XI, int g0, float* t1, float* res) {
  constexpr int m = 16 * TM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, r0 = TM * warp, g1 = g0 + kSub;
  const float* a21 = D + g1 * kLd + g0;
  const float* inv = XI + g0 * kLd + g0;
  const float* ls = D + g0 * kLd + g0;
  float acc[TM][1];
  zero(acc);
  mma_nt<TM, 1>(a21, kLd, inv, kLd, r0, lane, 0, 0, kSub, acc);
#pragma unroll
  for (int i = 0; i < TM; ++i) t1[(r0 + i) * kSLd + lane] = acc[i][0];
  __syncthreads();
  zero(acc);
  mma_nt<TM, 1>(t1, kSLd, ls, kLd, r0, lane, 0, 0, kSub, acc);
#pragma unroll
  for (int i = 0; i < TM; ++i) res[(r0 + i) * kSLd + lane] = a21[(r0 + i) * kLd + lane] - acc[i][0];
  __syncthreads();
  zero(acc);
  mma_nt<TM, 1>(res, kSLd, inv, kLd, r0, lane, 0, 0, kSub, acc);
#pragma unroll
  for (int i = 0; i < TM; ++i) D[(g1 + r0 + i) * kLd + g0 + lane] = t1[(r0 + i) * kSLd + lane] + acc[i][0];
  __syncthreads();
  STAGE_STAMP(3);
  constexpr int TN = m / 32;
  float up[TM][TN];
  zero(up);
  mma_nt<TM, TN>(D + g1 * kLd + g0, kLd, D + g1 * kLd + g0, kLd, r0, lane, 32, 0, kSub, up);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int r = r0 + i, c = lane + 32 * j;
      if (c <= r) D[(g1 + r) * kLd + g1 + c] -= up[i][j];
    }
  __syncthreads();
}

// One level's product pair of the merge tree at width 32: for the pairs at
// lo = 0 and lo = 64 (half the block each), T = L21 X11, then X21 = -X22 T.
__device__ void merge32(const float* D, float* XI, float* t0, float* t1) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int lo = (warp / 8) * 2 * kSub, mid = lo + kSub, r0 = 4 * (warp % 8);
  float* t = warp < 8 ? t0 : t1;
  float acc[4][1];
  zero(acc);
  mma_nn<4, 1>(D + mid * kLd + lo, kLd, XI + lo * kLd + lo, kLd, r0, lane, 0, 0, kSub, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) t[(r0 + i) * kSLd + lane] = acc[i][0];
  __syncthreads();
  zero(acc);
  mma_nn<4, 1>(XI + mid * kLd + mid, kLd, t, kSLd, r0, lane, 0, 0, kSub, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) XI[(mid + r0 + i) * kLd + lo + lane] = -acc[i][0];
  __syncthreads();
}

// The top level of the merge tree: T = L[64:, :64] X[:64, :64], then
// X[64:, :64] = -X[64:, 64:] T (T: 64 x (64 + 4)).
__device__ void merge64(const float* D, float* XI, float* t) {
  constexpr int ld = kHalf + 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, r0 = 4 * warp;
  float acc[4][2];
  zero(acc);
  mma_nn<4, 2>(D + kHalf * kLd, kLd, XI, kLd, r0, lane, 32, 0, kHalf, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) t[(r0 + i) * ld + lane + 32 * j] = acc[i][j];
  __syncthreads();
  zero(acc);
  mma_nn<4, 2>(XI + kHalf * kLd + kHalf, kLd, t, ld, r0, lane, 32, 0, kHalf, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) XI[(kHalf + r0 + i) * kLd + lane + 32 * j] = -acc[i][j];
  __syncthreads();
}

// Tile (p, p)'s U tasks counted once every earlier panel's update is done:
// the pool's 3 sub-tiles a panel, then the 8 look-ahead bands of panel p-1.
__device__ __forceinline__ unsigned diag_ready(int p) { return p == 0 ? 0u : 3u * (p - 1) + kBands; }

// F(p) of matrix b: Lp into A's diagonal block (zeros above), Lp^-1 (with
// its structural zeros) into X's, tril(Lp^-1) into the output.
__device__ __noinline__ void f_task(const Args& a, int b, int p, float* smem) {
  float* D = smem;
  float* XI = D + kBlockFloats;
  float* t1 = XI + kBlockFloats;          // 96 x kSLd; with res, the 64 x 68 merge T
  float* res = t1 + 96 * kSLd;            // 96 x kSLd
  float* p0 = res + 96 * kSLd;            // four 32 x kSLd buffers
  float* p1 = p0 + kSub * kSLd;
  float* xb = p1 + kSub * kSLd;
  float* tb = xb + kSub * kSLd;
  float4* col4 = reinterpret_cast<float4*>(tb + kSub * kSLd);  // 32 float4s
  float* dinv = tb + kSub * kSLd + 4 * kSub;
  unsigned* cnt = counters(a, b);
  const int np = a.npad, lo = p * kP, tid = threadIdx.x;
  float* A = mat(a, b) + (size_t)lo * np + lo;
  float* X = inv_of(a, b) + (size_t)lo * np + lo;

  if (tid == 0) spin_ge(cnt + kCntU + p * kMaxPanels + p, diag_ready(p));
  __syncthreads();
  STAGE_STAMP(7);
  STAGE_ANY(7);
  stage(D, kLd, A, np, kP, kP);
  stage_wait();
  for (int e = tid; e < kP * kP; e += kThreads) {
    const int r = e / kP, c = e % kP;
    if (c > r) D[r * kLd + c] = 0.f;
    XI[r * kLd + c] = 0.f;
  }
  __syncthreads();
  STAGE_STAMP(6);
  for (int g0 = 0; g0 < kP; g0 += kSub) {
    if (tid < 32) factor32(D + g0 * kLd + g0, col4);
    __syncthreads();
    STAGE_STAMP(1);
    neumann32(D + g0 * kLd + g0, XI + g0 * kLd + g0, p0, p1, xb, tb, dinv);
    STAGE_STAMP(2);
    if (g0 == 0) strip_and_update<6>(D, XI, g0, t1, res);
    if (g0 == kSub) strip_and_update<4>(D, XI, g0, t1, res);
    if (g0 == 2 * kSub) strip_and_update<2>(D, XI, g0, t1, res);
    if (g0 + kSub < kP) STAGE_STAMP(4);
  }
  merge32(D, XI, p0, p1);
  merge64(D, XI, t1);
  STAGE_STAMP(5);
  for (int e = tid; e < kP * kP / 4; e += kThreads) {
    const int r = e / (kP / 4), c = 4 * (e % (kP / 4));
    *reinterpret_cast<float4*>(A + (size_t)r * np + c) =
        *reinterpret_cast<const float4*>(D + r * kLd + c);
    *reinterpret_cast<float4*>(X + (size_t)r * np + c) =
        *reinterpret_cast<const float4*>(XI + r * kLd + c);
  }
  publish(cnt + kCntF + p);
  // The output, which no task reads, after the counter.
  float* out = a.out + (size_t)b * a.n * a.n;
  for (int e = tid; e < kP * kP; e += kThreads) {
    const int r = e / kP, c = e % kP, R = lo + r, C = lo + c;
    if (R < a.n && C < a.n) out[(size_t)R * a.n + C] = c <= r ? XI[r * kLd + c] : 0.f;
  }
  STAGE_STAMP(15);
  STAGE_ANY(14);
}

// ---- S: an 8-row band of the panel solve ----------------------------------

// Rows 8 h .. 8 h + 7 of row block q of L[:, p] = A21 Lp^-T, refined
// once. Split-K: four groups of 4 warps each take 32 of the 128 columns of
// every sum; a warp's tile: rows 4 (w % 2) + 0..3, columns 64 (w / 2) +
// lane + 32 j. `have` says Lp and Lp^-1 of (b, p) are already staged.
__device__ __noinline__ void s_task(const Args& a, int b, int p, int q, int h, float* smem, bool have,
                                    bool look_ahead) {
  float* Lp = smem;
  float* Li = Lp + kBlockFloats;
  float* band = Li + kBlockFloats;  // 16 x kLd each: A21, t1, res
  float* t1 = band + kBand * kLd;
  float* res = t1 + kBand * kLd;
  float* red = res + kBand * kLd;   // 3 x 1024
  unsigned* cnt = counters(a, b);
  const int np = a.npad, lo = p * kP, row0 = q * kP + h * kBand;
  float* A = mat(a, b);
  if (threadIdx.x == 0) {
    spin_ge(cnt + kCntF + p, 1);
    spin_ge(cnt + kCntU + q * kMaxPanels + p, 4u * p);
  }
  __syncthreads();
  STAGE_ANY(look_ahead ? 18 : 7);
  // Lp^-1 and the band first; Lp, which the second product needs, lands
  // while the first runs.
  if (!have) stage(Li, kLd, inv_of(a, b) + (size_t)lo * np + lo, np, kP, kP);
  stage(band, kLd, A + (size_t)row0 * np + lo, np, kBand, kP);
  cp_async::copy_commit();
  if (!have) stage(Lp, kLd, A + (size_t)lo * np + lo, np, kP, kP);
  cp_async::copy_commit();
  cp_async::copy_wait<1>();
  __syncthreads();
  STAGE_ANY(look_ahead ? 20 : 10);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = warp / 4, w = warp % 4, r0 = 4 * (w % 2), c0 = 64 * (w / 2) + lane;
  const int k0 = 32 * g, k1 = k0 + 32;
  float acc[4][2];
  // t1 = A21 Lp^-T
  zero(acc);
  mma_nt<4, 2>(band, kLd, Li, kLd, r0, c0, 32, k0, k1, acc);
  reduce_groups(acc, red, 4, 128);
  if (g == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) t1[(r0 + i) * kLd + c0 + 32 * j] = acc[i][j];
  }
  cp_async::copy_wait<0>();
  __syncthreads();
  // res = A21 - t1 Lp^T
  zero(acc);
  mma_nt<4, 2>(t1, kLd, Lp, kLd, r0, c0, 32, k0, k1, acc);
  reduce_groups(acc, red, 4, 128);
  if (g == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int o = (r0 + i) * kLd + c0 + 32 * j;
        res[o] = band[o] - acc[i][j];
      }
  }
  __syncthreads();
  // L21 = t1 + res Lp^-T
  zero(acc);
  mma_nt<4, 2>(res, kLd, Li, kLd, r0, c0, 32, k0, k1, acc);
  reduce_groups(acc, red, 4, 128);
  if (g == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = c0 + 32 * j;
        A[(size_t)(row0 + r0 + i) * np + lo + c] = t1[(r0 + i) * kLd + c] + acc[i][j];
      }
  }
  publish(cnt + kCntS + p * kMaxPanels + q);
  STAGE_ANY(look_ahead ? 16 : 11);
}

// ---- U: the trailing update -----------------------------------------------

// Look-ahead band h of tile (q, q), q = p + 1: rows 8 h .. 8 h + 7 of
// A[q, q] -= L[q, p] L[q, p]^T, lower triangle, the band's rows of A staged
// beside L[q, p]. Tiling as s_task.
__device__ __noinline__ void u_band(const Args& a, int b, int p, int h, float* smem) {
  float* Lq = smem;                  // the 128 rows of L[q, p]
  float* Ab = Lq + kBlockFloats;     // the band's rows of A[q, q]
  float* red = Ab + kBand * kLd;
  unsigned* cnt = counters(a, b);
  const int np = a.npad, lo = p * kP, q0 = (p + 1) * kP;
  float* A = mat(a, b);
  if (threadIdx.x == 0) {
    spin_ge(cnt + kCntS + p * kMaxPanels + p + 1, kBands);
    spin_ge(cnt + kCntU + (p + 1) * kMaxPanels + p + 1, 3u * p);
  }
  __syncthreads();
  STAGE_ANY(18);
  stage(Lq, kLd, A + (size_t)q0 * np + lo, np, kP, kP);
  stage(Ab, kLd, A + (size_t)(q0 + kBand * h) * np + q0, np, kBand, kP);
  stage_wait();
  STAGE_ANY(21);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = warp / 4, w = warp % 4, r0 = 4 * (w % 2), c0 = 64 * (w / 2) + lane;
  float acc[4][2];
  zero(acc);
  if (64 * (w / 2) <= kBand * h + kBand - 1)  // column half not wholly above the band
    mma_nt<4, 2>(Lq + kBand * h * kLd, kLd, Lq, kLd, r0, c0, 32, 32 * g, 32 * g + 32, acc);
  reduce_groups(acc, red, 4, 128);
  if (g == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = r0 + i, c = c0 + 32 * j;
        if (c <= kBand * h + r)
          A[(size_t)(q0 + kBand * h + r) * np + q0 + c] = Ab[r * kLd + c] - acc[i][j];
      }
  }
  publish(cnt + kCntU + (p + 1) * kMaxPanels + p + 1);
  STAGE_ANY(17);
}

// Pool: sub-tile (si, sj) (64 x 64) of A[q, r] -= L[q, p] L[r, p]^T.
// Split-K in two 64-deep halves; a warp's tile: rows 8 (w % 8) + 0..7,
// columns lane + 32 j.
__device__ __noinline__ void u_sub(const Args& a, int b, int p, int q, int r, int si, int sj, float* smem) {
  float* La = smem;                 // 64 x kLd: rows of L[q, p]
  float* Lb = La + kHalf * kLd;     // 64 x kLd: rows of L[r, p]
  float* red = Lb + kHalf * kLd;
  unsigned* cnt = counters(a, b);
  const int np = a.npad, lo = p * kP;
  const int ra = q * kP + kHalf * si, rb = r * kP + kHalf * sj;
  float* A = mat(a, b);
  if (threadIdx.x == 0) {
    spin_ge(cnt + kCntS + p * kMaxPanels + q, kBands);
    spin_ge(cnt + kCntS + p * kMaxPanels + r, kBands);
    spin_ge(cnt + kCntU + q * kMaxPanels + r, (q == r ? 3u : 4u) * p);
  }
  __syncthreads();
  STAGE_ANY(7);
  stage(La, kLd, A + (size_t)ra * np + lo, np, kHalf, kP);
  stage(Lb, kLd, A + (size_t)rb * np + lo, np, kHalf, kP);
  stage_wait();
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = warp / 8, r0 = 8 * (warp % 8);
  float acc[8][2];
  zero(acc);
  mma_nt<8, 2>(La, kLd, Lb, kLd, r0, lane, 32, 64 * g, 64 * g + 64, acc);
  reduce_groups(acc, red, 2, 256);
  if (g == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float* e = A + (size_t)(ra + r0 + i) * np + rb + lane + 32 * j;
        *e = __ldcg(e) - acc[i][j];
      }
  }
  publish(cnt + kCntU + q * kMaxPanels + r);
  STAGE_ANY(13);
}

// ---- I: an inverse tile ------------------------------------------------------

// Columns c0 .. c0 + 15 of block row p of X (c0 < lo = 128 p): S = sum over
// k in [c0, lo) of L[p rows, k] X[k, cols], streamed in 32-deep chunks
// (double-buffered); then, once F(p) is done, x = -Lp^-1 S, refined once,
// x += Lp^-1 (-S - Lp x). Thread: rows 8 (2 (warp % 8) + lane / 16) + 0..7,
// column lane % 16; split-K in two groups of 8 warps (16-deep halves of a
// chunk, 64-deep halves of Lp's width).
__device__ __noinline__ void i_task(const Args& a, int b, int p, int jt, float* smem) {
  float* Lp = smem;                      // phase 2; phase 1's chunks below alias it
  float* Li = Lp + kBlockFloats;
  float* Sb = Li + kBlockFloats;         // 128 x kColLd each: S, x, residual
  float* xb = Sb + kP * kColLd;
  float* rb = xb + kP * kColLd;
  float* red = rb + kP * kColLd;         // 2048
  float* lc[2] = {smem, smem + kP * (kChunk + 4)};                    // 128 x 36
  float* xc[2] = {smem + 2 * kP * (kChunk + 4), smem + 2 * kP * (kChunk + 4) + kChunk * kCols};
  unsigned* cnt = counters(a, b);
  const int np = a.npad, lo = p * kP, c0 = jt * kCols, jb = c0 / kP;
  const float* A = mat(a, b);
  float* X = inv_of(a, b);
  if (threadIdx.x == 0) {
    spin_ge(cnt + kCntF + jb, 1);
    for (int k = jb + 1; k < p; ++k) spin_ge(cnt + kCntI + k * kMaxTiles + jt, 1);
    for (int k = jb; k < p; ++k) spin_ge(cnt + kCntS + k * kMaxPanels + p, kBands);
  }
  __syncthreads();
  STAGE_ANY(7);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = warp / 8, r0 = 8 * (2 * (warp % 8) + lane / 16), c = lane % 16;
  float acc[8][1];
  zero(acc);
  auto load_chunk = [&](int buf, int k0) {
    const int cw = min(kChunk, lo - k0);
    stage(lc[buf], kChunk + 4, A + (size_t)lo * np + k0, np, kP, cw);
    stage(xc[buf], kCols, X + (size_t)k0 * np + c0, np, cw, kCols);
    cp_async::copy_commit();
  };
  load_chunk(0, c0);
  for (int k0 = c0, buf = 0; k0 < lo; k0 += kChunk, buf ^= 1) {
    if (k0 + kChunk < lo) {
      load_chunk(buf ^ 1, k0 + kChunk);
      cp_async::copy_wait<1>();
    } else {
      cp_async::copy_wait<0>();
    }
    __syncthreads();
    const int kg = 16 * g;
    if (k0 + kg < lo) mma_nn<8, 1>(lc[buf], kChunk + 4, xc[buf], kCols, r0, c, 0, kg, kg + 16, acc);
    __syncthreads();
  }
  reduce_groups(acc, red, 2, 256);
  if (g == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) Sb[(r0 + i) * kColLd + c] = acc[i][0];
  }
  STAGE_ANY(12);
  if (threadIdx.x == 0) spin_ge(cnt + kCntF + p, 1);
  __syncthreads();
  STAGE_ANY(19);
  stage(Lp, kLd, A + (size_t)lo * np + lo, np, kP, kP);
  stage(Li, kLd, X + (size_t)lo * np + lo, np, kP, kP);
  stage_wait();
  // x = -Lp^-1 S
  zero(acc);
  mma_nn<8, 1>(Li, kLd, Sb, kColLd, r0, c, 0, 64 * g, 64 * g + 64, acc);
  reduce_groups(acc, red, 2, 256);
  if (g == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) xb[(r0 + i) * kColLd + c] = -acc[i][0];
  }
  __syncthreads();
  // residual = -S - Lp x
  zero(acc);
  mma_nn<8, 1>(Lp, kLd, xb, kColLd, r0, c, 0, 64 * g, 64 * g + 64, acc);
  reduce_groups(acc, red, 2, 256);
  if (g == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int o = (r0 + i) * kColLd + c;
      rb[o] = -Sb[o] - acc[i][0];
    }
  }
  __syncthreads();
  // x += Lp^-1 residual
  zero(acc);
  mma_nn<8, 1>(Li, kLd, rb, kColLd, r0, c, 0, 64 * g, 64 * g + 64, acc);
  reduce_groups(acc, red, 2, 256);
  if (g == 0) {
    float* out = a.out + (size_t)b * a.n * a.n;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = r0 + i;
      const float v = xb[r * kColLd + c] + acc[i][0];
      X[(size_t)(lo + r) * np + c0 + c] = v;
      if (lo + r < a.n) out[(size_t)(lo + r) * a.n + c0 + c] = v;
    }
  }
  publish(cnt + kCntI + p * kMaxTiles + jt);
  STAGE_ANY(12);
}

// ---- the pool's tickets --------------------------------------------------------
// Section s (0 <= s <= panels - 2), for every matrix in turn: the solve
// bands of panel s for row blocks s + 2 .. (row block s + 1 is role C's);
// the update sub-tiles of panel s, tile by tile in order of need (column
// r = s + 1 first, then the diagonal tile (s + 2, s + 2) and its column,
// ...; tile (s + 1, s + 1) is role C's); the inverse tiles of block row
// s + 1, column 0 (the deepest) first. Every input of a task is made by an
// earlier ticket, by F(p) or by role C, which needs only earlier tickets.

struct Task {
  int kind;  // 0 none left, 1 solve band, 2 update sub-tile, 3 inverse tile
  int b, p, q, r, sub;
};

__device__ Task decode(int t, int bz, int panels) {
  for (int s = 0; s + 1 < panels; ++s) {
    const int ns = (panels - 2 - s) * kBands;
    int nu = 0;
    for (int r = s + 1; r < panels; ++r)
      for (int q = max(r, s + 2); q < panels; ++q) nu += q == r ? 3 : 4;
    const int ni = (s + 1) * kP / kCols;
    if (t < bz * ns) return Task{1, t / ns, s, s + 2 + (t % ns) / kBands, 0, t % kBands};
    t -= bz * ns;
    if (t < bz * nu) {
      const int b = t / nu;
      int i = t % nu;
      for (int r = s + 1; r < panels; ++r)
        for (int q = max(r, s + 2); q < panels; ++q) {
          const int k = q == r ? 3 : 4;
          if (i < k) return Task{2, b, s, q, r, q == r ? (i == 0 ? 0 : i + 1) : i};
          i -= k;
        }
    }
    t -= bz * nu;
    if (t < bz * ni) return Task{3, t / ni, s + 1, 0, 0, t % ni};
    t -= bz * ni;
  }
  return Task{0, 0, 0, 0, 0, 0};
}

__global__ void __launch_bounds__(kThreads, 1) chol_tri_inverse_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Task task;
  STAGE_STAMP(0);
  STAGE_ANY(0);
  STAGE_BLOCK(0);
  cg::grid_group grid = cg::this_grid();
  const int np = a.npad, n = a.n, panels = np / kP, tid = threadIdx.x;
  // The padded input blkdiag(B, I) into the workspace; zeros in the
  // output's blocks above the block diagonal; the counters zeroed (32-bit
  // indices: at most 13 matrices of 1024^2 a launch; four loads in flight).
  const int first = blockIdx.x * kThreads + tid, stride = gridDim.x * kThreads;
  const int nn = np * np, on = n * n;
  if (a.vec) {  // n % 4 == 0, in and out on 16 bytes: four columns a thread
    const int np4 = np / 4, n4 = n / 4;
#pragma unroll 4
    for (int e = first; e < a.bz * nn / 4; e += stride) {
      const int b = e / (nn / 4), r = (e - b * (nn / 4)) / np4, c = 4 * (e - b * (nn / 4) - r * np4);
      const float4 v =
          r < n && c < n ? __ldg(reinterpret_cast<const float4*>(a.in + (size_t)b * on + r * n + c))
                         : make_float4(r == c, r == c + 1, r == c + 2, r == c + 3);
      *reinterpret_cast<float4*>(a.ws + (size_t)2 * b * nn + r * np + c) = v;
    }
#pragma unroll 4
    for (int e = first; e < a.bz * on / 4; e += stride) {
      const int b = e / (on / 4), r = (e - b * (on / 4)) / n4, c = 4 * (e - b * (on / 4) - r * n4);
      if (c / kP > r / kP)
        *reinterpret_cast<float4*>(a.out + (size_t)b * on + r * n + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
#pragma unroll 4
    for (int e = first; e < a.bz * nn; e += stride) {
      const int b = e / nn, r = (e - b * nn) / np, c = e - b * nn - r * np;
      a.ws[(size_t)2 * b * nn + r * np + c] =
          r < n && c < n ? __ldg(a.in + (size_t)b * on + r * n + c) : (r == c ? 1.f : 0.f);
    }
#pragma unroll 4
    for (int e = first; e < a.bz * on; e += stride) {
      const int b = e / on, r = (e - b * on) / n, c = e - b * on - r * n;
      if (c / kP > r / kP) a.out[e] = 0.f;
    }
  }
  for (int e = first; e < kGlobalCounters + a.bz * kCounters; e += stride) a.cnt[e] = 0u;
  STAGE_STAMP(8);
  STAGE_ANY(8);
  grid.sync();
  STAGE_STAMP(7);
  STAGE_ANY(7);

  const int blk = blockIdx.x;
  if (blk < a.bz) {
    for (int p = 0; p < panels; ++p) f_task(a, blk, p, smem);
  } else if (blk < a.bz * (1 + kBands)) {
    const int b = (blk - a.bz) / kBands, h = (blk - a.bz) % kBands;
    for (int p = 0; p + 1 < panels; ++p) {
      s_task(a, b, p, p + 1, h, smem, false, true);
      u_band(a, b, p, h, smem);
    }
  } else {
    int have = -1;  // (b, p) whose Lp and Lp^-1 are staged for a solve band
    for (;;) {
      if (threadIdx.x == 0) task = decode((int)atomicAdd(a.cnt, 1u), a.bz, panels);
      __syncthreads();
      const Task t = task;
      __syncthreads();
      if (t.kind == 0) break;
      if (t.kind == 1) {
        const int key = t.b * kMaxPanels + t.p;
        s_task(a, t.b, t.p, t.q, t.sub, smem, key == have, false);
        have = key;
      } else {
        have = -1;
        if (t.kind == 2)
          u_sub(a, t.b, t.p, t.q, t.r, t.sub / 2, t.sub % 2, smem);
        else
          i_task(a, t.b, t.p, t.sub, smem);
      }
    }
  }
  STAGE_STAMP(9);
  STAGE_BLOCK(1);
}

}  // namespace

// b (bz, n, n) SPD, float32, contiguous -> x (bz, n, n) = L^-1, lower
// triangular; npad = ceil128(n) <= 1024. ws: per matrix the trailing matrix
// and L, and X = L^-1 (2 npad^2 floats), then kGlobalCounters + bz kCounters
// ready counters (ops/kernels/whiten.py::chol_tri_inverse_workspace_floats).
// Matrices go in launches of as many as the grid's roles allow (7 a launch
// on a 132-SM card), one after another on the stream.
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
  const int resident = per_sm * sms;
  // Roles F and C take 1 + kBands blocks a matrix; the pool at least one.
  const int per_launch = (resident - 1) / (1 + kBands);
  if (per_launch < 1) return (int)cudaErrorInvalidConfiguration;
  unsigned* cnt = reinterpret_cast<unsigned*>(ws + 2L * bz * npad * npad);
  for (int b0 = 0; b0 < bz; b0 += per_launch) {
    const int m = bz - b0 < per_launch ? bz - b0 : per_launch;
    const int grid = npad == kP ? m : resident;  // one panel: F alone
    const float* in = b + (size_t)b0 * n * n;
    float* out = x + (size_t)b0 * n * n;
    const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
    Args args{in, out, ws + 2 * (size_t)b0 * npad * npad, cnt, m, n, npad, vec};
    void* kargs[] = {&args};
    e = cudaLaunchCooperativeKernel((void*)chol_tri_inverse_kernel, grid, kThreads, kargs, kSmem,
                                    stream);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}
