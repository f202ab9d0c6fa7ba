// The tracking GEVD solver's Rayleigh-Ritz solve on its projected pencil
// (apvast_torch/ops/jdiag.py::jdiag_topk_tracked), one thread block per
// zone, and the Ritz coordinates that follow its small eigensolve (K4).
//
// Replaces no Pallas kernel. The JAX package leaves this chain to XLA,
// which fuses it into a few programs on the TPU. In PyTorch it was ~300
// small launches a hop (batched bmm, cholesky_ex, solve_triangular and
// elementwise ops on 64- and 128-wide matrices): each a graph node of a few
// microseconds on the H100 for work that one SM does in well under one,
// so the chain took ~1 ms of device time while 130 SMs waited.
//
// Per zone of a (z, n, n) pair (abar, bbar) of raw projections s^T A s and
// s^T B s, n = 2k <= 128:
//   abar, bbar <- sym(abar), sym(bbar);  bbar += 8 eps(float32) tr(bbar)/n I
//   lbar = chol(bbar), libar = lbar^-1;  wbar = sym(libar abar libar^T)
//   y = CholeskyQR2(lbar^T[:, :k]);  twice: y = CholeskyQR2(wbar y)
//   h = sym(y^T (wbar y))
// each CholeskyQR2 pass: G = y^T y, G += ((tr G) / k 1e-6 + 1e-30) I,
// L = chol(G), y <- y L^-T. It writes h (k x k), y (n x k) and libar
// (n x n). The second entry point forms c = libar^T (y v[:, ::-1]) and
// lam = d[::-1] from K4's ascending eigenpairs (d, v) of h.
//
// Failure semantics are the torch chain's, not chol_warp's clamp: a zone
// with a non-finite input, or whose pencil or Gram factorization meets a
// pivot that is not > 0 (where cholesky_ex reports info > 0 and the chain
// fills its factor with NaN), returns NaN in every entry of its h, y and
// libar. The other zones are untouched.
//
// Bound on the H100: latency, then one SM's fp32 FMA rate. At n = 128,
// k = 64 a zone takes ~10 M FMAs (wbar: 2 M with its triangles skipped;
// three wbar y: 3 M; six Gram matrices and six y L^-T: 4.6 M; h: 0.5 M),
// 40 us at one SM's 128 FMAs a clock at 1.98 GHz, and seven Cholesky
// factorizations (one 128-wide with its inverse, six 64-wide) whose column
// steps are serial. Nothing here is bound by device memory (128 KB in and
// 100 KB out a zone).
//
// Design: one block of 512 threads per zone keeps the whole solve in
// shared memory (226 KB at n = 128: wbar, two 128 x 128 work areas that
// change roles, chol_warp's scratch), so zones run at once on separate SMs
// and nothing but y's first value goes to device memory between steps.
// Widths are padded to 32, 64 or 128 (abar with zeros, bbar and the Gram
// matrices with the identity, y with zeros), which leaves every result
// unpadded entry for entry. Every product is 4 x 4 register tiles with
// both operands read as float4 rows along the depth: libar is transposed
// once in place, wbar (exactly symmetric) is read by rows, and where a
// triangular operand cuts the depth the lanes of a warp share it, so they
// run the same depth; a Gram matrix's depth is split over three thread
// groups. Factorizations by chol_warp.cuh (warps on 32-wide sub-panels,
// the merge tree for libar), its fail hook taking the raw pivots; a Gram
// factor is not inverted: y <- y L^-T runs as row-parallel forward
// substitutions, four threads a row joined by shuffles. Every sum runs in
// a fixed order, with no atomics: a replay repeats bit for bit. fp32 FMAs
// only: no tensor cores, no library call. Measured (tools/
// tracked_rr_stages.py, H100 SXM at 700 W): 0.30-0.32 ms a launch at
// z = 2 to 32, of which the factorizations' column steps take ~45 %.

#include <cuda_runtime.h>
#include <math.h>

#include "chol_warp.cuh"

extern __shared__ __align__(16) float smem[];

namespace {

constexpr int kThreads = 512;
constexpr int kMaxN = 128;
constexpr float kPencilJitter = 8.f * 1.1920928955078125e-7f;  // 8 eps(float32)
constexpr float kGramJitter = 1e-6f;
constexpr float kGramFloor = 1e-30f;
// Stage kinds of the timer stamps (tools/tracked_rr_stages.py): what the
// stage just ended did. chol_warp.cuh's own stamps use 9-11.
constexpr int kStampLoad = 1, kStampFactor = 2, kStampInvert = 3, kStampWhiten = 4,
              kStampGram = 5, kStampSmallFactor = 6, kStampApply = 7, kStampPower = 8,
              kStampH = 12, kStampStore = 13;

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int padded(int n) { return n <= 32 ? 32 : n <= 64 ? 64 : 128; }

// One zone's shared memory, as float offsets on 16 bytes, for the padded
// widths np (pencil) and kp (block). Row strides: ldl = np + 1 (odd, for
// chol_warp), ldw = np + 4 and ldy = kp + 4 (float4 rows), ldg = kp + 1.
//   w   abar, then wbar (np x ldw)
//   r1  bbar and lbar (np x ldl); then libar abar^T (np x ldw); then y and
//       wbar y (np x ldy each)
//   r2  libar (np x ldl), then its transpose (np x ldw); then a Gram matrix
//       and its factor (kp x ldg) with the factor's columns laid out for the
//       row solves (kp x (kp + 16)); then h's tiles
//   t   chol_warp's merge scratch; isr its column scales; scratch its own
struct Layout {
  int w, r1, r2, t, isr, scratch, flag, total;
};

__host__ __device__ inline Layout layout(int np, int kp) {
  const int ldl = np + 1, ldw = np + 4, ldy = kp + 4, ldg = kp + 1;
  Layout s;
  s.w = 0;
  s.r1 = s.w + round4(np * ldw);
  s.r2 = s.r1 + round4(imax(imax(np * ldl, np * ldw), 2 * np * ldy));
  s.t = s.r2 + round4(imax(imax(np * ldl, np * ldw), round4(kp * ldg) + kp * (kp + 16)));
  s.isr = s.t + round4((np / 2) * (np / 2 + 1));
  s.scratch = s.isr + round4(np);
  s.flag = s.scratch + chol_warp::kScratch;
  s.total = s.flag + 4;
  return s;
}

// acc += sum over l in [l0, l1) of p[l ldp + i] q[l ldq + j]: a 4 x 4 tile of
// P^T Q, both operands read along their rows, one float4 each a step.
__device__ __forceinline__ void tile_tn(float (&acc)[4][4], const float* p, int ldp,
                                        const float* q, int ldq, int l0, int l1) {
#pragma unroll 4
  for (int l = l0; l < l1; ++l) {
    const float4 pv = *reinterpret_cast<const float4*>(p + l * ldp);
    const float4 qv = *reinterpret_cast<const float4*>(q + l * ldq);
    const float a[4] = {pv.x, pv.y, pv.z, pv.w}, b[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc += sum over l in [l0, l1) (a multiple of 4 long) of p[i ldp + l]
// q[l ldq + j]: a 4 x 4 tile of P Q, four depth indices a step (P's four
// rows and Q's four rows as float4), each entry's sum in depth order.
__device__ __forceinline__ void tile_nn(float (&acc)[4][4], const float* p, int ldp,
                                        const float* q, int ldq, int l0, int l1) {
  for (int l = l0; l < l1; l += 4) {
    float a[4][4], b[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 pv = *reinterpret_cast<const float4*>(p + i * ldp + l);
      const float4 qv = *reinterpret_cast<const float4*>(q + (l + i) * ldq);
      a[i][0] = pv.x, a[i][1] = pv.y, a[i][2] = pv.z, a[i][3] = pv.w;
      b[i][0] = qv.x, b[i][1] = qv.y, b[i][2] = qv.z, b[i][3] = qv.w;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i][u], b[u][j], acc[i][j]);
  }
}

__device__ __forceinline__ void store_tile(float* c, int ldc, const float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(c + i * ldc) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// The same tile entry by entry (a row stride that is not a multiple of 4).
__device__ __forceinline__ void store_tile_scalar(float* c, int ldc, const float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i * ldc + j] = acc[i][j];
}

// log2 of a padded width (32, 64 or 128).
__device__ __forceinline__ int log2_of(int np) { return 31 - __clz(np); }

// x <- sym(x) in place (np x np, stride ld): both entries of a pair take
// 0.5 (x_rc + x_cr), the diagonal stays (0.5 (x + x) = x).
__device__ __forceinline__ void symmetrize(float* x, int ld, int np) {
  const int lnp = log2_of(np);
  for (int e = threadIdx.x; e < np * np; e += kThreads) {
    const int r = e >> lnp, c = e & (np - 1);
    if (r > c) {
      const float v = 0.5f * (x[r * ld + c] + x[c * ld + r]);
      x[r * ld + c] = v;
      x[c * ld + r] = v;
    }
  }
  __syncthreads();
}

// Warp 0: x[i][i] += jitter(trace) for i < n, x[i][i] = 1 for n <= i < np,
// with the trace of the first n diagonal entries summed in a fixed order
// (each lane its entries in row order, then a shuffle tree) and
// jitter(tr) = scale * (tr / n) + floor.
__device__ __forceinline__ void jitter_diagonal(float* x, int ld, int n, int np, float scale,
                                                float floor) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  float tr = 0.f;
  for (int i = lane; i < n; i += 32) tr += x[i * ld + i];
#pragma unroll
  for (int off = 16; off > 0; off /= 2) tr += __shfl_xor_sync(chol_warp::kFull, tr, off);
  const float jitter = scale * (tr / n) + floor;
  for (int i = lane; i < np; i += 32) x[i * ld + i] = i < n ? x[i * ld + i] + jitter : 1.f;
}

struct Args {
  const float* a;  // (z, n, n) s^T A s
  const float* b;  // (z, n, n) s^T B s
  float* h;        // (z, k, k)
  float* y;        // (z, n, k)
  float* libar;    // (z, n, n)
  int n, k;
};

// The zone's shared buffers and sizes.
struct Zone {
  int n, k, np, kp, ldl, ldw, ldy, ldg;
  float *w, *r1, *r2, *t, *isr, *scratch;
  int* fail;
};

// y <- y L^-T in place (np x KP, stride ldy) for the lower factor L in g
// (stride ldg): each row's forward substitution y' L^T = y, four threads a
// row, thread j holding the columns j, j + 4, ...; once column c's value is
// known (its owner scales the running sum by 1 / L[c][c]) it goes to the
// row's other threads by a shuffle and enters every later column's sum, in
// column order. L's columns are first laid out in lt so that each thread
// reads its share of column c as float4 (lt[c][j][w] = L[4 w + j][c] for
// 4 w + j > c, else 0; the four shares KP / 4 + 4 apart, on distinct banks).
template <int KP>
__device__ void solve_lt(const Zone& zn, float* y, const float* g, float* lt) {
  constexpr int kPer = KP / 4, kShare = kPer + 4, kLd = 4 * kShare;
  const int tid = threadIdx.x, j = tid & 3, r = tid >> 2, owner = (tid & 31) & ~3;
  const int ldg = zn.ldg, ldy = zn.ldy;
  for (int e = tid; e < KP * KP; e += kThreads) {
    const int c = e / KP, m = e % KP;
    lt[c * kLd + (m & 3) * kShare + (m >> 2)] = m > c ? g[m * ldg + c] : 0.f;
  }
  const bool active = r < zn.np;
  float acc[kPer], rinv[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int c = 4 * u + j;
    acc[u] = active ? y[r * ldy + c] : 0.f;
    rinv[u] = 1.f / g[c * ldg + c];
  }
  __syncthreads();
  const float* share = lt + j * kShare;
#pragma unroll
  for (int c = 0; c < KP; ++c) {
    const int u = c / 4;
    if (j == (c & 3)) acc[u] *= rinv[u];
    const float v = __shfl_sync(chol_warp::kFull, acc[u], owner | (c & 3));
#pragma unroll
    for (int q = u / 4; q < kPer / 4; ++q) {
      const float4 l4 = *reinterpret_cast<const float4*>(share + c * kLd + 4 * q);
      const float lw[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (4 * q + t >= u) acc[4 * q + t] = fmaf(-lw[t], v, acc[4 * q + t]);
    }
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u)
    if (active) y[r * ldy + 4 * u + j] = acc[u];
  __syncthreads();
}

// y <- CholeskyQR2(y) in place (np x kp, stride ldy; y in rows < n and
// columns < k, zeros elsewhere): two passes of the Gram matrix's lower
// tiles, its trace jitter, its factor, and y <- y L^-T by row solves. The
// Gram's depth is split over thread groups whose partial sums go through
// spare (a free np x ldy buffer) and are added in group order.
__device__ void cholqr2(const Zone& zn, float* y, float* spare) {
  const int tid = threadIdx.x, kp = zn.kp, kt = kp / 4, ldg = zn.ldg, ldy = zn.ldy;
  float* g = zn.r2;
  const int lower = kt * (kt + 1) / 2;
  const int groups = min(min(4, kThreads / lower), 1 + zn.np * ldy / (kp * kp));
  const int grp = tid / lower, t = tid % lower;
  int it = 0;  // lower tile t in row order: (it, jt), jt <= it
  while ((it + 1) * (it + 2) / 2 <= t) ++it;
  const int jt = t - it * (it + 1) / 2;
  const int l0 = grp * zn.n / groups, l1 = (grp + 1) * zn.n / groups;
  for (int pass = 0; pass < 2; ++pass) {
    float acc[4][4] = {};
    if (grp < groups) tile_tn(acc, y + 4 * it, ldy, y + 4 * jt, ldy, l0, l1);
    if (grp > 0 && grp < groups)
      store_tile(spare + (grp - 1) * kp * kp + 4 * it * kp + 4 * jt, kp, acc);
    __syncthreads();
    if (grp == 0) {
      for (int gg = 1; gg < groups; ++gg) {
        const float* part = spare + (gg - 1) * kp * kp + 4 * it * kp + 4 * jt;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += part[i * kp + j];
      }
      store_tile_scalar(g + 4 * it * ldg + 4 * jt, ldg, acc);  // chol_warp reads the lower
    }
    __syncthreads();
    jitter_diagonal(g, ldg, zn.k, kp, kGramJitter, kGramFloor);
    __syncthreads();
    STAGE_STAMP(kStampGram);
    chol_warp::factor(g, ldg, nullptr, 0, zn.isr, zn.scratch, kp, zn.fail);
    STAGE_STAMP(kStampSmallFactor);
    float* lt = g + round4(kp * ldg);
    if (kp == 64)
      solve_lt<64>(zn, y, g, lt);
    else
      solve_lt<32>(zn, y, g, lt);
    STAGE_STAMP(kStampApply);
  }
}

// z = wbar y (np x kp): wbar's rows read as its columns.
__device__ void times_wbar(const Zone& zn, const float* y, float* z) {
  const int kt = zn.kp / 4;
  for (int t = threadIdx.x; t < (zn.np / 4) * kt; t += kThreads) {
    const int rt = t / kt, ct = t % kt;
    float acc[4][4] = {};
    tile_tn(acc, zn.w + 4 * rt, zn.ldw, y + 4 * ct, zn.ldy, 0, zn.n);
    store_tile(z + 4 * rt * zn.ldy + 4 * ct, zn.ldy, acc);
  }
  __syncthreads();
  STAGE_STAMP(kStampPower);
}

__global__ void __launch_bounds__(kThreads) tracked_rr_kernel(Args p) {
  STAGE_STAMP(0);
  const int n = p.n, k = p.k, tid = threadIdx.x;
  Zone zn;
  zn.n = n, zn.k = k, zn.np = padded(n), zn.kp = padded(k);
  const int np = zn.np;
  zn.ldl = np + 1, zn.ldw = np + 4, zn.ldy = zn.kp + 4, zn.ldg = zn.kp + 1;
  const int ldl = zn.ldl, ldw = zn.ldw, ldy = zn.ldy;
  const Layout s = layout(np, zn.kp);
  zn.w = smem + s.w, zn.r1 = smem + s.r1, zn.r2 = smem + s.r2, zn.t = smem + s.t;
  zn.isr = smem + s.isr, zn.scratch = smem + s.scratch;
  zn.fail = reinterpret_cast<int*>(smem + s.flag);
  float *w = zn.w, *r1 = zn.r1, *r2 = zn.r2;
  const size_t zone = blockIdx.x;
  const float* a = p.a + zone * n * n;
  const float* b = p.b + zone * n * n;
  float* h_out = p.h + zone * k * k;
  float* y_out = p.y + zone * n * k;
  float* li_out = p.libar + zone * n * n;

  // abar into w, bbar into r1, padded; a non-finite entry fails the zone.
  bool bad = false;
  const int lnp = log2_of(np), lkp = log2_of(zn.kp);
  for (int e = tid; e < np * np; e += kThreads) {
    const int r = e >> lnp, c = e & (np - 1);
    const bool in = r < n && c < n;
    const float av = in ? a[r * n + c] : 0.f;
    const float bv = in ? b[r * n + c] : (r == c ? 1.f : 0.f);
    bad = bad || !isfinite(av) || !isfinite(bv);
    w[r * ldw + c] = av;
    r1[r * ldl + c] = bv;
  }
  if (tid == 0) *zn.fail = 0;
  __syncthreads();
  if (bad) *zn.fail = 1;
  symmetrize(w, ldw, np);
  symmetrize(r1, ldl, np);
  jitter_diagonal(r1, ldl, n, np, kPencilJitter, 0.f);
  __syncthreads();
  STAGE_STAMP(kStampLoad);

  // lbar in r1, libar in r2.
  chol_warp::factor(r1, ldl, r2, ldl, zn.isr, zn.scratch, np, zn.fail);
  STAGE_STAMP(kStampFactor);
  chol_warp::invert(r1, ldl, r2, ldl, zn.t, np);
  STAGE_STAMP(kStampInvert);

  // libar out; y's first value lbar^T[:, :k] out (read back below, once r1
  // is free); libar^T over libar in place, through registers.
  for (int e = tid; e < n * n; e += kThreads) li_out[e] = r2[(e / n) * ldl + e % n];
  for (int e = tid; e < n * k; e += kThreads) {
    const int r = e / k, c = e % k;
    y_out[e] = c >= r ? r1[c * ldl + r] : 0.f;
  }
  constexpr int kPer = kMaxN * kMaxN / kThreads;
  float held[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = tid + i * kThreads;  // e = c np + r
    held[i] = e < np * np ? r2[(e & (np - 1)) * ldl + (e >> lnp)] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = tid + i * kThreads;
    if (e < np * np) r2[(e >> lnp) * ldw + (e & (np - 1))] = held[i];
  }
  __syncthreads();
  const float* lit = r2;  // libar^T, upper triangular

  // v = abar libar^T into r1: v[l][c] = sum_{m <= c} abar[m][l] libar^T[m][c].
  // A warp's lanes take the row tiles of one column tile (one depth); the
  // second pass takes the column tiles in reverse, so each thread's two
  // depths sum to the same.
  const int tiles = np / 4, per = kThreads / tiles, q = tid / tiles, u = tid % tiles;
  for (int pass = 0; pass < 2; ++pass) {
    if (q >= (pass == 0 ? min(per, tiles) : tiles - per)) continue;
    const int ct = pass == 0 ? q : tiles - 1 - q;
    float acc[4][4] = {};
    tile_tn(acc, w + 4 * u, ldw, lit + 4 * ct, ldw, 0, min(np, 4 * ct + 4));
    store_tile(r1 + 4 * u * ldw + 4 * ct, ldw, acc);
  }
  __syncthreads();
  // wbar = sym(libar v) into w: wbar[r][c] = sum_{l <= r} libar^T[l][r] v[l][c];
  // a warp's lanes take the column tiles of one row tile.
  for (int pass = 0; pass < 2; ++pass) {
    if (q >= (pass == 0 ? min(per, tiles) : tiles - per)) continue;
    const int rt = pass == 0 ? q : tiles - 1 - q;
    float acc[4][4] = {};
    tile_tn(acc, lit + 4 * rt, ldw, r1 + 4 * u, ldw, 0, min(np, 4 * rt + 4));
    store_tile(w + 4 * rt * ldw + 4 * u, ldw, acc);
  }
  __syncthreads();
  symmetrize(w, ldw, np);

  // y's first value back, padded with zeros.
  float* y = r1;
  float* z = r1 + np * ldy;
  for (int e = tid; e < np * zn.kp; e += kThreads) {
    const int r = e >> lkp, c = e & (zn.kp - 1);
    y[r * ldy + c] = r < n && c < k ? y_out[r * k + c] : 0.f;
  }
  __syncthreads();
  STAGE_STAMP(kStampWhiten);

  cholqr2(zn, y, z);
  for (int step = 0; step < 2; ++step) {
    times_wbar(zn, y, z);
    cholqr2(zn, z, y);
    float* swap = y;
    y = z;
    z = swap;
  }
  times_wbar(zn, y, z);
  // h = sym(y^T z): every tile of y^T z into r2 (free again), then h.
  const int kt = zn.kp / 4, ldg = zn.ldg;
  for (int t = tid; t < kt * kt; t += kThreads) {
    const int it = t / kt, jt = t % kt;
    float acc[4][4] = {};
    tile_tn(acc, y + 4 * it, ldy, z + 4 * jt, ldy, 0, n);
    store_tile_scalar(r2 + 4 * it * ldg + 4 * jt, ldg, acc);
  }
  __syncthreads();
  STAGE_STAMP(kStampH);

  const bool failed = *zn.fail != 0;
  const float nan = __int_as_float(0x7fc00000);
  for (int e = tid; e < k * k; e += kThreads) {
    const int i = e / k, j = e % k;
    h_out[e] = failed ? nan : 0.5f * (r2[i * ldg + j] + r2[j * ldg + i]);
  }
  for (int e = tid; e < n * k; e += kThreads) y_out[e] = failed ? nan : y[(e / k) * ldy + e % k];
  if (failed)
    for (int e = tid; e < n * n; e += kThreads) li_out[e] = nan;
  STAGE_STAMP(kStampStore);
}

struct CoordArgs {
  const float* libar;  // (z, n, n)
  const float* y;      // (z, n, k)
  const float* d;      // (z, k) ascending
  const float* v;      // (z, k, k)
  float* c;            // (z, n, k)
  float* lam;          // (z, k) descending
  int n, k;
};

__host__ __device__ inline int coords_floats(int n, int k) {
  const int n4 = round4(n), k4 = round4(k), ldl = n4 + 4, ldk = k4 + 4;
  return n4 * ldl + 2 * n4 * ldk + k4 * ldk;
}

// c = libar^T (y v[:, ::-1]), lam = d[::-1], one block per zone: libar, y
// and v with its columns reversed in shared memory (zero-padded to
// multiples of 4), then the two products in 4 x 4 tiles, the second over
// libar^T's nonzero range (m >= the tile's first row).
__global__ void __launch_bounds__(kThreads) tracked_rr_coords_kernel(CoordArgs p) {
  const int n = p.n, k = p.k, tid = threadIdx.x;
  const int n4 = round4(n), k4 = round4(k), ldl = n4 + 4, ldk = k4 + 4;
  float* li = smem;
  float* ys = li + n4 * ldl;
  float* vf = ys + n4 * ldk;
  float* ts = vf + k4 * ldk;
  const size_t zone = blockIdx.x;
  const float* libar = p.libar + zone * n * n;
  const float* y = p.y + zone * n * k;
  const float* d = p.d + zone * k;
  const float* v = p.v + zone * k * k;
  float* c = p.c + zone * n * k;
  float* lam = p.lam + zone * k;
  for (int e = tid; e < n4 * n4; e += kThreads) {
    const int r = e / n4, col = e % n4;
    li[r * ldl + col] = r < n && col < n ? libar[r * n + col] : 0.f;
  }
  for (int e = tid; e < n4 * k4; e += kThreads) {
    const int r = e / k4, col = e % k4;
    ys[r * ldk + col] = r < n && col < k ? y[r * k + col] : 0.f;
  }
  for (int e = tid; e < k4 * k4; e += kThreads) {
    const int r = e / k4, col = e % k4;
    vf[r * ldk + col] = r < k && col < k ? v[r * k + k - 1 - col] : 0.f;
  }
  for (int j = tid; j < k; j += kThreads) lam[j] = d[k - 1 - j];
  __syncthreads();
  const int kt = k4 / 4, tiles = (n4 / 4) * kt;
  for (int t = tid; t < tiles; t += kThreads) {
    const int rt = t / kt, ct = t % kt;
    float acc[4][4] = {};
    tile_nn(acc, ys + 4 * rt * ldk, ldk, vf + 4 * ct, ldk, 0, k4);
    store_tile(ts + 4 * rt * ldk + 4 * ct, ldk, acc);
  }
  __syncthreads();
  for (int t = tid; t < tiles; t += kThreads) {
    const int rt = t / kt, ct = t % kt;
    float acc[4][4] = {};
    tile_tn(acc, li + 4 * rt, ldl, ts + 4 * ct, ldk, 4 * rt, n4);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * rt + i < n && 4 * ct + j < k) c[(4 * rt + i) * k + 4 * ct + j] = acc[i][j];
  }
}

}  // namespace

// a, b (z, n, n) -> h (z, k, k), y (z, n, k), libar (z, n, n); float32,
// contiguous; 2 k <= n <= 128.
extern "C" int tracked_rr_launch(const float* a, const float* b, float* h, float* y,
                                 float* libar, int z, int n, int k, cudaStream_t stream) {
  if (z < 1 || k < 1 || 2 * k > n || n > kMaxN) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)layout(padded(n), padded(k)).total * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(tracked_rr_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  tracked_rr_kernel<<<z, kThreads, bytes, stream>>>(Args{a, b, h, y, libar, n, k});
  return (int)cudaGetLastError();
}

// libar (z, n, n), y (z, n, k), d (z, k), v (z, k, k) -> c (z, n, k),
// lam (z, k); float32, contiguous; k <= n <= 128.
extern "C" int tracked_rr_coords_launch(const float* libar, const float* y, const float* d,
                                        const float* v, float* c, float* lam, int z, int n,
                                        int k, cudaStream_t stream) {
  if (z < 1 || k < 1 || k > n || n > kMaxN) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)coords_floats(n, k) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(tracked_rr_coords_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  tracked_rr_coords_kernel<<<z, kThreads, bytes, stream>>>(CoordArgs{libar, y, d, v, c, lam, n, k});
  return (int)cudaGetLastError();
}
