// K4: batched small symmetric eigensolver, cyclic parallel Jacobi.
//
// Replaces apvast_tpu/ops/pallas/jacobi_eigh.py::jacobi_eigh (the kernel
// body _kernel plus the wrapper's sort-free ranking). The TPU kernel ran
// every round as three n x n MXU products A <- M^T (A M), V <- V M with the
// rotation-permutation matrix M = R P: R rotates each slot pair (2i, 2i+1)
// by the angle that zeroes A[2i, 2i+1], and P moves the slots one step
// along the round-robin tournament ring (src[c] = the slot whose occupant
// moves into slot c). Each column of M has two nonzeros, so here a round
// is an O(n^2) gather-and-rotate:
//   r1 = src[c1], r2 = src[c2], p = partner slot (r ^ 1),
//   (A M)[a, c2]   = A[a, r2] R[r2, r2] + A[a, p2] R[p2, r2],
//   A'[c1, c2]     = R[r1, r1] (A M)[r1, c2] + R[p1, r1] (A M)[p1, c2],
//   V'[row, c2]    = V[row, r2] R[r2, r2] + V[row, p2] R[p2, r2],
// with R[r, r] = c and R[partner(r), r] = -s for even r, +s for odd r.
// The angle keeps the TPU formula: theta = A[q,q] - A[p,p], sign +1 for
// theta >= 0, t = 2 apq sign / (|theta| + sqrt(theta^2 + 4 apq^2) + 1e-30),
// c = 1/sqrt(1 + t^2) (IEEE sqrt and division: built without fast math,
// so the 1e-30 guard stays a normal float and no rsqrt approximation
// changes the rotations), s = t c.
//
// Bound on the H100: latency. At the production shape (2, 64, 64) with 2
// sweeps the work is 2 * 63 dependent rounds per matrix; bytes ~ 3 * 2 *
// 64^2 * 4 B = 98 KB (0.03 us at 3.35 TB/s) and operations ~ 2 * 2 * 63 *
// 9 * 64^2 = 9.3 MFLOP (0.14 us at 67 TFLOP/s), while every round waits on
// the one before it, and the batch of 2 keeps 2 of the 132 SMs busy.
// Up to 64 padded slots K4 runs the pair-block form (jacobi_pair_kernel,
// below): A rotated in place along a relabeled pair table, V's rows in
// registers, one block barrier a round, the same rotations and the same
// bits as the template form that follows, which serves wider matrices and
// stays reachable at every width (jacobi_eigh_template_launch).
// The template form: one thread block per matrix (grid = batch); A and V (npad x npad,
// zero-padded, V = I) stay in shared memory for all sweeps. Each thread
// owns a fixed set of entries (c1, c2); the schedule is fixed, so the
// slots it gathers from (r1, r2 and their partners) are computed once,
// packed into one register per entry, and the rotation pairs are read as
// (c, s) float2s: a round costs six loads of A and V and two of the pair
// table per entry, no integer division. Up to npad = 64 A and V are
// double-buffered (64 KB of dynamic shared memory), so a round is two
// phases between barriers: npad/2 threads compute the pair rotations, then
// every thread writes its new entries into the other buffer. Above that
// (npad <= 128, 128 KB) one buffer each: the new entries wait in registers
// for a third barrier. After the last sweep the same launch ranks the
// diagonal (pad slots keyed to +inf, ties to the lower index) and writes w
// ascending and the matching columns of V, so the kernel runs once per
// Rayleigh-Ritz solve.
// Wider matrices (the JAX functions have no width bound): up to npad = 160
// A and V still fit one block's shared memory single-buffered (205 KB of
// the 227 KB), with 512 threads of 50 entries each whose new values wait in
// registers (the slots they gather from are recomputed every round, not
// kept in registers); above that, up to npad = 512, a global-memory form of
// the same template keeps A, V and their second buffers in a workspace the
// wrapper allocates (4 npad^2 floats a matrix, 1 MB at npad = 256, L2
// resident), with only the pair table and the ranking in shared memory.
// Both run one block per matrix and the same rounds, so they give the
// shared forms' results; past npad = 512 the wrapper raises.
//
// K7: batched small complex Hermitian eigensolver (the FD engine's per-bin
// eigh), replacing apvast_tpu/ops/pallas/jacobi_eigh.py::
// jacobi_eigh_hermitian, which runs K4 on the real embedding
// T = [[X, -Y], [Y, X]] of H = X + iY (2n slots) and then picks one column
// of every J-pair. Here the same kernel body is a template with the form as
// its parameter (HERM), so K4's instantiations are the code they were and
// K7 runs exactly K4's sweeps and ranking in one launch per batch: the
// prologue builds T in shared memory from the interleaved complex input
// (never in HBM), and the epilogue takes w = w2[0::2] and q = the even
// columns as complex vectors, replaces a column whose overlap with the one
// before exceeds 0.7 by its odd neighbour (and its eigenvalue by
// w2[2j + 1]), and runs the one Gram-Schmidt pass of the TPU wrapper
// against the previous, uncorrected column. Bound: latency again. At the FD
// shape (1602, 16, 16) -> 32 slots, 6 sweeps: 186 dependent rounds per
// pencil, ~2.7 GFLOP in all (0.04 ms at 67 TFLOP/s) against ~6.6 MB of
// input and output (0.002 ms). Up to 64 slots K7 runs the HERM pair-block
// form (jacobi_pair_kernel: a few warps a pencil, two barriers a round);
// K4's template form serves wider pencils. (The first designs ran K4's
// double-buffered rounds, each round's rotations on np/2 threads between
// two block barriers and every entry gathered from six places: PERF.md,
// section 6.)

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

#ifndef STAGE_STAMP
#define STAGE_STAMP(kind)  // timer stamps: only tools/k2_k4_stages.py's build has them
#define STAGE_STAMP_AT(kind, thread, slot)  // likewise, by another thread of block 0
#endif

// K4's warp count at 64 slots and its round form, chosen on the card among
// 4-16 warps, pipelined (at least 5 warps) or with two barriers a round
// (PERF.md, section 6; tools/k2_k4_stages.py builds the others with -D).
#ifndef K4_PAIR_WARPS
#define K4_PAIR_WARPS 16
#endif
#ifndef K4_PIPELINED
#define K4_PIPELINED 1
#endif


namespace {

constexpr int kMaxThreads = 1024;

constexpr int kSharedSlots = 160;  // the widest single-buffered shared form
constexpr int kWideThreads = 512;
constexpr int kWidePer = kSharedSlots * kSharedSlots / kWideThreads;  // 50
constexpr int kMaxSlots = 512;  // the global form's bound
constexpr int kMaxDevices = 64;

// Raise `kernel`'s dynamic shared-memory limit on the current device to at
// least `bytes`, with one driver call the first time (and again only when a
// wider pencil needs more): the attribute stays set, so the host-bound hop
// pays no driver call a launch. `granted` is the caller's per-device record
// (a function-local static of the launching instantiation).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, std::atomic<int> (&granted)[kMaxDevices]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && granted[dev].load() >= (int)bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess && dev < kMaxDevices) granted[dev].store((int)bytes);
  return e;
}

// Entry e of the thread's k-th slot: c1 = e / np, c2 = e % np, and the
// occupants moving into them, r1 = src[c1], r2 = src[c2], packed 10 bits each.
__device__ __forceinline__ unsigned pack_entry(int e, int np, const int* src) {
  const int c1 = e / np, c2 = e % np;
  return (unsigned)c1 | ((unsigned)src[c1] << 10) | ((unsigned)src[c2] << 20);
}

// A'[c1, c2] and V'[c1, c2] of one round. R[r, r] = c, R[partner(r), r] =
// -s for even r and +s for odd r, with (c, s) of pair r / 2.
__device__ __forceinline__ void rotate_entry(unsigned packed, int np, const float* A,
                                             const float* V, const float2* cs,
                                             float& a_out, float& v_out) {
  const int c1 = packed & 0x3ff, r1 = (packed >> 10) & 0x3ff, r2 = packed >> 20;
  const int p1 = r1 ^ 1, p2 = r2 ^ 1;
  const float2 g1 = cs[r1 >> 1], g2 = cs[r2 >> 1];
  const float o1 = (r1 & 1) ? g1.y : -g1.y;
  const float o2 = (r2 & 1) ? g2.y : -g2.y;
  const float am_r = A[r1 * np + r2] * g2.x + A[r1 * np + p2] * o2;
  const float am_p = A[p1 * np + r2] * g2.x + A[p1 * np + p2] * o2;
  a_out = g1.x * am_r + o1 * am_p;
  v_out = V[c1 * np + r2] * g2.x + V[c1 * np + p2] * o2;
}

// (c, s) of the rotation that zeroes apq in [[app, apq], [apq, aqq]].
__device__ __forceinline__ float2 rotation(float app, float aqq, float apq) {
  const float theta = aqq - app;
  const float sg = theta >= 0.f ? 1.f : -1.f;
  const float denom = fabsf(theta) + sqrtf(theta * theta + 4.f * apq * apq) + 1e-30f;
  const float t = 2.f * apq * sg / denom;
  const float c = 1.f / sqrtf(1.f + t * t);
  return make_float2(c, t * c);
}

// The rotation of pair i = (2i, 2i+1) that zeroes A[2i, 2i+1], for
// i = tid, tid + nt, ... < np / 2.
__device__ __forceinline__ void pair_rotations(const float* A, float2* cs, int np,
                                               int tid, int nt) {
  for (int i = tid; i < np / 2; i += nt) {
    const int p = 2 * i, q = p + 1;
    cs[i] = rotation(A[p * np + p], A[q * np + q], A[p * np + q]);
  }
}

// Ascending rank of every slot of A's diagonal (pad slots, i >= n, keyed to
// +inf, ties to the lower index); cnt[r] counts the slots of rank r (zeroed
// by the caller) and first[r] is one of them.
__device__ void rank_slots(const float* A, int* rank, int* cnt, int* first, int n, int np,
                           int tid, int nt) {
  for (int i = tid; i < np; i += nt) {
    const float ki = i < n ? A[i * np + i] : INFINITY;
    int r = 0;
#pragma unroll 16
    for (int j = 0; j < np; ++j) {
      const float kj = j < n ? A[j * np + j] : INFINITY;
      r += (kj < ki) || (kj == ki && j < i);
    }
    rank[i] = r;
    if (r < n) {
      atomicAdd(&cnt[r], 1);
      first[r] = i;  // used only where exactly one slot has rank r
    }
  }
}

// K4's epilogue after the ranking: w (n) ascending and v (n x n) of one
// matrix. Output column c gathers the slots of rank c (the one-hot
// contraction of the TPU wrapper: a sum when NaNs collide ranks, 0 when
// none). As in that contraction, where 0 x NaN is NaN, every w is NaN when
// a diagonal slot is not finite, and every v of row r when a slot of V's
// row r is not; `flag` (n ints) holds the rows' findings. V's rows are ldv
// floats apart.
__device__ void real_outputs(const float* A, const float* V, int ldv, const int* rank,
                             const int* cnt, const int* first, int* flag, int n, int np,
                             int tid, int nt,
                             float* w_out, float* v_out) {
  for (int r = tid; r < n; r += nt) {
    bool bad = false;
#pragma unroll 16
    for (int i = 0; i < np; ++i) bad |= !isfinite(V[r * ldv + i]);
    flag[r] = bad;
  }
  for (int c = tid; c < n; c += nt) {
    bool bad = false;
#pragma unroll 16
    for (int i = 0; i < np; ++i) bad |= !isfinite(A[i * (np + 1)]);
    float s = 0.f;
    if (cnt[c] == 1) {
      s = A[first[c] * (np + 1)];
    } else if (cnt[c] > 1) {
      for (int i = 0; i < np; ++i)
        if (rank[i] == c) s += A[i * (np + 1)];
    }
    w_out[c] = bad ? NAN : s;
  }
  __syncthreads();
  for (int e = tid; e < n * n; e += nt) {
    const int r = e / n, c = e % n;
    float s = 0.f;
    if (flag[r]) {
      s = NAN;
    } else if (cnt[c] == 1) {
      s = V[r * ldv + first[c]];
    } else if (cnt[c] > 1) {
      for (int i = 0; i < np; ++i)
        if (rank[i] == c) s += V[r * ldv + i];
    }
    v_out[e] = s;
  }
}

// The Hermitian epilogue (K7) after the ranking: w (n) and q (n x n
// complex, interleaved) of one pencil from the 2n real slots. S (2n x 2n,
// row stride np) receives the ranked columns of V (row stride ldv); w2 the
// ranked diagonal.
__device__ void hermitian_pairs(const float* A, const float* V, int ldv, const int* rank,
                                const int* cnt, const int* first, float* S, float* w2,
                                int* dup, float* ofs, int n, int np, int tid, int nt,
                                float* w_out, float* q_out) {
  const int nr = 2 * n;
  for (int c = tid; c < nr; c += nt) {
    float s = 0.f;
    if (cnt[c] == 1) {
      s = A[first[c] * (np + 1)];
    } else if (cnt[c] > 1) {
      for (int i = 0; i < np; ++i)
        if (rank[i] == c) s += A[i * (np + 1)];
    }
    w2[c] = s;
  }
  __syncthreads();  // S may be A itself (single-buffered forms)
  for (int e = tid; e < nr * nr; e += nt) {
    const int r = e / nr, c = e % nr;
    float s = 0.f;
    if (cnt[c] == 1) {
      s = V[r * ldv + first[c]];
    } else if (cnt[c] > 1) {
      for (int i = 0; i < np; ++i)
        if (rank[i] == c) s += V[r * ldv + i];
    }
    S[r * np + c] = s;
  }
  __syncthreads();
  // Column j of q is S[:n, 2j] + i S[n:, 2j]; it duplicates column j - 1
  // when |q_{j-1}^H q_j| > 0.7 (a NaN overlap is no duplicate).
  for (int j = tid; j < n; j += nt) {
    bool d = false;
    if (j > 0) {
      float re = 0.f, im = 0.f;
      for (int r = 0; r < n; ++r) {
        const float ar = S[r * np + 2 * j - 2], ai = S[(r + n) * np + 2 * j - 2];
        const float br = S[r * np + 2 * j], bi = S[(r + n) * np + 2 * j];
        re += ar * br + ai * bi;
        im += ar * bi - ai * br;
      }
      d = sqrtf(re * re + im * im) > 0.7f;
    }
    dup[j] = d;
    w_out[j] = w2[2 * j + d];
  }
  __syncthreads();
  // One Gram-Schmidt pass: corr_j = q_j - q_{j-1} (q_{j-1}^H q_j) over
  // max(|corr_j|, FLT_MIN), with q_{j-1} the selected, uncorrected column.
  for (int j = 1 + tid; j < n; j += nt) {
    const int cp = 2 * j - 2 + dup[j - 1], cq = 2 * j + dup[j];
    float ore = 0.f, oim = 0.f;
    for (int r = 0; r < n; ++r) {
      const float ar = S[r * np + cp], ai = S[(r + n) * np + cp];
      const float br = S[r * np + cq], bi = S[(r + n) * np + cq];
      ore += ar * br + ai * bi;
      oim += ar * bi - ai * br;
    }
    float ss = 0.f;
    for (int r = 0; r < n; ++r) {
      const float ar = S[r * np + cp], ai = S[(r + n) * np + cp];
      const float cr = S[r * np + cq] - (ar * ore - ai * oim);
      const float ci = S[(r + n) * np + cq] - (ar * oim + ai * ore);
      ss += cr * cr + ci * ci;
    }
    const float nrm = sqrtf(ss);
    ofs[3 * j] = ore;
    ofs[3 * j + 1] = oim;
    ofs[3 * j + 2] = isnan(nrm) ? nrm : fmaxf(nrm, 1.17549435e-38f);  // FLT_MIN
  }
  __syncthreads();
  for (int e = tid; e < n * n; e += nt) {
    const int r = e / n, j = e % n;
    const int cq = 2 * j + dup[j];
    float qr = S[r * np + cq], qi = S[(r + n) * np + cq];
    if (j > 0) {
      const int cp = 2 * j - 2 + dup[j - 1];
      const float ar = S[r * np + cp], ai = S[(r + n) * np + cp];
      const float ore = ofs[3 * j], oim = ofs[3 * j + 1], nrm = ofs[3 * j + 2];
      qr = (qr - (ar * ore - ai * oim)) / nrm;
      qi = (qi - (ar * oim + ai * ore)) / nrm;
    }
    q_out[2 * e] = qr;
    q_out[2 * e + 1] = qi;
  }
}

// PER entries per thread (np^2 <= PER * blockDim.x); DOUBLE: A and V have
// a second buffer each. GLOBAL: A, V and their second buffers live in the
// workspace `work` (4 np^2 floats a matrix), not in shared memory; PER is
// unused and every thread walks its entries e = tid, tid + nt, ... HERM (K7):
// the input is a batch of n x n complex Hermitian matrices, interleaved
// (re, im), embedded into 2n real slots; the outputs are w (bz, n) and q
// (bz, n, n) interleaved. THREADS: the launch bound. Up to PER = 16 the
// packed slots of each entry stay in registers; above, they are recomputed
// every round, so that the new entries alone take the registers. One block
// an SM is the bound's promise, so ptxas may give a thread 65536 / THREADS
// registers.
template <int PER, bool DOUBLE, bool HERM, bool GLOBAL = false, int THREADS = kMaxThreads>
__global__ void __launch_bounds__(THREADS, 1)
jacobi_eigh_kernel(const float* __restrict__ a, const int* __restrict__ src_g,
                   float* __restrict__ w_out, float* __restrict__ v_out, float* work,
                   int n_in, int np, int sweeps) {
  extern __shared__ float smem[];
  constexpr bool kPacked = PER <= 16 && !GLOBAL;
  const int n = HERM ? 2 * n_in : n_in;  // real slots in use
  const int nn = np * np;
  float* A = GLOBAL ? work + (size_t)blockIdx.x * 4 * nn : smem;
  float* V = A + nn;
  float* A2 = DOUBLE ? V + nn : nullptr;
  float* V2 = DOUBLE ? A2 + nn : nullptr;
  float2* cs = reinterpret_cast<float2*>(GLOBAL ? smem : V + (DOUBLE ? 3 : 1) * nn);  // np / 2
  int* src = reinterpret_cast<int*>(cs + np / 2);
  int* rank = src + np;
  int* cnt = rank + np;
  int* first = cnt + np;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  if constexpr (HERM) {
    // T = [[X, -Y], [Y, X]] from H = X + iY, built here and never in HBM.
    const float2* hb = reinterpret_cast<const float2*>(a) + (size_t)b * n_in * n_in;
    for (int e = tid; e < nn; e += nt) {
      const int r = e / np, c = e % np;
      float t = 0.f;
      if (r < n && c < n) {
        const bool top = r < n_in, left = c < n_in;
        const float2 z = hb[(top ? r : r - n_in) * n_in + (left ? c : c - n_in)];
        t = top == left ? z.x : (top ? -z.y : z.y);
      }
      A[e] = t;
      V[e] = (r == c) ? 1.f : 0.f;
    }
  } else {
    const float* ab = a + (size_t)b * n * n;
    for (int e = tid; e < nn; e += nt) {
      const int r = e / np, c = e % np;
      A[e] = (r < n && c < n) ? ab[r * n + c] : 0.f;
      V[e] = (r == c) ? 1.f : 0.f;
    }
  }
  for (int i = tid; i < np; i += nt) {
    src[i] = src_g[i];
    cnt[i] = 0;
  }
  __syncthreads();

  // The packed slots of the thread's entries (kPacked), else recomputed.
  unsigned packed[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int e = tid + k * nt;
    packed[k] = kPacked && e < nn ? pack_entry(e, np, src) : 0u;
  }

  for (int sw = 0; sw < sweeps; ++sw) {
    for (int round = 0; round < np - 1; ++round) {
      pair_rotations(A, cs, np, tid, nt);
      __syncthreads();
      if constexpr (GLOBAL) {
        for (int e = tid; e < nn; e += nt)
          rotate_entry(pack_entry(e, np, src), np, A, V, cs, A2[e], V2[e]);
        __syncthreads();
        float* t = A; A = A2; A2 = t;
        t = V; V = V2; V2 = t;
      } else if constexpr (DOUBLE) {
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          const int e = tid + k * nt;
          if (e < nn) rotate_entry(packed[k], np, A, V, cs, A2[e], V2[e]);
        }
        __syncthreads();
        float* t = A; A = A2; A2 = t;
        t = V; V = V2; V2 = t;
      } else {
        float ra[PER], rv[PER];
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          const int e = tid + k * nt;
          if (e < nn) {
            const unsigned slots = kPacked ? packed[k] : pack_entry(e, np, src);
            rotate_entry(slots, np, A, V, cs, ra[k], rv[k]);
          }
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          const int e = tid + k * nt;
          if (e < nn) {
            A[e] = ra[k];
            V[e] = rv[k];
          }
        }
        __syncthreads();
      }
    }
  }

  rank_slots(A, rank, cnt, first, n, np, tid, nt);
  __syncthreads();
  if constexpr (HERM) {
    // A's diagonal is read into w2 before S overwrites A.
    int* dup = first + np;
    float* w2 = reinterpret_cast<float*>(dup + np);
    float* ofs = w2 + np;  // (o_re, o_im, clamped norm) per column
    hermitian_pairs(A, V, np, rank, cnt, first, DOUBLE ? A2 : A, w2, dup, ofs, n_in, np,
                    tid, nt, w_out + (size_t)b * n_in,
                    v_out + (size_t)b * n_in * n_in * 2);
    return;
  }
  // The schedule is done with: src holds real_outputs' row flags.
  real_outputs(A, V, np, rank, cnt, first, src, n, np, tid, nt, w_out + (size_t)b * n,
               v_out + (size_t)b * n * n);
}

template <int PER, bool DOUBLE, bool HERM, bool GLOBAL = false, int THREADS = kMaxThreads>
int launch(const float* a, const int* src, float* w, float* v, float* work, int bz, int n,
           int np, int sweeps, int threads, cudaStream_t stream) {
  const size_t nn = GLOBAL ? 0 : (size_t)np * np;
  // HERM adds dup (np ints), w2 (np floats) and three floats per column.
  const size_t smem = (DOUBLE ? 4 : 2) * nn * sizeof(float) + (np / 2) * sizeof(float2) +
                      4 * np * sizeof(int) + (HERM ? 5 * np * sizeof(float) : 0);
  static std::atomic<int> granted[kMaxDevices];
  auto kernel = jacobi_eigh_kernel<PER, DOUBLE, HERM, GLOBAL, THREADS>;
  cudaError_t e = allow_smem(kernel, smem, granted);
  if (e != cudaSuccess) return (int)e;
  kernel<<<bz, threads, smem, stream>>>(a, src, w, v, work, n, np, sweeps);
  return (int)cudaGetLastError();
}

// K4's launch shape for np slots: one entry of A and V per thread up to
// 1024 threads, double buffers up to np = 64, single buffers up to 128
// (1024 threads) and kSharedSlots (512 threads), then the global form. K7
// (HERM) comes here only past 64 slots, so its double-buffered forms are
// not built.
template <bool HERM>
int dispatch(const float* a, const int* src, float* w, float* v, float* work, int bz, int n,
             int np, int sweeps, cudaStream_t stream) {
  const int nn = np * np;
  const int threads = nn < kMaxThreads ? nn : kMaxThreads;
  if constexpr (!HERM) {
    if (nn <= threads)
      return launch<1, true, HERM>(a, src, w, v, work, bz, n, np, sweeps, threads, stream);
    if (nn <= 4 * threads)
      return launch<4, true, HERM>(a, src, w, v, work, bz, n, np, sweeps, threads, stream);
  }
  if (nn <= 16 * threads)
    return launch<16, false, HERM>(a, src, w, v, work, bz, n, np, sweeps, threads, stream);
  if (np <= kSharedSlots)
    return launch<kWidePer, false, HERM, false, kWideThreads>(a, src, w, v, work, bz, n, np,
                                                              sweeps, kWideThreads, stream);
  return launch<1, true, HERM, true>(a, src, w, v, work, bz, n, np, sweeps, kMaxThreads,
                                     stream);
}

// The pair-block form, up to kPairSlots slots, of K4 (real input) and K7
// (HERM: complex input on its real embedding): the same rotations in the
// same order as K4's template form (jacobi_eigh_kernel), with the same
// products and contractions, without moving A. A pure permutation is
// exact, so instead of writing P^T (R^T A R) P into a second buffer every
// round rotates, in place, the physical slots that hold the round's pairs,
// (pos_k(2i), pos_k(2i+1)) with pos_{k+1}(c) = pos_k(src[c]); after the
// np - 1 rounds of a sweep pos is the identity again, so the ranking and
// the epilogue read the slots they always did. The host builds that table
// once per np (ops/kernels/jacobi_eigh.py::pair_table): one int a pair,
// P | Q << 8 | swap << 16, where swap picks which of the pair's two
// columns a thread loads first, so that at 64 slots the 32 columns of one
// warp-wide load lie on 32 distinct banks (at 32 slots the row parity does
// it). One block of WARPS warps per matrix. Threads rotate whole 2 x 2
// pair blocks of A in shared memory (rows {P_i, Q_i} x columns {P_j, Q_j}:
// every value loaded and stored once a round, a batch of blocks loaded
// before any is stored), and np threads each rotate one row of V, held in
// registers in the moving schedule's order (the column moves are
// compile-time register moves), and store them at a stride of np + 1 at
// the end (a warp's rows on 32 banks). A round's pair i is one 16-byte load
// for the blocks' rows (pair_info: c, s and the byte offsets of rows P_i
// and Q_i). Two round forms:
//  - two barriers (PIPE false; K7): np/2 threads compute the round's
//    rotations into cs; a barrier; the blocks, which partition A, are
//    rotated in place; a barrier. The rotations' chain of IEEE square
//    roots and divisions (~0.3 us) and the updates run one after the
//    other.
//  - pipelined (PIPE true; K4): warp 0 computes the next round's
//    rotations while the other warps update this round. The next round's
//    pairs read their three entries from 2 x 2 blocks of this round: the
//    diagonal blocks and up to np/2 others (ops/kernels/jacobi_eigh.py::
//    export_table). One or two producer warps rotate those first and
//    arrive at a named barrier, on which warp 0 waits; then it reads the
//    entries (no other warp writes them) and writes the next round's
//    rotations into the second of two buffers, while V's warps rotate V
//    and the others the rest of A (skipping the export blocks, by a bit
//    mask a round). One block barrier ends the round; each role runs its
//    own loop over the rounds, so that V's rows take registers in V's
//    threads alone.
// The real form's prologue reads the input matrix and its epilogue is K4's
// ranking and output gather (real_outputs); the HERM form builds the
// embedding and ends with hermitian_pairs. ptxas, and the timings of the
// warp counts, the round forms and the first designs: PERF.md, section 6.
constexpr int kPairSlots = 64;

template <int WARPS>
__device__ __forceinline__ void pencil_sync() {
  if constexpr (WARPS == 1) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// Named barrier 1 (barrier 0 is __syncthreads) of n threads, whole warps:
// the arriving warps go on, the syncing ones wait for all n.
__device__ __forceinline__ void named_sync(int n) {
  asm volatile("bar.sync 1, %0;" ::"r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int n) {
  asm volatile("bar.arrive 1, %0;" ::"r"(n) : "memory");
}

__device__ __forceinline__ int slot_p(int e) { return e & 0xff; }
__device__ __forceinline__ int slot_q(int e) { return (e >> 8) & 0xff; }

// A pair's two slots in load order, (first, second), as swap(e) ^ parity
// picks, and o, the sign of s in the first slot's update: with x0, x1 the
// values at first and second, the rotation of rotate_entry is
//   x0' = x0 c + x1 o,  x1' = x1 c - x0 o,  o = -s if first is P, else +s,
// the same products and contractions in either order.
__device__ __forceinline__ void load_order(int e, int parity, float s, int& first, int& second,
                                           float& o) {
  const bool swp = ((e >> 16) ^ parity) & 1;
  first = swp ? slot_q(e) : slot_p(e);
  second = swp ? slot_p(e) : slot_q(e);
  o = swp ? s : -s;
}

// A round's pair i for the blocks' rows: (c, s) and the byte offsets in A
// of its rows P and Q (written with the rotations), one 16-byte load.
__device__ __forceinline__ float4 pair_info(float2 g, int p, int q, int np) {
  return make_float4(g.x, g.y, __int_as_float(p * np * 4), __int_as_float(q * np * 4));
}

__device__ __forceinline__ float ld(const float* A, int bytes) {
  return *reinterpret_cast<const float*>(reinterpret_cast<const char*>(A) + bytes);
}
__device__ __forceinline__ void st(float* A, int bytes, float x) {
  *reinterpret_cast<float*>(reinterpret_cast<char*>(A) + bytes) = x;
}

// One 2 x 2 pair block (i, j), t = i * np/2 + j, of a round: rows
// {P_i, Q_i} x columns {P_j, Q_j} (byte offsets a[row][column] in load
// order), loaded, then rotated and stored.
struct PairBlock {
  float v[4], o, c, ci, si;
  int a[4];
};

// The column pair j of a thread's blocks: the byte offsets of its slots in
// load order at row parity 0 and the signed sine; parity 1 swaps the slots
// and the sign.
struct ColPair {
  int c0, c1;
  float o, c;
};

__device__ __forceinline__ ColPair col_pair(const int* pr, const float2* cs, int j) {
  ColPair q;
  const float2 gj = cs[j];
  load_order(pr[j], 0, gj.y, q.c0, q.c1, q.o);
  q.c0 *= 4;
  q.c1 *= 4;
  q.c = gj.x;
  return q;
}

__device__ __forceinline__ PairBlock load_block(const float* A, const float4* info, int i,
                                                const ColPair& q) {
  PairBlock k;
  const float4 pi = info[i];
  const int r0 = __float_as_int(pi.z), r1 = __float_as_int(pi.w);
  const bool odd = i & 1;
  const int c0 = odd ? q.c1 : q.c0, c1 = odd ? q.c0 : q.c1;
  k.o = odd ? -q.o : q.o;
  k.c = q.c;
  k.ci = pi.x;
  k.si = pi.y;
  k.a[0] = r0 + c0;
  k.a[1] = r0 + c1;
  k.a[2] = r1 + c0;
  k.a[3] = r1 + c1;
#pragma unroll
  for (int e = 0; e < 4; ++e) k.v[e] = ld(A, k.a[e]);
  return k;
}

template <int NP>
__device__ __forceinline__ PairBlock load_block(const float* A, const int* pr, const float2* cs,
                                                const float4* info, int t) {
  return load_block(A, info, t / (NP / 2), col_pair(pr, cs, t % (NP / 2)));
}

__device__ __forceinline__ void store_block(float* A, const PairBlock& k) {
  // Columns: A R.
  const float m0 = __fmaf_rn(k.v[0], k.c, __fmul_rn(k.v[1], k.o));
  const float m1 = __fmaf_rn(k.v[1], k.c, __fmul_rn(k.v[0], -k.o));
  const float q0 = __fmaf_rn(k.v[2], k.c, __fmul_rn(k.v[3], k.o));
  const float q1 = __fmaf_rn(k.v[3], k.c, __fmul_rn(k.v[2], -k.o));
  // Rows: P <- c (AR)[P] - s (AR)[Q], Q <- c (AR)[Q] + s (AR)[P].
  st(A, k.a[0], __fmaf_rn(k.ci, m0, __fmul_rn(-k.si, q0)));
  st(A, k.a[1], __fmaf_rn(k.ci, m1, __fmul_rn(-k.si, q1)));
  st(A, k.a[2], __fmaf_rn(k.ci, q0, __fmul_rn(k.si, m0)));
  st(A, k.a[3], __fmaf_rn(k.ci, q1, __fmul_rn(k.si, m1)));
}

// One round's update of A in place: the pair blocks t = ut + x KT of this
// thread, but those whose bit is set in `skip` (MASKED). Where KT is a
// multiple of np/2 every block of the thread has the same column pair,
// loaded once. The blocks partition A, so each batch of BATCH blocks is
// loaded whole before any of it is stored, and loaded without branches
// (a block past the end, or skipped, is read from `idle`, an np x np area
// that no thread writes during the rounds, and not stored): the pair-table
// loads, the address arithmetic and the loads of all of the batch's blocks
// are in flight together.
template <int NP, int KT, int BATCH, bool MASKED>
__device__ __forceinline__ void rotate_blocks(float* A, const float* idle, const int* pr,
                                              const float2* cs, const float4* info,
                                              const int* skip, int ut) {
  constexpr int kHalf = NP / 2, kBlocks = kHalf * kHalf;
  constexpr int kPer = (kBlocks + KT - 1) / KT;
  constexpr bool kOneColumn = KT % kHalf == 0;
  ColPair q{};
  if constexpr (kOneColumn) q = col_pair(pr, cs, ut % kHalf);
#pragma unroll
  for (int x0 = 0; x0 < kPer; x0 += BATCH) {
    constexpr int kB = BATCH;
    PairBlock k[kB];
    bool ok[kB];
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      if (x0 + b >= kPer) continue;
      const int t = ut + (x0 + b) * KT;
      ok[b] = kBlocks % KT == 0 || t < kBlocks;
      const int tv = ok[b] ? t : 0;
      if (MASKED) ok[b] = ok[b] && !((skip[tv >> 5] >> (tv & 31)) & 1);
      const float* src = ok[b] ? A : idle;
      if constexpr (kOneColumn) {
        k[b] = load_block(src, info, tv / kHalf, q);
      } else {
        k[b] = load_block<NP>(src, pr, cs, info, tv);
      }
    }
#pragma unroll
    for (int b = 0; b < kB; ++b)
      if (x0 + b < kPer && ok[b]) store_block(A, k[b]);
  }
}

// The tournament schedule in closed form (tournament_schedule of the
// wrapper): slot 0 stays; the others walk the ring of the top row left to
// right, then the bottom row right to left; src[c] is the slot one step
// back on the ring from c.
__host__ __device__ constexpr int ring_slot(int m, int q) {
  return q < m - 1 ? 2 * (q + 1) : 2 * (2 * m - 2 - q) + 1;
}
__host__ __device__ constexpr int ring_pos(int m, int c) {
  return c % 2 == 0 ? c / 2 - 1 : 2 * m - 2 - (c - 1) / 2;
}
__host__ __device__ constexpr int tournament_src(int np, int c) {
  return c == 0 ? 0 : ring_slot(np / 2, (ring_pos(np / 2, c) + np - 2) % (np - 1));
}

// One round's update of row `v` of V, held in registers in the moving
// schedule's order: rotate the logical pairs (2i, 2i+1) as rotate_entry
// does, then move column src[c] into c (compile-time indices, so the move
// is register renaming or moves, no memory).
template <int NP>
__device__ __forceinline__ void rotate_row(float (&v)[NP], const float2* cs) {
  float t[NP];
#pragma unroll
  for (int i = 0; i < NP / 2; i += 2) {  // two pairs' (c, s) a load (NP / 2 is even)
    const float4 g = reinterpret_cast<const float4*>(cs)[i / 2];
    t[2 * i] = __fmaf_rn(v[2 * i], g.x, __fmul_rn(v[2 * i + 1], -g.y));
    t[2 * i + 1] = __fmaf_rn(v[2 * i + 1], g.x, __fmul_rn(v[2 * i], g.y));
    t[2 * i + 2] = __fmaf_rn(v[2 * i + 2], g.z, __fmul_rn(v[2 * i + 3], -g.w));
    t[2 * i + 3] = __fmaf_rn(v[2 * i + 3], g.z, __fmul_rn(v[2 * i + 2], g.w));
  }
#pragma unroll
  for (int c = 0; c < NP; ++c) v[c] = t[tournament_src(NP, c)];
}

// dst[0, count) = src[0, count), 16 bytes a load where both start on 16
// bytes (the tables the host builds, into 16-byte aligned shared memory).
__device__ __forceinline__ void copy_ints(int* dst, const int* __restrict__ src, int count,
                                          int tid, int nt) {
  int head = 0;
  if ((reinterpret_cast<size_t>(src) & 15) == 0 && (reinterpret_cast<size_t>(dst) & 15) == 0) {
    head = count & ~3;
    for (int i = tid; i < head / 4; i += nt)
      reinterpret_cast<int4*>(dst)[i] = reinterpret_cast<const int4*>(src)[i];
  }
  for (int i = head + tid; i < count; i += nt) dst[i] = src[i];
}

// Per round of the pipelined form: a skip bit a pair block, then the
// off-diagonal blocks that hold the next round's A[P, Q] (-1: none).
template <int NP>
__host__ __device__ constexpr int export_ints() {
  return ((NP / 2) * (NP / 2) + 31) / 32 + NP / 2;
}

// Shared memory of the pair-block form: A, V, the rotations' pair infos and
// (c, s) (two sets of each when pipelined), the pair table, the export
// table (pipelined), rank / cnt / first / dup, w2 and 3 floats a column.
template <int NP, bool PIPE>
constexpr size_t pair_smem() {
  return (NP * NP + NP * (NP + 1)) * sizeof(float) +
         (PIPE ? 2 : 1) * (NP / 2) * (sizeof(float4) + sizeof(float2)) +
         (NP - 1) * (NP / 2) * sizeof(int) +
         (PIPE ? (NP - 1) * export_ints<NP>() : 0) * sizeof(int) + 4 * NP * sizeof(int) +
         (NP + 3 * NP / 2) * sizeof(float);
}

template <int NP, int WARPS, bool HERM, bool PIPE>
__global__ void __launch_bounds__(WARPS * 32)
jacobi_pair_kernel(const float* __restrict__ in, const int* __restrict__ pairs_g,
                   const int* __restrict__ exports_g, float* __restrict__ w_out,
                   float* __restrict__ v_out, int n_in, int sweeps) {
  constexpr int kHalf = NP / 2, kT = WARPS * 32, kRounds = NP - 1;
  constexpr int kBlocks = kHalf * kHalf, kWords = (kBlocks + 31) / 32, kExp = export_ints<NP>();
  // The threads' roles. K7 (two barriers): V's rows on the first np
  // threads, the blocks on all. K4, two barriers: V's rows on the first
  // warps, the blocks on the others. K4 pipelined: warp 0 computes the next
  // round's rotations, the next warps hold V's rows, and the blocks are on
  // the warps after them, the first of which (the producers) update the
  // export blocks first.
  constexpr int kVWarps = (NP + 31) / 32, kProducers = (NP + 31) / 32;
  constexpr int kABase = HERM ? 0 : 32 * kVWarps;
  constexpr int kAT = PIPE ? kT - 32 - 32 * kVWarps : kT - kABase;
  static_assert(kT >= NP, "a thread for every row of V");
  static_assert(kAT >= 32 * (PIPE ? kProducers : 1), "warps for the blocks");
  static_assert(!PIPE || (!HERM && WARPS > kVWarps + kProducers),
                "warps for the rotations, V's rows and the producers");
  extern __shared__ __align__(16) float smem[];
  float* A = smem;
  // V's rows at a stride of np + 1 floats: a warp's threads, which hold a
  // row each, store and scan them on 32 banks.
  constexpr int kLdv = NP + 1;
  float* V = A + NP * NP;
  float4* info = reinterpret_cast<float4*>(V + NP * kLdv);  // pair_info of each pair
  float2* cs = reinterpret_cast<float2*>(info + (PIPE ? 2 : 1) * kHalf);
  int* pairs = reinterpret_cast<int*>(cs + (PIPE ? 2 : 1) * kHalf);
  int* exports = pairs + kRounds * kHalf;
  int* rank = exports + (PIPE ? kRounds * kExp : 0);
  int* cnt = rank + NP;
  int* first = cnt + NP;
  int* dup = first + NP;
  float* w2 = reinterpret_cast<float*>(dup + NP);
  float* ofs = w2 + NP;  // (o_re, o_im, clamped norm) per column

  STAGE_STAMP(0);
  const int b = blockIdx.x, tid = threadIdx.x;
  const int n = HERM ? 2 * n_in : n_in;  // real slots in use
  const int warp = tid >> 5, lane = tid & 31;
  // This thread's row of V (if in [0, NP)) and its index among the block
  // threads (if >= 0).
  int vr = tid, ut = tid - kABase;
  if constexpr (PIPE) {
    vr = (warp - 1) * 32 + lane;  // in V's warps 1 .. kVWarps
    ut = (warp - 1 - kVWarps) * 32 + lane;  // in the warps after them
  }
  if constexpr (HERM) {
    // T = [[X, -Y], [Y, X]] from H = X + iY, as in jacobi_eigh_kernel (HERM).
    const float2* hb = reinterpret_cast<const float2*>(in) + (size_t)b * n_in * n_in;
    for (int e = tid; e < NP * NP; e += kT) {
      const int r = e / NP, c = e % NP;
      float t = 0.f;
      if (r < n && c < n) {
        const bool top = r < n_in, left = c < n_in;
        const float2 z = hb[(top ? r : r - n_in) * n_in + (left ? c : c - n_in)];
        t = top == left ? z.x : (top ? -z.y : z.y);
      }
      A[e] = t;
    }
  } else {
    const float* ab = in + (size_t)b * n * n;
    if (n == NP && (reinterpret_cast<size_t>(ab) & 15) == 0) {
      for (int e = tid; e < NP * NP / 4; e += kT)
        reinterpret_cast<float4*>(A)[e] = reinterpret_cast<const float4*>(ab)[e];
    } else {
      for (int e = tid; e < NP * NP; e += kT) {
        const int r = e / NP, c = e % NP;
        A[e] = (r < n && c < n) ? ab[r * n + c] : 0.f;
      }
    }
  }
  copy_ints(pairs, pairs_g, kRounds * kHalf, tid, kT);
  if constexpr (PIPE) copy_ints(exports, exports_g, kRounds * kExp, tid, kT);
  for (int i = tid; i < NP; i += kT) cnt[i] = 0;
  __syncthreads();
  if constexpr (PIPE) {
    // Round 0's rotations.
    if (tid < kHalf) {
      const int e = pairs[tid], p = slot_p(e), q = slot_q(e);
      const float2 r = rotation(A[p * NP + p], A[q * NP + q], A[p * NP + q]);
      cs[tid] = r;
      info[tid] = pair_info(r, p, q, NP);
    }
    __syncthreads();
  }
  STAGE_STAMP(10);

  // Each role runs its own loop over the rounds (one block barrier a round
  // in each), so that V's rows take registers only in V's threads.
  // After whole sweeps the moving order of V's rows is the identity again.
  if constexpr (PIPE) {
    // The named barrier of the export blocks: the producers arrive, warp 0
    // waits.
    constexpr int kMeet = 32 * (kProducers + 1);
    if (warp == 0) {
      // The next round's rotations, once its entries are final (no other
      // warp writes them).
      int g = 0;
      for (int sw = 0; sw < sweeps; ++sw) {
        for (int k = 0; k < kRounds; ++k, ++g) {
          const int e =
              pairs[(k + 1 == kRounds ? 0 : k + 1) * kHalf + (lane < kHalf ? lane : 0)];
          const int p = slot_p(e), q = slot_q(e);
          named_sync(kMeet);
          STAGE_STAMP(16);
          if (lane < kHalf) {
            const float2 r = rotation(A[p * NP + p], A[q * NP + q], A[p * NP + q]);
            cs[((g + 1) & 1) * kHalf + lane] = r;
            info[((g + 1) & 1) * kHalf + lane] = pair_info(r, p, q, NP);
          }
          STAGE_STAMP(17);
          __syncthreads();
          STAGE_STAMP(14);
        }
      }
    } else if (warp <= kVWarps) {
      // V's warps; past np rows (np < 32 kVWarps) a lane only keeps the
      // barriers.
      float vrow[NP];  // row vr of V
#pragma unroll
      for (int c = 0; c < NP; ++c) vrow[c] = c == vr ? 1.f : 0.f;
      int g = 0;
      for (int sw = 0; sw < sweeps; ++sw) {
        for (int k = 0; k < kRounds; ++k, ++g) {
          STAGE_STAMP_AT(0, 32, 1);
          if (vr < NP) rotate_row<NP>(vrow, cs + (g & 1) * kHalf);
          STAGE_STAMP_AT(19, 32, 1);
          __syncthreads();
        }
      }
      if (vr < NP) {
#pragma unroll
        for (int c = 0; c < NP; ++c) V[vr * kLdv + c] = vrow[c];
      }
    } else {
      int g = 0;
      for (int sw = 0; sw < sweeps; ++sw) {
        for (int k = 0; k < kRounds; ++k, ++g) {
          const int* pr = pairs + k * kHalf;
          const float2* cur = cs + (g & 1) * kHalf;
          const float4* cur_info = info + (g & 1) * kHalf;
          const int* ex = exports + k * kExp;
          STAGE_STAMP_AT(0, kT - 32, 3);
          if (ut < 32 * kProducers) {
            // The export blocks: the diagonal ones, then the listed ones.
            const int t = ut < kHalf ? ut * (kHalf + 1)
                                     : (ut < 2 * kHalf ? ex[kWords + ut - kHalf] : -1);
            if (t >= 0) store_block(A, load_block<NP>(A, pr, cur, cur_info, t));
            named_arrive(kMeet);
          }
          rotate_blocks<NP, kAT, 8, true>(A, V, pr, cur, cur_info, ex, ut);
          STAGE_STAMP_AT(18, kT - 32, 3);
          __syncthreads();
        }
      }
    }
  } else {
    float vrow[NP];  // row tid of V
#pragma unroll
    for (int c = 0; c < NP; ++c) vrow[c] = c == tid ? 1.f : 0.f;
    for (int sw = 0; sw < sweeps; ++sw) {
      for (int k = 0; k < kRounds; ++k) {
        const int* pr = pairs + k * kHalf;
        if (tid < kHalf) {
          const int e = pr[tid], p = slot_p(e), q = slot_q(e);
          const float2 r = rotation(A[p * NP + p], A[q * NP + q], A[p * NP + q]);
          cs[tid] = r;
          info[tid] = pair_info(r, p, q, NP);
        }
        STAGE_STAMP(11);
        pencil_sync<WARPS>();
        STAGE_STAMP(12);
        STAGE_STAMP_AT(0, 32, 1);
        STAGE_STAMP_AT(0, kT - 32, 3);
        if (ut >= 0) rotate_blocks<NP, kAT, 8, false>(A, V, pr, cs, info, nullptr, ut);
        if (tid < NP) rotate_row<NP>(vrow, cs);
        STAGE_STAMP_AT(19, 32, 1);
        STAGE_STAMP_AT(18, kT - 32, 3);
        STAGE_STAMP(13);
        pencil_sync<WARPS>();
        STAGE_STAMP(14);
      }
    }
    if (tid < NP) {
#pragma unroll
      for (int c = 0; c < NP; ++c) V[tid * kLdv + c] = vrow[c];
    }
  }

  rank_slots(A, rank, cnt, first, n, NP, tid, kT);
  __syncthreads();
  if constexpr (HERM) {
    hermitian_pairs(A, V, kLdv, rank, cnt, first, A, w2, dup, ofs, n_in, NP, tid, kT,
                    w_out + (size_t)b * n_in, v_out + (size_t)b * n_in * n_in * 2);
  } else {
    real_outputs(A, V, kLdv, rank, cnt, first, dup, n, NP, tid, kT, w_out + (size_t)b * n,
                 v_out + (size_t)b * n * n);
  }
  STAGE_STAMP(15);
}

template <int NP, int WARPS, bool HERM, bool PIPE>
int launch_pairs(const float* in, const int* pairs, const int* exports, float* w, float* v,
                 int bz, int n, int sweeps, cudaStream_t stream) {
  constexpr size_t smem = pair_smem<NP, PIPE>();
  static std::atomic<int> granted[kMaxDevices];
  auto kernel = jacobi_pair_kernel<NP, WARPS, HERM, PIPE>;
  cudaError_t e = allow_smem(kernel, smem, granted);
  if (e != cudaSuccess) return (int)e;
  kernel<<<bz, WARPS * 32, smem, stream>>>(in, pairs, exports, w, v, n, sweeps);
  return (int)cudaGetLastError();
}


// The pair-block form at np <= kPairSlots, one warp count a width. K7
// (HERM; batches of ~1600 pencils, so few warps a pencil), two barriers a
// round: one warp up to 24 slots, two at 40-56, and at 32 and 64 slots
// four, the fastest of 1, 2 and 4. K4 (batches of 2), K4_PIPELINED's
// round form: four warps up to 32 slots, six at 40-56, K4_PAIR_WARPS at 64
// (the pipelined roles need 3 warps up to 32 slots, 5 above).
template <bool HERM>
int pair_form(const float* in, const int* pairs, const int* exports, float* w, float* v,
              int bz, int n, int np, int sweeps, cudaStream_t stream) {
  constexpr bool kPipe = !HERM && K4_PIPELINED != 0;
  constexpr int kSmall = HERM ? 1 : 4, kMid = HERM ? 2 : 6, kWide = HERM ? 4 : K4_PAIR_WARPS;
#define K4_PAIRS(NP, W) \
  launch_pairs<NP, W, HERM, kPipe>(in, pairs, exports, w, v, bz, n, sweeps, stream)
  switch (np) {
    case 8: return K4_PAIRS(8, kSmall);
    case 16: return K4_PAIRS(16, kSmall);
    case 24: return K4_PAIRS(24, kSmall);
    case 32: return K4_PAIRS(32, 4);
    case 40: return K4_PAIRS(40, kMid);
    case 48: return K4_PAIRS(48, kMid);
    case 56: return K4_PAIRS(56, kMid);
    case 64: return K4_PAIRS(64, kWide);
    default: return (int)cudaErrorInvalidValue;
  }
#undef K4_PAIRS
}

}  // namespace

// a (bz, n, n) symmetric; src (np,) int32, the tournament schedule; pairs
// ((np - 1) * np / 2,) int32, its relabeled pair table, and exports
// ((np - 1) * export_ints,) int32, the pipelined form's export table (both
// read up to kPairSlots slots, else may be null) -> w (bz, n) ascending, v (bz, n, n)
// eigenvectors in columns; float32, contiguous; np = max(8, ceil8(n)) <=
// 512; above kSharedSlots, work holds 4 bz np^2 floats (else it may be
// null). The pair-block form serves np <= kPairSlots, the template form
// the rest.
extern "C" int jacobi_eigh_launch(const float* a, const int* src, const int* pairs,
                                  const int* exports, float* w, float* v, float* work, int bz,
                                  int n, int np, int sweeps, cudaStream_t stream) {
  if (np % 8 || np < n || np > kMaxSlots || (np > kSharedSlots && !work) ||
      (np <= kPairSlots && (!pairs || !exports)))
    return (int)cudaErrorInvalidValue;
  if (np <= kPairSlots)
    return pair_form<false>(a, pairs, exports, w, v, bz, n, np, sweeps, stream);
  return dispatch<false>(a, src, w, v, work, bz, n, np, sweeps, stream);
}

// K4's template form at every width, for tests and tools: the pair-block
// form must equal it bit for bit. Arguments as jacobi_eigh_launch, without
// the pair table.
extern "C" int jacobi_eigh_template_launch(const float* a, const int* src, float* w, float* v,
                                           float* work, int bz, int n, int np, int sweeps,
                                           cudaStream_t stream) {
  if (np % 8 || np < n || np > kMaxSlots || (np > kSharedSlots && !work))
    return (int)cudaErrorInvalidValue;
  return dispatch<false>(a, src, w, v, work, bz, n, np, sweeps, stream);
}

// K7. h (bz, n, n, 2) complex Hermitian, interleaved; src (np,) int32, the
// tournament schedule; pairs ((np - 1) * np / 2,) int32, its relabeled pair
// table (read up to kPairSlots slots, else may be null) -> w (bz, n)
// ascending, q (bz, n, n, 2) eigenvectors in columns; float32, contiguous;
// np = max(8, ceil8(2n)) <= 512; work as for jacobi_eigh_launch. The
// pair-block form serves np <= kPairSlots, K4's template form the rest.
extern "C" int jacobi_eigh_hermitian_launch(const float* h, const int* src, const int* pairs,
                                            float* w, float* q, float* work, int bz, int n,
                                            int np, int sweeps, cudaStream_t stream) {
  if (np % 8 || np < 2 * n || np > kMaxSlots || (np > kSharedSlots && !work) ||
      (np <= kPairSlots && !pairs))
    return (int)cudaErrorInvalidValue;
  if (np <= kPairSlots)
    return pair_form<true>(h, pairs, nullptr, w, q, bz, n, np, sweeps, stream);
  return dispatch<true>(h, src, w, q, work, bz, n, np, sweeps, stream);
}
