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
// the one before it.
// Design: one thread block per matrix (grid = batch); A and V (npad x npad,
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
// input and output (0.002 ms). Up to 64 slots K7 runs the pair-block form
// (hermitian_pair_kernel: a few warps a pencil, A rotated in place along a
// relabeled pair table, V's rows in registers); K4's template form serves
// wider pencils. (The first design ran K4's double-buffered rounds at every
// width, 256 threads a pencil at 32 slots, each round's rotations on 16 of
// them between two block barriers: PERF.md, section 6.)

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

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

// The Hermitian epilogue (K7) after the ranking: w (n) and q (n x n
// complex, interleaved) of one pencil from the 2n real slots. S (2n x 2n,
// row stride np) receives the ranked columns of V; w2 the ranked diagonal.
__device__ void hermitian_pairs(const float* A, const float* V, const int* rank,
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
      s = V[r * np + first[c]];
    } else if (cnt[c] > 1) {
      for (int i = 0; i < np; ++i)
        if (rank[i] == c) s += V[r * np + i];
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
    hermitian_pairs(A, V, rank, cnt, first, DOUBLE ? A2 : A, w2, dup, ofs, n_in, np,
                    tid, nt, w_out + (size_t)b * n_in,
                    v_out + (size_t)b * n_in * n_in * 2);
    return;
  }
  // Output column c gathers the slots of rank c (the one-hot contraction
  // of the TPU wrapper: a sum when NaNs collide ranks, 0 when none).
  for (int c = tid; c < n; c += nt) {
    float s = 0.f;
    if (cnt[c] == 1) {
      s = A[first[c] * (np + 1)];
    } else if (cnt[c] > 1) {
      for (int i = 0; i < np; ++i)
        if (rank[i] == c) s += A[i * (np + 1)];
    }
    w_out[(size_t)b * n + c] = s;
  }
  float* vb = v_out + (size_t)b * n * n;
  for (int e = tid; e < n * n; e += nt) {
    const int r = e / n, c = e % n;
    float s = 0.f;
    if (cnt[c] == 1) {
      s = V[r * np + first[c]];
    } else if (cnt[c] > 1) {
      for (int i = 0; i < np; ++i)
        if (rank[i] == c) s += V[r * np + i];
    }
    vb[e] = s;
  }
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

// K7's pair-block form, up to kPairSlots slots: the same rotations in the
// same order as K4's template form (jacobi_eigh_kernel, HERM), with the
// same products and contractions, without moving A. A pure permutation is
// exact, so instead of writing P^T (R^T A R) P into a second buffer every
// round rotates, in place, the physical slots that hold the round's pairs,
// (pos_k(2i), pos_k(2i+1)) with pos_{k+1}(c) = pos_k(src[c]); after the
// np - 1 rounds of a sweep pos is the identity again, so the ranking and
// the epilogue read the slots they always did. The host builds that table
// once per np (ops/kernels/jacobi_eigh.py::pair_table): one int a pair,
// P | Q << 8 | swap << 16, where swap picks which of the pair's two
// columns a thread loads first, so that at 64 slots the 32 columns of one
// warp-wide load lie on 32 distinct banks (at 32 slots the row parity does
// it). One block of WARPS warps per pencil: the np/2 rotations of a round
// are computed by np/2 threads into cs; then each thread rotates whole
// 2 x 2 pair blocks of A in shared memory (rows {P_i, Q_i} x columns
// {P_j, Q_j}: every value loaded and stored once a round, a batch of
// blocks loaded before any is stored), and the first np threads each
// rotate one row of V, held in registers in the moving schedule's order
// (the column moves are compile-time register moves). The blocks partition
// A, so a round takes two pencil barriers and no second buffer. ptxas, and
// the timings of the warp counts and of the first design: PERF.md, section 6.
constexpr int kPairSlots = 64;

template <int WARPS>
__device__ __forceinline__ void pencil_sync() {
  if constexpr (WARPS == 1) {
    __syncwarp();
  } else {
    __syncthreads();
  }
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

// One round's update of A in place: the pair blocks (i, j), rows {P_i, Q_i}
// x columns {P_j, Q_j}, t = i * np/2 + j = tid + x KT of this thread. The
// blocks partition A, so each batch of BATCH blocks is loaded whole before
// any of it is stored: its loads are in flight together.
template <int NP, int KT, int BATCH>
__device__ __forceinline__ void rotate_blocks(float* A, const int* pr, const float2* cs,
                                              int tid) {
  constexpr int kHalf = NP / 2, kBlocks = kHalf * kHalf;
  constexpr int kPer = (kBlocks + KT - 1) / KT;
#pragma unroll
  for (int x0 = 0; x0 < kPer; x0 += BATCH) {
    float v[BATCH][4], o[BATCH];
    float2 gi[BATCH], gj[BATCH];
    int c0[BATCH], c1[BATCH], r0[BATCH], r1[BATCH];
    bool ok[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int t = tid + (x0 + b) * KT;
      ok[b] = x0 + b < kPer && (kBlocks % KT == 0 || t < kBlocks);
      if (!ok[b]) continue;
      const int i = t / kHalf, j = t % kHalf, ei = pr[i];
      gi[b] = cs[i];
      gj[b] = cs[j];
      load_order(pr[j], i, gj[b].y, c0[b], c1[b], o[b]);
      r0[b] = slot_p(ei) * NP;
      r1[b] = slot_q(ei) * NP;
      v[b][0] = A[r0[b] + c0[b]];
      v[b][1] = A[r0[b] + c1[b]];
      v[b][2] = A[r1[b] + c0[b]];
      v[b][3] = A[r1[b] + c1[b]];
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      if (!ok[b]) continue;
      // Columns: A R.
      const float c = gj[b].x;
      const float m0 = __fmaf_rn(v[b][0], c, __fmul_rn(v[b][1], o[b]));
      const float m1 = __fmaf_rn(v[b][1], c, __fmul_rn(v[b][0], -o[b]));
      const float q0 = __fmaf_rn(v[b][2], c, __fmul_rn(v[b][3], o[b]));
      const float q1 = __fmaf_rn(v[b][3], c, __fmul_rn(v[b][2], -o[b]));
      // Rows: P <- c (AR)[P] - s (AR)[Q], Q <- c (AR)[Q] + s (AR)[P].
      const float ci = gi[b].x, si = gi[b].y;
      A[r0[b] + c0[b]] = __fmaf_rn(ci, m0, __fmul_rn(-si, q0));
      A[r0[b] + c1[b]] = __fmaf_rn(ci, m1, __fmul_rn(-si, q1));
      A[r1[b] + c0[b]] = __fmaf_rn(ci, q0, __fmul_rn(si, m0));
      A[r1[b] + c1[b]] = __fmaf_rn(ci, q1, __fmul_rn(si, m1));
    }
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
  for (int i = 0; i < NP / 2; ++i) {
    const float2 g = cs[i];
    t[2 * i] = __fmaf_rn(v[2 * i], g.x, __fmul_rn(v[2 * i + 1], -g.y));
    t[2 * i + 1] = __fmaf_rn(v[2 * i + 1], g.x, __fmul_rn(v[2 * i], g.y));
  }
#pragma unroll
  for (int c = 0; c < NP; ++c) v[c] = t[tournament_src(NP, c)];
}

template <int NP, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
hermitian_pair_kernel(const float* __restrict__ h, const int* __restrict__ pairs_g,
                      float* __restrict__ w_out, float* __restrict__ q_out, int n_in,
                      int sweeps) {
  constexpr int kHalf = NP / 2, kT = WARPS * 32, kRounds = NP - 1;
  static_assert(kT >= NP, "a thread for every row of V");
  extern __shared__ __align__(16) float smem[];
  float* A = smem;
  float* V = A + NP * NP;
  float2* cs = reinterpret_cast<float2*>(V + NP * NP);
  int* pairs = reinterpret_cast<int*>(cs + kHalf);
  int* rank = pairs + kRounds * kHalf;
  int* cnt = rank + NP;
  int* first = cnt + NP;
  int* dup = first + NP;
  float* w2 = reinterpret_cast<float*>(dup + NP);
  float* ofs = w2 + NP;  // (o_re, o_im, clamped norm) per column

  const int b = blockIdx.x, tid = threadIdx.x;
  const int n = 2 * n_in;
  // T = [[X, -Y], [Y, X]] from H = X + iY, as in jacobi_eigh_kernel (HERM).
  const float2* hb = reinterpret_cast<const float2*>(h) + (size_t)b * n_in * n_in;
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
  float vrow[NP];  // row tid of V (tid < NP)
#pragma unroll
  for (int c = 0; c < NP; ++c) vrow[c] = c == tid ? 1.f : 0.f;
  for (int i = tid; i < kRounds * kHalf; i += kT) pairs[i] = pairs_g[i];
  for (int i = tid; i < NP; i += kT) cnt[i] = 0;
  __syncthreads();

  for (int sw = 0; sw < sweeps; ++sw) {
    for (int k = 0; k < kRounds; ++k) {
      const int* pr = pairs + k * kHalf;
      if (tid < kHalf) {
        const int e = pr[tid], p = slot_p(e), q = slot_q(e);
        cs[tid] = rotation(A[p * NP + p], A[q * NP + q], A[p * NP + q]);
      }
      pencil_sync<WARPS>();
      rotate_blocks<NP, kT, 8>(A, pr, cs, tid);
      if (tid < NP) rotate_row<NP>(vrow, cs);
      pencil_sync<WARPS>();
    }
  }
  // After whole sweeps the moving order is the identity again.
  if (tid < NP) {
#pragma unroll
    for (int c = 0; c < NP; ++c) V[tid * NP + c] = vrow[c];
  }

  rank_slots(A, rank, cnt, first, n, NP, tid, kT);
  __syncthreads();
  hermitian_pairs(A, V, rank, cnt, first, A, w2, dup, ofs, n_in, NP, tid, kT,
                  w_out + (size_t)b * n_in, q_out + (size_t)b * n_in * n_in * 2);
}

template <int NP, int WARPS>
int launch_pairs(const float* h, const int* pairs, float* w, float* q, int bz, int n,
                 int sweeps, cudaStream_t stream) {
  // A, V, cs, the pair table, rank / cnt / first / dup, w2 and 3 floats a column.
  const size_t smem = 2 * NP * NP * sizeof(float) + NP / 2 * sizeof(float2) +
                      (NP - 1) * (NP / 2) * sizeof(int) + 4 * NP * sizeof(int) +
                      (NP + 3 * NP / 2) * sizeof(float);
  static std::atomic<int> granted[kMaxDevices];
  auto kernel = hermitian_pair_kernel<NP, WARPS>;
  cudaError_t e = allow_smem(kernel, smem, granted);
  if (e != cudaSuccess) return (int)e;
  kernel<<<bz, WARPS * 32, smem, stream>>>(h, pairs, w, q, n, sweeps);
  return (int)cudaGetLastError();
}

// The pair-block form at np <= kPairSlots, one warp count a width (a thread
// for each row of V at least): one warp up to 24 slots, two at 40-56, and at
// 32 and 64 slots four, the fastest of 1, 2 and 4 (PERF.md, section 6).
int pair_form(const float* h, const int* pairs, float* w, float* q, int bz, int n, int np,
              int sweeps, cudaStream_t stream) {
  switch (np) {
    case 8: return launch_pairs<8, 1>(h, pairs, w, q, bz, n, sweeps, stream);
    case 16: return launch_pairs<16, 1>(h, pairs, w, q, bz, n, sweeps, stream);
    case 24: return launch_pairs<24, 1>(h, pairs, w, q, bz, n, sweeps, stream);
    case 32: return launch_pairs<32, 4>(h, pairs, w, q, bz, n, sweeps, stream);
    case 40: return launch_pairs<40, 2>(h, pairs, w, q, bz, n, sweeps, stream);
    case 48: return launch_pairs<48, 2>(h, pairs, w, q, bz, n, sweeps, stream);
    case 56: return launch_pairs<56, 2>(h, pairs, w, q, bz, n, sweeps, stream);
    case 64: return launch_pairs<64, 4>(h, pairs, w, q, bz, n, sweeps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// a (bz, n, n) symmetric, src (np,) int32 tournament schedule -> w (bz, n)
// ascending, v (bz, n, n) eigenvectors in columns; float32, contiguous;
// np = max(8, ceil8(n)) <= 512; above kSharedSlots, work holds 4 bz np^2
// floats (else it may be null).
extern "C" int jacobi_eigh_launch(const float* a, const int* src, float* w, float* v,
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
  if (np <= kPairSlots) return pair_form(h, pairs, w, q, bz, n, np, sweeps, stream);
  return dispatch<true>(h, src, w, q, work, bz, n, np, sweeps, stream);
}
