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
// block, ~2.7 GFLOP in all (0.04 ms at 67 TFLOP/s) against ~6.6 MB of
// input and output (0.002 ms); 1602 blocks of 256 threads, several to an
// SM (see dispatch_hermitian).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 1024;

constexpr int kSharedSlots = 160;  // the widest single-buffered shared form
constexpr int kWideThreads = 512;
constexpr int kWidePer = kSharedSlots * kSharedSlots / kWideThreads;  // 50
constexpr int kMaxSlots = 512;  // the global form's bound

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

// The rotation of pair i = (2i, 2i+1) that zeroes A[2i, 2i+1], for
// i = tid, tid + nt, ... < np / 2.
__device__ __forceinline__ void pair_rotations(const float* A, float2* cs, int np,
                                               int tid, int nt) {
  for (int i = tid; i < np / 2; i += nt) {
    const int p = 2 * i, q = p + 1;
    const float app = A[p * np + p], aqq = A[q * np + q], apq = A[p * np + q];
    const float theta = aqq - app;
    const float sg = theta >= 0.f ? 1.f : -1.f;
    const float denom = fabsf(theta) + sqrtf(theta * theta + 4.f * apq * apq) + 1e-30f;
    const float t = 2.f * apq * sg / denom;
    const float c = 1.f / sqrtf(1.f + t * t);
    cs[i] = make_float2(c, t * c);
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

  // Ascending rank of every slot; pad slots key to +inf.
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
  auto kernel = jacobi_eigh_kernel<PER, DOUBLE, HERM, GLOBAL, THREADS>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<bz, threads, smem, stream>>>(a, src, w, v, work, n, np, sweeps);
  return (int)cudaGetLastError();
}

// K4's launch shape for np slots: one entry of A and V per thread up to
// 1024 threads, double buffers up to np = 64, single buffers up to 128
// (1024 threads) and kSharedSlots (512 threads), then the global form.
template <bool HERM>
int dispatch(const float* a, const int* src, float* w, float* v, float* work, int bz, int n,
             int np, int sweeps, cudaStream_t stream) {
  const int nn = np * np;
  const int threads = nn < kMaxThreads ? nn : kMaxThreads;
  if (nn <= threads)
    return launch<1, true, HERM>(a, src, w, v, work, bz, n, np, sweeps, threads, stream);
  if (nn <= 4 * threads)
    return launch<4, true, HERM>(a, src, w, v, work, bz, n, np, sweeps, threads, stream);
  if (nn <= 16 * threads)
    return launch<16, false, HERM>(a, src, w, v, work, bz, n, np, sweeps, threads, stream);
  if (np <= kSharedSlots)
    return launch<kWidePer, false, HERM, false, kWideThreads>(a, src, w, v, work, bz, n, np,
                                                              sweeps, kWideThreads, stream);
  return launch<1, true, HERM, true>(a, src, w, v, work, bz, n, np, sweeps, kMaxThreads,
                                     stream);
}

// K7's launch shape. Its batch is thousands of pencils (2 * bins), not
// K4's two, so its blocks are smaller where that costs few entries a
// thread: kHermThreads threads with up to 4 entries each (double
// buffered), so that several blocks share an SM and one block's barriers
// overlap another's work; beyond that, K4's shape (16 entries a thread
// were slower than it at 64 slots). At 32 slots (S = 16) 256 threads take
// about half the time of 1024 (tools/k7_launch_shapes.py).
constexpr int kHermThreads = 256;

int dispatch_hermitian(const float* h, const int* src, float* w, float* q, float* work,
                       int bz, int n, int np, int sweeps, cudaStream_t stream) {
  const int nn = np * np;
  const int t = kHermThreads;
  if (nn <= t) return launch<1, true, true>(h, src, w, q, work, bz, n, np, sweeps, nn, stream);
  if (nn <= 2 * t)
    return launch<2, true, true>(h, src, w, q, work, bz, n, np, sweeps, t, stream);
  if (nn <= 4 * t)
    return launch<4, true, true>(h, src, w, q, work, bz, n, np, sweeps, t, stream);
  return dispatch<true>(h, src, w, q, work, bz, n, np, sweeps, stream);
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

// K7. h (bz, n, n, 2) complex Hermitian, interleaved; src (np,) int32 ->
// w (bz, n) ascending, q (bz, n, n, 2) eigenvectors in columns; float32,
// contiguous; np = max(8, ceil8(2n)) <= 512; work as for jacobi_eigh_launch.
extern "C" int jacobi_eigh_hermitian_launch(const float* h, const int* src, float* w,
                                            float* q, float* work, int bz, int n, int np,
                                            int sweeps, cudaStream_t stream) {
  if (np % 8 || np < 2 * n || np > kMaxSlots || (np > kSharedSlots && !work))
    return (int)cudaErrorInvalidValue;
  return dispatch_hermitian(h, src, w, q, work, bz, n, np, sweeps, stream);
}
