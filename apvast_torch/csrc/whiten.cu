// K10a: Cholesky factor and its inverse of a batch of 128 x 128 SPD panels.
//
// Replaces apvast_tpu/ops/pallas/whiten.py::chol_panel_pallas, the panel
// step of blocked_cholesky (ops/kernels/whiten.py runs the trailing updates
// as matmuls between the launches). Contract: L lower-triangular with exact
// zeros above the diagonal, L L^T = d (d's lower triangle is read), and
// X = L^-1, also lower-triangular. The pivot rule is the TPU kernel's,
// rsqrt(max(pivot, 1e-30)) (whiten.py:100): a pivot <= 0 scales its column
// by 1e15 and the factor overflows, so a non-PD panel gives non-finite
// output, as in JAX, and the solver's `silenced` count sees it. (Built
// without fast math and with denormals kept, so 1e-30 stays a normal float;
// the clamp lets a NaN pivot through.)
//
// The Pallas body splits the panel into 32-wide sub-blocks with Neumann
// sub-inverses and a concat merge tree for Mosaic's layout limits
// (whiten.py:141-201). Here the same contract comes from the plain column
// algorithms: a right-looking column Cholesky (step c scales column c by the
// pivot's rsqrt and subtracts its outer product from the trailing lower
// triangle) and a right-looking forward substitution for L^-1 (step i
// divides row i of the right-hand side by L[i, i] and eliminates it from the
// rows below).
//
// Bound on the H100: latency. Per panel 2 * 128 dependent steps of an
// O(128^2) update. The roofline bound is bytes: 393 KB per launch at bz = 2
// (0.117 us at 3.35 TB/s) against 2.8 MFLOP (n^3 / 3 for the factor and
// n^3 / 3 for its inverse per panel: 0.04 us at 67 TFLOP/s), while every
// step waits on the one before it.
// Design: one block of 1024 threads per panel; d (then the substitution's
// right-hand side), L and X stay in dynamic shared memory (3 x 128 x 129
// floats = 198 KB; the row stride 129 keeps column reads free of bank
// conflicts). Thread t owns column t % 128 and rows t / 128 + 8 i, and starts
// its row loop at the first row a step touches, so the work is the
// triangular n^3 / 6 per phase. Each step reads only a column (Cholesky) or a row (substitution)
// that no thread writes in that step, so a step needs one barrier.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kP = 128;                    // panel width
constexpr int kLd = kP + 1;                // shared-memory row stride
constexpr int kThreads = 1024;
constexpr int kRowStep = kThreads / kP;    // 8 row groups
constexpr int kRowsPerThread = kP / kRowStep;
constexpr size_t kSmem = 3 * kP * kLd * sizeof(float);

// The first of a thread's row slots (rows row0 + kRowStep * i) at or below
// row `from`: a step skips the rows it does not touch.
__device__ __forceinline__ int first_row_slot(int from, int row0) {
  return from > row0 ? (from - row0 + kRowStep - 1) / kRowStep : 0;
}

// max(x, 1e-30) that propagates a NaN (jnp.maximum / torch.clamp_min do).
__device__ __forceinline__ float clamp_pivot(float x) { return x < 1e-30f ? 1e-30f : x; }

__global__ void __launch_bounds__(kThreads)
whiten_kernel(const float* __restrict__ d, float* __restrict__ l_out,
              float* __restrict__ inv_out) {
  extern __shared__ float smem[];
  float* D = smem;           // trailing matrix, then the right-hand side of L X = I
  float* L = D + kP * kLd;
  float* X = L + kP * kLd;
  const int tid = threadIdx.x;
  const int col = tid % kP;
  const int row0 = tid / kP;
  const size_t base = (size_t)blockIdx.x * kP * kP;

  for (int e = tid; e < kP * kP; e += kThreads) {
    const int r = e / kP, c = e % kP;
    D[r * kLd + c] = d[base + e];
    L[r * kLd + c] = 0.f;
    X[r * kLd + c] = 0.f;
  }
  __syncthreads();

  // Cholesky. Step c reads column c of D and writes L's column c (thread
  // col == c) or the trailing lower triangle, columns > c (the others).
  for (int c = 0; c < kP; ++c) {
    const float isr = 1.f / sqrtf(clamp_pivot(D[c * kLd + c]));
    if (col >= c) {
      const float lj = D[col * kLd + c] * isr;
      for (int i = first_row_slot(col, row0); i < kRowsPerThread; ++i) {
        const int r = row0 + i * kRowStep;
        const float li = D[r * kLd + c] * isr;
        if (col == c) {
          L[r * kLd + c] = li;
        } else {
          D[r * kLd + col] -= li * lj;
        }
      }
    }
    __syncthreads();
  }

  // The right-hand side I, in D's buffer.
  for (int e = tid; e < kP * kP; e += kThreads) {
    const int r = e / kP, c = e % kP;
    D[r * kLd + c] = r == c ? 1.f : 0.f;
  }
  __syncthreads();

  // Forward substitution. Step i reads row i of the right-hand side and
  // writes X's row i (thread row i) or the rows below it, columns <= i.
  for (int i = 0; i < kP; ++i) {
    if (col <= i) {
      const float xi = D[i * kLd + col] / L[i * kLd + i];
      for (int k = first_row_slot(i, row0); k < kRowsPerThread; ++k) {
        const int r = row0 + k * kRowStep;
        if (r == i) {
          X[r * kLd + col] = xi;
        } else {
          D[r * kLd + col] -= L[r * kLd + i] * xi;
        }
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < kP * kP; e += kThreads) {
    const int r = e / kP, c = e % kP;
    l_out[base + e] = L[r * kLd + c];
    inv_out[base + e] = X[r * kLd + c];
  }
}

}  // namespace

// d (bz, 128, 128) SPD, float32, contiguous -> l (bz, 128, 128) lower
// Cholesky factors, inv (bz, 128, 128) their inverses.
extern "C" int chol_panel_launch(const float* d, float* l, float* inv, int bz,
                                 cudaStream_t stream) {
  if (bz < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(whiten_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  whiten_kernel<<<bz, kThreads, kSmem, stream>>>(d, l, inv);
  return (int)cudaGetLastError();
}
