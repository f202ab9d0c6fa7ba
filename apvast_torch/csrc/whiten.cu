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
// Bound on the H100: latency. The roofline bound is bytes: 393 KB per
// launch at bz = 2 (0.117 us at 3.35 TB/s) against 2.8 MFLOP (n^3 / 3 for
// the factor and n^3 / 3 for its inverse per panel: 0.04 us at 67
// TFLOP/s); what takes the time is the chain of dependent steps. The first
// design ran the column algorithms with one 1024-thread barrier
// per column step, 256 a panel (0.186 ms at bz = 2).
// Design: one block of 512 threads per panel, d, then L, and X in dynamic
// shared memory (2 x 128 x 129 floats, a 64 x 65 merge buffer and the
// diagonal block's scratch, 154 KB;
// the odd row stride keeps a warp's column reads free of bank conflicts),
// factored and inverted by chol_warp.cuh: four 32-wide sub-panels, each
// diagonal block factored inside one warp by shuffles, its strip solved by
// 15 warps while the 16th inverts the diagonal block, one trailing update
// by the block in 4 x 4 register tiles, then the merge tree for the
// inverse's off-diagonal blocks: 16 block barriers a panel. The TPU kernel
// had cut its chain the same way (32-wide sub-blocks and a merge tree,
// whiten.py:141-201). The factor repeats the column algorithm's operations
// in the same order (chol_warp.cuh).

#include <cuda_runtime.h>

#include "chol_warp.cuh"

namespace {

constexpr int kP = 128;  // panel width
constexpr int kLd = kP + 1;
constexpr int kThreads = 512;
constexpr int kTFloats = (kP / 2) * (kP / 2 + 1);
constexpr size_t kSmem =
    (chol_warp::kScratch + 2 * kP * kLd + kTFloats + kP) * sizeof(float);

__global__ void __launch_bounds__(kThreads)
whiten_kernel(const float* __restrict__ d, float* __restrict__ l_out,
              float* __restrict__ inv_out) {
  extern __shared__ __align__(16) float smem[];
  float* scratch = smem;  // on 16 bytes
  float* A = scratch + chol_warp::kScratch;  // d, then L in its lower triangle
  float* X = A + kP * kLd;
  float* T = X + kP * kLd;
  float* isr = T + kTFloats;
  const size_t base = (size_t)blockIdx.x * kP * kP;
  STAGE_STAMP(0);

  for (int e = threadIdx.x; e < kP * kP; e += kThreads) A[(e / kP) * kLd + e % kP] = d[base + e];
  __syncthreads();
  STAGE_STAMP(4);
  chol_warp::factor(A, kLd, X, kLd, isr, scratch, kP);
  STAGE_STAMP(5);
  chol_warp::invert(A, kLd, X, kLd, T, kP);
  STAGE_STAMP(6);
  for (int e = threadIdx.x; e < kP * kP; e += kThreads) {
    const int r = e / kP, c = e % kP;
    l_out[base + e] = c <= r ? A[r * kLd + c] : 0.f;
    inv_out[base + e] = X[r * kLd + c];
  }
  STAGE_STAMP(7);
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
