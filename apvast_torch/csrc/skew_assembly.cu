// K3: lag tables -> source-major covariance rows (full form).
//
// Replaces apvast_tpu/ops/pallas/skew_assembly.py::lag_skew_assemble
// (half_scaled=False). The TPU kernel ran the tap band a as a sequential
// grid axis, carrying acc_a = shift_left(acc_{a-1}) + lhsT[a] . rhs in
// scratch, with acc_0 = c0. Unrolled, the recursion is a running sum
// along each lane diagonal D = t2 + a of a source block:
//   out[p, s1, J-1-a, s2*J + D-a] = c0_sm[p, s1, s2*J + D]
//                                   + sum_{i<=a} lhsT[p, i*S1+s1, :] . rhs[p, :, s2*J + D-i]
// for a <= D (the valid lanes t2 <= t1 of row t1 = J-1-a). Diagonals never
// cross a source block, so every (p, s1, s2, D) is independent.
//
// Bound: bytes. At the north-star shapes (P=4, S=16, J=50, C=2M=34) the
// 10.24 MB output dominates ~11.3 MB of traffic; the arithmetic is
// ~0.17 GFLOP.
// Design: one thread per (p, s1, lane diagonal) walks a = 0..J-1 and
// carries the running sum in a register; the block's J lhsT rows (J*C
// floats) sit in shared memory, rhs columns are read through L1/L2 at
// consecutive lanes. At step a the block's threads write one whole output
// row t1 = J-1-a: valid lanes get the sum, the strict-upper-tap lanes
// (t2 > t1, lane s2*J + (D-a) mod J for a > D) get 0. Any S works: there
// is no sublane alignment and no lane padding to inherit.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;  // output lanes (diagonals) per block

__global__ void __launch_bounds__(kLanes)
skew_assembly_kernel(const float* __restrict__ lhs_t,
                     const float* __restrict__ rhs,
                     const float* __restrict__ c0,
                     float* __restrict__ out,
                     int s1n, int j, int c, int w) {
  extern __shared__ float lhs_s[];  // lhs_s[a*c + cc] = lhs_t[p, a*s1n + s1, cc]
  const int p = blockIdx.z;
  const int s1 = blockIdx.y;
  const int wi = blockIdx.x * kLanes + threadIdx.x;

  const float* lp = lhs_t + (size_t)p * j * s1n * c;
  for (int i = threadIdx.x; i < j * c; i += kLanes) {
    const int a = i / c, cc = i % c;
    lhs_s[i] = lp[((size_t)a * s1n + s1) * c + cc];
  }
  __syncthreads();
  if (wi >= w) return;

  const int s2 = wi / j;
  const int dd = wi % j;  // diagonal D within source block s2
  const float* rp = rhs + (size_t)p * c * w;
  float* op = out + ((size_t)p * s1n + s1) * j * w;
  float acc = c0[((size_t)p * s1n + s1) * w + wi];
  for (int a = 0; a < j; ++a) {
    const size_t row = (size_t)(j - 1 - a) * w;
    if (a <= dd) {
      const int lane = s2 * j + (dd - a);
      const float* la = lhs_s + a * c;
      float dot = 0.f;
      for (int cc = 0; cc < c; ++cc) dot = fmaf(la[cc], rp[(size_t)cc * w + lane], dot);
      acc += dot;
      op[row + lane] = acc;
    } else {
      op[row + s2 * j + (dd - a + j)] = 0.f;
    }
  }
}

}  // namespace

// lhs_t (p, j*s1, c), rhs (p, c, w), c0 (p, s1, w) -> out (p, s1, j, w),
// w = s2*j; float32, contiguous.
extern "C" int skew_assembly_launch(const float* lhs_t, const float* rhs,
                                    const float* c0, float* out, int p, int s1,
                                    int j, int c, int w, cudaStream_t stream) {
  const size_t smem = (size_t)j * c * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        skew_assembly_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((w + kLanes - 1) / kLanes, s1, p);
  skew_assembly_kernel<<<grid, kLanes, smem, stream>>>(lhs_t, rhs, c0, out, s1,
                                                       j, c, w);
  return (int)cudaGetLastError();
}
