// K1: streaming FIR bank for stage 1 of the hop (RIR convolution).
//
// Replaces apvast_tpu/ops/pallas/streaming_conv.py::streaming_conv_pallas.
//   out[z, r, h] = sum_k kern[z, r, k] * seg[z, hist + h - k],  hist = seg_len - hop
// i.e. the `hop` valid outputs of each FIR row over the carried history
// plus the new hop samples: per signal, the product K (rows x taps) times
// the Toeplitz window matrix W[k, h] = seg[hist + h - k] (taps x hop).
//
// Bound: operations. At the north-star shapes (z=2, rows=561, taps=2400,
// hop=800) it is 4.31 GFLOP against ~14.4 MB: 0.0643 ms at 67 TFLOP/s of
// fp32 FMA, 0.0261 ms as the 3 x 4.31 GFLOP of 3xTF32 at 495 TFLOP/s.
// Design: the TPU kernel built W in VMEM for its matrix unit; here W is
// never built. The product runs on the tensor cores in 3xTF32
// (tf32x3.cuh), which holds fp32 accuracy. Each block owns a (signal, 64-row
// tile, 64-output tile), 4 warps of 32 x 32 (2 x 4 m16n8 tiles); the grid is
// 9 x 13 x 2 = 234 blocks at the north star, all resident at once. The taps
// are walked in chunks of kChunk, double-buffered: cp.async stages the
// chunk of the block's kernel rows (16-byte copies where the rows start on
// 16 bytes, else 4-byte; zero-filled past the rows and taps) and the one
// segment slice of kOuts + kChunk - 1 samples that the chunk reads (4-byte
// copies: its start is not aligned in general), while the warps compute on
// the other buffer. B fragments come straight from the slice, B[k, n] =
// s[n - k + kChunk - 1]: a warp's loads touch 11 consecutive words, no bank
// conflict. The Toeplitz structure gives register reuse: n-tile j at k-step
// q reads what n-tile j - 1 read at k-step q - 1, so a chunk of 8 k-steps
// loads and splits 11 B fragments, not 32. The kernel-row stride kChunk + 4
// puts the 32 words of an A fragment load on 32 banks. Chunks of 64 taps
// halve the per-tap staging and barrier work against 32. In the last chunk
// B is zeroed past the taps: the slice holds real samples there, older than
// the outputs' windows, and a NaN among them must not reach the outputs.
// Every 4 k-steps the MMA sums are added to an fp32 total with
// round-to-nearest adds: the tensor core's accumulator does not round to
// nearest, so a long sum left in it drifts from fp32 accuracy. No sum
// crosses blocks, no atomics: results repeat run to run.

#include <cuda_runtime.h>

#include <cstdint>

#include "cp_async.cuh"
#include "tf32x3.cuh"

namespace {

using namespace cp_async;
using namespace tf32x3;

constexpr int kRows = 64;               // kernel rows per block
constexpr int kOuts = 64;               // outputs per block
constexpr int kChunk = 64;              // taps per staged chunk
constexpr int kSteps = kChunk / 8;      // k-steps of 8 taps per chunk
constexpr int kPromote = 4;             // k-steps per sum added to the fp32 total
constexpr int kThreads = 128;           // 2 x 2 warps of 32 rows x 32 outputs
constexpr int kStride = kChunk + 4;     // staged kernel-row stride (16 B multiple)
constexpr int kSlice = kOuts + kChunk;  // kOuts + kChunk - 1 samples, padded

struct Stage {
  float k[kRows * kStride];
  float s[kSlice];
};

// Stage taps [k0, k0 + kChunk) of rows [r0, r0 + kRows) and the samples
// seg[base .. base + kOuts + kChunk - 2]. VEC: 16-byte copies (kern on 16
// bytes and taps % 4 == 0, so a group lies inside or past a row's taps).
template <bool VEC>
__device__ __forceinline__ void stage(Stage& st, const float* __restrict__ segz,
                                      const float* __restrict__ kz, int r0, int rows, int taps,
                                      int k0, int base, int seg_len) {
  if constexpr (VEC) {
    constexpr int groups = kChunk / 4;
    for (int i = threadIdx.x; i < kRows * groups; i += kThreads) {
      const int r = i / groups, c = 4 * (i % groups);
      const bool ok = r0 + r < rows && k0 + c < taps;
      copy16(&st.k[r * kStride + c], ok ? kz + (size_t)(r0 + r) * taps + k0 + c : kz, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * kChunk; i += kThreads) {
      const int r = i / kChunk, c = i % kChunk;
      const bool ok = r0 + r < rows && k0 + c < taps;
      copy4(&st.k[r * kStride + c], ok ? kz + (size_t)(r0 + r) * taps + k0 + c : kz, ok);
    }
  }
  for (int u = threadIdx.x; u < kSlice - 1; u += kThreads) {
    const int g = base + u;
    const bool ok = g >= 0 && g < seg_len;
    copy4(&st.s[u], ok ? segz + g : segz, ok);
  }
  copy_commit();
}

// One staged chunk's products into the warp's 32 x 32 tile acc, each
// kPromote k-steps' sums added to the fp32 total. MASK: the chunk passes
// the taps, and B is zero from chunk tap lim on (A is zero there, but
// 0 * NaN is not).
template <bool MASK>
__device__ __forceinline__ void chunk_products(float (&acc)[2][4][4], const Stage& sc,
                                               int a_off, int b_off, int t, int lim) {
  uint32_t bh[kSteps + 3][2], bl[kSteps + 3][2];  // index j - q + kSteps - 1
#pragma unroll
  for (int d = 0; d < kSteps + 3; ++d) {
    split_tf32(sc.s[b_off + 8 * (d - kSteps + 1)], bh[d][0], bl[d][0]);
    split_tf32(sc.s[b_off + 8 * (d - kSteps + 1) - 4], bh[d][1], bl[d][1]);
  }
#pragma unroll
  for (int q0 = 0; q0 < kSteps; q0 += kPromote) {
    float part[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][j][e] = 0.f;
#pragma unroll
    for (int q = q0; q < q0 + kPromote; ++q) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* ap = sc.k + a_off + mt * 16 * kStride + 8 * q;
        split_tf32(ap[0], ah[mt][0], al[mt][0]);
        split_tf32(ap[8 * kStride], ah[mt][1], al[mt][1]);
        split_tf32(ap[4], ah[mt][2], al[mt][2]);
        split_tf32(ap[8 * kStride + 4], ah[mt][3], al[mt][3]);
      }
      // b[0] is tap 8 q + t of the chunk, b[1] tap 8 q + t + 4.
      const bool v0 = !MASK || 8 * q + t < lim, v1 = !MASK || 8 * q + t + 4 < lim;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = j - q + kSteps - 1;
        const uint32_t mh[2] = {v0 ? bh[d][0] : 0u, v1 ? bh[d][1] : 0u};
        const uint32_t ml[2] = {v0 ? bl[d][0] : 0u, v1 ? bl[d][1] : 0u};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_3xtf32(part[mt][j], ah[mt], al[mt], mh, ml);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] += part[mt][j][e];
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
streaming_conv_kernel(const float* __restrict__ seg, const float* __restrict__ kern,
                      float* __restrict__ out, int seg_len, int rows, int taps, int hop) {
  __shared__ __align__(16) Stage st[2];

  const int z = blockIdx.z;
  const int r0 = blockIdx.y * kRows;
  const int h0 = blockIdx.x * kOuts;
  const float* segz = seg + (size_t)z * seg_len;
  const float* kz = kern + (size_t)z * rows * taps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;

  // Output h0 + n at tap k0 + kk reads seg[hist + h0 + n - k0 - kk] =
  // s[n - kk + kChunk - 1], with s[u] = seg[base0 - k0 + u].
  const int base0 = seg_len - hop + h0 - (kChunk - 1);
  // A[g][t] of the warp's first m-tile; B[k = t][n = g] of its first n-tile
  // at k-step 0. n-tile j at k-step q reads b_off + 8 (j - q) (and - 4), so
  // a chunk needs the kSteps + 3 fragments j - q = -(kSteps - 1) .. 3.
  const int a_off = (wm * 32 + g) * kStride + t;
  const int b_off = wn * 32 + g - t + kChunk - 1;

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  const int chunks = (taps + kChunk - 1) / kChunk;
  stage<VEC>(st[0], segz, kz, r0, rows, taps, 0, base0, seg_len);
  for (int c = 0, k0 = 0; c < chunks; ++c, k0 += kChunk) {
    if (c + 1 < chunks) {
      stage<VEC>(st[(c + 1) & 1], segz, kz, r0, rows, taps, k0 + kChunk,
                 base0 - k0 - kChunk, seg_len);
    } else {
      copy_commit();  // an empty group keeps one group per chunk
    }
    copy_wait<1>();
    __syncthreads();
    const Stage& sc = st[c & 1];

    if (k0 + kChunk <= taps) {
      chunk_products<false>(acc, sc, a_off, b_off, t, kChunk);
    } else {
      chunk_products<true>(acc, sc, a_off, b_off, t, taps - k0);
    }
    __syncthreads();  // the next chunk's copies overwrite this buffer
  }

  float* oz = out + (size_t)z * rows * hop;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + wm * 32 + mt * 16 + g + 8 * half;
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int h = h0 + wn * 32 + 8 * j + 2 * t;
        if (h < hop) oz[(size_t)r * hop + h] = acc[mt][j][2 * half];
        if (h + 1 < hop) oz[(size_t)r * hop + h + 1] = acc[mt][j][2 * half + 1];
      }
    }
}

}  // namespace

// seg (z, seg_len), kern (z, rows, taps) -> out (z, rows, hop); float32,
// contiguous, seg_len - hop >= taps - 1 (checked by the Python wrapper).
extern "C" int streaming_conv_launch(const float* seg, const float* kern,
                                     float* out, int z, int seg_len, int rows,
                                     int taps, int hop, cudaStream_t stream) {
  const dim3 grid((hop + kOuts - 1) / kOuts, (rows + kRows - 1) / kRows, z);
  if (reinterpret_cast<uintptr_t>(kern) % 16 == 0 && taps % 4 == 0) {
    streaming_conv_kernel<true><<<grid, kThreads, 0, stream>>>(seg, kern, out, seg_len, rows,
                                                               taps, hop);
  } else {
    streaming_conv_kernel<false><<<grid, kThreads, 0, stream>>>(seg, kern, out, seg_len, rows,
                                                                taps, hop);
  }
  return (int)cudaGetLastError();
}
