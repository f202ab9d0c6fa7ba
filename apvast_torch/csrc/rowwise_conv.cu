// K8: per-(zone, mic) circular convolution of the response rows, as
// overlap-save frames against a transposed Toeplitz matrix.
//
// Replaces apvast_tpu/ops/pallas/rowwise_conv.py::rowwise_circular_conv_pallas.
//   xp[q]            = x[(q - h) mod N]                  (h = T / 2)
//   out[p, m, s, f*B + o] = sum_{u < U} xp[p, m, s, f*B + u] * k_t[z, m, o, u]
//   z = p mod 2 (path = 2 * signal + zone), U = B + T - 1, f < N / B.
// Every frame is contracted over its full depth U against the given k_t,
// as the TPU kernel does, so the result holds for any k_t, banded or not,
// and a non-finite sample reaches every output of each frame whose window
// holds it.
//
// Bound: operations. At the north-star shapes (x (4, 17, 16, 1600), T=257,
// B=160) it is 2 * 2*17 * 32 rows * 1600 * 416 = 1.45 GFLOP of fp32 FMA
// against 23 MB of x, k_t and output.
// Design: the TPU kernel kept one (zone, mic)'s 2S rows in VMEM and ran one
// (rows, U) x (U, B) product per frame. Here one block owns one (zone, mic,
// frame, 32-row tile) and up to kMaxWarps 32-output tiles of it, one warp
// each: the 340 (zone, mic, frame) products at the north star are 340 blocks
// of 5 warps, all resident at once. A warp's 32 x 32 tile is register-tiled:
// lane (rg, og) holds rows rg + 4i (i < 8) and outputs og + 8c (c < 4), 32
// sums, so a depth step of 4 is 8 + 4 LDS.128 for 128 FMAs, and the row and
// output strides of the staged tiles (kStride floats) put the 4 (8) distinct
// rows of each load on distinct banks. The depth is walked in chunks of
// kDepth, double-buffered: the window rows (with their circular halo) and
// the k_t rows are copied with cp.async 16-byte copies (zero-filled past U,
// past the rows, past B) while the block computes on the other buffer; where
// N, B or h is not a multiple of 4, or x or k_t does not start on 16 bytes
// (a view with a storage offset), the same staging runs as plain loads. The
// global offset of each tile row (row -> signal, source) is computed once
// per block. Every output is one thread's fp32 sum over u = 0 .. U-1 in
// order: no sum crosses threads or blocks, no atomics, results repeat run
// to run.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "cp_async.cuh"

namespace {

using namespace cp_async;

constexpr int kTile = 32;                  // rows and outputs of a warp's tile
constexpr int kDepth = 32;                 // depth chunk
constexpr int kStride = kDepth + 4;        // staged row stride (floats, 16 B aligned)
constexpr int kMaxWarps = 5;               // output tiles per block
constexpr int kTileFloats = kTile * kStride;
constexpr size_t kMaxSmem = 2 * (1 + kMaxWarps) * kTileFloats * sizeof(float);  // 55296 B
constexpr int kMaxDevices = 64;

// Stage depth chunk [u0, u0 + kDepth) of the row tile (xs, kTile rows) and
// of the block's k_t rows (ks, warps x kTile rows). VEC: 16-byte cp.async
// copies (N, B and h multiples of 4, so no group crosses the wrap or U);
// else element by element.
template <bool VEC>
__device__ __forceinline__ void stage(float* xs, float* ks, const float* __restrict__ x,
                                      const float* __restrict__ kz, const long long* row_off,
                                      int u0, int u_len, int fbase, int n, int o0, int b,
                                      int warps) {
  const int nt = blockDim.x;
  constexpr int groups = kDepth / 4;
  const int rows_total = (1 + warps) * kTile;  // the x tile, then the k_t rows
  if constexpr (VEC) {
    for (int i = threadIdx.x; i < rows_total * groups; i += nt) {
      const int r = i / groups, u = u0 + 4 * (i % groups);
      if (r < kTile) {
        const long long off = row_off[r];
        int g = fbase + u;
        g += g < 0 ? n : (g >= n ? -n : 0);
        const bool ok = off >= 0 && u < u_len;
        copy16(xs + r * kStride + (u - u0), ok ? x + off + g : x, ok);
      } else {
        const int o = r - kTile;
        const bool ok = o0 + o < b && u < u_len;
        copy16(ks + o * kStride + (u - u0), ok ? kz + (long long)(o0 + o) * u_len + u : kz, ok);
      }
    }
    copy_commit();
  } else {
    for (int i = threadIdx.x; i < rows_total * kDepth; i += nt) {
      const int r = i / kDepth, u = u0 + i % kDepth;
      float v = 0.f;
      if (r < kTile) {
        const long long off = row_off[r];
        int g = fbase + u;
        g += g < 0 ? n : (g >= n ? -n : 0);
        if (off >= 0 && u < u_len) v = x[off + g];
        xs[r * kStride + (u - u0)] = v;
      } else {
        const int o = r - kTile;
        if (o0 + o < b && u < u_len) v = kz[(long long)(o0 + o) * u_len + u];
        ks[o * kStride + (u - u0)] = v;
      }
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kMaxWarps * 32)
rowwise_conv_kernel(const float* __restrict__ x, const float* __restrict__ k_t,
                    float* __restrict__ out, int m, int s, int n, int taps, int b,
                    int row_tiles) {
  extern __shared__ __align__(16) float smem[];
  __shared__ long long row_off[kTile];  // global row offset, -1 past the rows

  // Scene blockIdx.z / (2 m row_tiles): its 4 paths of x and out, its 2
  // zones of k_t.
  const int per_scene = 2 * m * row_tiles;
  const long long scene = blockIdx.z / per_scene;
  const int u_len = b + taps - 1;
  x += scene * 4 * m * s * n;
  out += scene * 4 * m * s * n;
  k_t += scene * 2 * m * b * u_len;
  const int warps = blockDim.x / 32;
  const int stage_floats = (1 + warps) * kTileFloats;
  const int h = taps / 2;
  const int o0 = blockIdx.x * warps * kTile;
  const int f = blockIdx.y;
  const int zr = blockIdx.z % per_scene;
  const int zm = zr / row_tiles;
  const int r0 = (zr % row_tiles) * kTile;
  const int z = zm / m, mi = zm % m;
  const int rows = 2 * s;
  const float* kz = k_t + ((long long)z * m + mi) * b * u_len;
  const int fbase = f * b - h;

  if (threadIdx.x < kTile) {
    const int r = r0 + threadIdx.x;
    // Row r of this (zone, mic): signal r / S, source r % S.
    row_off[threadIdx.x] =
        r < rows ? (((long long)(2 * (r / s) + z) * m + mi) * s + r % s) * n : -1;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane >> 3, og = lane & 7;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  const int chunks = (u_len + kDepth - 1) / kDepth;
  stage<VEC>(smem, smem + kTileFloats, x, kz, row_off, 0, u_len, fbase, n, o0, b, warps);
  for (int ch = 0; ch < chunks; ++ch) {
    float* cur = smem + (ch & 1) * stage_floats;
    if (ch + 1 < chunks) {
      float* nxt = smem + ((ch + 1) & 1) * stage_floats;
      stage<VEC>(nxt, nxt + kTileFloats, x, kz, row_off, (ch + 1) * kDepth, u_len, fbase, n,
                 o0, b, warps);
      if constexpr (VEC) copy_wait<1>();
    } else if constexpr (VEC) {
      copy_wait<0>();
    }
    __syncthreads();
    const float* xs = cur + rg * kStride;
    const float* ks = cur + kTileFloats + (warp * kTile + og) * kStride;
#pragma unroll 2
    for (int u = 0; u < kDepth; u += 4) {
      float4 xv[8], kv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        xv[i] = *reinterpret_cast<const float4*>(xs + 4 * i * kStride + u);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kv[c] = *reinterpret_cast<const float4*>(ks + 8 * c * kStride + u);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[i][c] = fmaf(xv[i].x, kv[c].x, acc[i][c]);
          acc[i][c] = fmaf(xv[i].y, kv[c].y, acc[i][c]);
          acc[i][c] = fmaf(xv[i].z, kv[c].z, acc[i][c]);
          acc[i][c] = fmaf(xv[i].w, kv[c].w, acc[i][c]);
        }
    }
    __syncthreads();  // the buffer is restaged two chunks on
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long off = row_off[rg + 4 * i];
    if (off < 0) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int o = o0 + warp * kTile + og + 8 * c;
      if (o < b) out[off + f * b + o] = acc[i][c];
    }
  }
}

}  // namespace

// x (4 scenes, m, s, n), k_t (2 scenes, m, b, b + taps - 1) -> out (4 scenes,
// m, s, n); float32, contiguous, taps odd, taps / 2 < n, b divides n. Each
// scene's 4 paths against its 2 zones' k_t: one launch for every scene,
// each scene's arithmetic that of a launch of its own.
extern "C" int rowwise_conv_launch(const float* x, const float* k_t, float* out,
                                   int m, int s, int n, int taps, int b, int scenes,
                                   cudaStream_t stream) {
  const int tiles = (b + kTile - 1) / kTile;
  const int warps = tiles < kMaxWarps ? tiles : kMaxWarps;
  const int row_tiles = (2 * s + kTile - 1) / kTile;
  const dim3 grid((tiles + warps - 1) / warps, n / b, scenes * 2 * m * row_tiles);
  const size_t smem = 2 * (1 + warps) * kTileFloats * sizeof(float);
  const bool vec = n % 4 == 0 && b % 4 == 0 && (taps / 2) % 4 == 0 &&
                   ((uintptr_t)x | (uintptr_t)k_t) % 16 == 0;
  auto kernel = vec ? rowwise_conv_kernel<true> : rowwise_conv_kernel<false>;
  // Both forms may take kMaxSmem: raised once per device, not with a driver
  // call a launch (the weighting-conv hop is host-bound).
  static std::atomic<bool> raised[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices || !raised[dev].load()) {
    e = cudaFuncSetAttribute(rowwise_conv_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(rowwise_conv_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) raised[dev].store(true);
  }
  kernel<<<grid, warps * 32, smem, stream>>>(x, k_t, out, m, s, n, taps, b, row_tiles);
  return (int)cudaGetLastError();
}
