// K2: mic-summed windowed lag correlations of the lag statistics.
//
// Replaces apvast_tpu/ops/pallas/lag_corr.py::lag_corr_pallas.
//   C0[p, s1, s2, l] = sum_m sum_{t<K} x[p, m, s1, t] * x[p, m, s2, t + l],
//   l < J, K = N - J + 1.
//
// Bound: operations. At the north-star shapes (x (4, 17, 17, 999), J=50,
// the target riding as row 17) it is 1.87 GFLOP of fp32 FMA over 4.6 MB
// of input, and only 57,800 outputs: the parallelism has to come from the
// 16,150-deep mic x time sum.
// Design: one cooperative launch in two phases.
//  1. The depth of each path, the mics' time ranges laid end to end, is
//     cut into `slices` equal slices, one block each, as many blocks as the
//     card holds at once (264 on an H100) unless that makes slices shorter
//     than 128 steps. A block owns the whole
//     (S+1) x (S+1) x J cube of its path and slice: its 256 threads each
//     hold a register tile of 6 rows of s1 x 10 lags for one s2 (17 rows
//     pad to 18 and 50 lags to 50: 94% of the FMAs are useful). Per chunk
//     of 256 time steps of one mic the block stages the S+1 rows, with
//     the lag halo, in shared memory by cp.async (4-byte copies: rows of
//     999 floats start on no 16-byte boundary), double-buffered, so the
//     next chunk's loads overlap this chunk's FMAs. A thread reads four
//     time steps of each of its s1 rows as one float4 and slides a window
//     of 13 s2 samples over its 10 lags: 240 FMAs for 6 float4 and 7
//     float2 loads. Only time steps t < K of the slice are multiplied, so
//     a NaN past K in an s2 row reaches only the lags whose window holds
//     it, as in the plain version, and zero rows (the dark paths' target
//     row) are multiplied like any other (0 x NaN stays NaN).
//  2. After a grid barrier every thread of the grid sums one output's
//     `slices` partials in slice order, so the result repeats bit for bit.
// Wider S (more tiles than threads) runs the tiles in passes over the
// slice; one slice (a batch too large for the grid) skips phase 2.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"

#ifndef STAGE_STAMP
#define STAGE_STAMP(kind)  // timer stamps: only tools/k2_k4_stages.py's build has them
#define STAGE_BLOCK(kind)  // every block's start and end of phase 1, likewise
#endif
#ifndef K2_CHUNK
#define K2_CHUNK 256  // time steps of a staged chunk (the tool builds others with -D)
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 6;   // s1 rows of a thread's tile
constexpr int kLags = 10;  // lags of a thread's tile
constexpr int kStep = 4;   // time steps a step: one float4 of each s1 row
constexpr int kWindow = kLags + kStep - 1;  // s2 samples a step, loaded as 7 float2
constexpr int kTile = kRows * kLags;        // outputs of a thread's tile
constexpr int kMaxSmem = 200 * 1024;
constexpr int kMinSlice = 128;  // time steps of the shortest depth slice
constexpr int kMaxDevices = 64;

struct Args {
  const float* x;
  float* out;
  float* part;  // (p4, slices, tiles, 6, 10) partials; unused with one slice
  int p4, m, s, n, j, k;
  int slices;    // depth slices of a path: blocks per path
  int nsg, nlg;  // s1 row groups, lag groups
  int tiles;     // s * nsg * nlg thread tiles of a cube
  int ct;        // time steps of a staged chunk
  int ld;        // row stride of a staged chunk (floats)
};

struct Plan {
  int slices, ct, ld, rows;
  size_t smem;
  bool cooperative;
};

// The chunks of a slice: mic mi's time range [lo, hi) cut into ct steps.
struct Cursor {
  int mi, t, hi;
};

__device__ __forceinline__ Cursor first_chunk(const Args& a, long long q0, long long q1) {
  const int mi = (int)(q0 / a.k);
  const long long base = (long long)mi * a.k;
  return Cursor{mi, (int)(q0 - base), (int)min((long long)a.k, q1 - base)};
}

__device__ __forceinline__ Cursor next_chunk(const Args& a, Cursor c, long long q1) {
  c.t += a.ct;
  if (c.t >= c.hi) {
    ++c.mi;
    c.t = 0;
    c.hi = (int)min((long long)a.k, q1 - (long long)c.mi * a.k);
  }
  return c;
}

// Rows [0, S) of mic c.mi, samples [c.t, c.t + ct + 10 nlg - 1), into buf;
// zeros past N.
__device__ __forceinline__ void stage(const Args& a, int p, Cursor c, float* buf) {
  const int w = a.ct + kLags * a.nlg - 1;
  const float* src = a.x + ((size_t)p * a.m + c.mi) * a.s * a.n + c.t;
  for (int r = 0; r < a.s; ++r) {
    for (int u = threadIdx.x; u < w; u += kThreads) {
      const bool ok = c.t + u < a.n;
      cp_async::copy4(buf + r * a.ld + u, ok ? src + (size_t)r * a.n + u : a.x, ok);
    }
  }
  cp_async::copy_commit();
}

// acc[i][l] += the sum over the kStep time steps from tt of s1 row i x the
// s2 window: a float4 of each row, the window as float2s.
__device__ __forceinline__ void fma_step4(const float* a_rows, const float* w_row, int ld, int tt,
                                          float (&acc)[kRows][kLags]) {
  float av[kRows][kStep];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(a_rows + i * ld + tt);
    av[i][0] = v.x; av[i][1] = v.y; av[i][2] = v.z; av[i][3] = v.w;
  }
  float wv[kWindow + 1];
#pragma unroll
  for (int q = 0; q < (kWindow + 1) / 2; ++q) {
    const float2 v = *reinterpret_cast<const float2*>(w_row + tt + 2 * q);
    wv[2 * q] = v.x;
    wv[2 * q + 1] = v.y;
  }
#pragma unroll
  for (int u = 0; u < kStep; ++u)
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int l = 0; l < kLags; ++l) acc[i][l] = fmaf(av[i][u], wv[u + l], acc[i][l]);
}

__global__ void __launch_bounds__(kThreads, 2) lag_corr_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  STAGE_STAMP(0);
  STAGE_BLOCK(0);
  const int tid = threadIdx.x;
  const int p = blockIdx.x / a.slices, d = blockIdx.x % a.slices;
  const long long depth = (long long)a.m * a.k;
  const long long q0 = depth * d / a.slices, q1 = depth * (d + 1) / a.slices;
  const size_t cube = (size_t)a.s * a.s * a.j;
  // The two staging buffers, smem + (ch & 1) * buf_floats: an offset, not a
  // pointer table, so that the loads stay shared-memory loads.
  const int buf_floats = a.nsg * kRows * a.ld;
  int nchunks = 0;
  for (Cursor c = first_chunk(a, q0, q1); (long long)c.mi * a.k + c.t < q1;
       c = next_chunk(a, c, q1))
    ++nchunks;

  for (int pass = 0; pass * kThreads < a.tiles; ++pass) {
    const int tau = pass * kThreads + tid;
    const bool active = tau < a.tiles;
    const int lg = tau % a.nlg, sg = (tau / a.nlg) % a.nsg, s2 = tau / (a.nlg * a.nsg);
    float acc[kRows][kLags] = {};
    // The pad rows of the last row group are zero (the tiles of a pass
    // before pass through the same memory).
    for (int e = a.s * a.ld + tid; e < buf_floats; e += kThreads) {
      smem[e] = 0.f;
      smem[buf_floats + e] = 0.f;
    }
    Cursor c = first_chunk(a, q0, q1);
    if (nchunks) stage(a, p, c, smem);
    for (int ch = 0; ch < nchunks; ++ch) {
      const Cursor nx = next_chunk(a, c, q1);
      if (ch + 1 < nchunks) {
        stage(a, p, nx, smem + ((ch + 1) & 1) * buf_floats);
      } else {
        cp_async::copy_commit();
      }
      cp_async::copy_wait<1>();
      STAGE_STAMP(1);
      __syncthreads();
      STAGE_STAMP(2);
      if (pass == 0 && ch == 0) STAGE_BLOCK(2);
      if (active) {
        const float* buf = smem + (ch & 1) * buf_floats;
        const float* a_rows = buf + sg * kRows * a.ld;
        const float* w_row = buf + s2 * a.ld + lg * kLags;
        const int len = min(a.ct, c.hi - c.t);
        const int whole = len & ~(kStep - 1);
#pragma unroll 2
        for (int tt = 0; tt < whole; tt += kStep) fma_step4(a_rows, w_row, a.ld, tt, acc);
        for (int tt = whole; tt < len; ++tt) {
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const float av = a_rows[i * a.ld + tt];
#pragma unroll
            for (int l = 0; l < kLags; ++l) acc[i][l] = fmaf(av, w_row[tt + l], acc[i][l]);
          }
        }
      }
      STAGE_STAMP(3);
      __syncthreads();
      STAGE_STAMP(4);
      if (ch + 1 == nchunks) STAGE_BLOCK(3);
      c = nx;
    }
    if (a.slices == 1) {
      // One slice: the tile straight into the output.
      if (active) {
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int s1 = sg * kRows + i;
          if (s1 >= a.s) continue;
          float* row = a.out + (size_t)p * cube + ((size_t)s1 * a.s + s2) * a.j;
#pragma unroll
          for (int l = 0; l < kLags; ++l) {
            const int lag = lg * kLags + l;
            if (lag < a.j) row[lag] = acc[i][l];
          }
        }
      }
    } else {
      // The pass's tiles, tile-major (tau, row, lag), are one contiguous
      // range of the slice's partials: through shared memory, so that the
      // block writes it in whole sectors.
      float* tile = smem + tid * kTile;
      if (active) {
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int l = 0; l < kLags; l += 2)
            *reinterpret_cast<float2*>(tile + i * kLags + l) = make_float2(acc[i][l], acc[i][l + 1]);
      }
      __syncthreads();
      const int n4 = min(kThreads, a.tiles - pass * kThreads) * kTile / 4;
      float4* dst = reinterpret_cast<float4*>(
          a.part + (((size_t)p * a.slices + d) * a.tiles + (size_t)pass * kThreads) * kTile);
      for (int e = tid; e < n4; e += kThreads) dst[e] = reinterpret_cast<const float4*>(smem)[e];
      __syncthreads();
    }
    STAGE_STAMP(5);
  }
  STAGE_BLOCK(1);
  if (a.slices == 1) return;

  cg::this_grid().sync();
  STAGE_STAMP(7);
  // Every partial index of a path (tile-major), its slices summed in slice
  // order into its output.
  const size_t per_slice = (size_t)a.tiles * kTile, total = (size_t)a.p4 * per_slice;
  for (size_t e = (size_t)blockIdx.x * kThreads + tid; e < total;
       e += (size_t)gridDim.x * kThreads) {
    const size_t p_ = e / per_slice, idx = e % per_slice;
    const int tau = (int)(idx / kTile), i = (int)(idx % kTile) / kLags, l = (int)(idx % kLags);
    const int s1 = ((tau / a.nlg) % a.nsg) * kRows + i, lag = (tau % a.nlg) * kLags + l;
    if (s1 >= a.s || lag >= a.j) continue;
    const int s2 = tau / (a.nlg * a.nsg);
    const float* src = a.part + p_ * a.slices * per_slice + idx;
    float v = src[0];
#pragma unroll 8
    for (int sl = 1; sl < a.slices; ++sl) v += src[(size_t)sl * per_slice];
    a.out[p_ * cube + ((size_t)s1 * a.s + s2) * a.j + lag] = v;
  }
  STAGE_STAMP(6);
}

// The launch shape: the chunk length and row stride that fit shared memory,
// and as many depth slices a path as the card holds blocks at once.
cudaError_t make_plan(int p4, int m, int s, int n, int j, Plan& pl) {
  const int nsg = (s + kRows - 1) / kRows, nlg = (j + kLags - 1) / kLags;
  pl.rows = nsg * kRows;
  for (pl.ct = K2_CHUNK;; pl.ct /= 2) {
    // One float past the window: a whole step's float2 loads read it.
    const int w = pl.ct + kLags * nlg - 1;
    const int w4 = (w + 1 + 3) & ~3;
    pl.ld = w4 + ((4 - w4) & 31);  // 4 mod 32: the row groups' float4 loads on other banks
    // Two staging buffers; a pass's tiles pass through the same memory.
    const size_t staging = 2 * (size_t)pl.rows * pl.ld, tiles = (size_t)kThreads * kTile;
    pl.smem = (staging > tiles ? staging : tiles) * sizeof(float);
    if (pl.smem <= kMaxSmem) break;
    if (pl.ct == 16) return cudaErrorInvalidValue;
  }
  static int sms[kMaxDevices], last_bytes[kMaxDevices], per_sm[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (last_bytes[dev] != (int)pl.smem) {
    if ((e = cudaFuncSetAttribute(lag_corr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)pl.smem)) != cudaSuccess)
      return e;
    if ((e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev)) !=
        cudaSuccess)
      return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[dev], lag_corr_kernel,
                                                           kThreads, pl.smem)) != cudaSuccess)
      return e;
    if (per_sm[dev] < 1) return cudaErrorInvalidConfiguration;
    last_bytes[dev] = (int)pl.smem;
  }
  // As many slices as the card holds blocks, but none shorter than
  // kMinSlice steps: a slice's partials cost a store and a load of the
  // whole cube, which short slices would not repay (the north star's are
  // 245 steps long).
  const long long depth = (long long)m * (n - j + 1);
  const long long fit = (long long)per_sm[dev] * sms[dev] / p4;
  const long long most = (depth + kMinSlice - 1) / kMinSlice;
  pl.slices = (int)(fit < most ? fit : most);
  if (pl.slices < 2) pl.slices = 1;
  pl.cooperative = pl.slices > 1;
  return cudaSuccess;
}

}  // namespace

// Floats of the workspace that lag_corr_launch needs for these shapes (the
// partials of the depth slices; 0 for one slice), or minus a cudaError.
extern "C" long long lag_corr_workspace_floats(int p4, int m, int s, int n, int j) {
  if (p4 < 1 || m < 1 || s < 1 || j < 1 || j > n) return -(long long)cudaErrorInvalidValue;
  Plan pl;
  const cudaError_t e = make_plan(p4, m, s, n, j, pl);
  if (e != cudaSuccess) return -(long long)e;
  const long long tiles = (long long)s * ((s + kRows - 1) / kRows) * ((j + kLags - 1) / kLags);
  return pl.slices > 1 ? (long long)p4 * pl.slices * tiles * kTile : 0;
}

// x (p4, m, s, n) -> out (p4, s, s, j); float32, contiguous, j <= n; ws
// holds lag_corr_workspace_floats(p4, m, s, n, j) floats.
extern "C" int lag_corr_launch(const float* x, float* out, float* ws, int p4, int m, int s,
                               int n, int j, cudaStream_t stream) {
  if (p4 < 1 || m < 1 || s < 1 || j < 1 || j > n) return (int)cudaErrorInvalidValue;
  Plan pl;
  cudaError_t e = make_plan(p4, m, s, n, j, pl);
  if (e != cudaSuccess) return (int)e;
  Args args{x, out, ws, p4, m, s, n, j, n - j + 1, pl.slices,
            (s + kRows - 1) / kRows, (j + kLags - 1) / kLags,
            s * ((s + kRows - 1) / kRows) * ((j + kLags - 1) / kLags), pl.ct, pl.ld};
  const int grid = p4 * pl.slices;
  if (pl.cooperative) {
    void* kargs[] = {&args};
    e = cudaLaunchCooperativeKernel((void*)lag_corr_kernel, grid, kThreads, kargs, pl.smem,
                                    stream);
    if (e != cudaSuccess) return (int)e;
  } else {
    lag_corr_kernel<<<grid, kThreads, pl.smem, stream>>>(args);
  }
  return (int)cudaGetLastError();
}
