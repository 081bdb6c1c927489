// K5: RMSNorm out = x * rsqrt(mean(x^2) + eps) * (1 + scale), row by row (Hopper).
//
// Replaces the TPU kernel `_rms_kernel` (src/repro/kernels/rms_norm.py), which
// kept a tile of 128 full rows in VMEM, took the f32 mean of squares and
// scaled in one pass over HBM.
//
// What bounds it: bytes.  It does about 4 flops per element on 2 or 4 bytes
// read and the same written, far below the card's ridge point, so the design
// goal is to read each row once from HBM with wide loads and to keep every
// SM busy.
//
// Two routes, chosen by the Python wrapper (rms_norm.route):
//
// Resident route (atlas_rms_norm_resident; the served and trained widths
// 128, 2048, 2560, 3584, 4096, 5120 and 7168 in bf16 or f32, 16-byte
// aligned).  TPR threads own a row and each holds the same whole number PPT
// of 16-byte packs (table at atlas_rms_norm_resident: 4 or 5 packs a thread
// for the wide bf16 rows, 2 for bf16 3584 and 7168 (seven and fourteen warps
// a row), 4 for f32 2048, 3584 and 7168, 8 for f32 4096, 10 for f32 5120,
// and for f32 2560 one warp owns a row with 20 packs a lane; one or two for
// 128), so no thread idles in a ragged last step.  The row stays in registers
// between the sum of squares and the scaling, so x is read once; each thread
// loads its packs of `scale` once per block.  The grid is sized to the
// card's resident blocks and walks the rows in a grid-stride loop, issuing
// the next row's loads before this row's reduction, so loads stay in flight
// across rows.  The reduction order is fixed: the thread's packs in order, a
// warp xor tree, then the row's warps in order (through shared memory,
// double-buffered by row parity, one __syncthreads per row).
//
// General route (atlas_rms_norm; every other width, e.g. musicgen's 1536
// and starcoder2's 3072, and unaligned views).  A group of threads owns one
// row.  For rows of at most 1024 values the group is one warp and a block of
// 256 threads holds eight rows; for wider rows the group is the whole block.
// Each thread reads VEC consecutive values per load (16 bytes: 4 f32 or 8
// bf16) when the row length and the pointers allow it, else one value.
// Squares are summed in f32 in the thread's fixed element order, then across the warp with an xor-shuffle tree and, for a
// block row, across the warps in warp order through shared memory: one fixed
// summation order, the same bits on every run.  The second pass re-reads the
// row (from L1/L2, it was just loaded).
//
// Both scale in f32 in the reference's order ((x * r) * (1 + scale)) and
// store in x's dtype.  The backward (for training) has the same two routes
// under the same rule, below: the resident one
// (atlas_rms_norm_bwd_resident) reads x and dy once into registers and
// keeps dscale's per-column sums in registers; the general one
// (atlas_rms_norm_bwd) makes two passes over the row and sums dscale in a
// shared-memory slice.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (repro_torch/kernels/_build.py), loaded by ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// GROUP threads own one row: 32 (a warp, kWarps rows per block) or kThreads.
template <typename T, int VEC, int GROUP>
__global__ void __launch_bounds__(kThreads)
rms_kernel(const T* __restrict__ x, const T* __restrict__ scale, T* __restrict__ out,
           int n, int d, float eps) {
  using P = Pack<T, VEC>;
  constexpr int kRowsPerBlock = kThreads / GROUP;
  const int lane = threadIdx.x % GROUP;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / GROUP;
  const bool active = row < n;  // every thread still joins the reductions
  const T* xr = x + row * d;
  T* outr = out + row * d;

  float ss = 0.0f;
  if (active) {
    for (int i = lane * VEC; i < d; i += GROUP * VEC) {
      const P p = *reinterpret_cast<const P*>(xr + i);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = to_f32(p.v[e]);
        ss = fmaf(f, f, ss);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if constexpr (GROUP == kThreads) {
    __shared__ float partial[kWarps];
    if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = ss;
    __syncthreads();
    ss = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) ss += partial[w];
  }
  if (!active) return;
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  for (int i = lane * VEC; i < d; i += GROUP * VEC) {
    const P p = *reinterpret_cast<const P*>(xr + i);
    const P s = *reinterpret_cast<const P*>(scale + i);
    P o;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      o.v[e] = from_f32<T>((to_f32(p.v[e]) * r) * (1.0f + to_f32(s.v[e])));
    }
    *reinterpret_cast<P*>(outr + i) = o;
  }
}

template <typename T, int VEC>
void launch(const void* x, const void* scale, void* out, int n, int d, float eps,
            cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* sp = static_cast<const T*>(scale);
  T* op = static_cast<T*>(out);
  if (d <= 1024) {
    const int blocks = (n + kWarps - 1) / kWarps;
    rms_kernel<T, VEC, 32><<<blocks, kThreads, 0, stream>>>(xp, sp, op, n, d, eps);
  } else {
    rms_kernel<T, VEC, kThreads><<<n, kThreads, 0, stream>>>(xp, sp, op, n, d, eps);
  }
}

// ---------------------------------------------------------------- resident route

// TPR threads own a row, each PPT 16-byte packs at columns (lane + k*TPR)*VEC;
// a block of BLOCK threads walks BLOCK / TPR rows at a time.
template <typename T, int D, int TPR, int BLOCK>
__global__ void __launch_bounds__(BLOCK)
rms_resident_kernel(const T* __restrict__ x, const T* __restrict__ scale, T* __restrict__ out,
                    int n, float eps) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  constexpr int PPT = D / (VEC * TPR);
  static_assert(PPT * VEC * TPR == D && TPR <= BLOCK && BLOCK % TPR == 0, "layout");
  static_assert(TPR <= 32 || TPR % 32 == 0, "a row is part of a warp or whole warps");
  constexpr int RPB = BLOCK / TPR;        // rows per block step
  constexpr int LANES = TPR < 32 ? TPR : 32;  // the xor tree's width
  constexpr int WPR = TPR / 32;           // warps per row when a row spans warps
  using Pk = Pack<T, VEC>;
  __shared__ float partial[2][BLOCK / 32];

  const int g = threadIdx.x / TPR;
  const int lane = threadIdx.x % TPR;
  Pk sc[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) sc[k] = *reinterpret_cast<const Pk*>(scale + (lane + k * TPR) * VEC);

  const int64_t step = static_cast<int64_t>(gridDim.x) * RPB;
  int64_t row = static_cast<int64_t>(blockIdx.x) * RPB + g;
  Pk cur[PPT];
  if (row < n) {
#pragma unroll
    for (int k = 0; k < PPT; ++k)
      cur[k] = *reinterpret_cast<const Pk*>(x + row * D + (lane + k * TPR) * VEC);
  }
  int parity = 0;
  // the loop bound is the block's, so every thread reaches every barrier
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * RPB; base < n;
       base += step, row += step, parity ^= 1) {
    const bool active = row < n;
    Pk nxt[PPT];
    if (row + step < n) {  // the next row's loads fly during this row's reduction
#pragma unroll
      for (int k = 0; k < PPT; ++k)
        nxt[k] = *reinterpret_cast<const Pk*>(x + (row + step) * D + (lane + k * TPR) * VEC);
    }
    float ss = 0.0f;
    if (active) {
#pragma unroll
      for (int k = 0; k < PPT; ++k)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float f = to_f32(cur[k].v[e]);
          ss = fmaf(f, f, ss);
        }
    }
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if constexpr (WPR > 1) {
      if (threadIdx.x % 32 == 0) partial[parity][threadIdx.x / 32] = ss;
      __syncthreads();
      ss = 0.0f;
#pragma unroll
      for (int w = 0; w < WPR; ++w) ss += partial[parity][g * WPR + w];
    }
    if (active) {
      const float r = rsqrtf(ss / static_cast<float>(D) + eps);
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        Pk o;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          o.v[e] = from_f32<T>((to_f32(cur[k].v[e]) * r) * (1.0f + to_f32(sc[k].v[e])));
        *reinterpret_cast<Pk*>(out + row * D + (lane + k * TPR) * VEC) = o;
      }
    }
#pragma unroll
    for (int k = 0; k < PPT; ++k) cur[k] = nxt[k];
  }
}

template <typename T, int D, int TPR, int BLOCK>
cudaError_t launch_resident(const void* x, const void* scale, void* out, int n, float eps,
                            cudaStream_t stream) {
  auto kernel = rms_resident_kernel<T, D, TPR, BLOCK>;
  static int max_blocks = 0;  // blocks resident on the whole card at once
  if (max_blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BLOCK, 0);
    if (err != cudaSuccess) return err;
    max_blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  constexpr int RPB = BLOCK / TPR;
  const int64_t need = (static_cast<int64_t>(n) + RPB - 1) / RPB;
  const int blocks = static_cast<int>(need < max_blocks ? need : max_blocks);
  kernel<<<blocks, BLOCK, 0, stream>>>(static_cast<const T*>(x), static_cast<const T*>(scale),
                                          static_cast<T*>(out), n, eps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- backward
// The gradient of out = (x * r) * (1 + scale), r = rsqrt(mean(x^2) + eps),
// row by row in f32:
//   dx     = r * (1 + scale) * dy - x * r^3 * mean(x * (1 + scale) * dy)
//   dscale = sum over rows of dy * x * r
// No Pallas counterpart: the reference differentiates rms_norm's jnp form
// with XLA.  Bound by bytes, like the forward: x and dy read, dx written.
//
// General route (atlas_rms_norm_bwd; every width the resident route below
// does not take).  GROUP threads own a row (a warp for rows of at most 1024 values, eight
// rows a block; the whole block for wider rows) and the grid, a fixed
// number of blocks for the card, walks the rows.  Pass 1 sums x^2 and
// x * (1 + scale) * dy (the thread's elements in order, the xor tree, the
// row's warps in order); pass 2 writes dx and adds dy * x * r into the
// block's dscale slice in shared memory, where each thread only ever
// touches its own columns.  The block then sums its row slots in order
// into partial[block, d], and a second launch sums partial over the blocks
// in block order: dscale has one summation order and no float atomics.
template <typename T, int VEC, int GROUP>
__global__ void __launch_bounds__(kThreads)
rms_bwd_kernel(const T* __restrict__ x, const T* __restrict__ scale, const T* __restrict__ dy,
               T* __restrict__ dx, float* __restrict__ partial, int n, int d, float eps) {
  using P = Pack<T, VEC>;
  constexpr int kRows = kThreads / GROUP;
  extern __shared__ float ds[];  // [kRows][d]: this block's dscale, one slice per row slot
  __shared__ float red[2][2][kWarps];  // (sum x^2, sum x*w*dy) per warp, by row parity
  const int slot = threadIdx.x / GROUP;
  const int lane = threadIdx.x % GROUP;
  float* dsr = ds + static_cast<int64_t>(slot) * d;
  for (int i = lane * VEC; i < d; i += GROUP * VEC)
#pragma unroll
    for (int e = 0; e < VEC; ++e) dsr[i + e] = 0.0f;

  int parity = 0;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kRows; base < n;
       base += static_cast<int64_t>(gridDim.x) * kRows, parity ^= 1) {
    const int64_t row = base + slot;
    const bool active = row < n;  // every thread still joins the reductions
    const T* xr = x + row * d;
    const T* gr = dy + row * d;
    float ss = 0.0f, sd = 0.0f;
    if (active) {
      for (int i = lane * VEC; i < d; i += GROUP * VEC) {
        const P px = *reinterpret_cast<const P*>(xr + i);
        const P pg = *reinterpret_cast<const P*>(gr + i);
        const P ps = *reinterpret_cast<const P*>(scale + i);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float f = to_f32(px.v[e]);
          ss = fmaf(f, f, ss);
          sd = fmaf(f * (1.0f + to_f32(ps.v[e])), to_f32(pg.v[e]), sd);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      sd += __shfl_xor_sync(0xffffffffu, sd, off);
    }
    if constexpr (GROUP == kThreads) {
      if (threadIdx.x % 32 == 0) {
        red[parity][0][threadIdx.x / 32] = ss;
        red[parity][1][threadIdx.x / 32] = sd;
      }
      __syncthreads();
      ss = 0.0f;
      sd = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        ss += red[parity][0][w];
        sd += red[parity][1][w];
      }
    }
    if (!active) continue;
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    const float c = r * r * r * (sd / static_cast<float>(d));
    T* dxr = dx + row * d;
    for (int i = lane * VEC; i < d; i += GROUP * VEC) {
      const P px = *reinterpret_cast<const P*>(xr + i);
      const P pg = *reinterpret_cast<const P*>(gr + i);
      const P ps = *reinterpret_cast<const P*>(scale + i);
      P o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = to_f32(px.v[e]);
        const float g = to_f32(pg.v[e]);
        o.v[e] = from_f32<T>(r * (1.0f + to_f32(ps.v[e])) * g - f * c);
        dsr[i + e] = fmaf(g, f * r, dsr[i + e]);
      }
      *reinterpret_cast<P*>(dxr + i) = o;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < d; i += kThreads) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kRows; ++k) acc += ds[static_cast<int64_t>(k) * d + i];
    partial[static_cast<int64_t>(blockIdx.x) * d + i] = acc;
  }
}

// dscale[i] = sum over b of partial[b, i], in block order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_bwd_reduce_kernel(const float* __restrict__ partial, T* __restrict__ dscale, int blocks,
                      int d) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= d) return;
  float acc = 0.0f;
  for (int b = 0; b < blocks; ++b) acc += partial[static_cast<int64_t>(b) * d + i];
  dscale[i] = from_f32<T>(acc);
}

template <typename T, int VEC, int GROUP>
cudaError_t launch_bwd(const void* x, const void* scale, const void* dy, void* dx, void* dscale,
                       float* partial, int n, int d, int blocks, float eps, cudaStream_t stream) {
  auto kernel = rms_bwd_kernel<T, VEC, GROUP>;
  const size_t bytes = sizeof(float) * static_cast<size_t>(kThreads / GROUP) * d;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<const T*>(dy),
      static_cast<T*>(dx), partial, n, d, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rms_bwd_reduce_kernel<T><<<(d + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partial, static_cast<T*>(dscale), blocks, d);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_bwd_rows(const void* x, const void* scale, const void* dy, void* dx,
                            void* dscale, float* partial, int n, int d, int blocks, float eps,
                            cudaStream_t stream) {
  if (d <= 1024)
    return launch_bwd<T, VEC, 32>(x, scale, dy, dx, dscale, partial, n, d, blocks, eps, stream);
  return launch_bwd<T, VEC, kThreads>(x, scale, dy, dx, dscale, partial, n, d, blocks, eps,
                                      stream);
}

// ---------------------------------------------------------------- backward, resident route
// The forward's resident widths (128, 2048, 2560, 3584, 4096, 5120, 7168) in
// bf16 or f32, 16-byte aligned.  TPR threads own a row, each PPT (2 or 4) 16-byte packs of x and
// of dy at columns (lane + k*TPR)*VEC, read once into registers, and the
// next row's packs are loaded while this row is reduced and written.  Both
// row sums, x^2 and x*(1+scale)*dy, go up one xor tree together (and across
// the row's warps through shared memory, double-buffered by row parity);
// dx is written from the registers.  Each thread adds dy*x*r for its fixed
// columns into f32 registers over the rows the grid (blocks, fixed per card
// by the caller) gives its block; at the end the block's RPB row groups are
// summed in order into partial[block, d], written once, and
// rms_bwd_partial_sum_kernel sums partial over the blocks in one fixed
// order (runs of consecutive blocks, each in block order, then the runs in
// order) with 16-byte loads: no float atomics.  scale is read from L1 at
// each use rather than held, to keep two blocks an SM (at 7168 the layout
// is sized for one: two spill).
template <typename T, int D, int TPR, int BLOCK, int MINB>
__global__ void __launch_bounds__(BLOCK, MINB)
rms_bwd_resident_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        float* __restrict__ partial, int n, float eps) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  constexpr int PPT = D / (VEC * TPR);
  static_assert(PPT * VEC * TPR == D && TPR <= BLOCK && BLOCK % TPR == 0, "layout");
  static_assert(TPR <= 32 || TPR % 32 == 0, "a row is part of a warp or whole warps");
  constexpr int RPB = BLOCK / TPR;            // rows per block step
  constexpr int LANES = TPR < 32 ? TPR : 32;  // the xor tree's width
  constexpr int WPR = TPR / 32;               // warps per row when a row spans warps
  using Pk = Pack<T, VEC>;
  __shared__ float red[2][2][BLOCK / 32];  // (sum x^2, sum x*w*dy) per warp, by row parity
  __shared__ __align__(16) float acc_s[RPB > 1 ? RPB * D : 4];

  const int g = threadIdx.x / TPR;
  const int lane = threadIdx.x % TPR;
  float ds[PPT][VEC];
#pragma unroll
  for (int k = 0; k < PPT; ++k)
#pragma unroll
    for (int e = 0; e < VEC; ++e) ds[k][e] = 0.0f;

  const int64_t step = static_cast<int64_t>(gridDim.x) * RPB;
  int64_t row = static_cast<int64_t>(blockIdx.x) * RPB + g;
  Pk px[PPT], pg[PPT];
  if (row < n) {
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      px[k] = *reinterpret_cast<const Pk*>(x + row * D + (lane + k * TPR) * VEC);
      pg[k] = *reinterpret_cast<const Pk*>(dy + row * D + (lane + k * TPR) * VEC);
    }
  }
  int parity = 0;
  // the loop bound is the block's, so every thread reaches every barrier
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * RPB; base < n;
       base += step, row += step, parity ^= 1) {
    const bool active = row < n;
    Pk nx[PPT], ng[PPT];
    if (row + step < n) {  // the next row's loads fly during this row's work
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        nx[k] = *reinterpret_cast<const Pk*>(x + (row + step) * D + (lane + k * TPR) * VEC);
        ng[k] = *reinterpret_cast<const Pk*>(dy + (row + step) * D + (lane + k * TPR) * VEC);
      }
    }
    float ss = 0.0f, sd = 0.0f;
    if (active) {
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const Pk ps = *reinterpret_cast<const Pk*>(scale + (lane + k * TPR) * VEC);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float f = to_f32(px[k].v[e]);
          ss = fmaf(f, f, ss);
          sd = fmaf(f * (1.0f + to_f32(ps.v[e])), to_f32(pg[k].v[e]), sd);
        }
      }
    }
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      sd += __shfl_xor_sync(0xffffffffu, sd, off);
    }
    if constexpr (WPR > 1) {
      if (threadIdx.x % 32 == 0) {
        red[parity][0][threadIdx.x / 32] = ss;
        red[parity][1][threadIdx.x / 32] = sd;
      }
      __syncthreads();
      ss = 0.0f;
      sd = 0.0f;
#pragma unroll
      for (int w = 0; w < WPR; ++w) {
        ss += red[parity][0][g * WPR + w];
        sd += red[parity][1][g * WPR + w];
      }
    }
    if (active) {
      const float r = rsqrtf(ss / static_cast<float>(D) + eps);
      const float c = r * r * r * (sd / static_cast<float>(D));
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const Pk ps = *reinterpret_cast<const Pk*>(scale + (lane + k * TPR) * VEC);
        Pk o;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float f = to_f32(px[k].v[e]);
          const float gv = to_f32(pg[k].v[e]);
          o.v[e] = from_f32<T>(r * (1.0f + to_f32(ps.v[e])) * gv - f * c);
          ds[k][e] = fmaf(gv, f * r, ds[k][e]);
        }
        *reinterpret_cast<Pk*>(dx + row * D + (lane + k * TPR) * VEC) = o;
      }
    }
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      px[k] = nx[k];
      pg[k] = ng[k];
    }
  }

  float* pr = partial + static_cast<int64_t>(blockIdx.x) * D;
  if constexpr (RPB == 1) {
#pragma unroll
    for (int k = 0; k < PPT; ++k)
#pragma unroll
      for (int e = 0; e < VEC; e += 4)
        *reinterpret_cast<float4*>(pr + (lane + k * TPR) * VEC + e) =
            make_float4(ds[k][e], ds[k][e + 1], ds[k][e + 2], ds[k][e + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < PPT; ++k)
#pragma unroll
      for (int e = 0; e < VEC; e += 4)
        *reinterpret_cast<float4*>(acc_s + g * D + (lane + k * TPR) * VEC + e) =
            make_float4(ds[k][e], ds[k][e + 1], ds[k][e + 2], ds[k][e + 3]);
    __syncthreads();
    for (int i = threadIdx.x * 4; i < D; i += BLOCK * 4) {  // the row groups in order
      float4 a = *reinterpret_cast<const float4*>(acc_s + i);
#pragma unroll
      for (int gg = 1; gg < RPB; ++gg) {
        const float4 b = *reinterpret_cast<const float4*>(acc_s + gg * D + i);
        a.x += b.x;
        a.y += b.y;
        a.z += b.z;
        a.w += b.w;
      }
      *reinterpret_cast<float4*>(pr + i) = a;
    }
  }
}

// dscale[i..i+3] = sum over b of partial[b, i..i+3] in one fixed order:
// kRuns runs of consecutive blocks, each summed in block order by its own
// thread (16-byte loads, so a run's loads are in flight together), then the
// runs' sums added in run order.  A block covers kQuads column quads.
constexpr int kRuns = 16;
constexpr int kQuads = kThreads / kRuns;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_bwd_partial_sum_kernel(const float* __restrict__ partial, T* __restrict__ dscale, int blocks,
                           int d) {
  __shared__ float4 runs[kRuns][kQuads];
  const int quad = threadIdx.x % kQuads;
  const int run = threadIdx.x / kQuads;
  const int i = (blockIdx.x * kQuads + quad) * 4;
  const int per = (blocks + kRuns - 1) / kRuns;
  const int b1 = min(blocks, (run + 1) * per);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (i < d) {
#pragma unroll 8
    for (int b = run * per; b < b1; ++b) {
      const float4 p = *reinterpret_cast<const float4*>(partial + static_cast<int64_t>(b) * d + i);
      acc.x += p.x;
      acc.y += p.y;
      acc.z += p.z;
      acc.w += p.w;
    }
  }
  runs[run][quad] = acc;
  __syncthreads();
  if (run != 0 || i >= d) return;
#pragma unroll
  for (int r = 1; r < kRuns; ++r) {
    const float4 p = runs[r][quad];
    acc.x += p.x;
    acc.y += p.y;
    acc.z += p.z;
    acc.w += p.w;
  }
  dscale[i] = from_f32<T>(acc.x);
  dscale[i + 1] = from_f32<T>(acc.y);
  dscale[i + 2] = from_f32<T>(acc.z);
  dscale[i + 3] = from_f32<T>(acc.w);
}

template <typename T, int D, int TPR, int BLOCK, int MINB = 2>
cudaError_t launch_bwd_resident(const void* x, const void* scale, const void* dy, void* dx,
                                void* dscale, float* partial, int n, int blocks, float eps,
                                cudaStream_t stream) {
  rms_bwd_resident_kernel<T, D, TPR, BLOCK, MINB><<<blocks, BLOCK, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<const T*>(dy),
      static_cast<T*>(dx), partial, n, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rms_bwd_partial_sum_kernel<T><<<(D / 4 + kQuads - 1) / kQuads, kThreads, 0, stream>>>(
      partial, static_cast<T*>(dscale), blocks, D);
  return cudaGetLastError();
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

}  // namespace

// The resident route: x, out [n, d] and scale [d] of one dtype (0 = float32,
// 1 = bfloat16), contiguous and 16-byte aligned; d = 128, 2048, 2560, 3584,
// 4096, 5120 or 7168.  Threads per row x 16-byte packs per thread, threads per block
// (each the fastest of the layouts timed on the H100 at the served shapes:
// one row per block beat 256-thread blocks of several rows for the wide
// rows, and a warp per row for f32 2560; 2048 follows the wide rows' one row
// per block): bf16 128 = 16 x 1 in 256, 2048 = 64 x 4 in 64, 2560 = 64 x 5
// in 64, 4096 = 128 x 4 in 128, 5120 = 128 x 5 in 128; f32 128 = 16 x 2 in
// 256, 2048 = 128 x 4 in 128, 2560 = 32 x 20 in 256, 4096 = 128 x 8 in 128,
// 5120 = 128 x 10 in 128.  At 4096 the bf16 candidates 64 x 8, 128 x 4 and
// 256 x 2 lay within 3 % of each other and f32 128 x 8 beat 256 x 4 by 1-5 %
// (PERF.md).  3584 and 7168, one row a block: bf16 3584 = 224 x 2, f32
// 3584 = 224 x 4, bf16 7168 = 448 x 2, f32 7168 = 448 x 4.  On the H100
// (the candidates timed side by side in one run, PERF.md), bf16 3584's 224 x 2
// took 0.0247 / 0.0079 / 0.0102 ms at [4096 / 1024 / 2048, 3584], 64 x 7
// 0.0246 / 0.0079 / 0.0103 and 448 x 1 0.0255 / 0.0088 / 0.0117; f32 3584's
// 128 x 7, 224 x 4 and 448 x 2 0.0471, 0.0467 and 0.0462 at [4096, 3584];
// at [250, 7168] bf16 128 x 7, 224 x 4 and 448 x 2 0.0070, 0.0068 and 0.0068,
// f32 256 x 7, 448 x 4 and 896 x 2 0.0077, 0.0078 and 0.0080.  Layouts
// within 2 % of the fastest tie, so each width keeps one thread count in
// both dtypes.  Returns cudaGetLastError(), or cudaErrorInvalidValue for
// another width, dtype or alignment.
extern "C" int atlas_rms_norm_resident(const void* x, const void* scale, void* out, int n, int d,
                                       float eps, int dtype, void* stream) {
  if (!aligned16({x, scale, out})) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1) {
    using T = __nv_bfloat16;
    if (d == 128) err = launch_resident<T, 128, 16, 256>(x, scale, out, n, eps, st);
    if (d == 2048) err = launch_resident<T, 2048, 64, 64>(x, scale, out, n, eps, st);
    if (d == 2560) err = launch_resident<T, 2560, 64, 64>(x, scale, out, n, eps, st);
    if (d == 3584) err = launch_resident<T, 3584, 224, 224>(x, scale, out, n, eps, st);
    if (d == 4096) err = launch_resident<T, 4096, 128, 128>(x, scale, out, n, eps, st);
    if (d == 5120) err = launch_resident<T, 5120, 128, 128>(x, scale, out, n, eps, st);
    if (d == 7168) err = launch_resident<T, 7168, 448, 448>(x, scale, out, n, eps, st);
  } else if (dtype == 0) {
    if (d == 128) err = launch_resident<float, 128, 16, 256>(x, scale, out, n, eps, st);
    if (d == 2048) err = launch_resident<float, 2048, 128, 128>(x, scale, out, n, eps, st);
    if (d == 2560) err = launch_resident<float, 2560, 32, 256>(x, scale, out, n, eps, st);
    if (d == 3584) err = launch_resident<float, 3584, 224, 224>(x, scale, out, n, eps, st);
    if (d == 4096) err = launch_resident<float, 4096, 128, 128>(x, scale, out, n, eps, st);
    if (d == 5120) err = launch_resident<float, 5120, 128, 128>(x, scale, out, n, eps, st);
    if (d == 7168) err = launch_resident<float, 7168, 448, 448>(x, scale, out, n, eps, st);
  }
  return static_cast<int>(err);
}

// dtype: 0 = float32, 1 = bfloat16 (x, scale and out share it).  vec: 1, or
// 16 bytes' worth of values (the caller checks d % vec == 0 and 16-byte
// alignment of every pointer).  Returns cudaGetLastError().
extern "C" int atlas_rms_norm(const void* x, const void* scale, void* out, int n, int d,
                              float eps, int dtype, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4) {
    launch<float, 4>(x, scale, out, n, d, eps, st);
  } else if (dtype == 0 && vec == 1) {
    launch<float, 1>(x, scale, out, n, d, eps, st);
  } else if (dtype == 1 && vec == 8) {
    launch<__nv_bfloat16, 8>(x, scale, out, n, d, eps, st);
  } else if (dtype == 1 && vec == 1) {
    launch<__nv_bfloat16, 1>(x, scale, out, n, d, eps, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward: x, dy, dx [n, d], scale, dscale [d] of one dtype (0 =
// float32, 1 = bfloat16), contiguous; partial [blocks, d] float32 scratch,
// blocks >= 1 (a fixed count for the card: it fixes dscale's summation
// order); vec as for atlas_rms_norm, checked for every pointer by the
// caller; d * 4 bytes (d <= 1024: 8 * d * 4) of shared memory must fit a
// block.  Two launches (the rows, then the reduction over blocks).
// Returns the first launch error.
extern "C" int atlas_rms_norm_bwd(const void* x, const void* scale, const void* dy, void* dx,
                                  void* dscale, void* partial, int n, int d, int blocks,
                                  float eps, int dtype, int vec, void* stream) {
  if (blocks < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(partial);
  if (dtype == 0 && vec == 4)
    return static_cast<int>(launch_bwd_rows<float, 4>(x, scale, dy, dx, dscale, pp, n, d, blocks, eps, st));
  if (dtype == 0 && vec == 1)
    return static_cast<int>(launch_bwd_rows<float, 1>(x, scale, dy, dx, dscale, pp, n, d, blocks, eps, st));
  if (dtype == 1 && vec == 8)
    return static_cast<int>(
        launch_bwd_rows<__nv_bfloat16, 8>(x, scale, dy, dx, dscale, pp, n, d, blocks, eps, st));
  if (dtype == 1 && vec == 1)
    return static_cast<int>(
        launch_bwd_rows<__nv_bfloat16, 1>(x, scale, dy, dx, dscale, pp, n, d, blocks, eps, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* atlas_rms_norm_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The backward's resident route: x, dy, dx [n, d] and scale, dscale [d] of
// one dtype (0 = float32, 1 = bfloat16), contiguous, x, scale, dy and dx
// 16-byte aligned; d = 128, 2048, 2560, 3584, 4096, 5120 or 7168; partial [blocks, d]
// float32 scratch, 16-byte aligned, blocks >= 1 (a fixed count for the
// card: it fixes dscale's summation order).  Threads per row x 16-byte packs
// per thread, threads per block: bf16 128 = 8 x 2 in 256, 2048 = 128 x 2 in
// 256, 2560 = 160 x 2 in 320, 4096 = 256 x 2 in 256, 5120 = 320 x 2 in 320;
// f32 128 = 16 x 2 in 256, 2048 = 128 x 4 in 256, 2560 = 160 x 4 in 320,
// 4096 = 256 x 4 in 256, 5120 = 320 x 4 in 320 (2048 keeps the others' packs
// a thread, two rows a block; at bf16 4096 that layout, 128 x 4, spills
// under two blocks an SM and took twice 256 x 2's time).  3584 and 7168,
// one row a block: 3584 = 224 x 2 bf16 and 224 x 4 f32 in 224, two blocks
// an SM; 7168 = 448 x 2 bf16 and 448 x 4 f32 in 448 with registers for one
// block an SM (119 and 127).  On the H100 (the candidates timed side by side
// in one run, PERF.md): at [4096, 3584] 448 x 1 bf16 and 448 x 2 f32 took
// 0.0417 and 0.0726 ms against 0.0413 and 0.0698; at
// [4096, 7168] the two-blocks-an-SM 448 layouts spill at 72 registers
// (124 / 168 B bf16, 144 / 140 B f32) and took 0.1283 and 0.1900 ms against
// one block's 0.0771 and 0.1324, and 896 threads at one block (1 or 2
// packs) 0.0796 and 0.1375.  Two launches (the rows, then the sum over
// blocks).  Returns the first launch error, or cudaErrorInvalidValue for
// another width, dtype or alignment.
extern "C" int atlas_rms_norm_bwd_resident(const void* x, const void* scale, const void* dy,
                                           void* dx, void* dscale, void* partial, int n, int d,
                                           int blocks, float eps, int dtype, void* stream) {
  if (blocks < 1 || !aligned16({x, scale, dy, dx, partial}))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(partial);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1) {
    using T = __nv_bfloat16;
    if (d == 128) err = launch_bwd_resident<T, 128, 8, 256>(x, scale, dy, dx, dscale, pp, n, blocks, eps, st);
    if (d == 2048) err = launch_bwd_resident<T, 2048, 128, 256>(x, scale, dy, dx, dscale, pp, n, blocks, eps, st);
    if (d == 2560) err = launch_bwd_resident<T, 2560, 160, 320>(x, scale, dy, dx, dscale, pp, n, blocks, eps, st);
    if (d == 3584) err = launch_bwd_resident<T, 3584, 224, 224>(x, scale, dy, dx, dscale, pp, n, blocks, eps, st);
    if (d == 4096) err = launch_bwd_resident<T, 4096, 256, 256>(x, scale, dy, dx, dscale, pp, n, blocks, eps, st);
    if (d == 5120) err = launch_bwd_resident<T, 5120, 320, 320>(x, scale, dy, dx, dscale, pp, n, blocks, eps, st);
    if (d == 7168) err = launch_bwd_resident<T, 7168, 448, 448, 1>(x, scale, dy, dx, dscale, pp, n, blocks, eps, st);
  } else if (dtype == 0) {
    if (d == 128) err = launch_bwd_resident<float, 128, 16, 256>(x, scale, dy, dx, dscale, pp, n, blocks, eps, st);
    if (d == 2048) err = launch_bwd_resident<float, 2048, 128, 256>(x, scale, dy, dx, dscale, pp, n, blocks, eps, st);
    if (d == 2560) err = launch_bwd_resident<float, 2560, 160, 320>(x, scale, dy, dx, dscale, pp, n, blocks, eps, st);
    if (d == 3584) err = launch_bwd_resident<float, 3584, 224, 224>(x, scale, dy, dx, dscale, pp, n, blocks, eps, st);
    if (d == 4096) err = launch_bwd_resident<float, 4096, 256, 256>(x, scale, dy, dx, dscale, pp, n, blocks, eps, st);
    if (d == 5120) err = launch_bwd_resident<float, 5120, 320, 320>(x, scale, dy, dx, dscale, pp, n, blocks, eps, st);
    if (d == 7168) err = launch_bwd_resident<float, 7168, 448, 448, 1>(x, scale, dy, dx, dscale, pp, n, blocks, eps, st);
  }
  return static_cast<int>(err);
}

