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
// Resident route (atlas_rms_norm_resident; the served widths 128, 2560 and
// 5120 in bf16 or f32, 16-byte aligned).  TPR threads own a row and each
// holds the same whole number PPT of 16-byte packs (table at
// atlas_rms_norm_resident: 5 packs a thread for the wide bf16 rows, 10 for
// f32 5120, and for f32 2560 one warp owns a row with 20 packs a lane; one or
// two for 128), so no thread idles in a ragged last step.  The row stays in registers
// between the sum of squares and the scaling, so x is read once; each thread
// loads its packs of `scale` once per block.  The grid is sized to the
// card's resident blocks and walks the rows in a grid-stride loop, issuing
// the next row's loads before this row's reduction, so loads stay in flight
// across rows.  The reduction order is fixed: the thread's packs in order, a
// warp xor tree, then the row's warps in order (through shared memory,
// double-buffered by row parity, one __syncthreads per row).
//
// General route (atlas_rms_norm; every other width and unaligned views).  A
// group of threads owns one row.  For rows of at most 1024 values the group
// is one warp and a block of 256 threads holds eight rows; for wider rows
// the group is the whole block.  Each thread reads VEC consecutive values
// per load (16 bytes: 4 f32 or 8 bf16) when the row length and the pointers
// allow it, else one value.  Squares are summed in f32 in the thread's fixed
// element order, then across the warp with an xor-shuffle tree and, for a
// block row, across the warps in warp order through shared memory: one fixed
// summation order, the same bits on every run.  The second pass re-reads the
// row (from L1/L2, it was just loaded).
//
// Both scale in f32 in the reference's order ((x * r) * (1 + scale)) and
// store in x's dtype.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (repro_torch/kernels/_build.py), loaded by ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

// The resident route: x, out [n, d] and scale [d] of one dtype (0 = float32,
// 1 = bfloat16), contiguous and 16-byte aligned; d = 128, 2560 or 5120.
// Threads per row x 16-byte packs per thread, threads per block (each the
// fastest of the layouts timed on the H100 at the served shapes: one row per
// block beat 256-thread blocks of several rows for the wide rows, and a warp
// per row for f32 2560): bf16 128 = 16 x 1 in 256, 2560 = 64 x 5 in 64,
// 5120 = 128 x 5 in 128; f32 128 = 16 x 2 in 256, 2560 = 32 x 20 in 256,
// 5120 = 128 x 10 in 128.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for another width, dtype or alignment.
extern "C" int atlas_rms_norm_resident(const void* x, const void* scale, void* out, int n, int d,
                                       float eps, int dtype, void* stream) {
  const void* ptrs[3] = {x, scale, out};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1) {
    using T = __nv_bfloat16;
    if (d == 128) err = launch_resident<T, 128, 16, 256>(x, scale, out, n, eps, st);
    if (d == 2560) err = launch_resident<T, 2560, 64, 64>(x, scale, out, n, eps, st);
    if (d == 5120) err = launch_resident<T, 5120, 128, 128>(x, scale, out, n, eps, st);
  } else if (dtype == 0) {
    if (d == 128) err = launch_resident<float, 128, 16, 256>(x, scale, out, n, eps, st);
    if (d == 2560) err = launch_resident<float, 2560, 32, 256>(x, scale, out, n, eps, st);
    if (d == 5120) err = launch_resident<float, 5120, 128, 128>(x, scale, out, n, eps, st);
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

extern "C" const char* atlas_rms_norm_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
