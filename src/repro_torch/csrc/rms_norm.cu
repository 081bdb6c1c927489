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
// Design: a group of threads owns one row.  For rows of at most 1024 values
// (qk-norm's 128, small models) the group is one warp and a block of 256
// threads holds eight rows; for wider rows (d_model 2560..5120) the group is
// the whole block.  Each thread reads VEC consecutive values per load
// (16 bytes: 4 f32 or 8 bf16) when the row length and the pointers allow it,
// else one value.  Squares are summed in f32 in the thread's fixed element
// order, then across the warp with an xor-shuffle tree and, for a block row,
// across the warps in warp order through shared memory: one fixed summation
// order, the same bits on every run.  The second pass re-reads the row (from
// L1/L2, it was just loaded), scales in f32 in the reference's order
// ((x * r) * (1 + scale)) and stores in x's dtype.
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

}  // namespace

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
