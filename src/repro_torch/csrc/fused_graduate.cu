// K2: the graduation transform out = act(x @ W + b) (Hopper).
//
// Replaces the TPU kernel `_graduate_kernel` (src/repro/kernels/fused_graduate.py),
// which accumulated x@W over a k grid axis in a VMEM f32 scratch and applied
// bias and activation on the last k step.
//
// What bounds it: operations.  At the main path's shapes (x [8192, 256|512],
// W [256|512, 256|172]) it does 2*N*K*M flops on N*K + K*M + N*M values, far
// above the card's f32 ridge point, so the design goal is register reuse.
//
// Design: a plain shared-memory SGEMM on the CUDA cores.  A block of 256
// threads owns a 64x64 output tile and walks K in steps of 16: it stages the
// 64x16 slice of x (transposed) and the 16x64 slice of W in shared memory,
// converting to f32 on the way in, and each thread accumulates a 4x4 patch of
// the tile in registers with f32 FMAs.  The epilogue adds the bias, applies
// the activation (none, relu, or gelu with the tanh approximation, as
// jax.nn.gelu defaults to) and stores in x's dtype.  Ragged edges in N, K and
// M are zero-filled on load and masked on store.  No tensor cores, no TF32:
// wgmma and TMA are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (repro_torch/kernels/_build.py), loaded by ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // output rows per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 16;   // K step staged in shared memory
constexpr int TM = 4;    // rows per thread
constexpr int TN = 4;    // columns per thread
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if constexpr (ACT == 1) {
    return fmaxf(v, 0.0f);
  } else if constexpr (ACT == 2) {
    const float k0 = 0.7978845608028654f;  // sqrt(2/pi)
    return 0.5f * v * (1.0f + tanhf(k0 * (v + 0.044715f * v * v * v)));
  } else {
    return v;
  }
}

template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
graduate_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
                T* __restrict__ out, int n, int k, int m) {
  __shared__ __align__(16) float As[BK][BM];  // x tile, transposed: As[kk][row]
  __shared__ __align__(16) float Bs[BK][BN];  // W tile: Bs[kk][col]

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int l = 0; l < (BM * BK) / kThreads; ++l) {
      const int i = tid + l * kThreads;
      const int r = i / BK, c = i % BK;  // x: 64 rows x 16 k
      const int gr = row0 + r, gk = k0 + c;
      As[c][r] = (gr < n && gk < k) ? to_f32(x[static_cast<int64_t>(gr) * k + gk]) : 0.0f;
      const int rb = i / BN, cb = i % BN;  // W: 16 k x 64 cols
      const int gkb = k0 + rb, gc = col0 + cb;
      Bs[rb][cb] = (gkb < k && gc < m) ? to_f32(w[static_cast<int64_t>(gkb) * m + gc]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bw[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      if (c >= m) continue;
      const float v = activate<ACT>(acc[i][j] + to_f32(b[c]));
      out[static_cast<int64_t>(r) * m + c] = from_f32<T>(v);
    }
  }
}

template <typename T>
void launch(const void* x, const void* w, const void* b, void* out, int n, int k, int m,
            int act, cudaStream_t stream) {
  const dim3 grid((n + BM - 1) / BM, (m + BN - 1) / BN);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* bp = static_cast<const T*>(b);
  T* op = static_cast<T*>(out);
  if (act == 0) {
    graduate_kernel<T, 0><<<grid, kThreads, 0, stream>>>(xp, wp, bp, op, n, k, m);
  } else if (act == 1) {
    graduate_kernel<T, 1><<<grid, kThreads, 0, stream>>>(xp, wp, bp, op, n, k, m);
  } else {
    graduate_kernel<T, 2><<<grid, kThreads, 0, stream>>>(xp, wp, bp, op, n, k, m);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, W, b and out share it).
// act: 0 = none, 1 = relu, 2 = gelu (tanh).  Returns cudaGetLastError().
extern "C" int atlas_fused_graduate(const void* x, const void* w, const void* b, void* out,
                                    int n, int k, int m, int dtype, int act, void* stream) {
  if (act < 0 || act > 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, w, b, out, n, k, m, act, st);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, w, b, out, n, k, m, act, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* atlas_fused_graduate_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
