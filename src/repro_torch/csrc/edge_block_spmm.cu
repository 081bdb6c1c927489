// K1: chunk aggregation as a deterministic segmented reduction (Hopper).
//
// Replaces the TPU kernel `_spmm_kernel` (src/repro/kernels/edge_block_spmm.py),
// which computed out[dst[e]] += w[e] * feats[src[e]] as two one-hot GEMMs on
// the MXU.  Here the edges arrive grouped by destination (the host builds the
// chunk's destination dictionary with a stable sort), so each output row is a
// sum over one contiguous segment of edges:
//
//   out[s, :] = sum_{e in [offsets[s], offsets[s+1])} w[e] * feats[src[e], :]
//
// What bounds it: memory.  Per edge it reads one feature row and writes
// nothing; its 2*m*d flops are negligible next to the n*d*4 + m*8 + s*d*4
// bytes it moves, so the design goal is coalesced row reads.
//
// Design: a warp owns one destination segment and a tile of 32*VEC columns;
// lane i reads VEC consecutive values of the source row (16-byte loads for
// f32, 8-byte for bf16), so one edge costs the warp one coalesced row read.
// Eight warps (eight segments) share a block.  Each lane walks its segment's
// edges in the given order and accumulates in f32 with __fadd_rn/__fmul_rn,
// which the compiler never contracts into an FMA: no atomics, one fixed
// summation order, the same bits on every run.  Source rows outside
// [0, n_rows) add nothing (the TPU kernel's -1 padding sentinel), and the
// segment bounds are clamped to [0, m), so no input reads out of bounds.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (repro_torch/kernels/_build.py), loaded by ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;         // threads across columns: one warp
constexpr int kRowsPerBlock = 8;   // destination segments per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kLanes * kRowsPerBlock)
segment_reduce_kernel(const T* __restrict__ feats, const int32_t* __restrict__ src,
                      const float* __restrict__ w, const int32_t* __restrict__ offsets,
                      float* __restrict__ out, int num_seg, int n_rows, int m, int d) {
  const int seg = blockIdx.x * kRowsPerBlock + threadIdx.y;
  const int col = (blockIdx.y * kLanes + threadIdx.x) * VEC;
  if (seg >= num_seg || col >= d) return;

  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;

  const int e0 = max(offsets[seg], 0);
  const int e1 = min(offsets[seg + 1], m);
  for (int e = e0; e < e1; ++e) {
    const int s = src[e];
    if (s < 0 || s >= n_rows) continue;
    const float wv = w[e];
    const T* row = feats + static_cast<int64_t>(s) * d + col;
    float f[VEC];
    if constexpr (VEC == 4) {
      load4(row, f);
    } else {
      f[0] = to_f32(row[0]);
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = __fadd_rn(acc[v], __fmul_rn(wv, f[v]));
  }

  float* o = out + static_cast<int64_t>(seg) * d + col;
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    o[0] = acc[0];
  }
}

template <typename T>
void launch(const void* feats, const void* src, const void* w, const void* offsets,
            void* out, int num_seg, int n_rows, int m, int d, cudaStream_t stream) {
  const uintptr_t align = 4 * sizeof(T);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(feats) % align == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int cols_per_block = kLanes * (vec ? 4 : 1);
  const dim3 block(kLanes, kRowsPerBlock);
  const dim3 grid((num_seg + kRowsPerBlock - 1) / kRowsPerBlock,
                  (d + cols_per_block - 1) / cols_per_block);
  const T* f = static_cast<const T*>(feats);
  const int32_t* s = static_cast<const int32_t*>(src);
  const float* wv = static_cast<const float*>(w);
  const int32_t* off = static_cast<const int32_t*>(offsets);
  float* o = static_cast<float*>(out);
  if (vec) {
    segment_reduce_kernel<T, 4><<<grid, block, 0, stream>>>(f, s, wv, off, o, num_seg, n_rows, m, d);
  } else {
    segment_reduce_kernel<T, 1><<<grid, block, 0, stream>>>(f, s, wv, off, o, num_seg, n_rows, m, d);
  }
}

}  // namespace

// feats_dtype: 0 = float32, 1 = bfloat16.  All indices are int32; the
// wrapper checks n_rows, m < 2^31.  Returns cudaGetLastError().
extern "C" int atlas_segment_reduce(const void* feats, int feats_dtype, const void* src,
                                    const void* w, const void* offsets, void* out,
                                    int num_seg, int n_rows, int m, int d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (feats_dtype == 0) {
    launch<float>(feats, src, w, offsets, out, num_seg, n_rows, m, d, st);
  } else if (feats_dtype == 1) {
    launch<__nv_bfloat16>(feats, src, w, offsets, out, num_seg, n_rows, m, d, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* atlas_edge_block_spmm_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
