// K6: the RG-LRU linear recurrence h_t = a_t * h_{t-1} + w_t, forward and
// backward (Hopper).
//
// No TPU kernel to replace: the reference runs this recurrence with
// jax.lax.associative_scan (src/repro/models/rglru.py:64, rglru_scan), and
// XLA differentiates it.  This is a port-only kernel of the hybrid family
// (recurrentgemma-9b), in every RG-LRU layer's prefill and training forward.
//
// Layout: a, w and h are [B, S, R] f32, contiguous; h0 and dh0 [B, R] f32.
//
// Design (the simple kernel): one thread per (batch, channel), consecutive
// threads on consecutive channels, so every step's loads of a warp are one
// 128-byte line.  The state stays in a register and the thread walks S in
// order.  The loads run ahead of the arithmetic: the next kUnroll steps'
// values are loaded into registers while this chunk's steps compute, so
// the dependent chain is the product and the sum alone.  Blocks are one
// warp (32 channels), so the B*R/32 blocks spread over every SM.
//
// What bounds it: bytes, at 12 B per element forward (a, w read, h
// written) and 20 B backward (a, h, dh read, da, dw written); with only
// B*R threads the loop is bound by memory latency well above that.  A
// chunked two-pass scan (chunks across blocks, then a pass that carries
// the state between chunks) is the later redesign.
//
// Numerics: each step rounds as the plain loop does, one f32 product then
// one f32 sum (__fmul_rn, __fadd_rn: no FMA contraction), so the kernel
// equals rglru_scan_ref and rglru_scan_bwd_ref bitwise.
//
// Backward, walking t downwards with g_{S-1} = dh_{S-1}:
//   g_t = dh_t + a_{t+1} * g_{t+1},  dw_t = g_t,  da_t = g_t * h_{t-1}
// with h_{-1} = h0 (or 0), and dh0 = a_0 * g_0.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (repro_torch/kernels/_build.py), loaded by ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;  // one warp a block: 32 consecutive channels
constexpr int kUnroll = 8;    // steps a chunk; the next chunk's loads fly during this one

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ w,
                  const float* __restrict__ h0, float* __restrict__ h, int s, int r) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= r) return;
  const int64_t b = blockIdx.y;
  const int64_t stride = r;
  const float* ab = a + b * s * stride + c;
  const float* wb = w + b * s * stride + c;
  float* hb = h + b * s * stride + c;
  float hv = h0 != nullptr ? h0[b * stride + c] : 0.0f;

  float an[kUnroll], wn[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    an[u] = u < s ? ld(ab + u * stride) : 0.0f;
    wn[u] = u < s ? ld(wb + u * stride) : 0.0f;
  }
  for (int t0 = 0; t0 < s; t0 += kUnroll) {
    float ac[kUnroll], wc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ac[u] = an[u];
      wc[u] = wn[u];
    }
    const int t1 = t0 + kUnroll;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // the next chunk's loads, in flight during this one
      an[u] = t1 + u < s ? ld(ab + (t1 + u) * stride) : 0.0f;
      wn[u] = t1 + u < s ? ld(wb + (t1 + u) * stride) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < s) {
        hv = __fadd_rn(__fmul_rn(ac[u], hv), wc[u]);
        hb[(t0 + u) * stride] = hv;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
rglru_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                      const float* __restrict__ dh, const float* __restrict__ h0,
                      float* __restrict__ da, float* __restrict__ dw, float* __restrict__ dh0,
                      int s, int r) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= r) return;
  const int64_t b = blockIdx.y;
  const int64_t stride = r;
  const int64_t base = b * s * stride + c;
  const float* ab = a + base;
  const float* hb = h + base;
  const float* db = dh + base;
  float* dab = da + base;
  float* dwb = dw + base;
  const float hinit = h0 != nullptr ? h0[b * stride + c] : 0.0f;

  // step t needs dh_t, h_{t-1} and a_{t+1}: chunk values indexed by u = t0 - t
  float dn[kUnroll], hn[kUnroll], an[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int t = s - 1 - u;
    dn[u] = t >= 0 ? ld(db + t * stride) : 0.0f;
    hn[u] = t >= 1 ? ld(hb + (t - 1) * stride) : hinit;
    an[u] = t >= 0 && t + 1 < s ? ld(ab + (t + 1) * stride) : 0.0f;
  }
  float g = 0.0f;
  for (int t0 = s - 1; t0 >= 0; t0 -= kUnroll) {
    float dc[kUnroll], hc[kUnroll], ac[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      dc[u] = dn[u];
      hc[u] = hn[u];
      ac[u] = an[u];
    }
    const int t1 = t0 - kUnroll;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // the next chunk's loads, in flight during this one
      const int t = t1 - u;
      dn[u] = t >= 0 ? ld(db + t * stride) : 0.0f;
      hn[u] = t >= 1 ? ld(hb + (t - 1) * stride) : hinit;
      an[u] = t >= 0 ? ld(ab + (t + 1) * stride) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 - u;
      if (t >= 0) {
        g = t == s - 1 ? dc[u] : __fadd_rn(dc[u], __fmul_rn(ac[u], g));
        dwb[t * stride] = g;
        dab[t * stride] = __fmul_rn(g, hc[u]);
      }
    }
  }
  if (dh0 != nullptr) dh0[b * stride + c] = __fmul_rn(ab[0], g);
}

}  // namespace

// a, w, h [b, s, r] float32, contiguous; h0 null or [b, r] float32.
// Returns cudaGetLastError() after the launch.
extern "C" int atlas_rglru_scan(const void* a, const void* w, const void* h0, void* h, int b,
                                int s, int r, void* stream) {
  if (b < 1 || s < 1 || r < 1 || b > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((r + kThreads - 1) / kThreads, b);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(w), static_cast<const float*>(h0),
      static_cast<float*>(h), s, r);
  return static_cast<int>(cudaGetLastError());
}

// The backward: a, h (the forward's output), dh, da, dw [b, s, r] float32,
// contiguous; h0 and dh0 both null or both [b, r] float32.
// Returns cudaGetLastError() after the launch.
extern "C" int atlas_rglru_scan_bwd(const void* a, const void* h, const void* dh, const void* h0,
                                    void* da, void* dw, void* dh0, int b, int s, int r,
                                    void* stream) {
  if (b < 1 || s < 1 || r < 1 || b > 65535 || (h0 == nullptr) != (dh0 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((r + kThreads - 1) / kThreads, b);
  rglru_scan_bwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(h), static_cast<const float*>(dh),
      static_cast<const float*>(h0), static_cast<float*>(da), static_cast<float*>(dw),
      static_cast<float*>(dh0), s, r);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* atlas_rglru_scan_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
