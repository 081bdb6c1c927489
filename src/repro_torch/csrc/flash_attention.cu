// K3: causal GQA flash attention, forward (Hopper).
//
// Replaces the TPU kernel `_flash_kernel` (src/repro/kernels/flash_attention.py),
// whose grid walked (batch*q_head, q_block, kv_block) in order and carried the
// online-softmax state (running max, sum and f32 accumulator) in VMEM scratch
// from one kv step to the next.
//
// What bounds it: operations at the long-prompt shape (S = 4096: 4*S*S*D/2
// flops per head on 3*S*D inputs), bytes at short prompts (S = 256, where the
// tile loads and the output dominate).  The design goal of this first kernel
// is to never materialise the S x S score matrix and to never repeat KV heads.
//
// Design: one block of 256 threads per (batch*q_head, 64-row q tile); the kv
// loop lives inside the block, since blocks run in no order.  The q tile
// stays in shared memory as f32; each 64-row kv tile is staged in shared
// memory (K, then V in the same buffer) and converted to f32 on the way in.
// Thread (ty, tx) of a 16x16 grid owns query rows ty + 16*i and, for the
// scores, kv columns tx + 16*j (i, j < 4); for the output it owns head-dim
// columns tx*4 + 64*h + e.  The 16 threads that share a row reduce its max
// and sum with xor-shuffles inside a half-warp, so the running max m, sum l
// and the rescale factor stay in registers, and the 4 x (D/16) accumulator
// too.  The probabilities stay in f32 (as in the TPU kernel) and go through
// shared memory to the PV product.  Scores are scaled by 1/sqrt(D) after the
// dot, masked with -1e30 (causal: key position > query position; ragged:
// key position >= S), and a row whose sum is 0 outputs 0.  Causal blocks
// stop at the diagonal, and the heaviest q tiles are launched first.  KV head
// = (batch*q_head) / group, as the TPU kernel's index map.  The head dim is
// padded with zeros to 64 or 128.  CUDA-core f32 FMAs only: mma.sync, wgmma
// and TMA are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (repro_torch/kernels/_build.py), loaded by ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BKV = 64;        // kv rows per tile
constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr float kNegInf = -1e30f;
constexpr int LDP = BKV + 4;   // row stride of the probability tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int DP>
constexpr int smem_bytes() {
  return (BQ * (DP + 4) + BKV * (DP + 4) + BQ * LDP) * static_cast<int>(sizeof(float));
}

// rows x DP tile of a [S, d] matrix starting at row r0, zero-filled past S and d
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int r0,
                                          int rows, int s, int d) {
  constexpr int LD = DP + 4;
  for (int i = threadIdx.x; i < rows * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    const int gr = r0 + r;
    dst[r * LD + c] =
        (gr < s && c < d) ? to_f32(src[static_cast<int64_t>(gr) * d + c]) : 0.0f;
  }
}

template <typename T, int DP, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int s, int d, int group, float sm_scale) {
  constexpr int LD = DP + 4;
  constexpr int DH = DP / 64;  // float4 column groups of the output per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;              // [BQ][LD]
  float* KVs = Qs + BQ * LD;     // [BKV][LD]: K for the scores, then V
  float* Ps = KVs + BKV * LD;    // [BQ][LDP]

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int q0 = qt * BQ;
  const int64_t bh = blockIdx.y;
  const T* qb = q + bh * s * d;
  const T* kb = k + (bh / group) * s * d;
  const T* vb = v + (bh / group) * s * d;

  load_tile<T, DP>(Qs, qb, q0, BQ, s, d);

  float o[4][DH][4];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.0f;
#pragma unroll
    for (int h = 0; h < DH; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][h][e] = 0.0f;
  }

  const int kv_end = CAUSAL ? min(s, q0 + BQ) : s;
  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();  // the previous tile's PV product is done with KVs and Ps
    load_tile<T, DP>(KVs, kb, k0, BKV, s, d);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < DP; c += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * LD + c]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&KVs[(tx + 16 * j) * LD + c]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float acc = sc[i][j];
          acc = fmaf(qv[i].x, kv[j].x, acc);
          acc = fmaf(qv[i].y, kv[j].y, acc);
          acc = fmaf(qv[i].z, kv[j].z, acc);
          acc = fmaf(qv[i].w, kv[j].w, acc);
          sc[i][j] = acc;
        }
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool keep = kpos < s && (!CAUSAL || kpos <= qpos);
        sc[i][j] = keep ? sc[i][j] * sm_scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      alpha[i] = expf(m_run[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        rs += sc[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_run[i] = l_run[i] * alpha[i] + rs;
      m_run[i] = m_new;
    }
    __syncthreads();  // every thread is done reading K

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * LDP + tx + 16 * j] = sc[i][j];
    load_tile<T, DP>(KVs, vb, k0, BKV, s, d);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < DH; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][h][e] *= alpha[i];
#pragma unroll 2
    for (int c = 0; c < BKV; c += 4) {
      float pv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * LDP + c]);
        pv[i][0] = t.x; pv[i][1] = t.y; pv[i][2] = t.z; pv[i][3] = t.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int h = 0; h < DH; ++h) {
          const float4 vv =
              *reinterpret_cast<const float4*>(&KVs[(c + cc) * LD + tx * 4 + 64 * h]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            o[i][h][0] = fmaf(pv[i][cc], vv.x, o[i][h][0]);
            o[i][h][1] = fmaf(pv[i][cc], vv.y, o[i][h][1]);
            o[i][h][2] = fmaf(pv[i][cc], vv.z, o[i][h][2]);
            o[i][h][3] = fmaf(pv[i][cc], vv.w, o[i][h][3]);
          }
        }
    }
  }

  T* ob = out + bh * s * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= s) continue;
    const float l = l_run[i] == 0.0f ? 1.0f : l_run[i];  // fully masked rows -> 0
#pragma unroll
    for (int h = 0; h < DH; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = tx * 4 + 64 * h + e;
        if (col < d) ob[static_cast<int64_t>(r) * d + col] = from_f32<T>(o[i][h][e] / l);
      }
  }
}

template <typename T, int DP, bool CAUSAL>
cudaError_t launch_one(const void* q, const void* k, const void* v, void* out, int bhq, int s,
                       int d, int group, float sm_scale, cudaStream_t stream) {
  auto kernel = flash_kernel<T, DP, CAUSAL>;
  constexpr int bytes = smem_bytes<DP>();
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + BQ - 1) / BQ, bhq);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), s, d, group, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int bhq, int s,
                   int d, int group, float sm_scale, int causal, cudaStream_t stream) {
  if (d <= 64) {
    return causal ? launch_one<T, 64, true>(q, k, v, out, bhq, s, d, group, sm_scale, stream)
                  : launch_one<T, 64, false>(q, k, v, out, bhq, s, d, group, sm_scale, stream);
  }
  return causal ? launch_one<T, 128, true>(q, k, v, out, bhq, s, d, group, sm_scale, stream)
                : launch_one<T, 128, false>(q, k, v, out, bhq, s, d, group, sm_scale, stream);
}

}  // namespace

// q [bhq, s, d], k and v [bhq / group, s, d], out [bhq, s, d], all contiguous
// and of one dtype: 0 = float32, 1 = bfloat16.  1 <= d <= 128.
// Returns cudaGetLastError() (or the error of setting the shared-memory size).
extern "C" int atlas_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int bhq, int s, int d, int group, float sm_scale,
                                     int causal, int dtype, void* stream) {
  if (d < 1 || d > 128 || group < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(q, k, v, out, bhq, s, d, group, sm_scale, causal, st);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(q, k, v, out, bhq, s, d, group, sm_scale, causal, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

extern "C" const char* atlas_flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
