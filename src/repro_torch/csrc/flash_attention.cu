// K3: causal GQA flash attention, forward and backward (Hopper).
//
// Replaces the TPU kernel `_flash_kernel` (src/repro/kernels/flash_attention.py),
// whose grid walked (batch*q_head, q_block, kv_block) in order and carried the
// online-softmax state (running max, sum and f32 accumulator) in VMEM scratch
// from one kv step to the next.  Here the kv loop lives inside a block, since
// blocks run in no order; KV head = (batch*q_head) / group, as the TPU
// kernel's index map, so KV heads are never repeated.
//
// What bounds it: operations at long prompts (S = 4096: 2*S*S*D flops per
// head with the causal half skipped, on 3*S*D inputs), bytes and latency at
// the served prompts (S = 125: a block has one or two KV tiles).
//
// Two routes, chosen by the Python wrapper from (dtype, head dim):
//
// Tensor-core route (atlas_flash_attention_tc; bf16, d = 64 or 128).  One
// warpgroup per (batch*q_head, 64-row q tile), heaviest causal tiles first.
// Q, K and V stay bf16 in shared memory; TMA loads them from [B*H, S, D]
// tensor maps with 128-byte swizzle (a 128-column row as two 64-column
// boxes), and K and V go through a two-stage ring, each tile on its own
// mbarrier, so the next tile's load overlaps this tile's math and S = QKᵀ
// starts before V has landed.  S is one wgmma m64n64k16 chain (Q and K
// K-major from shared memory); the softmax runs on the f32 accumulator
// fragments in registers (row max and sum over the 4 lanes of a row by
// shuffles, exp2 with log2(e) folded into the scale); P is rounded to bf16
// and fed back as wgmma's register A operand (m64n{64,128}k16, V MN-major
// with the transpose flag), so it never touches shared memory.  Masks
// (causal: key > query; ragged: key >= S, where TMA's zero rows would still
// score 0) apply only on the diagonal and last tiles.  Numerics: unlike the
// TPU kernel and the CUDA-core route, which keep P in f32, this route rounds
// P to bf16 before the PV product (as FlashAttention does on the card); the
// bf16 bar of 5e-2 against the plain version covers it.  Shared memory is
// 80 KB at d = 128, so two blocks share an SM.
//
// CUDA-core route (atlas_flash_attention; f32, and bf16 at other head dims).
// One block of 256 threads per (batch*q_head, 64-row q tile); the q tile
// stays in shared memory as f32, each 64-row kv tile is staged there (K,
// then V in the same buffer) and converted to f32 on the way in.  Thread
// (ty, tx) of a 16x16 grid owns query rows ty + 16*i and, for the scores,
// kv columns tx + 16*j (i, j < 4); for the output it owns head-dim columns
// tx*4 + 64*h + e.  The 16 threads that share a row reduce its max and sum
// with xor-shuffles inside a half-warp; the probabilities stay in f32 (as
// in the TPU kernel) and go through shared memory to the PV product.
// Scores are scaled by 1/sqrt(D) after the dot, masked with -1e30, and a row
// whose sum is 0 outputs 0.  The head dim is padded with zeros to 64 or 128.
// It beats SDPA's f32 path at the served shape, so f32 stays here.
//
// For training, both routes also write each row's log-sum-exp (lse, f32)
// when given a buffer, and namespace bwd below holds the backward (dQ, then
// dK/dV); with no buffer the forward stores exactly what it did before.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (repro_torch/kernels/_build.py), loaded by ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BKV = 64;        // kv rows per tile
constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr float kNegInf = -1e30f;
constexpr int LDP = BKV + 4;   // row stride of the probability tile
// the lse of a fully masked row: its probabilities stay 0 in the backward
__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

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
             T* __restrict__ out, float* __restrict__ lse, int s, int d, int group,
             float sm_scale) {
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
    if (lse != nullptr && tx == 0)  // the row's log-sum-exp, for the backward
      lse[bh * s + r] = l_run[i] == 0.0f ? pos_inf() : m_run[i] + logf(l_run[i]);
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
cudaError_t launch_one(const void* q, const void* k, const void* v, void* out, float* lse,
                       int bhq, int s, int d, int group, float sm_scale, cudaStream_t stream) {
  auto kernel = flash_kernel<T, DP, CAUSAL>;
  constexpr int bytes = smem_bytes<DP>();
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + BQ - 1) / BQ, bhq);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, s, d, group, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int bhq,
                   int s, int d, int group, float sm_scale, int causal, cudaStream_t stream) {
  if (d <= 64) {
    return causal
        ? launch_one<T, 64, true>(q, k, v, out, lse, bhq, s, d, group, sm_scale, stream)
        : launch_one<T, 64, false>(q, k, v, out, lse, bhq, s, d, group, sm_scale, stream);
  }
  return causal
      ? launch_one<T, 128, true>(q, k, v, out, lse, bhq, s, d, group, sm_scale, stream)
      : launch_one<T, 128, false>(q, k, v, out, lse, bhq, s, d, group, sm_scale, stream);
}

}  // namespace

namespace tc {

// ---------------------------------------------------------------- tensor-core route
// bf16, head dim 64 or 128: one warpgroup (128 threads) per (batch*q_head,
// 64-row q tile).  Q, K and V stay bf16 in shared memory, loaded by TMA from
// [B*H, S, D] tensor maps (3-D, so the zero fill past S never reads the next
// head's rows) with 128-byte swizzle; K and V tiles go through a two-stage
// ring with one mbarrier per tile, so tile j+1 loads while tile j computes.

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int kThreads = 128;
constexpr int kStages = 2;
constexpr int kBoxBytes = 64 * 64 * 2;  // one [64 rows][64 columns] bf16 box
constexpr float kNegInf = -1e30f;

template <int D>
__host__ __device__ constexpr int tile_bytes() { return 64 * D * 2; }

template <int D>
constexpr int smem_bytes() {
  // 1 KB for alignment, Q, kStages x (K, V), 1 + 2 * kStages barriers
  return 1024 + tile_bytes<D>() * (1 + 2 * kStages) + 8 * (1 + 2 * kStages);
}

// K and V tile j of KV head kvh into ring stage j % kStages (one thread)
template <int D>
__device__ __forceinline__ void load_kv(const CUtensorMap* tk, const CUtensorMap* tv,
                                        uint8_t* ks, uint8_t* vs, uint64_t* bar_k,
                                        uint64_t* bar_v, int j, int kvh) {
  constexpr int kTile = tile_bytes<D>();
  const int st = j % kStages;
  hopper::mbar_expect_tx(&bar_k[st], kTile);
#pragma unroll
  for (int b = 0; b < D / 64; ++b)
    hopper::tma_load_3d(ks + st * kTile + b * kBoxBytes, tk, &bar_k[st], 64 * b, j * BKV, kvh);
  hopper::mbar_expect_tx(&bar_v[st], kTile);
#pragma unroll
  for (int b = 0; b < D / 64; ++b)
    hopper::tma_load_3d(vs + st * kTile + b * kBoxBytes, tv, &bar_v[st], 64 * b, j * BKV, kvh);
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                float* __restrict__ lse, int s, int group, float scale_log2) {
  constexpr int kBoxes = D / 64;
  constexpr int kTile = tile_bytes<D>();
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* qs = hopper::align_1024(smem_raw);
  uint8_t* ks = qs + kTile;             // kStages K tiles
  uint8_t* vs = ks + kStages * kTile;   // kStages V tiles
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(vs + kStages * kTile);
  uint64_t* bar_k = bar_q + 1;
  uint64_t* bar_v = bar_k + kStages;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int q0 = qt * BQ;
  const int bh = blockIdx.y;
  const int kvh = bh / group;
  const int n_kv = CAUSAL ? qt + 1 : static_cast<int>(gridDim.x);  // up to the diagonal

  if (tid == 0) {
    for (int i = 0; i < 1 + 2 * kStages; ++i) hopper::mbar_init(bar_q + i, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(bar_q, kTile);
#pragma unroll
    for (int b = 0; b < kBoxes; ++b)
      hopper::tma_load_3d(qs + b * kBoxBytes, &tq, bar_q, 64 * b, q0, bh);
    for (int j = 0; j < kStages && j < n_kv; ++j)
      load_kv<D>(&tk, &tv, ks, vs, bar_k, bar_v, j, kvh);
  }

  // this thread's rows of the tile (accumulator layout, hopper.cuh)
  const int r0 = q0 + 16 * warp + lane / 4;
  const int r1 = r0 + 8;
  const int cq = 2 * (lane % 4);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
  const uint32_t q_addr = hopper::smem_u32(qs);

  hopper::mbar_wait(bar_q, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int st = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    const uint32_t k_addr = hopper::smem_u32(ks + st * kTile);
    const uint32_t v_addr = hopper::smem_u32(vs + st * kTile);

    // S = Q Kᵀ: Q and K K-major (head dim contiguous), 16 columns per step
    float sc[32];
    hopper::mbar_wait(&bar_k[st], parity);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      hopper::wgmma_m64n64k16_ss<0>(sc, hopper::desc_sw128(q_addr + off, 16, 1024),
                                    hopper::desc_sw128(k_addr + off, 16, 1024), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // masks only on the diagonal tile and the ragged last tile
    const int k0 = j * BKV;
    if (k0 + BKV > s || (CAUSAL && j == qt)) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * jj + cq + e;
          if (col >= s || (CAUSAL && col > r0)) sc[4 * jj + e] = kNegInf;
          if (col >= s || (CAUSAL && col > r1)) sc[4 * jj + 2 + e] = kNegInf;
        }
    }

    // online softmax on the fragments: a row's 64 columns sit in the 4
    // lanes l/4 == const, 16 each
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * jj], sc[4 * jj + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * jj + 2], sc[4 * jj + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f((m0 - mn0) * scale_log2);
    const float alpha1 = exp2f((m1 - mn1) * scale_log2);
    m0 = mn0;
    m1 = mn1;
    const float b0 = mn0 * scale_log2, b1 = mn1 * scale_log2;
    float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      sc[4 * jj] = exp2f(fmaf(sc[4 * jj], scale_log2, -b0));
      sc[4 * jj + 1] = exp2f(fmaf(sc[4 * jj + 1], scale_log2, -b0));
      sc[4 * jj + 2] = exp2f(fmaf(sc[4 * jj + 2], scale_log2, -b1));
      sc[4 * jj + 3] = exp2f(fmaf(sc[4 * jj + 3], scale_log2, -b1));
      rs0 += sc[4 * jj] + sc[4 * jj + 1];
      rs1 += sc[4 * jj + 2] + sc[4 * jj + 3];
    }
    l0 = l0 * alpha0 + rs0;  // this thread's columns; the 4 lanes add up at the end
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      o[4 * jj] *= alpha0;
      o[4 * jj + 1] *= alpha0;
      o[4 * jj + 2] *= alpha1;
      o[4 * jj + 3] *= alpha1;
    }

    // P in bf16 as wgmma's register A operand: 16 accumulator columns are
    // one k16 fragment (hopper.cuh)
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = hopper::pack_bf16x2(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = hopper::pack_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = hopper::pack_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = hopper::pack_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7]);
    }

    // O += P V: V MN-major (head dim contiguous), 16 kv rows per step
    hopper::mbar_wait(&bar_v[st], parity);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = hopper::desc_sw128(v_addr + kk * 16 * 128, kBoxBytes, 1024);
      if constexpr (D == 64) {
        hopper::wgmma_m64n64k16_rs<1>(o, pa[kk], dv, 1);
      } else {
        hopper::wgmma_m64n128k16_rs<1>(o, pa[kk], dv, 1);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);

    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && j + kStages < n_kv)
      load_kv<D>(&tk, &tv, ks, vs, bar_k, bar_v, j + kStages, kvh);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 == 0.0f ? 0.0f : 1.0f / l0;
  const float inv1 = l1 == 0.0f ? 0.0f : 1.0f / l1;
  if (lse != nullptr && lane % 4 == 0) {
    // the rows' log-sum-exp in natural units of the scaled score, once per
    // row after the last kv tile: m is the raw max, exp2 ran on raw * scale_log2
    constexpr float kLn2 = 0.6931471805599453f;
    float* lb = lse + static_cast<int64_t>(bh) * s;
    if (r0 < s) lb[r0] = l0 == 0.0f ? pos_inf() : (m0 * scale_log2 + log2f(l0)) * kLn2;
    if (r1 < s) lb[r1] = l1 == 0.0f ? pos_inf() : (m1 * scale_log2 + log2f(l1)) * kLn2;
  }
  __nv_bfloat16* ob = out + static_cast<int64_t>(bh) * s * D;
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj) {
    const int col = 8 * jj + cq;
    if (r0 < s)
      *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<int64_t>(r0) * D + col) =
          __floats2bfloat162_rn(o[4 * jj] * inv0, o[4 * jj + 1] * inv0);
    if (r1 < s)
      *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<int64_t>(r1) * D + col) =
          __floats2bfloat162_rn(o[4 * jj + 2] * inv1, o[4 * jj + 3] * inv1);
  }
}

template <int D>
cudaError_t encode_qkv_map(CUtensorMap* map, const void* base, int bh, int s) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(s) * D * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  return hopper::encode_bf16_map(map, base, 3, dims, strides, box);
}

template <int D, bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int bhq,
                   int s, int group, float sm_scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = encode_qkv_map<D>(&tq, q, bhq, s);
  if (err == cudaSuccess) err = encode_qkv_map<D>(&tk, k, bhq / group, s);
  if (err == cudaSuccess) err = encode_qkv_map<D>(&tv, v, bhq / group, s);
  if (err != cudaSuccess) return err;
  auto kernel = flash_tc_kernel<D, CAUSAL>;
  constexpr int bytes = smem_bytes<D>();
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + BQ - 1) / BQ, bhq);
  kernel<<<grid, kThreads, bytes, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse,
                                            s, group, sm_scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace tc

namespace bwd {

// ---------------------------------------------------------------- backward
// The gradient of the forward above in the FlashAttention-2 form, on the
// CUDA cores in f32 for both dtypes (no Pallas counterpart: the reference
// differentiates its jnp attention with XLA).  The forward left each row's
// lse = log sum_k exp(scale * q.k); the backward recomputes
// P = exp(scale * Q K^T - lse) in f32 tile by tile and never stores it.
// With delta = rowsum(dO * O):
//   dS = P * (dO V^T - delta),  dQ = scale * dS K,
//   dV = P^T dO,                dK = scale * dS^T Q.
// What bounds it: operations (seven 64x64xD products per pair of tiles on
// and below the diagonal, against 3 S D inputs and outputs per head).
//
// Two kernels, 256 threads each as a 16 x 16 grid with the forward's
// register layout, tiles of 64 rows staged in shared memory as f32:
// dq_kernel, one block per (batch*q_head, q tile), computes its rows' delta
// (written out for the second kernel), walks the kv tiles up to the
// diagonal and accumulates dQ in registers.  dkdv_kernel, one block per
// (batch*kv_head, kv tile), keeps K and V resident and walks the group's q
// heads in order and, for each, the q tiles from the diagonal on, with
// dK and dV in registers: the GQA sum over the group happens inside one
// block in one fixed order, so nothing needs atomics and the result is the
// same bits on every run.

template <int DP>
constexpr int dq_smem_bytes() {  // Q, dO, K, V, dS, lse, delta
  return (4 * BQ * (DP + 4) + BQ * LDP + 2 * BQ) * static_cast<int>(sizeof(float));
}

template <int DP>
constexpr int dkdv_smem_bytes() {  // K, V, Q, dO, P, dS, lse, delta
  return (4 * BQ * (DP + 4) + 2 * BQ * LDP + 2 * BQ) * static_cast<int>(sizeof(float));
}

// acc[i][j] += sum_c A[ty + 16 i][c] * B[tx + 16 j][c] over the padded head dim
template <int DP>
__device__ __forceinline__ void dot_tiles(float (&acc)[4][4], const float* A, const float* B,
                                          int ty, int tx) {
  constexpr int LD = DP + 4;
#pragma unroll 4
  for (int c = 0; c < DP; c += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(&A[(ty + 16 * i) * LD + c]);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const float4*>(&B[(tx + 16 * j) * LD + c]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float a = acc[i][j];
        a = fmaf(av[i].x, bv[j].x, a);
        a = fmaf(av[i].y, bv[j].y, a);
        a = fmaf(av[i].z, bv[j].z, a);
        a = fmaf(av[i].w, bv[j].w, a);
        acc[i][j] = a;
      }
  }
}

// acc[i][h][e] += sum_r W[ty + 16 i][r] * M[r][tx * 4 + 64 h + e] over 64 rows r
template <int DP>
__device__ __forceinline__ void weigh_rows(float (&acc)[4][DP / 64][4], const float* W,
                                           const float* M, int ty, int tx) {
  constexpr int LD = DP + 4;
  constexpr int DH = DP / 64;
#pragma unroll 2
  for (int c = 0; c < BKV; c += 4) {
    float w[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 t = *reinterpret_cast<const float4*>(&W[(ty + 16 * i) * LDP + c]);
      w[i][0] = t.x; w[i][1] = t.y; w[i][2] = t.z; w[i][3] = t.w;
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
#pragma unroll
      for (int h = 0; h < DH; ++h) {
        const float4 m = *reinterpret_cast<const float4*>(&M[(c + cc) * LD + tx * 4 + 64 * h]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][h][0] = fmaf(w[i][cc], m.x, acc[i][h][0]);
          acc[i][h][1] = fmaf(w[i][cc], m.y, acc[i][h][1]);
          acc[i][h][2] = fmaf(w[i][cc], m.z, acc[i][h][2]);
          acc[i][h][3] = fmaf(w[i][cc], m.w, acc[i][h][3]);
        }
      }
  }
}

// the 64 rows' lse and delta of head bh from row r0 (0 past s)
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s, const float* lse,
                                          const float* delta, int64_t bh, int r0, int s) {
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    const int r = r0 + i;
    lse_s[i] = r < s ? lse[bh * s + r] : 0.0f;
    delta_s[i] = r < s ? delta[bh * s + r] : 0.0f;
  }
}

template <typename T, int DP>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[4][DP / 64][4], int r0,
                                           int s, int d, float mul, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= s) continue;
#pragma unroll
    for (int h = 0; h < DP / 64; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = tx * 4 + 64 * h + e;
        if (col < d) dst[static_cast<int64_t>(r) * d + col] = from_f32<T>(acc[i][h][e] * mul);
      }
  }
}

template <typename T, int DP, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ delta, T* __restrict__ dq, int s, int d, int group,
          float sm_scale) {
  constexpr int LD = DP + 4;
  constexpr int DH = DP / 64;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BKV * LD;
  float* dSs = Vs + BKV * LD;  // [BQ][LDP]
  float* lse_s = dSs + BQ * LDP;
  float* delta_s = lse_s + BQ;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int q0 = qt * BQ;
  const int64_t bh = blockIdx.y;
  const T* kb = k + (bh / group) * s * d;
  const T* vb = v + (bh / group) * s * d;

  load_tile<T, DP>(Qs, q + bh * s * d, q0, BQ, s, d);
  load_tile<T, DP>(dOs, dout + bh * s * d, q0, BQ, s, d);
  __syncthreads();
  {  // delta = rowsum(dO * O): four threads a row, then a shuffle over the four
    const int r = threadIdx.x / 4;
    const int part = threadIdx.x % 4;
    const int gr = q0 + r;
    float acc = 0.0f;
    if (gr < s) {
      const T* orow = o + (bh * s + gr) * d;
      for (int c = part; c < d; c += 4) acc = fmaf(dOs[r * LD + c], to_f32(orow[c]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      delta_s[r] = acc;
      if (gr < s) delta[bh * s + gr] = acc;
      lse_s[r] = gr < s ? lse[bh * s + gr] : 0.0f;
    }
  }

  float acc[4][DH][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < DH; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][h][e] = 0.0f;

  const int kv_end = CAUSAL ? min(s, q0 + BQ) : s;
  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();  // the previous tile's dS K product is done with Ks and dSs
    load_tile<T, DP>(Ks, kb, k0, BKV, s, d);
    load_tile<T, DP>(Vs, vb, k0, BKV, s, d);
    __syncthreads();
    float sc[4][4] = {}, dp[4][4] = {};
    dot_tiles<DP>(sc, Qs, Ks, ty, tx);
    dot_tiles<DP>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const int qpos = q0 + row;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool keep = qpos < s && kpos < s && (!CAUSAL || kpos <= qpos);
        const float p = keep ? expf(sc[i][j] * sm_scale - lse_s[row]) : 0.0f;
        dSs[row * LDP + tx + 16 * j] = p * (dp[i][j] - delta_s[row]);
      }
    }
    __syncthreads();
    weigh_rows<DP>(acc, dSs, Ks, ty, tx);
  }
  store_rows<T, DP>(dq + bh * s * d, acc, q0, s, d, sm_scale, ty, tx);
}

template <typename T, int DP, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int s, int d,
            int group, float sm_scale) {
  constexpr int LD = DP + 4;
  constexpr int DH = DP / 64;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BKV * LD;
  float* Qs = Vs + BKV * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;   // [BKV][LDP]: P^T, kv rows by q columns
  float* dSs = Ps + BKV * LDP;  // [BKV][LDP]: dS^T
  float* lse_s = dSs + BKV * LDP;
  float* delta_s = lse_s + BQ;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int kt = blockIdx.x;  // kv tile 0 meets the most q tiles: heaviest first
  const int k0 = kt * BKV;
  const int64_t bkv = blockIdx.y;
  load_tile<T, DP>(Ks, k + bkv * s * d, k0, BKV, s, d);
  load_tile<T, DP>(Vs, v + bkv * s * d, k0, BKV, s, d);

  float gk[4][DH][4], gv[4][DH][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < DH; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) gk[i][h][e] = gv[i][h][e] = 0.0f;

  const int n_q = (s + BQ - 1) / BQ;
  for (int g = 0; g < group; ++g) {
    const int64_t bh = bkv * group + g;
    for (int qt = CAUSAL ? kt : 0; qt < n_q; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's products are done with Qs, dOs, Ps and dSs
      load_tile<T, DP>(Qs, q + bh * s * d, q0, BQ, s, d);
      load_tile<T, DP>(dOs, dout + bh * s * d, q0, BQ, s, d);
      load_rows(lse_s, delta_s, lse, delta, bh, q0, s);
      __syncthreads();
      float st[4][4] = {}, dpt[4][4] = {};
      dot_tiles<DP>(st, Ks, Qs, ty, tx);
      dot_tiles<DP>(dpt, Vs, dOs, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = ty + 16 * i;  // kv row
        const int kpos = k0 + row;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;  // q row
          const int qpos = q0 + col;
          const bool keep = qpos < s && kpos < s && (!CAUSAL || kpos <= qpos);
          const float p = keep ? expf(st[i][j] * sm_scale - lse_s[col]) : 0.0f;
          Ps[row * LDP + col] = p;
          dSs[row * LDP + col] = p * (dpt[i][j] - delta_s[col]);
        }
      }
      __syncthreads();
      weigh_rows<DP>(gv, Ps, dOs, ty, tx);
      weigh_rows<DP>(gk, dSs, Qs, ty, tx);
    }
  }
  store_rows<T, DP>(dk + bkv * s * d, gk, k0, s, d, sm_scale, ty, tx);
  store_rows<T, DP>(dv + bkv * s * d, gv, k0, s, d, 1.0f, ty, tx);
}

template <typename T, int DP, bool CAUSAL>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int bhq, int s, int d, int group, float sm_scale,
                       cudaStream_t stream) {
  auto k_dq = dq_kernel<T, DP, CAUSAL>;
  auto k_dkdv = dkdv_kernel<T, DP, CAUSAL>;
  constexpr int b_dq = dq_smem_bytes<DP>();
  constexpr int b_dkdv = dkdv_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(k_dq, cudaFuncAttributeMaxDynamicSharedMemorySize, b_dq);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(k_dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, b_dkdv);
  if (err != cudaSuccess) return err;
  const int tiles = (s + BQ - 1) / BQ;
  k_dq<<<dim3(tiles, bhq), kThreads, b_dq, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq),
      s, d, group, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k_dkdv<<<dim3(tiles, bhq / group), kThreads, b_dkdv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), s, d,
      group, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_dims(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const float* lse, float* delta, void* dq,
                            void* dk, void* dv, int bhq, int s, int d, int group,
                            float sm_scale, int causal, cudaStream_t st) {
  if (d <= 64) {
    return causal ? launch_bwd<T, 64, true>(q, k, v, o, dout, lse, delta, dq, dk, dv, bhq, s, d,
                                            group, sm_scale, st)
                  : launch_bwd<T, 64, false>(q, k, v, o, dout, lse, delta, dq, dk, dv, bhq, s,
                                             d, group, sm_scale, st);
  }
  return causal ? launch_bwd<T, 128, true>(q, k, v, o, dout, lse, delta, dq, dk, dv, bhq, s, d,
                                           group, sm_scale, st)
                : launch_bwd<T, 128, false>(q, k, v, o, dout, lse, delta, dq, dk, dv, bhq, s, d,
                                            group, sm_scale, st);
}

}  // namespace bwd

// q [bhq, s, d], k and v [bhq / group, s, d], out [bhq, s, d], all contiguous
// and of one dtype: 0 = float32, 1 = bfloat16.  1 <= d <= 128.  lse: null, or
// [bhq, s] float32 that receives each row's log-sum-exp of the scaled
// scores (+inf for a fully masked row), for the backward.
// Returns cudaGetLastError() (or the error of setting the shared-memory size).
extern "C" int atlas_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     void* lse, int bhq, int s, int d, int group,
                                     float sm_scale, int causal, int dtype, void* stream) {
  if (d < 1 || d > 128 || group < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(q, k, v, out, static_cast<float*>(lse), bhq, s, d, group, sm_scale,
                        causal, st);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(q, k, v, out, static_cast<float*>(lse), bhq, s, d, group,
                                sm_scale, causal, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

extern "C" const char* atlas_flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The tensor-core route: q [bhq, s, d], k and v [bhq / group, s, d], out
// [bhq, s, d], all bfloat16, contiguous and 16-byte aligned; d = 64 or 128;
// lse null or [bhq, s] float32, as for atlas_flash_attention.
// Returns cudaGetLastError(), or the error of encoding a tensor map or of
// setting the shared-memory size.
extern "C" int atlas_flash_attention_tc(const void* q, const void* k, const void* v, void* out,
                                        void* lse, int bhq, int s, int d, int group,
                                        float sm_scale, int causal, void* stream) {
  if ((d != 64 && d != 128) || group < 1 || bhq % group || s < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[4] = {q, k, v, out};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lp = static_cast<float*>(lse);
  cudaError_t err;
  if (d == 64) {
    err = causal ? tc::launch<64, true>(q, k, v, out, lp, bhq, s, group, sm_scale, st)
                 : tc::launch<64, false>(q, k, v, out, lp, bhq, s, group, sm_scale, st);
  } else {
    err = causal ? tc::launch<128, true>(q, k, v, out, lp, bhq, s, group, sm_scale, st)
                 : tc::launch<128, false>(q, k, v, out, lp, bhq, s, group, sm_scale, st);
  }
  return static_cast<int>(err);
}

// The backward: q, o, dout, dq [bhq, s, d], k, v, dk, dv [bhq / group, s, d]
// of one dtype (0 = float32, 1 = bfloat16), contiguous; lse [bhq, s] float32
// from the forward on the same inputs; delta [bhq, s] float32 scratch.
// 1 <= d <= 128.  Two launches (dQ, which also writes delta, then dK/dV).
// Returns the first launch error.
extern "C" int atlas_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* lse,
                                         void* delta, void* dq, void* dk, void* dv, int bhq,
                                         int s, int d, int group, float sm_scale, int causal,
                                         int dtype, void* stream) {
  if (d < 1 || d > 128 || group < 1 || bhq % group || s < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(lse);
  float* dp = static_cast<float*>(delta);
  cudaError_t err;
  if (dtype == 0) {
    err = bwd::launch_bwd_dims<float>(q, k, v, o, dout, lp, dp, dq, dk, dv, bhq, s, d, group,
                                      sm_scale, causal, st);
  } else if (dtype == 1) {
    err = bwd::launch_bwd_dims<__nv_bfloat16>(q, k, v, o, dout, lp, dp, dq, dk, dv, bhq, s, d,
                                              group, sm_scale, causal, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
