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
// head with the causal half skipped, on 3*S*D inputs; with a window only
// the band's pairs), bytes and latency at the served prompts (S = 125: a
// block has one or two KV tiles).
//
// A sliding window (window > 0; the hybrid family's local attention, which
// the TPU kernel lacks and the reference computes with its jnp
// blockwise_attention(window=)): query q sees key k only if q - k < window
// (and k <= q when causal).  Both routes take it the same way: the kv walk
// starts at the tile holding key q0 - window + 1 (band_start), the band's
// first tiles are masked, and the backward's q walk ends at the band's last
// q tile.  A window of S or more is causal attention, bit for bit.
//
// Two routes, chosen by the Python wrapper from (dtype, head dim, alignment):
//
// Tensor-core route (atlas_flash_attention_tc; bf16, d = 64, 128 or 256,
// 16-byte aligned, with or without a window).  One
// warpgroup per (batch*q_head, 64-row q tile), heaviest causal tiles first.
// Q, K and V stay bf16 in shared memory; TMA loads them from [B*H, S, D]
// tensor maps with 128-byte swizzle (a row as D/64 boxes of 64 columns),
// and K and V go through a two-stage ring, each tile on its own
// mbarrier, so the next tile's load overlaps this tile's math and S = QKᵀ
// starts before V has landed.  S is one wgmma m64n64k16 chain of D/16 steps
// (Q and K K-major from shared memory); the softmax runs on the f32 accumulator
// fragments in registers (row max and sum over the 4 lanes of a row by
// shuffles, exp2 with log2(e) folded into the scale); P is rounded to bf16
// and fed back as wgmma's register A operand (m64n64k16 at d = 64,
// m64n128k16 otherwise, one chain per 128 columns of V, MN-major with the
// transpose flag), so it never touches shared memory.  Masks
// (causal: key > query; ragged: key >= S, where TMA's zero rows would still
// score 0; the band's edge) apply only on the diagonal, last and band-edge
// tiles; a row with no key of the band in a tile so far subtracts 0 from
// its masked scores, so their p is 0.  Numerics: unlike the
// TPU kernel and the CUDA-core route, which keep P in f32, this route rounds
// P to bf16 before the PV product (as FlashAttention does on the card); the
// bf16 bar of 5e-2 against the plain version covers it.  Shared memory is
// 80 KB at d = 128, so two blocks share an SM; at d = 256 (recurrentgemma)
// 161 KB, one block an SM, and O takes 128 registers a thread.
//
// CUDA-core route (atlas_flash_attention; f32, bf16 at other head dims up to
// 256 and on views off 16 bytes).
// One block of 256 threads per (batch*q_head, 64-row q tile); the q tile
// stays in shared memory as f32, each 64-row kv tile is staged there (K,
// then V in the same buffer) and converted to f32 on the way in.  Thread
// (ty, tx) of a 16x16 grid owns query rows ty + 16*i and, for the scores,
// kv columns tx + 16*j (i, j < 4); for the output it owns head-dim columns
// tx*4 + 64*h + e.  The 16 threads that share a row reduce its max and sum
// with xor-shuffles inside a half-warp; the probabilities stay in f32 (as
// in the TPU kernel) and go through shared memory to the PV product.
// Scores are scaled by 1/sqrt(D) after the dot, masked with -1e30, and a row
// whose sum is 0 outputs 0.  The head dim is padded with zeros to 64, 128
// or 256 (recurrentgemma's; 150,528 B of shared memory).  It beats SDPA's
// f32 path at the served shape, so f32 stays here.
//
// For training, both routes also write each row's log-sum-exp (lse, f32)
// when given a buffer; with no buffer the forward stores exactly what it did
// before.  The backward (dQ, then dK/dV, no float atomics) has the same two
// routes under the same rule: namespace bwd_tc (atlas_flash_attention_bwd_tc;
// bf16, d = 64, 128 or 256, with or without a window) runs its products per
// pair of tiles on wgmma with TMA-fed tiles (at d = 256 the dK/dV pass on
// two warpgroups, one block per q head, then a fixed-order sum), and
// namespace bwd (atlas_flash_attention_bwd; f32, the other head dims and
// unaligned views) on the CUDA cores in f32.
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

// Sliding window (window > 0): query q sees key k only if q - k < window.
__device__ __forceinline__ bool in_band(int qpos, int kpos, int window) {
  return window <= 0 || qpos - kpos < window;
}

// the first kv tile a q tile starting at q0 meets: the one that holds key
// q0 - window + 1, the band's first key for the tile's first row
__device__ __forceinline__ int band_start(int q0, int window) {
  return window > 0 ? max(0, q0 - window + 1) / BKV * BKV : 0;
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
             float sm_scale, int window) {
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
  for (int k0 = band_start(q0, window); k0 < kv_end; k0 += BKV) {
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
        const bool keep = kpos < s && (!CAUSAL || kpos <= qpos) && in_band(qpos, kpos, window);
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
                       int bhq, int s, int d, int group, float sm_scale, int window,
                       cudaStream_t stream) {
  auto kernel = flash_kernel<T, DP, CAUSAL>;
  constexpr int bytes = smem_bytes<DP>();
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + BQ - 1) / BQ, bhq);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, s, d, group, sm_scale, window);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dp(const void* q, const void* k, const void* v, void* out, float* lse,
                      int bhq, int s, int d, int group, float sm_scale, int causal, int window,
                      cudaStream_t stream) {
  return causal
      ? launch_one<T, DP, true>(q, k, v, out, lse, bhq, s, d, group, sm_scale, window, stream)
      : launch_one<T, DP, false>(q, k, v, out, lse, bhq, s, d, group, sm_scale, window, stream);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int bhq,
                   int s, int d, int group, float sm_scale, int causal, int window,
                   cudaStream_t stream) {
  if (d <= 64)
    return launch_dp<T, 64>(q, k, v, out, lse, bhq, s, d, group, sm_scale, causal, window, stream);
  if (d <= 128)
    return launch_dp<T, 128>(q, k, v, out, lse, bhq, s, d, group, sm_scale, causal, window,
                             stream);
  return launch_dp<T, 256>(q, k, v, out, lse, bhq, s, d, group, sm_scale, causal, window, stream);
}

}  // namespace

namespace tc {

// ---------------------------------------------------------------- tensor-core route
// bf16, head dim 64, 128 or 256: one warpgroup (128 threads) per (batch*q_head,
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

// K and V tile j of KV head kvh into ring stage it % kStages (one thread);
// `it` counts the block's tiles from the first of its band
template <int D>
__device__ __forceinline__ void load_kv(const CUtensorMap* tk, const CUtensorMap* tv,
                                        uint8_t* ks, uint8_t* vs, uint64_t* bar_k,
                                        uint64_t* bar_v, int it, int j, int kvh) {
  constexpr int kTile = tile_bytes<D>();
  const int st = it % kStages;
  hopper::mbar_expect_tx(&bar_k[st], kTile);
#pragma unroll
  for (int b = 0; b < D / 64; ++b)
    hopper::tma_load_3d(ks + st * kTile + b * kBoxBytes, tk, &bar_k[st], 64 * b, j * BKV, kvh);
  hopper::mbar_expect_tx(&bar_v[st], kTile);
#pragma unroll
  for (int b = 0; b < D / 64; ++b)
    hopper::tma_load_3d(vs + st * kTile + b * kBoxBytes, tv, &bar_v[st], 64 * b, j * BKV, kvh);
}

// acc[64 x D] += A[64 x 64] M[64 x D]: A as four k16 register fragments, M a
// [64 rows][D] tile read MN-major; at D = 256 one m64n128k16 chain per half
// of M's columns (boxes 0-1, then 2-3), accumulator entries 64 h on
template <int D>
__device__ __forceinline__ void frags_times_tile(float (&acc)[D / 2], const uint32_t (&a)[4][4],
                                                 uint32_t m_addr) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (D == 64) {
      hopper::wgmma_m64n64k16_rs<1>(
          acc, a[kk], hopper::desc_sw128(m_addr + kk * 16 * 128, kBoxBytes, 1024), 1);
    } else {
#pragma unroll
      for (int h = 0; h < D / 128; ++h)
        hopper::wgmma_m64n128k16_rs<1>(
            *reinterpret_cast<float(*)[64]>(acc + 64 * h), a[kk],
            hopper::desc_sw128(m_addr + 2 * h * kBoxBytes + kk * 16 * 128, kBoxBytes, 1024), 1);
    }
  }
}

// does a 64 x 64 pair of tiles hold a pair the window hides (q - k >= window)?
__device__ __forceinline__ bool band_edge(int q0, int k0, int window) {
  return window > 0 && q0 + BQ - 1 - k0 >= window;
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                float* __restrict__ lse, int s, int group, float scale_log2, int window) {
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
  const int j0 = band_start(q0, window) / BKV;  // the band's first kv tile (0 without a window)
  const int n_it = n_kv - j0;

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
    for (int it = 0; it < kStages && it < n_it; ++it)
      load_kv<D>(&tk, &tv, ks, vs, bar_k, bar_v, it, j0 + it, kvh);
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
  for (int it = 0; it < n_it; ++it) {
    const int j = j0 + it;
    const int st = it % kStages;
    const uint32_t parity = (it / kStages) & 1;
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

    // masks only on the diagonal tile, the ragged last tile and the band's
    // first tiles
    const int k0 = j * BKV;
    if (k0 + BKV > s || (CAUSAL && j == qt) || band_edge(q0, k0, window)) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * jj + cq + e;
          if (col >= s || (CAUSAL && col > r0) || !in_band(r0, col, window))
            sc[4 * jj + e] = kNegInf;
          if (col >= s || (CAUSAL && col > r1) || !in_band(r1, col, window))
            sc[4 * jj + 2 + e] = kNegInf;
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
    // a row whose keys so far all lie outside the band (its first band
    // tile, with a window) has max -1e30: it subtracts 0, so its p is
    // exp2(-1e30 * scale) = 0 (fma's unrounded product would leave
    // ±ulp(9e28) from -1e30 - -1e30, and exp2 of that overflows); every row
    // meets its own key on the diagonal
    const float b0 = mn0 == kNegInf ? 0.0f : mn0 * scale_log2;
    const float b1 = mn1 == kNegInf ? 0.0f : mn1 * scale_log2;
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
    frags_times_tile<D>(o, pa, v_addr);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);

    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && it + kStages < n_it)
      load_kv<D>(&tk, &tv, ks, vs, bar_k, bar_v, it + kStages, j + kStages, kvh);
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
                   int s, int group, float sm_scale, int window, cudaStream_t stream) {
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
                                            s, group, sm_scale * 1.4426950408889634f, window);
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
// Three kernels, 256 threads each as a 16 x 16 grid with the forward's
// register layout, tiles of 64 rows staged in shared memory as f32:
// dq_kernel, one block per (batch*q_head, q tile), computes its rows' delta
// (written out for the second kernel), walks the kv tiles up to the
// diagonal and accumulates dQ in registers.  dkdv_kernel, one block per
// (batch*kv_head, kv tile, q head of the group, run of up to QCHUNK q tiles
// among those that see the kv tile), keeps K and V resident, walks its
// run of q tiles with dK and dV in registers and writes them as f32
// partials; dkdv_sum_kernel adds each kv row's partials in one fixed order
// (head, then run) and writes dK and dV.  Nothing needs atomics, and the
// result is the same bits on every run.  Splitting the walk bounds each
// f32 chain at QCHUNK * 64 terms: one block walking a group of 16 heads
// over a band of 2048 queries (recurrentgemma) chained 32,768 terms into
// one accumulator, too long for the f32 bar of 1e-5 against the plain
// version, and ran one block per kv tile (64 blocks at S = 4096).
//
// At head dim 256 four f32 tiles of 64 x 260 no longer fit a block's shared
// memory (the dQ kernel would take 284,160 B and the dK/dV kernel 301,568 B,
// against 232,448), so there (kOneBuf) each kernel keeps two tiles resident
// and stages the other two, one after the other, in a single buffer: the dQ
// kernel holds Q and dO and stages V (for dO V^T), then K (for the scores
// and dS K); the dK/dV kernel holds K and V and stages Q (for the scores),
// then dO (for dO V^T and P^T dO), then Q again (for dS^T Q), with P and
// then dS in one shared tile.  Both take 217,600 B; the products and their
// order are the same as at the narrower head dims, so are the bits.
//
// With a sliding window (window > 0: key k visible to query q only if
// q - k < window), the dQ kernel's kv walk starts at the band's first tile,
// as the forward's, and the dK/dV kernel's q walk ends at the tile that
// holds query k0 + 63 + window - 1, the last that sees the kv tile.

template <int DP>
__host__ __device__ constexpr bool one_buf() { return DP > 128; }

template <int DP>
constexpr int dq_smem_bytes() {  // Q, dO, K, V (or one buffer for both), dS, lse, delta
  return ((one_buf<DP>() ? 3 : 4) * BQ * (DP + 4) + BQ * LDP + 2 * BQ) *
         static_cast<int>(sizeof(float));
}

template <int DP>
constexpr int dkdv_smem_bytes() {  // K, V, Q, dO (or one buffer for both), P, dS, lse, delta
  return one_buf<DP>()
      ? (3 * BQ * (DP + 4) + BQ * LDP + 2 * BQ) * static_cast<int>(sizeof(float))
      : (4 * BQ * (DP + 4) + 2 * BQ * LDP + 2 * BQ) * static_cast<int>(sizeof(float));
}
static_assert(dq_smem_bytes<256>() <= 232448 && dkdv_smem_bytes<256>() <= 232448,
              "the head-dim-256 backward must fit a block's shared memory");

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
          float sm_scale, int window) {
  constexpr int LD = DP + 4;
  constexpr int DH = DP / 64;
  constexpr bool kOneBuf = one_buf<DP>();
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = kOneBuf ? Ks : Ks + BKV * LD;  // one buffer: V, then K
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
  for (int k0 = band_start(q0, window); k0 < kv_end; k0 += BKV) {
    __syncthreads();  // the previous tile's dS K product is done with Ks and dSs
    float sc[4][4] = {}, dp[4][4] = {};
    if constexpr (kOneBuf) {
      load_tile<T, DP>(Vs, vb, k0, BKV, s, d);
      __syncthreads();
      dot_tiles<DP>(dp, dOs, Vs, ty, tx);
      __syncthreads();  // every thread is done reading V
      load_tile<T, DP>(Ks, kb, k0, BKV, s, d);
      __syncthreads();
      dot_tiles<DP>(sc, Qs, Ks, ty, tx);
    } else {
      load_tile<T, DP>(Ks, kb, k0, BKV, s, d);
      load_tile<T, DP>(Vs, vb, k0, BKV, s, d);
      __syncthreads();
      dot_tiles<DP>(sc, Qs, Ks, ty, tx);
      dot_tiles<DP>(dp, dOs, Vs, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const int qpos = q0 + row;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool keep = qpos < s && kpos < s && (!CAUSAL || kpos <= qpos) &&
                          in_band(qpos, kpos, window);
        const float p = keep ? expf(sc[i][j] * sm_scale - lse_s[row]) : 0.0f;
        dSs[row * LDP + tx + 16 * j] = p * (dp[i][j] - delta_s[row]);
      }
    }
    __syncthreads();
    weigh_rows<DP>(acc, dSs, Ks, ty, tx);
  }
  store_rows<T, DP>(dq + bh * s * d, acc, q0, s, d, sm_scale, ty, tx);
}

// one past the last q tile that sees kv tile k0 (n_q without a window)
__host__ __device__ __forceinline__ int band_q_end(int k0, int window, int n_q) {
  if (window <= 0) return n_q;
  const int64_t end = (static_cast<int64_t>(k0) + BKV - 1 + window - 1) / BQ + 1;
  return end < n_q ? static_cast<int>(end) : n_q;
}

constexpr int QCHUNK = 8;  // q tiles one dK/dV block walks: chains of at most 512 rows

// the runs of QCHUNK q tiles that cover the q tiles seeing kv tile kt
__host__ __device__ __forceinline__ int q_runs(int kt, int window, int n_q, bool causal) {
  const int first = causal ? kt : 0;
  return (band_q_end(kt * BKV, window, n_q) - first + QCHUNK - 1) / QCHUNK;
}

// the most runs any kv tile has: the partials' slots per head
int max_q_runs(int s, int window, bool causal) {
  const int n_q = (s + BQ - 1) / BQ;
  int most = 0;
  for (int kt = 0; kt < n_q; ++kt) {
    const int r = q_runs(kt, window, n_q, causal);
    most = r > most ? r : most;
  }
  return most;
}

template <typename T, int DP, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, float* __restrict__ pk, float* __restrict__ pv,
            int s, int d, int group, float sm_scale, int window, int runs) {
  constexpr int LD = DP + 4;
  constexpr int DH = DP / 64;
  constexpr bool kOneBuf = one_buf<DP>();
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BKV * LD;
  float* Qs = Vs + BKV * LD;
  float* dOs = kOneBuf ? Qs : Qs + BQ * LD;  // one buffer: Q, then dO, then Q again
  float* Ps = dOs + BQ * LD;  // [BKV][LDP]: P^T, kv rows by q columns
  float* dSs = kOneBuf ? Ps : Ps + BKV * LDP;  // [BKV][LDP]: dS^T (over P^T in one buffer)
  float* lse_s = dSs + BKV * LDP;
  float* delta_s = lse_s + BQ;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int kt = blockIdx.x;
  const int k0 = kt * BKV;
  const int64_t bkv = blockIdx.y;
  const int g = blockIdx.z / runs;    // the q head of the group
  const int run = blockIdx.z % runs;  // which run of QCHUNK q tiles
  const int n_q = (s + BQ - 1) / BQ;
  const int qt_end = band_q_end(k0, window, n_q);
  const int qt_begin = (CAUSAL ? kt : 0) + run * QCHUNK;
  if (qt_begin >= qt_end) return;  // past this kv tile's band: no partial
  load_tile<T, DP>(Ks, k + bkv * s * d, k0, BKV, s, d);
  load_tile<T, DP>(Vs, v + bkv * s * d, k0, BKV, s, d);

  float gk[4][DH][4], gv[4][DH][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < DH; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) gk[i][h][e] = gv[i][h][e] = 0.0f;

  const int64_t bh = bkv * group + g;
  const int qt_stop = min(qt_end, qt_begin + QCHUNK);
  for (int qt = qt_begin; qt < qt_stop; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's products are done with Qs, dOs, Ps and dSs
    load_tile<T, DP>(Qs, q + bh * s * d, q0, BQ, s, d);
    if constexpr (!kOneBuf) load_tile<T, DP>(dOs, dout + bh * s * d, q0, BQ, s, d);
    load_rows(lse_s, delta_s, lse, delta, bh, q0, s);
    __syncthreads();
    float st[4][4] = {}, dpt[4][4] = {};
    dot_tiles<DP>(st, Ks, Qs, ty, tx);
    if constexpr (kOneBuf) {
      __syncthreads();  // every thread is done reading Q
      load_tile<T, DP>(dOs, dout + bh * s * d, q0, BQ, s, d);
    } else {
      dot_tiles<DP>(dpt, Vs, dOs, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;  // kv row
      const int kpos = k0 + row;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;  // q row
        const int qpos = q0 + col;
        const bool keep = qpos < s && kpos < s && (!CAUSAL || kpos <= qpos) &&
                          in_band(qpos, kpos, window);
        const float p = keep ? expf(st[i][j] * sm_scale - lse_s[col]) : 0.0f;
        Ps[row * LDP + col] = p;
        if constexpr (kOneBuf) {
          st[i][j] = p;  // dS waits for dO V^T
        } else {
          dSs[row * LDP + col] = p * (dpt[i][j] - delta_s[col]);
        }
      }
    }
    __syncthreads();
    if constexpr (kOneBuf) {
      dot_tiles<DP>(dpt, Vs, dOs, ty, tx);
      weigh_rows<DP>(gv, Ps, dOs, ty, tx);
      __syncthreads();  // every thread is done reading dO and P^T
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          dSs[(ty + 16 * i) * LDP + col] = st[i][j] * (dpt[i][j] - delta_s[col]);
        }
      load_tile<T, DP>(Qs, q + bh * s * d, q0, BQ, s, d);
      __syncthreads();
      weigh_rows<DP>(gk, dSs, Qs, ty, tx);
    } else {
      weigh_rows<DP>(gv, Ps, dOs, ty, tx);
      weigh_rows<DP>(gk, dSs, Qs, ty, tx);
    }
  }
  const int64_t slot = (static_cast<int64_t>(blockIdx.z) * gridDim.y + bkv) * s * d;
  store_rows<float, DP>(pk + slot, gk, k0, s, d, 1.0f, ty, tx);
  store_rows<float, DP>(pv + slot, gv, k0, s, d, 1.0f, ty, tx);
}

// dK = scale * (sum of the partials), dV = sum of the partials, for every
// kv row: the group's heads in order, each head's runs in order
template <typename T, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
dkdv_sum_kernel(const float* __restrict__ pk, const float* __restrict__ pv, T* __restrict__ dk,
                T* __restrict__ dv, int s, int d, int group, float sm_scale, int window,
                int runs) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<int64_t>(s) * d) return;
  const int64_t bkv = blockIdx.y;
  const int kt = static_cast<int>(i / d) / BKV;
  const int used = q_runs(kt, window, (s + BQ - 1) / BQ, CAUSAL);
  const int64_t stride = static_cast<int64_t>(gridDim.y) * s * d;  // one slot
  const int64_t at = bkv * s * d + i;
  float ak = 0.0f, av = 0.0f;
  for (int g = 0; g < group; ++g)
    for (int r = 0; r < used; ++r) {
      const int64_t z = static_cast<int64_t>(g) * runs + r;
      ak += pk[z * stride + at];
      av += pv[z * stride + at];
    }
  dk[at] = from_f32<T>(ak * sm_scale);
  dv[at] = from_f32<T>(av);
}

template <typename T, int DP, bool CAUSAL>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* delta, float* partials,
                       void* dq, void* dk, void* dv, int bhq, int s, int d, int group,
                       float sm_scale, int window, int runs, cudaStream_t stream) {
  auto k_dq = dq_kernel<T, DP, CAUSAL>;
  auto k_dkdv = dkdv_kernel<T, DP, CAUSAL>;
  constexpr int b_dq = dq_smem_bytes<DP>();
  constexpr int b_dkdv = dkdv_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(k_dq, cudaFuncAttributeMaxDynamicSharedMemorySize, b_dq);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(k_dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, b_dkdv);
  if (err != cudaSuccess) return err;
  const int tiles = (s + BQ - 1) / BQ;
  const int bhkv = bhq / group;
  k_dq<<<dim3(tiles, bhq), kThreads, b_dq, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq),
      s, d, group, sm_scale, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // partials: [group * runs][bhkv][s][d] for dK, then the same for dV
  float* pk = partials;
  float* pv = partials + static_cast<int64_t>(group) * runs * bhkv * s * d;
  k_dkdv<<<dim3(tiles, bhkv, group * runs), kThreads, b_dkdv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, pk, pv, s, d, group, sm_scale, window, runs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t elems = static_cast<int64_t>(s) * d;
  dkdv_sum_kernel<T, CAUSAL><<<dim3(static_cast<unsigned>((elems + kThreads - 1) / kThreads),
                                    bhkv), kThreads, 0, stream>>>(
      pk, pv, static_cast<T*>(dk), static_cast<T*>(dv), s, d, group, sm_scale, window, runs);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_bwd_dp(const void* q, const void* k, const void* v, const void* o,
                          const void* dout, const float* lse, float* delta, float* partials,
                          void* dq, void* dk, void* dv, int bhq, int s, int d, int group,
                          float sm_scale, int causal, int window, int runs, cudaStream_t st) {
  return causal ? launch_bwd<T, DP, true>(q, k, v, o, dout, lse, delta, partials, dq, dk, dv,
                                          bhq, s, d, group, sm_scale, window, runs, st)
                : launch_bwd<T, DP, false>(q, k, v, o, dout, lse, delta, partials, dq, dk, dv,
                                           bhq, s, d, group, sm_scale, window, runs, st);
}

template <typename T>
cudaError_t launch_bwd_dims(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const float* lse, float* delta, float* partials,
                            void* dq, void* dk, void* dv, int bhq, int s, int d, int group,
                            float sm_scale, int causal, int window, int runs, cudaStream_t st) {
  if (d <= 64)
    return launch_bwd_dp<T, 64>(q, k, v, o, dout, lse, delta, partials, dq, dk, dv, bhq, s, d,
                                group, sm_scale, causal, window, runs, st);
  if (d <= 128)
    return launch_bwd_dp<T, 128>(q, k, v, o, dout, lse, delta, partials, dq, dk, dv, bhq, s, d,
                                 group, sm_scale, causal, window, runs, st);
  return launch_bwd_dp<T, 256>(q, k, v, o, dout, lse, delta, partials, dq, dk, dv, bhq, s, d,
                               group, sm_scale, causal, window, runs, st);
}

}  // namespace bwd

namespace bwd_tc {

// ---------------------------------------------------------------- backward, tensor cores
// bf16, head dim 64, 128 or 256: the same gradient as namespace bwd, with the
// 64 x 64 x D products of a pair of tiles on wgmma.  At d 64 and 128 two
// kernels of one warpgroup each, fed by TMA with 128-byte swizzle from the
// forward's [B*H, S, D] tensor maps (at d = 256 the dK/dV kernel below
// them, dkdv_tc_wide_kernel, takes the place of the second):
//
// dq_tc_kernel, one block per (batch*q_head, 64-row q tile), heaviest
// causal tiles first.  Q and dO arrive once; K and V come through the
// forward's two-stage ring (tc::load_kv).  S = Q Kᵀ and dP = dO Vᵀ are
// m64n64k16 chains with both operands K-major in shared memory; P =
// exp2(S * scale*log2e - lse*log2e) and dS = P * (dP - delta) are formed on
// the f32 accumulator fragments; dS is rounded to bf16 and fed back as
// wgmma's register A operand for dQ += dS K (K read MN-major from the same
// tile, as the forward reads V for P V).  Before its loop the block takes
// delta = rowsum(dO * O) of its rows (16-byte loads, four lanes a row) and
// writes delta and lse*log2e into row scratch padded to whole tiles
// ([B*Hq, S_pad] each, 0 past S), so the second kernel can fetch a tile's
// 64 values with one bulk copy.
//
// dkdv_tc_kernel, one block per (batch*kv_head, 64-row kv tile), kv tile 0
// (which meets the most q tiles) first.  K and V stay resident; the block
// walks the group's q heads in order and, for each, the q tiles from the
// diagonal on, each (Q, dO, lse row, delta row) through a two-stage ring
// on one mbarrier.  Sᵀ = K Qᵀ and dPᵀ = V dOᵀ come out transposed, so lse
// and delta are indexed by the accumulator's column (the q row): thread t
// holds columns 8j + 2(t%4) + {0,1}.  Pᵀ and dSᵀ, rounded to bf16, are the
// register A operands of dV += Pᵀ dO and dK += dSᵀ Q (B MN-major).  dK and
// dV (2 x D/2 f32 a thread) stay in registers across the whole group, so
// the GQA sum has one fixed order and nothing needs atomics.
//
// Masks as namespace bwd: a (q, k) pair counts when q < S, k < S, if
// causal, k <= q, and with a window q - k < window; they run only on the
// diagonal tile, the ragged last tiles (TMA's zero rows past S would
// otherwise give P = exp(-lse)) and the band's edge tiles.  With a window
// the dQ kernel's kv walk starts at the band's first tile and the dK/dV
// kernels' q walk ends at the band's last.
// Numerics: P and dS are rounded to bf16 before their products (as
// FlashAttention-2 and -3 do), so the bits differ from the CUDA-core
// route's; the bf16 bar of 2e-2 against the plain version covers it.
// scale is applied to dQ and dK in the epilogue.  Shared memory at
// D = 128: 97 KB (dQ) and 98 KB (dK/dV), two blocks an SM; at D = 256 the
// dQ kernel takes 193 KB (one block an SM) and holds dQ (128 registers), S
// and dP (32 each) a thread.

// the forward's tiles, warpgroup and ring (the dQ kernel's K/V ring is tc::load_kv)
constexpr int BM = tc::BKV;  // rows of a q or kv tile
constexpr int kThreads = tc::kThreads;
constexpr int kStages = tc::kStages;
constexpr int kBoxBytes = tc::kBoxBytes;
constexpr float kLog2e = 1.4426950408889634f;
using tc::band_edge;
using tc::frags_times_tile;  // acc[64 x D] += A[64 x 64] M[64 x D] (the forward's P V)
using tc::tile_bytes;

template <int D>
constexpr int dq_smem_bytes() {
  // 1 KB for alignment, Q, dO, kStages x (K, V), 1 + 2 * kStages barriers
  return 1024 + tile_bytes<D>() * (2 + 2 * kStages) + 8 * (1 + 2 * kStages);
}

template <int D>
constexpr int dkdv_smem_bytes() {
  // 1 KB for alignment, K, V, kStages x (Q, dO, lse row, delta row), 1 + kStages barriers
  return 1024 + tile_bytes<D>() * (2 + 2 * kStages) + kStages * 2 * BM * 4 + 8 * (1 + kStages);
}

// acc[64 x 64] = A Bᵀ over the head dim, A and B [64 rows][D] tiles in
// shared memory, both K-major (the forward's Q Kᵀ chain)
template <int D>
__device__ __forceinline__ void rows_dot_rows(float (&acc)[32], uint32_t a_addr, uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    hopper::wgmma_m64n64k16_ss<0>(acc, hopper::desc_sw128(a_addr + off, 16, 1024),
                                  hopper::desc_sw128(b_addr + off, 16, 1024), kk > 0);
  }
}

// a 64-column accumulator as four k16 A fragments in bf16 (hopper.cuh)
__device__ __forceinline__ void pack_frags(uint32_t (&a)[4][4], const float (&v)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = hopper::pack_bf16x2(v[8 * kk], v[8 * kk + 1]);
    a[kk][1] = hopper::pack_bf16x2(v[8 * kk + 2], v[8 * kk + 3]);
    a[kk][2] = hopper::pack_bf16x2(v[8 * kk + 4], v[8 * kk + 5]);
    a[kk][3] = hopper::pack_bf16x2(v[8 * kk + 6], v[8 * kk + 7]);
  }
}

// sum over columns [part * D/4, (part + 1) * D/4) of a[row] * b[row], f32
template <int D>
__device__ __forceinline__ float row_part_dot(const __nv_bfloat16* a, const __nv_bfloat16* b,
                                              int64_t row, int part) {
  const uint4* pa = reinterpret_cast<const uint4*>(a + row * D + part * (D / 4));
  const uint4* pb = reinterpret_cast<const uint4*>(b + row * D + part * (D / 4));
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < D / 32; ++i) {
    const uint4 va = pa[i], vb = pb[i];
    const __nv_bfloat162* ha = reinterpret_cast<const __nv_bfloat162*>(&va);
    const __nv_bfloat162* hb = reinterpret_cast<const __nv_bfloat162*>(&vb);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 fa = __bfloat1622float2(ha[e]);
      const float2 fb = __bfloat1622float2(hb[e]);
      acc = fmaf(fa.x, fb.x, acc);
      acc = fmaf(fa.y, fb.y, acc);
    }
  }
  return acc;
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
dq_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
             const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
             const float* __restrict__ lse, float* __restrict__ lse2_rows,
             float* __restrict__ delta_rows, __nv_bfloat16* __restrict__ dq, int s, int s_pad,
             int group, float scale_log2, float sm_scale, int window) {
  constexpr int kTile = tile_bytes<D>();
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* qs = hopper::align_1024(smem_raw);
  uint8_t* dos = qs + kTile;
  uint8_t* ks = dos + kTile;            // kStages K tiles
  uint8_t* vs = ks + kStages * kTile;   // kStages V tiles
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(vs + kStages * kTile);
  uint64_t* bar_k = bar_q + 1;
  uint64_t* bar_v = bar_k + kStages;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * BM;
  const int kvh = bh / group;
  const int n_kv = CAUSAL ? qt + 1 : static_cast<int>(gridDim.y);
  const int j0 = band_start(q0, window) / BM;  // the band's first kv tile (0 without a window)
  const int n_it = n_kv - j0;

  if (tid == 0) {
    for (int i = 0; i < 1 + 2 * kStages; ++i) hopper::mbar_init(bar_q + i, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(bar_q, 2 * kTile);
#pragma unroll
    for (int b = 0; b < D / 64; ++b) {
      hopper::tma_load_3d(qs + b * kBoxBytes, &tq, bar_q, 64 * b, q0, bh);
      hopper::tma_load_3d(dos + b * kBoxBytes, &tdo, bar_q, 64 * b, q0, bh);
    }
    for (int it = 0; it < kStages && it < n_it; ++it)
      tc::load_kv<D>(&tk, &tv, ks, vs, bar_k, bar_v, it, j0 + it, kvh);
  }

  // this thread's rows (accumulator layout, hopper.cuh); delta over four lanes a row
  const int r0 = q0 + 16 * warp + lane / 4;
  const int r1 = r0 + 8;
  const int cq = 2 * (lane % 4);
  const int64_t hrow = static_cast<int64_t>(bh) * s;
  float dl0 = r0 < s ? row_part_dot<D>(o, dout, hrow + r0, lane % 4) : 0.0f;
  float dl1 = r1 < s ? row_part_dot<D>(o, dout, hrow + r1, lane % 4) : 0.0f;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    dl0 += __shfl_xor_sync(0xffffffffu, dl0, off);
    dl1 += __shfl_xor_sync(0xffffffffu, dl1, off);
  }
  // lse in log2 units; +inf past S, so those rows' P is 0 on any tile
  const float l2_0 = r0 < s ? lse[hrow + r0] * kLog2e : pos_inf();
  const float l2_1 = r1 < s ? lse[hrow + r1] * kLog2e : pos_inf();
  if (lane % 4 == 0) {
    const int64_t prow = static_cast<int64_t>(bh) * s_pad;
    lse2_rows[prow + r0] = r0 < s ? l2_0 : 0.0f;
    lse2_rows[prow + r1] = r1 < s ? l2_1 : 0.0f;
    delta_rows[prow + r0] = dl0;
    delta_rows[prow + r1] = dl1;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  const uint32_t q_addr = hopper::smem_u32(qs);
  const uint32_t do_addr = hopper::smem_u32(dos);

  hopper::mbar_wait(bar_q, 0);
  for (int it = 0; it < n_it; ++it) {
    const int j = j0 + it;
    const int st = it % kStages;
    const uint32_t parity = (it / kStages) & 1;
    const uint32_t k_addr = hopper::smem_u32(ks + st * kTile);
    const uint32_t v_addr = hopper::smem_u32(vs + st * kTile);

    // S = Q Kᵀ, dP = dO Vᵀ
    float sc[32], dp[32];
    hopper::mbar_wait(&bar_k[st], parity);
    hopper::wgmma_fence();
    rows_dot_rows<D>(sc, q_addr, k_addr);
    hopper::wgmma_commit();
    hopper::mbar_wait(&bar_v[st], parity);
    hopper::wgmma_fence();
    rows_dot_rows<D>(dp, do_addr, v_addr);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);

    // dS = P * (dP - delta) on the fragments, into sc
    const int k0 = j * BM;
    const bool edge =
        (CAUSAL && j == qt) || k0 + BM > s || q0 + BM > s || band_edge(q0, k0, window);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p0 = exp2f(fmaf(sc[4 * jj + e], scale_log2, -l2_0));
        float p1 = exp2f(fmaf(sc[4 * jj + 2 + e], scale_log2, -l2_1));
        if (edge) {
          const int col = k0 + 8 * jj + cq + e;
          if (!(col < s && r0 < s && (!CAUSAL || col <= r0) && in_band(r0, col, window)))
            p0 = 0.0f;
          if (!(col < s && r1 < s && (!CAUSAL || col <= r1) && in_band(r1, col, window)))
            p1 = 0.0f;
        }
        sc[4 * jj + e] = p0 * (dp[4 * jj + e] - dl0);
        sc[4 * jj + 2 + e] = p1 * (dp[4 * jj + 2 + e] - dl1);
      }

    // dQ += dS K
    uint32_t da[4][4];
    pack_frags(da, sc);
    hopper::wgmma_fence();
    frags_times_tile<D>(acc, da, k_addr);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);

    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && it + kStages < n_it)
      tc::load_kv<D>(&tk, &tv, ks, vs, bar_k, bar_v, it + kStages, j + kStages, kvh);
  }

  __nv_bfloat16* qb = dq + static_cast<int64_t>(bh) * s * D;
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj) {
    const int col = 8 * jj + cq;
    if (r0 < s)
      *reinterpret_cast<__nv_bfloat162*>(qb + static_cast<int64_t>(r0) * D + col) =
          __floats2bfloat162_rn(acc[4 * jj] * sm_scale, acc[4 * jj + 1] * sm_scale);
    if (r1 < s)
      *reinterpret_cast<__nv_bfloat162*>(qb + static_cast<int64_t>(r1) * D + col) =
          __floats2bfloat162_rn(acc[4 * jj + 2] * sm_scale, acc[4 * jj + 3] * sm_scale);
  }
}

// Q, dO, lse and delta of q head bh's tile at row q0 into ring stage
// it % kStages of a dK/dV block (one thread)
template <int D>
__device__ __forceinline__ void load_q_stage(const CUtensorMap* tq, const CUtensorMap* tdo,
                                             uint8_t* qs, uint8_t* dos, float* rows_s,
                                             uint64_t* bar_s, const float* lse2_rows,
                                             const float* delta_rows, int it, int bh, int q0,
                                             int s_pad) {
  constexpr int kTile = tile_bytes<D>();
  const int st = it % kStages;
  uint64_t* bar = &bar_s[st];
  hopper::mbar_expect_tx(bar, 2 * kTile + 2 * BM * 4);
#pragma unroll
  for (int b = 0; b < D / 64; ++b) {
    hopper::tma_load_3d(qs + st * kTile + b * kBoxBytes, tq, bar, 64 * b, q0, bh);
    hopper::tma_load_3d(dos + st * kTile + b * kBoxBytes, tdo, bar, 64 * b, q0, bh);
  }
  const int64_t row = static_cast<int64_t>(bh) * s_pad + q0;
  hopper::bulk_load(rows_s + st * 2 * BM, lse2_rows + row, BM * 4, bar);
  hopper::bulk_load(rows_s + st * 2 * BM + BM, delta_rows + row, BM * 4, bar);
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
dkdv_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ lse2_rows, const float* __restrict__ delta_rows,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int s, int s_pad,
               int group, float scale_log2, float sm_scale, int window) {
  constexpr int kTile = tile_bytes<D>();
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ks = hopper::align_1024(smem_raw);
  uint8_t* vs = ks + kTile;
  uint8_t* qs = vs + kTile;                 // kStages Q tiles
  uint8_t* dos = qs + kStages * kTile;      // kStages dO tiles
  float* rows_s = reinterpret_cast<float*>(dos + kStages * kTile);  // [kStages][lse2, delta][BM]
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(rows_s + kStages * 2 * BM);
  uint64_t* bar_s = bar_kv + 1;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bkv = blockIdx.x;
  const int kt = blockIdx.y;  // kv tile 0 meets the most q tiles: heaviest first
  const int k0 = kt * BM;
  const int qt0 = CAUSAL ? kt : 0;
  // q tiles per q head: up to the band's last that sees this kv tile
  const int per = bwd::band_q_end(k0, window, static_cast<int>(gridDim.y)) - qt0;
  const int n_it = group * per;

  if (tid == 0) {
    for (int i = 0; i < 1 + kStages; ++i) hopper::mbar_init(bar_kv + i, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(bar_kv, 2 * kTile);
#pragma unroll
    for (int b = 0; b < D / 64; ++b) {
      hopper::tma_load_3d(ks + b * kBoxBytes, &tk, bar_kv, 64 * b, k0, bkv);
      hopper::tma_load_3d(vs + b * kBoxBytes, &tv, bar_kv, 64 * b, k0, bkv);
    }
    for (int it = 0; it < kStages && it < n_it; ++it)
      load_q_stage<D>(&tq, &tdo, qs, dos, rows_s, bar_s, lse2_rows, delta_rows, it,
                      bkv * group + it / per, (qt0 + it % per) * BM, s_pad);
  }

  // this thread's kv rows and q columns (accumulator layout, hopper.cuh)
  const int kr0 = k0 + 16 * warp + lane / 4;
  const int kr1 = kr0 + 8;
  const int cq = 2 * (lane % 4);
  float gk[D / 2], gv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) gk[i] = gv[i] = 0.0f;
  const uint32_t k_addr = hopper::smem_u32(ks);
  const uint32_t v_addr = hopper::smem_u32(vs);

  hopper::mbar_wait(bar_kv, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages;
    const uint32_t parity = (it / kStages) & 1;
    const int qt = qt0 + it % per;
    const int q0 = qt * BM;
    const uint32_t q_addr = hopper::smem_u32(qs + st * kTile);
    const uint32_t do_addr = hopper::smem_u32(dos + st * kTile);
    const float* l2s = rows_s + st * 2 * BM;
    const float* dls = l2s + BM;

    // Sᵀ = K Qᵀ, dPᵀ = V dOᵀ
    float sc[32], dp[32];
    hopper::mbar_wait(&bar_s[st], parity);
    hopper::wgmma_fence();
    rows_dot_rows<D>(sc, k_addr, q_addr);
    rows_dot_rows<D>(dp, v_addr, do_addr);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);

    // Pᵀ into sc, dSᵀ = Pᵀ * (dPᵀ - delta) into dp, lse and delta by column
    const bool edge =
        (CAUSAL && qt == kt) || q0 + BM > s || k0 + BM > s || band_edge(q0, k0, window);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * jj + cq + e;
        const float l2 = l2s[c];
        const float dl = dls[c];
        float p0 = exp2f(fmaf(sc[4 * jj + e], scale_log2, -l2));
        float p1 = exp2f(fmaf(sc[4 * jj + 2 + e], scale_log2, -l2));
        if (edge) {
          const int qpos = q0 + c;
          if (!(qpos < s && kr0 < s && (!CAUSAL || kr0 <= qpos) && in_band(qpos, kr0, window)))
            p0 = 0.0f;
          if (!(qpos < s && kr1 < s && (!CAUSAL || kr1 <= qpos) && in_band(qpos, kr1, window)))
            p1 = 0.0f;
        }
        dp[4 * jj + e] = p0 * (dp[4 * jj + e] - dl);
        dp[4 * jj + 2 + e] = p1 * (dp[4 * jj + 2 + e] - dl);
        sc[4 * jj + e] = p0;
        sc[4 * jj + 2 + e] = p1;
      }

    // dV += Pᵀ dO, dK += dSᵀ Q
    uint32_t pa[4][4], da[4][4];
    pack_frags(pa, sc);
    pack_frags(da, dp);
    hopper::wgmma_fence();
    frags_times_tile<D>(gv, pa, do_addr);
    frags_times_tile<D>(gk, da, q_addr);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(gv);
    hopper::fence_regs(gk);

    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && it + kStages < n_it) {
      const int nx = it + kStages;
      load_q_stage<D>(&tq, &tdo, qs, dos, rows_s, bar_s, lse2_rows, delta_rows, nx,
                      bkv * group + nx / per, (qt0 + nx % per) * BM, s_pad);
    }
  }

  const int64_t base = static_cast<int64_t>(bkv) * s * D;
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj) {
    const int col = 8 * jj + cq;
    if (kr0 < s) {
      const int64_t at = base + static_cast<int64_t>(kr0) * D + col;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) =
          __floats2bfloat162_rn(gk[4 * jj] * sm_scale, gk[4 * jj + 1] * sm_scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) = __floats2bfloat162_rn(gv[4 * jj], gv[4 * jj + 1]);
    }
    if (kr1 < s) {
      const int64_t at = base + static_cast<int64_t>(kr1) * D + col;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) =
          __floats2bfloat162_rn(gk[4 * jj + 2] * sm_scale, gk[4 * jj + 3] * sm_scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(gv[4 * jj + 2], gv[4 * jj + 3]);
    }
  }
}

// ---- head dim 256: dK/dV split over the group's q heads, two warpgroups
//
// At D = 256 a 64 x 256 f32 accumulator takes 128 registers a thread, so
// dK and dV no longer share one warpgroup.  dkdv_tc_wide_kernel runs two:
// warpgroup 0 owns dV, warpgroup 1 owns dK.  Each q tile, warpgroup 0
// forms Sᵀ = K Qᵀ while warpgroup 1 forms dPᵀ = V dOᵀ (each a 16-step
// m64n64k16 chain); warpgroup 0 turns Sᵀ into Pᵀ (masked, f32) and hands it
// over through shared memory (thread t's 32 fragments at [i][t], the same
// accumulator layout on both sides), then runs dV += Pᵀ dO while warpgroup
// 1 forms dSᵀ = Pᵀ * (dPᵀ - delta) and runs dK += dSᵀ Q.  Four products a
// pair of tiles, none formed twice, one 16 KB exchange.  One block per
// (kv tile, kv head, q head of the group): each walks only its own head's
// q tiles of the band and writes f32 partials, which dkdv_tc_sum_kernel
// adds in head order: no atomics, the same bits on every run, and
// group x kv tiles blocks (1,024 at recurrentgemma's S = 4096, group 16)
// where one block per kv tile would give 64.  Shared memory: K, V, a
// two-stage (Q, dO, lse, delta) ring and the exchange, 210 KB: one block
// an SM.

constexpr int kWideThreads = 2 * kThreads;

constexpr int dkdv_wide_smem_bytes() {
  // 1 KB for alignment, K, V, kStages x (Q, dO), the Pᵀ exchange,
  // kStages x (lse row, delta row), 1 + kStages barriers
  return 1024 + tile_bytes<256>() * (2 + 2 * kStages) + BM * BM * 4 + kStages * 2 * BM * 4 +
         8 * (1 + kStages);
}
static_assert(dkdv_wide_smem_bytes() <= 232448, "the D = 256 dK/dV block must fit an SM");

// both warpgroups at named barrier 1 (barrier 0 is __syncthreads)
__device__ __forceinline__ void sync_warpgroups() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kWideThreads) : "memory");
}

template <bool CAUSAL>
__global__ void __launch_bounds__(kWideThreads, 1)
dkdv_tc_wide_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse2_rows, const float* __restrict__ delta_rows,
                    float* __restrict__ pk, float* __restrict__ pv, int s, int s_pad, int group,
                    float scale_log2, int window) {
  constexpr int D = 256;
  constexpr int kTile = tile_bytes<D>();
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ks = hopper::align_1024(smem_raw);
  uint8_t* vs = ks + kTile;
  uint8_t* qs = vs + kTile;                 // kStages Q tiles
  uint8_t* dos = qs + kStages * kTile;      // kStages dO tiles
  float* xchg = reinterpret_cast<float*>(dos + kStages * kTile);  // [32][128]: Pᵀ fragments
  float* rows_s = xchg + BM * BM;           // [kStages][lse2, delta][BM]
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(rows_s + kStages * 2 * BM);
  uint64_t* bar_s = bar_kv + 1;

  const int tid = threadIdx.x;
  const int wg = tid / kThreads;  // 0: dV, 1: dK
  const int t = tid % kThreads;
  const int warp = t / 32;
  const int lane = t % 32;
  const int kt = blockIdx.x;
  const int k0 = kt * BM;
  const int bkv = blockIdx.y;
  const int bh = bkv * group + blockIdx.z;  // the q head whose tiles this block walks
  const int qt0 = CAUSAL ? kt : 0;
  const int n_it = bwd::band_q_end(k0, window, static_cast<int>(gridDim.x)) - qt0;

  if (tid == 0) {
    for (int i = 0; i < 1 + kStages; ++i) hopper::mbar_init(bar_kv + i, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(bar_kv, 2 * kTile);
#pragma unroll
    for (int b = 0; b < D / 64; ++b) {
      hopper::tma_load_3d(ks + b * kBoxBytes, &tk, bar_kv, 64 * b, k0, bkv);
      hopper::tma_load_3d(vs + b * kBoxBytes, &tv, bar_kv, 64 * b, k0, bkv);
    }
    for (int it = 0; it < kStages && it < n_it; ++it)
      load_q_stage<D>(&tq, &tdo, qs, dos, rows_s, bar_s, lse2_rows, delta_rows, it, bh,
                      (qt0 + it) * BM, s_pad);
  }

  // this thread's kv rows and q columns (accumulator layout, hopper.cuh)
  const int kr0 = k0 + 16 * warp + lane / 4;
  const int kr1 = kr0 + 8;
  const int cq = 2 * (lane % 4);
  float acc[D / 2];  // dV (warpgroup 0) or dK (warpgroup 1), before the scale
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  // warpgroup 0 multiplies K by Q, then Pᵀ by dO; warpgroup 1 V by dO, then dSᵀ by Q
  const uint32_t a_addr = hopper::smem_u32(wg == 0 ? ks : vs);

  hopper::mbar_wait(bar_kv, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages;
    const uint32_t parity = (it / kStages) & 1;
    const int q0 = (qt0 + it) * BM;
    const uint32_t q_addr = hopper::smem_u32(qs + st * kTile);
    const uint32_t do_addr = hopper::smem_u32(dos + st * kTile);
    const float* l2s = rows_s + st * 2 * BM;
    const float* dls = l2s + BM;

    // Sᵀ = K Qᵀ (warpgroup 0), dPᵀ = V dOᵀ (warpgroup 1)
    float sc[32];
    hopper::mbar_wait(&bar_s[st], parity);
    hopper::wgmma_fence();
    rows_dot_rows<D>(sc, a_addr, wg == 0 ? q_addr : do_addr);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    if (wg == 0) {  // Pᵀ, lse by column, into sc and the exchange
      const bool edge =
          (CAUSAL && q0 == k0) || q0 + BM > s || k0 + BM > s || band_edge(q0, k0, window);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * jj + cq + e;
          const float l2 = l2s[c];
          float p0 = exp2f(fmaf(sc[4 * jj + e], scale_log2, -l2));
          float p1 = exp2f(fmaf(sc[4 * jj + 2 + e], scale_log2, -l2));
          if (edge) {
            const int qpos = q0 + c;
            if (!(qpos < s && kr0 < s && (!CAUSAL || kr0 <= qpos) && in_band(qpos, kr0, window)))
              p0 = 0.0f;
            if (!(qpos < s && kr1 < s && (!CAUSAL || kr1 <= qpos) && in_band(qpos, kr1, window)))
              p1 = 0.0f;
          }
          sc[4 * jj + e] = p0;
          sc[4 * jj + 2 + e] = p1;
        }
#pragma unroll
      for (int i = 0; i < 32; ++i) xchg[i * kThreads + t] = sc[i];
    }
    sync_warpgroups();  // Pᵀ is in shared memory
    if (wg == 1) {  // dSᵀ = Pᵀ * (dPᵀ - delta), delta by column
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dl = dls[8 * jj + cq + e];
          sc[4 * jj + e] = xchg[(4 * jj + e) * kThreads + t] * (sc[4 * jj + e] - dl);
          sc[4 * jj + 2 + e] = xchg[(4 * jj + 2 + e) * kThreads + t] * (sc[4 * jj + 2 + e] - dl);
        }
    }

    // dV += Pᵀ dO (warpgroup 0), dK += dSᵀ Q (warpgroup 1)
    uint32_t fa[4][4];
    pack_frags(fa, sc);
    hopper::wgmma_fence();
    frags_times_tile<D>(acc, fa, wg == 0 ? do_addr : q_addr);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);

    __syncthreads();  // both warpgroups are done with this stage and the exchange
    if (tid == 0 && it + kStages < n_it)
      load_q_stage<D>(&tq, &tdo, qs, dos, rows_s, bar_s, lse2_rows, delta_rows, it + kStages, bh,
                      (qt0 + it + kStages) * BM, s_pad);
  }

  // this head's partial: [group][bkv][s][D] f32, rows past S not written
  float* dst = (wg == 0 ? pv : pk) +
               (static_cast<int64_t>(blockIdx.z) * gridDim.y + bkv) * s * D;
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj) {
    const int col = 8 * jj + cq;
    if (kr0 < s)
      *reinterpret_cast<float2*>(dst + static_cast<int64_t>(kr0) * D + col) =
          make_float2(acc[4 * jj], acc[4 * jj + 1]);
    if (kr1 < s)
      *reinterpret_cast<float2*>(dst + static_cast<int64_t>(kr1) * D + col) =
          make_float2(acc[4 * jj + 2], acc[4 * jj + 3]);
  }
}

// dK = scale * (sum of the group's partials), dV = their sum, in head
// order, four values a thread; n4 = (bhq / group) * s * D / 4
__global__ void __launch_bounds__(kThreads)
dkdv_tc_sum_kernel(const float4* __restrict__ pk, const float4* __restrict__ pv,
                   __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int64_t n4,
                   int group, float sm_scale) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n4) return;
  float4 ak = pk[i], av = pv[i];
  for (int g = 1; g < group; ++g) {
    const float4 bk = pk[g * n4 + i], bv = pv[g * n4 + i];
    ak.x += bk.x; ak.y += bk.y; ak.z += bk.z; ak.w += bk.w;
    av.x += bv.x; av.y += bv.y; av.z += bv.z; av.w += bv.w;
  }
  __nv_bfloat162* ok = reinterpret_cast<__nv_bfloat162*>(dk + 4 * i);
  __nv_bfloat162* ov = reinterpret_cast<__nv_bfloat162*>(dv + 4 * i);
  ok[0] = __floats2bfloat162_rn(ak.x * sm_scale, ak.y * sm_scale);
  ok[1] = __floats2bfloat162_rn(ak.z * sm_scale, ak.w * sm_scale);
  ov[0] = __floats2bfloat162_rn(av.x, av.y);
  ov[1] = __floats2bfloat162_rn(av.z, av.w);
}

template <int D, bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* scratch, float* partials, void* dq, void* dk, void* dv,
                   int bhq, int s, int group, float sm_scale, int window, cudaStream_t stream) {
  const int tiles = (s + BM - 1) / BM;
  if (tiles > 65535) return cudaErrorInvalidValue;  // tiles run on grid y
  const int s_pad = tiles * BM;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = tc::encode_qkv_map<D>(&tq, q, bhq, s);
  if (err == cudaSuccess) err = tc::encode_qkv_map<D>(&tk, k, bhq / group, s);
  if (err == cudaSuccess) err = tc::encode_qkv_map<D>(&tv, v, bhq / group, s);
  if (err == cudaSuccess) err = tc::encode_qkv_map<D>(&tdo, dout, bhq, s);
  if (err != cudaSuccess) return err;
  auto k_dq = dq_tc_kernel<D, CAUSAL>;
  constexpr int b_dq = dq_smem_bytes<D>();
  err = cudaFuncSetAttribute(k_dq, cudaFuncAttributeMaxDynamicSharedMemorySize, b_dq);
  if (err != cudaSuccess) return err;
  float* lse2_rows = scratch;
  float* delta_rows = scratch + static_cast<int64_t>(bhq) * s_pad;
  const float scale_log2 = sm_scale * kLog2e;
  k_dq<<<dim3(bhq, tiles), kThreads, b_dq, stream>>>(
      tq, tk, tv, tdo, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, lse2_rows, delta_rows,
      static_cast<__nv_bfloat16*>(dq), s, s_pad, group, scale_log2, sm_scale, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int bhkv = bhq / group;
  if constexpr (D == 256) {
    // partials: [group][bhkv][s][D] for dK, then the same for dV
    auto k_wide = dkdv_tc_wide_kernel<CAUSAL>;
    constexpr int b_wide = dkdv_wide_smem_bytes();
    err = cudaFuncSetAttribute(k_wide, cudaFuncAttributeMaxDynamicSharedMemorySize, b_wide);
    if (err != cudaSuccess) return err;
    const int64_t n = static_cast<int64_t>(bhkv) * s * D;
    float* pk = partials;
    float* pv = partials + group * n;
    k_wide<<<dim3(tiles, bhkv, group), kWideThreads, b_wide, stream>>>(
        tq, tk, tv, tdo, lse2_rows, delta_rows, pk, pv, s, s_pad, group, scale_log2, window);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int64_t n4 = n / 4;
    dkdv_tc_sum_kernel<<<static_cast<unsigned>((n4 + kThreads - 1) / kThreads), kThreads, 0,
                         stream>>>(reinterpret_cast<const float4*>(pk),
                                   reinterpret_cast<const float4*>(pv),
                                   static_cast<__nv_bfloat16*>(dk),
                                   static_cast<__nv_bfloat16*>(dv), n4, group, sm_scale);
  } else {
    auto k_dkdv = dkdv_tc_kernel<D, CAUSAL>;
    constexpr int b_dkdv = dkdv_smem_bytes<D>();
    err = cudaFuncSetAttribute(k_dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, b_dkdv);
    if (err != cudaSuccess) return err;
    k_dkdv<<<dim3(bhkv, tiles), kThreads, b_dkdv, stream>>>(
        tq, tk, tv, tdo, lse2_rows, delta_rows, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), s, s_pad, group, scale_log2, sm_scale, window);
  }
  return cudaGetLastError();
}

}  // namespace bwd_tc

// q [bhq, s, d], k and v [bhq / group, s, d], out [bhq, s, d], all contiguous
// and of one dtype: 0 = float32, 1 = bfloat16.  1 <= d <= 256.  window: 0
// for none, else query q sees key k only if q - k < window.  lse: null, or
// [bhq, s] float32 that receives each row's log-sum-exp of the scaled
// scores (+inf for a fully masked row), for the backward.
// Returns cudaGetLastError() (or the error of setting the shared-memory size).
extern "C" int atlas_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     void* lse, int bhq, int s, int d, int group,
                                     float sm_scale, int causal, int window, int dtype,
                                     void* stream) {
  if (d < 1 || d > 256 || group < 1 || window < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(q, k, v, out, static_cast<float*>(lse), bhq, s, d, group, sm_scale,
                        causal, window, st);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(q, k, v, out, static_cast<float*>(lse), bhq, s, d, group,
                                sm_scale, causal, window, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

extern "C" const char* atlas_flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, float* lse, int bhq,
                      int s, int group, float sm_scale, int causal, int window, cudaStream_t st) {
  return causal ? tc::launch<D, true>(q, k, v, out, lse, bhq, s, group, sm_scale, window, st)
                : tc::launch<D, false>(q, k, v, out, lse, bhq, s, group, sm_scale, window, st);
}

template <int D>
cudaError_t launch_bwd_tc(const void* q, const void* k, const void* v, const void* o,
                          const void* dout, const float* lse, float* scratch, float* partials,
                          void* dq, void* dk, void* dv, int bhq, int s, int group, float sm_scale,
                          int causal, int window, cudaStream_t st) {
  return causal ? bwd_tc::launch<D, true>(q, k, v, o, dout, lse, scratch, partials, dq, dk, dv,
                                          bhq, s, group, sm_scale, window, st)
                : bwd_tc::launch<D, false>(q, k, v, o, dout, lse, scratch, partials, dq, dk, dv,
                                           bhq, s, group, sm_scale, window, st);
}

}  // namespace

// The tensor-core route: q [bhq, s, d], k and v [bhq / group, s, d], out
// [bhq, s, d], all bfloat16, contiguous and 16-byte aligned; d = 64, 128 or
// 256; lse null or [bhq, s] float32 and window (0: none) as for
// atlas_flash_attention.
// Returns cudaGetLastError(), or the error of encoding a tensor map or of
// setting the shared-memory size.
extern "C" int atlas_flash_attention_tc(const void* q, const void* k, const void* v, void* out,
                                        void* lse, int bhq, int s, int d, int group,
                                        float sm_scale, int causal, int window, void* stream) {
  if ((d != 64 && d != 128 && d != 256) || group < 1 || bhq % group || s < 1 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[4] = {q, k, v, out};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lp = static_cast<float*>(lse);
  cudaError_t err;
  if (d == 64) {
    err = launch_tc<64>(q, k, v, out, lp, bhq, s, group, sm_scale, causal, window, st);
  } else if (d == 128) {
    err = launch_tc<128>(q, k, v, out, lp, bhq, s, group, sm_scale, causal, window, st);
  } else {
    err = launch_tc<256>(q, k, v, out, lp, bhq, s, group, sm_scale, causal, window, st);
  }
  return static_cast<int>(err);
}

// The backward: q, o, dout, dq [bhq, s, d], k, v, dk, dv [bhq / group, s, d]
// of one dtype (0 = float32, 1 = bfloat16), contiguous; lse [bhq, s] float32
// from the forward on the same inputs; delta [bhq, s] float32 scratch;
// partials float32 scratch of 2 * group * runs * (bhq / group) * s * d
// values, where runs = atlas_flash_attention_bwd_runs(s, window, causal).
// 1 <= d <= 256; window as for atlas_flash_attention.  Three launches
// (dQ, which also writes delta; the dK/dV partials; their sum).  Returns
// the first launch error.
extern "C" int atlas_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* lse,
                                         void* delta, void* partials, void* dq, void* dk,
                                         void* dv, int bhq, int s, int d, int group,
                                         float sm_scale, int causal, int window, int runs,
                                         int dtype, void* stream) {
  if (d < 1 || d > 256 || group < 1 || bhq % group || s < 1 || window < 0 ||
      runs != bwd::max_q_runs(s, window, causal) || group * runs > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(lse);
  float* dp = static_cast<float*>(delta);
  float* pp = static_cast<float*>(partials);
  cudaError_t err;
  if (dtype == 0) {
    err = bwd::launch_bwd_dims<float>(q, k, v, o, dout, lp, dp, pp, dq, dk, dv, bhq, s, d, group,
                                      sm_scale, causal, window, runs, st);
  } else if (dtype == 1) {
    err = bwd::launch_bwd_dims<__nv_bfloat16>(q, k, v, o, dout, lp, dp, pp, dq, dk, dv, bhq, s,
                                              d, group, sm_scale, causal, window, runs, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// The runs of q tiles the backward's dK/dV partials hold per head: the
// size of atlas_flash_attention_bwd's partials.
extern "C" int atlas_flash_attention_bwd_runs(int s, int window, int causal) {
  return bwd::max_q_runs(s, window, causal != 0);
}

// The backward's tensor-core route: q, o, dout, dq [bhq, s, d], k, v, dk, dv
// [bhq / group, s, d], all bfloat16, contiguous and 16-byte aligned; d = 64,
// 128 or 256; lse [bhq, s] float32 from the forward on the same inputs;
// scratch [2, bhq, ceil(s / 64) * 64] float32 (lse in log2 units and delta,
// padded to whole tiles), 16-byte aligned; partials null at d 64 and 128,
// at d = 256 float32 scratch of 2 * bhq * s * d values (each q head's dK
// and dV before the group's sum), 16-byte aligned; window (0: none) as
// for atlas_flash_attention.  Two launches at d 64 and 128 (dQ, which also
// fills scratch, then dK/dV), three at 256 (dQ, the dK/dV partials, their
// sum).  Returns the first launch error, or the error of encoding a
// tensor map or of setting the shared-memory size.
extern "C" int atlas_flash_attention_bwd_tc(const void* q, const void* k, const void* v,
                                            const void* o, const void* dout, const void* lse,
                                            void* scratch, void* partials, void* dq, void* dk,
                                            void* dv, int bhq, int s, int d, int group,
                                            float sm_scale, int causal, int window,
                                            void* stream) {
  if ((d != 64 && d != 128 && d != 256) || group < 1 || bhq % group || s < 1 || window < 0 ||
      (d == 256) != (partials != nullptr) || group > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[10] = {q, k, v, o, dout, scratch, dq, dk, dv, partials};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(lse);
  float* sp = static_cast<float*>(scratch);
  float* pp = static_cast<float*>(partials);
  cudaError_t err;
  if (d == 64) {
    err = launch_bwd_tc<64>(q, k, v, o, dout, lp, sp, pp, dq, dk, dv, bhq, s, group, sm_scale,
                            causal, window, st);
  } else if (d == 128) {
    err = launch_bwd_tc<128>(q, k, v, o, dout, lp, sp, pp, dq, dk, dv, bhq, s, group, sm_scale,
                             causal, window, st);
  } else {
    err = launch_bwd_tc<256>(q, k, v, o, dout, lp, sp, pp, dq, dk, dv, bhq, s, group, sm_scale,
                             causal, window, st);
  }
  return static_cast<int>(err);
}
