// K4: Mamba-2 SSD chunk scan (Hopper).
//
// Replaces the TPU kernel `_ssd_kernel` (src/repro/kernels/ssd_chunk.py).  Its
// grid walked (batch*head, chunk) in order and carried the [P, N] f32 state
// from chunk to chunk in VMEM scratch.  Per chunk of T steps, with
// cl = cumsum(log a) inside the chunk:
//
//   y[t]   = sum_{s<=t} exp(cl[t]-cl[s]) (C[t].B[s]) x[s]  +  exp(cl[t]) C[t] state^T
//   state' = exp(cl[T-1]) state + sum_s exp(cl[T-1]-cl[s]) x[s] B[s]^T
//
// What bounds it: at mamba2-2.7b's shape (T = 256, P = 64, N = 128) about
// T*T*(N+P) + 2*T*P*N multiply-adds per chunk against T*(2P+2N) values moved:
// in bf16 the operation and byte bounds are of one size.
//
// Two routes, chosen by the Python wrapper (ssd_chunk.route):
//
// Tensor-core route (atlas_ssd_chunk_tc; bf16, P = 64, N = 64 or 128, chunk a
// multiple of 64 up to 256): Mamba-2's chunked decomposition in three
// launches, so every chunk of every sequence runs in parallel.
//  1. chunk_states_kernel, one warpgroup per (sequence, chunk), up to four
//     sequences that share a b/c row in one block so B's tiles are loaded once
//     for them: cl by a warpgroup scan (written out for pass 3), then the
//     chunk-local state
//     S_c = (w o X)^T B with w_s = exp(cl[T-1] - cl[s]), by wgmma with
//     (w o X)^T as the register A operand and B MN-major from shared memory.
//     w o X is f32; it enters the tensor cores as a bf16 hi + lo pair (two
//     wgmmas into one f32 accumulator), which keeps the state at f32
//     accuracy (about 2^-17 relative per term).  X and B arrive by TMA, all
//     of the chunk's 64-row s-tiles in flight at once, each on its mbarrier.
//     (One sequence per block moved B's 64 KB per chunk once per head.)
//  2. state_pass_kernel, per sequence in chunk order, f32:
//     state_in[c+1] = exp(cl_last[c]) state_in[c] + S_c, written as the bf16
//     hi + lo pair pass 3 reads, and the final state when asked for.
//  3. chunk_scan_kernel, one block per (sequence, chunk) and one warpgroup
//     per 64-row t-tile; every tile of the chunk is loaded once and shared by
//     the warpgroups (loading them per t-tile moved about twice the bytes
//     from L2): y = exp(cl[t]) C_t state_in^T (hi and lo, wgmma
//     SS) + sum over the s-tiles up to the diagonal of G X, where
//     G = (C_t B_s^T) o exp(cl[t] - cl[s]) is one wgmma SS chain (k = N), the
//     decay is applied to the accumulator in registers (evaluated only on and
//     below the diagonal: above it the exponential overflows, and inf*0 is
//     NaN), G is split in place into a bf16 hi + lo pair and fed as wgmma's
//     register A operand against X MN-major (G in bf16 alone misses the bf16
//     bar of 2e-2 on a few of mamba's 10.5 M outputs).  C, B and X arrive by
//     TMA from 3-D maps over [rows, S, width], so b/c stay shared by
//     `heads_per_bc` sequences without copies.  Nothing is rounded to bf16
//     but the output.
// Every sum has one fixed order (no atomics): the same bits on every run.
//
// CUDA-core route (atlas_ssd_chunk; f32, and bf16 at other shapes): one
// block of 256 threads owns a whole (batch*head) sequence and walks its
// chunks in a loop, with the state in shared memory ([64][128] f32, 32 KiB)
// for the whole sequence.  Per chunk, warp 0 forms cl with a warp scan.  The
// chunk is cut into 64-row t-tiles; for each, the block stages C's tile,
// reads the carried state for the inter-chunk term, then walks the 64-row
// s-tiles up to the diagonal: it stages B and x, forms
// G = (C B^T) * exp(cl[t]-cl[s]) in shared memory (the exponential only where
// s <= t), and accumulates G x.  The last t-tile walks every s-tile, so it
// also accumulates the next state there, in registers, and writes it back
// once the chunk's outputs no longer need the old state; after the last chunk
// it also goes out to `state` when the caller asks for it (the prefill hands
// it to the decode cache, so nothing recomputes it).  Thread (ty, tx) of a
// 16 x 16 grid owns rows ty + 16*i and columns tx + 16*j, which keeps the
// shared-memory reads conflict-free.  All math in f32 (inputs are converted
// on the way in, as the TPU kernel does); P and N are zero-padded to 64 and
// 128.  b and c may be shared by `heads_per_bc` consecutive sequences
// (Mamba-2's ngroups = 1): sequence i reads row i / heads_per_bc, so no
// per-head copy of them is made.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (repro_torch/kernels/_build.py), loaded by ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int TT = 64;          // rows of a t- or s-tile
constexpr int PP = 64;          // head dim, zero-padded
constexpr int NP = 128;         // state dim, zero-padded
constexpr int kMaxChunk = 256;  // cl lives in shared memory
constexpr int LDN = NP + 4;     // row stride of the state, C and B tiles
constexpr int LDG = TT + 4;     // row stride of G
constexpr int kThreads = 256;
constexpr int kSmemFloats = PP * LDN + 2 * TT * LDN + TT * PP + TT * LDG + kMaxChunk;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// TT x COLS tile of a [rows, width] matrix from row r0, zero past `rows`/`width`
template <typename T, int COLS, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int r0,
                                          int rows, int width) {
  for (int i = threadIdx.x; i < TT * COLS; i += kThreads) {
    const int r = i / COLS, c = i % COLS;
    const int gr = r0 + r;
    dst[r * LD + c] =
        (gr < rows && c < width) ? to_f32(src[static_cast<int64_t>(gr) * width + c]) : 0.0f;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// cl[t] = sum_{r<=t} log a[r] over one chunk, by the 32 lanes of one warp in
// one fixed order: each lane's `per` consecutive steps, then a warp scan
__device__ __forceinline__ void warp_cumlog(const float* __restrict__ a, int chunk, float* cl) {
  const int lane = threadIdx.x % 32;
  const int per = (chunk + 31) / 32;
  float loc[kMaxChunk / 32];
  float run = 0.0f;
#pragma unroll
  for (int e = 0; e < kMaxChunk / 32; ++e) {
    const int t = lane * per + e;
    if (e < per && t < chunk) run += logf(a[t]);
    loc[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0f;
#pragma unroll
  for (int e = 0; e < kMaxChunk / 32; ++e) {
    const int t = lane * per + e;
    if (e < per && t < chunk) cl[t] = excl + loc[e];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ a, const T* __restrict__ b,
           const T* __restrict__ c, T* __restrict__ y, float* __restrict__ state, int s, int p,
           int n, int chunk, int heads_per_bc) {
  extern __shared__ __align__(16) float smem[];
  float* Ss = smem;               // [PP][LDN] carried state
  float* Cs = Ss + PP * LDN;      // [TT][LDN] C tile
  float* Bs = Cs + TT * LDN;      // [TT][LDN] B tile
  float* Xs = Bs + TT * LDN;      // [TT][PP]  x tile
  float* Gs = Xs + TT * PP;       // [TT][LDG] G tile
  float* cl = Gs + TT * LDG;      // [kMaxChunk] cumulative log decay

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t seq = blockIdx.x;
  const T* xs = x + seq * s * p;
  const float* as = a + seq * s;
  const T* bs = b + (seq / heads_per_bc) * s * n;
  const T* cs = c + (seq / heads_per_bc) * s * n;
  T* ys = y + seq * s * p;

  for (int i = threadIdx.x; i < PP * LDN; i += kThreads) Ss[i] = 0.0f;

  for (int c0 = 0; c0 < s; c0 += chunk) {
    __syncthreads();  // state written, cl free
    if (threadIdx.x < 32) warp_cumlog(as + c0, chunk, cl);
    __syncthreads();
    const float cl_last = cl[chunk - 1];
    const T* xc = xs + static_cast<int64_t>(c0) * p;
    const T* bc = bs + static_cast<int64_t>(c0) * n;
    const T* cc = cs + static_cast<int64_t>(c0) * n;
    T* yc = ys + static_cast<int64_t>(c0) * p;

    float nst[4][8];  // next state, rows p = ty + 16*i, columns n = tx + 16*j
    for (int t0 = 0; t0 < chunk; t0 += TT) {
      const bool last = t0 + TT >= chunk;
      __syncthreads();  // the previous t-tile is done with Cs
      load_tile<T, NP, LDN>(Cs, cc, t0, chunk, n);
      __syncthreads();

      // inter-chunk term: exp(cl[t]) * C[t] . state[p]
      float inter[4][4], acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) inter[i][j] = acc[i][j] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < NP; k += 4) {
        float4 cv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cv[i] = *reinterpret_cast<const float4*>(&Cs[(ty + 16 * i) * LDN + k]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sv[j] = *reinterpret_cast<const float4*>(&Ss[(tx + 16 * j) * LDN + k]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) inter[i][j] = dot4(cv[i], sv[j], inter[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 16 * i;
        const float dec = t < chunk ? expf(cl[t]) : 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) inter[i][j] *= dec;
      }
      if (last) {
        const float carry = expf(cl_last);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) nst[i][j] = Ss[(ty + 16 * i) * LDN + tx + 16 * j] * carry;
      }

      // intra-chunk term over the s-tiles up to the diagonal
      for (int s0 = 0; s0 <= t0; s0 += TT) {
        __syncthreads();  // the previous s-tile is done with Bs, Xs and Gs
        load_tile<T, NP, LDN>(Bs, bc, s0, chunk, n);
        load_tile<T, PP, PP>(Xs, xc, s0, chunk, p);
        __syncthreads();

        float g[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = 0.0f;
#pragma unroll 4
        for (int k = 0; k < NP; k += 4) {
          float4 cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            cv[i] = *reinterpret_cast<const float4*>(&Cs[(ty + 16 * i) * LDN + k]);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            bv[j] = *reinterpret_cast<const float4*>(&Bs[(tx + 16 * j) * LDN + k]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) g[i][j] = dot4(cv[i], bv[j], g[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int sj = s0 + tx + 16 * j;
            // the decay is evaluated only on and below the diagonal
            const float val = (sj <= t && t < chunk) ? g[i][j] * expf(cl[t] - cl[sj]) : 0.0f;
            Gs[(ty + 16 * i) * LDG + tx + 16 * j] = val;
          }
        }
        __syncthreads();

#pragma unroll 2
        for (int k = 0; k < TT; k += 4) {
          float gv[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 t = *reinterpret_cast<const float4*>(&Gs[(ty + 16 * i) * LDG + k]);
            gv[i][0] = t.x; gv[i][1] = t.y; gv[i][2] = t.z; gv[i][3] = t.w;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float xv[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) xv[j] = Xs[(k + e) * PP + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(gv[i][e], xv[j], acc[i][j]);
          }
        }
        if (last) {
          const int rows = min(TT, chunk - s0);
          for (int k = 0; k < rows; ++k) {
            const float w = expf(cl_last - cl[s0 + k]);
            float xv[4], bv[8];
#pragma unroll
            for (int i = 0; i < 4; ++i) xv[i] = w * Xs[k * PP + ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 8; ++j) bv[j] = Bs[k * LDN + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j) nst[i][j] = fmaf(xv[i], bv[j], nst[i][j]);
          }
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 16 * i;
        if (t >= chunk) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          if (col < p) yc[static_cast<int64_t>(t) * p + col] = from_f32<T>(acc[i][j] + inter[i][j]);
        }
      }
    }

    __syncthreads();  // every t-tile has read the old state
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) Ss[(ty + 16 * i) * LDN + tx + 16 * j] = nst[i][j];
    if (state != nullptr && c0 + chunk >= s) {
      float* st = state + seq * p * n;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = ty + 16 * i;
        if (row >= p) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = tx + 16 * j;
          if (col < n) st[row * n + col] = nst[i][j];
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* a, const void* b, const void* c, void* y,
                   void* state, int bh, int s, int p, int n, int chunk, int heads_per_bc,
                   cudaStream_t stream) {
  auto kernel = ssd_kernel<T>;
  constexpr int bytes = kSmemFloats * static_cast<int>(sizeof(float));
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<bh, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), static_cast<float*>(state), s, p, n, chunk,
      heads_per_bc);
  return cudaGetLastError();
}

}  // namespace

// x, y [bh, s, p] and b, c [bh / heads_per_bc, s, n] in one dtype (0 = float32,
// 1 = bfloat16); a [bh, s] float32 in (0, 1]; state, if not null, [bh, p, n]
// float32 receives the state after the last step.  All contiguous.  Requires
// p <= 64, n <= 128, 1 <= chunk <= 256 and s % chunk == 0.
// Returns cudaGetLastError() (or the error of setting the shared-memory size).
extern "C" int atlas_ssd_chunk(const void* x, const void* a, const void* b, const void* c,
                               void* y, void* state, int bh, int s, int p, int n, int chunk,
                               int heads_per_bc, int dtype, void* stream) {
  if (p < 1 || p > PP || n < 1 || n > NP || chunk < 1 || chunk > kMaxChunk ||
      s % chunk != 0 || heads_per_bc < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(x, a, b, c, y, state, bh, s, p, n, chunk, heads_per_bc, st);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(x, a, b, c, y, state, bh, s, p, n, chunk, heads_per_bc, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

extern "C" const char* atlas_ssd_chunk_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace tc {

// ---------------------------------------------------------------- tensor-core route
// bf16, P = 64, N = 64 or 128, chunk % 64 == 0 and chunk <= 256.  Tiles are
// [64 rows][64 bf16 columns] TMA boxes with 128-byte swizzle (hopper.cuh).

constexpr int kThreads = 128;  // one warpgroup
constexpr int TT = 64;         // rows of a t- or s-tile
constexpr int P = 64;          // head dim
constexpr int kMaxChunk = 256;
constexpr int kMaxTiles = kMaxChunk / TT;
constexpr int kBoxBytes = 64 * 64 * 2;
constexpr int kXTile = TT * P * 2;  // one x tile, [64 steps][64]
constexpr int kMaxGroup = 4;        // sequences per pass-1 block (one warpgroup each)
constexpr float kLog2e = 1.4426950408889634f;

template <int N>
__host__ __device__ constexpr int ntile_bytes() { return TT * N * 2; }  // [64 rows][N] bf16

template <int N>
constexpr int states_smem() {
  // 1 KB alignment, every s-tile of B and of each sequence's x, then per
  // sequence cl, w and 4 warp sums, barriers
  return 1024 + kMaxTiles * (ntile_bytes<N>() + kMaxGroup * kXTile) +
         kMaxGroup * (2 * kMaxChunk + 4) * 4 + 8 * kMaxTiles;
}

template <int N>
constexpr int scan_smem() {
  // 1 KB alignment, every C, B and x tile of a chunk, state hi and lo, cl and the
  // column factors, barriers
  return 1024 + kMaxTiles * (2 * ntile_bytes<N>() + kXTile) + 2 * P * N * 2 + 2 * kMaxChunk * 4 +
         8 * (2 * kMaxTiles + 1);
}

// x[r][p] of a swizzled [64][64] bf16 box (128-byte swizzle: the 16-byte
// chunk index of a row is XORed with the row index mod 8)
__device__ __forceinline__ float swz_at(const uint8_t* box, int r, int p) {
  const int byte = r * 128 + ((((2 * p) >> 4) ^ (r & 7)) << 4) + ((2 * p) & 15);
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(box + byte));
}

// two f32 values as bf16x2 hi and lo parts: v ~= hi + lo to about 2^-17
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(v0 - __low2float(h), v1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// the 128 threads of warpgroup `wg` meet (named barrier 1 + wg)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kThreads) : "memory");
}

// cl[t] = sum_{r<=t} log a[r] over one chunk, by one warpgroup's 128
// threads in one fixed order: each thread's consecutive steps, a warp scan,
// then the warps in order
__device__ __forceinline__ void chunk_cumlog(const float* __restrict__ a, int chunk, float* cl,
                                             float* wsum, int wg) {
  const int tid = threadIdx.x % kThreads, lane = tid % 32, warp = tid / 32;
  const int per = (chunk + kThreads - 1) / kThreads;  // 1 or 2
  float loc[2];
  float run = 0.0f;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int t = tid * per + e;
    if (e < per && t < chunk) run += logf(a[t]);
    loc[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0f;
  if (lane == 31) wsum[warp] = incl;
  wg_sync(wg);
  float base = 0.0f;
  for (int w = 0; w < warp; ++w) base += wsum[w];
  excl = base + excl;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int t = tid * per + e;
    if (e < per && t < chunk) cl[t] = excl + loc[e];
  }
  wg_sync(wg);
}

template <int N>
__device__ __forceinline__ void wgmma_rs_trans(float (&d)[N / 2], const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  if constexpr (N == 64) {
    hopper::wgmma_m64n64k16_rs<1>(d, a, desc_b, 1);
  } else {
    hopper::wgmma_m64n128k16_rs<1>(d, a, desc_b, 1);
  }
}

// pass 1: cl and the chunk-local state S_c = (w o X)^T B, [P][N] f32, for
// `group` consecutive sequences that share one b/c row (warpgroup h owns
// sequence seq0 + h): the chunk's B tiles are loaded once for all of them.
// With `reverse` (the backward's state gradient) the weight is exp(cl[s])
// in place of w[s] = exp(cl[T-1] - cl[s]), and the maps are dy's and c's:
// dS_c = (exp(cl) o dY)^T C.  cl_out may be null.
template <int N>
__device__ __forceinline__ void chunk_states_body(const CUtensorMap& tx, const CUtensorMap& tb,
                                                  const float* __restrict__ a,
                                                  float* __restrict__ cl_out,
                                                  float* __restrict__ states, int s, int chunk,
                                                  int heads_per_bc, bool reverse) {
  constexpr int kNB = ntile_bytes<N>();
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* bs = hopper::align_1024(smem_raw);  // kMaxTiles B tiles
  uint8_t* xs = bs + kMaxTiles * kNB;          // [kMaxTiles][kMaxGroup] x tiles
  const int group = blockDim.x / kThreads;
  const int wg = threadIdx.x / kThreads;
  float* cl = reinterpret_cast<float*>(xs + kMaxTiles * kMaxGroup * kXTile) +
              wg * (2 * kMaxChunk + 4);        // this warpgroup's cl, w, warp sums
  float* w = cl + kMaxChunk;
  float* wsum = w + kMaxChunk;
  uint64_t* bar = reinterpret_cast<uint64_t*>(
      reinterpret_cast<float*>(xs + kMaxTiles * kMaxGroup * kXTile) +
      kMaxGroup * (2 * kMaxChunk + 4));

  const int tid = threadIdx.x % kThreads, warp = tid / 32, lane = tid % 32;
  const int nc = s / chunk;
  const int seq0 = (blockIdx.x / nc) * group, c = blockIdx.x % nc;
  const int seq = seq0 + wg;
  const int c0 = c * chunk;
  const int nst = chunk / TT;
  if (threadIdx.x == 0) {
    for (int j = 0; j < nst; ++j) hopper::mbar_init(&bar[j], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int j = 0; j < nst; ++j) {
      hopper::mbar_expect_tx(&bar[j], kNB + group * kXTile);
#pragma unroll
      for (int bb = 0; bb < N / 64; ++bb)
        hopper::tma_load_3d(bs + j * kNB + bb * kBoxBytes, &tb, &bar[j], 64 * bb, c0 + j * TT,
                            seq0 / heads_per_bc);
      for (int h = 0; h < group; ++h)
        hopper::tma_load_3d(xs + (j * kMaxGroup + h) * kXTile, &tx, &bar[j], 0, c0 + j * TT,
                            seq0 + h);
    }
  }
  const int64_t off = static_cast<int64_t>(seq) * s + c0;
  chunk_cumlog(a + off, chunk, cl, wsum, wg);
  const float cl_last = cl[chunk - 1];
  for (int t = tid; t < chunk; t += kThreads) {
    if (cl_out != nullptr) cl_out[off + t] = cl[t];
    w[t] = reverse ? expf(cl[t]) : expf(cl_last - cl[t]);
  }
  wg_sync(wg);

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  const int q = lane % 4;
  const int p0 = 16 * warp + lane / 4;  // this thread's A rows: p0 and p0 + 8
  for (int j = 0; j < nst; ++j) {
    hopper::mbar_wait(&bar[j], 0);
    const uint8_t* xt = xs + (j * kMaxGroup + wg) * kXTile;
    const float* wj = w + j * TT;
    // A = (w o X)^T: row p, k = step; fragment f holds row p0 + 8 (f & 1),
    // steps 2q + {0, 1} + 8 (f >> 1) of the k16 slice (hopper.cuh)
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int p = p0 + 8 * (f & 1);
        const int r = 16 * kk + 2 * q + 8 * (f >> 1);
        split2(wj[r] * swz_at(xt, r, p), wj[r + 1] * swz_at(xt, r + 1, p), hi[kk][f],
               lo[kk][f]);
      }
    const uint32_t b_addr = hopper::smem_u32(bs + j * kNB);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = hopper::desc_sw128(b_addr + kk * 16 * 128, kBoxBytes, 1024);
      wgmma_rs_trans<N>(acc, hi[kk], db);
      wgmma_rs_trans<N>(acc, lo[kk], db);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
  }

  float* st = states + (static_cast<int64_t>(seq) * nc + c) * P * N;
#pragma unroll
  for (int jj = 0; jj < N / 8; ++jj) {
    const int col = 8 * jj + 2 * q;
    *reinterpret_cast<float2*>(st + p0 * N + col) = make_float2(acc[4 * jj], acc[4 * jj + 1]);
    *reinterpret_cast<float2*>(st + (p0 + 8) * N + col) =
        make_float2(acc[4 * jj + 2], acc[4 * jj + 3]);
  }
}

template <int N>
__global__ void __launch_bounds__(kMaxGroup * kThreads)
chunk_states_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
                    const float* __restrict__ a, float* __restrict__ cl_out,
                    float* __restrict__ states, int s, int chunk, int heads_per_bc) {
  chunk_states_body<N>(tx, tb, a, cl_out, states, s, chunk, heads_per_bc, false);
}

// pass 2: state_in[c+1] = exp(cl_last[c]) state_in[c] + S_c in f32, in chunk
// order; written as the bf16 hi + lo pair for pass 3 (slot seq*nc + c + 1;
// slot 0 of a sequence is never read), and the final state when asked for.
// With `reverse` (the backward's state gradient) the chunks go in reverse
// order and chunk c's sum goes to slot c - 1: dS[c-1] = exp(cl_last[c]) dS[c]
// + dS_c (slot nc - 1 of a sequence is never read).  256 threads, 4
// consecutive values each, 1024 values per block.
__device__ __forceinline__ void state_pass_body(const float* __restrict__ states,
                                                const float* __restrict__ cl,
                                                __nv_bfloat16* __restrict__ hi,
                                                __nv_bfloat16* __restrict__ lo,
                                                float* __restrict__ state_out, int s, int chunk,
                                                int pn, bool reverse) {
  const int nc = s / chunk;
  const int per_seq = pn / 1024;
  const int64_t seq = blockIdx.x / per_seq;
  const int e = (blockIdx.x % per_seq) * 1024 + threadIdx.x * 4;
  float4 run = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
  for (int step = 0; step < nc; ++step) {
    const int c = reverse ? nc - 1 - step : step;
    const float g = expf(cl[seq * s + static_cast<int64_t>(c) * chunk + chunk - 1]);
    const float4 v = *reinterpret_cast<const float4*>(states + (seq * nc + c) * pn + e);
    run.x = run.x * g + v.x;
    run.y = run.y * g + v.y;
    run.z = run.z * g + v.z;
    run.w = run.w * g + v.w;
    const int to = reverse ? c - 1 : c + 1;
    if (to >= 0 && to < nc) {
      uint2 h, l;
      split2(run.x, run.y, h.x, l.x);
      split2(run.z, run.w, h.y, l.y);
      const int64_t at = (seq * nc + to) * pn + e;
      *reinterpret_cast<uint2*>(hi + at) = h;
      *reinterpret_cast<uint2*>(lo + at) = l;
    }
  }
  if (state_out != nullptr) *reinterpret_cast<float4*>(state_out + seq * pn + e) = run;
}

__global__ void __launch_bounds__(256)
state_pass_kernel(const float* __restrict__ states, const float* __restrict__ cl,
                  __nv_bfloat16* __restrict__ hi, __nv_bfloat16* __restrict__ lo,
                  float* __restrict__ state_out, int s, int chunk, int pn) {
  state_pass_body(states, cl, hi, lo, state_out, s, chunk, pn, false);
}

// pass 3: the outputs of one chunk of one sequence.  Warpgroup w owns the
// 64-row t-tile w; every tile of the chunk (C, B, x per 64 rows, and the
// state_in pair) is loaded once, each on its own mbarrier, and read by
// every warpgroup that needs it: t-tile w walks the s-tiles 0..w.
template <int N>
__global__ void __launch_bounds__(kMaxTiles * kThreads)
chunk_scan_kernel(const __grid_constant__ CUtensorMap tcm, const __grid_constant__ CUtensorMap tb,
                  const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap thi,
                  const __grid_constant__ CUtensorMap tlo, const float* __restrict__ cl_g,
                  __nv_bfloat16* __restrict__ y, int s, int chunk, int heads_per_bc) {
  constexpr int kNB = ntile_bytes<N>();
  constexpr int kState = P * N * 2;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* cs = hopper::align_1024(smem_raw);  // kMaxTiles C tiles
  uint8_t* bs = cs + kMaxTiles * kNB;           // kMaxTiles B tiles
  uint8_t* xs = bs + kMaxTiles * kNB;           // kMaxTiles x tiles
  uint8_t* his = xs + kMaxTiles * kXTile;       // state_in hi
  uint8_t* los = his + kState;                  // state_in lo
  float* cl = reinterpret_cast<float*>(los + kState);  // cl * log2(e)
  float* colf = cl + kMaxChunk;  // exp(cl[end of s's tile] - cl[s]), <= 1
  uint64_t* bar_c = reinterpret_cast<uint64_t*>(colf + kMaxChunk);  // C tile w
  uint64_t* bar_s = bar_c + kMaxTiles;                             // B and x tile j
  uint64_t* bar_st = bar_s + kMaxTiles;                            // state_in

  const int tid = threadIdx.x % kThreads, wg = threadIdx.x / kThreads;
  const int warp = tid / 32, lane = tid % 32;
  const int nt = chunk / TT, nc = s / chunk;
  const int seq = blockIdx.x / nc, c = blockIdx.x % nc;
  const int c0 = c * chunk, t0 = wg * TT;
  const int row_bc = seq / heads_per_bc;

  if (threadIdx.x == 0) {
    for (int k = 0; k < 2 * kMaxTiles + 1; ++k) hopper::mbar_init(bar_c + k, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (c > 0) {
      hopper::mbar_expect_tx(bar_st, 2 * kState);
#pragma unroll
      for (int bb = 0; bb < N / 64; ++bb) {
        hopper::tma_load_3d(his + bb * kBoxBytes, &thi, bar_st, 64 * bb, 0, seq * nc + c);
        hopper::tma_load_3d(los + bb * kBoxBytes, &tlo, bar_st, 64 * bb, 0, seq * nc + c);
      }
    }
    for (int j = 0; j < nt; ++j) {
      hopper::mbar_expect_tx(&bar_s[j], kNB + kXTile);
#pragma unroll
      for (int bb = 0; bb < N / 64; ++bb)
        hopper::tma_load_3d(bs + j * kNB + bb * kBoxBytes, &tb, &bar_s[j], 64 * bb,
                            c0 + j * TT, row_bc);
      hopper::tma_load_3d(xs + j * kXTile, &tx, &bar_s[j], 0, c0 + j * TT, seq);
      hopper::mbar_expect_tx(&bar_c[j], kNB);
#pragma unroll
      for (int bb = 0; bb < N / 64; ++bb)
        hopper::tma_load_3d(cs + j * kNB + bb * kBoxBytes, &tcm, &bar_c[j], 64 * bb,
                            c0 + j * TT, row_bc);
    }
  }
  // the decay exp(cl[t] - cl[s]) as exp2 of cl scaled by log2(e); below
  // the diagonal tile it factors through the s-tile's last step m:
  // exp(cl[t] - cl[m]) * exp(cl[m] - cl[s]), both factors <= 1 (t > m >= s),
  // so neither overflows and the column factor is shared by every row
  const float* clg = cl_g + static_cast<int64_t>(seq) * s + c0;
  for (int t = threadIdx.x; t < chunk; t += blockDim.x) cl[t] = clg[t] * kLog2e;
  __syncthreads();
  for (int t = threadIdx.x; t < chunk; t += blockDim.x) colf[t] = exp2f(cl[t | (TT - 1)] - cl[t]);
  __syncthreads();

  // this thread's rows of the tile (accumulator layout, hopper.cuh)
  const int r0 = t0 + 16 * warp + lane / 4;
  const int r1 = r0 + 8;
  const int cq = 2 * (lane % 4);
  const float cl0 = cl[r0], cl1 = cl[r1];
  const uint32_t c_addr = hopper::smem_u32(cs + wg * kNB);
  float yacc[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) yacc[k] = 0.0f;

  hopper::mbar_wait(&bar_c[wg], 0);
  if (c > 0) {
    // inter-chunk term: exp(cl[t]) C_t state_in^T, state_in [P][N] K-major
    const uint32_t hi_addr = hopper::smem_u32(his), lo_addr = hopper::smem_u32(los);
    hopper::mbar_wait(bar_st, 0);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      hopper::wgmma_m64n64k16_ss<0>(yacc, hopper::desc_sw128(c_addr + off, 16, 1024),
                                    hopper::desc_sw128(hi_addr + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      hopper::wgmma_m64n64k16_ss<0>(yacc, hopper::desc_sw128(c_addr + off, 16, 1024),
                                    hopper::desc_sw128(lo_addr + off, 16, 1024), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(yacc);
    const float e0 = exp2f(cl0), e1 = exp2f(cl1);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      yacc[4 * jj] *= e0;
      yacc[4 * jj + 1] *= e0;
      yacc[4 * jj + 2] *= e1;
      yacc[4 * jj + 3] *= e1;
    }
  }

  for (int j = 0; j <= wg; ++j) {
    const uint32_t b_addr = hopper::smem_u32(bs + j * kNB);
    const uint32_t x_addr = hopper::smem_u32(xs + j * kXTile);

    // C_t B_s^T: both K-major (the state dim contiguous)
    float sc[32];
    hopper::mbar_wait(&bar_s[j], 0);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      hopper::wgmma_m64n64k16_ss<0>(sc, hopper::desc_sw128(c_addr + off, 16, 1024),
                                    hopper::desc_sw128(b_addr + off, 16, 1024), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // the decay, only on and below the diagonal
    const int s0 = j * TT;
    if (j < wg) {  // every s of the tile is below every t
      const float f0 = exp2f(cl0 - cl[s0 + TT - 1]), f1 = exp2f(cl1 - cl[s0 + TT - 1]);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float cf = colf[s0 + 8 * jj + cq + e];
          sc[4 * jj + e] *= f0 * cf;
          sc[4 * jj + 2 + e] *= f1 * cf;
        }
    } else {  // the diagonal tile: one exponential per element on and below it
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int sl = s0 + 8 * jj + cq + e;
          const float cls = cl[sl];
          sc[4 * jj + e] = sl <= r0 ? sc[4 * jj + e] * exp2f(cl0 - cls) : 0.0f;
          sc[4 * jj + 2 + e] = sl <= r1 ? sc[4 * jj + 2 + e] * exp2f(cl1 - cls) : 0.0f;
        }
    }

    // G as wgmma's register A operand, a bf16 hi + lo pair (hopper.cuh's
    // fragment layout: 16 accumulator columns are one k16 fragment)
    uint32_t ghi[4][4], glo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f)
        split2(sc[8 * kk + 2 * f], sc[8 * kk + 2 * f + 1], ghi[kk][f], glo[kk][f]);

    // y += G X: X MN-major (the head dim contiguous), 16 steps per k slice
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dx = hopper::desc_sw128(x_addr + kk * 16 * 128, kBoxBytes, 1024);
      hopper::wgmma_m64n64k16_rs<1>(yacc, ghi[kk], dx, 1);
      hopper::wgmma_m64n64k16_rs<1>(yacc, glo[kk], dx, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(yacc);
  }

  __nv_bfloat16* yb = y + (static_cast<int64_t>(seq) * s + c0) * P;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int col = 8 * jj + cq;
    *reinterpret_cast<__nv_bfloat162*>(yb + static_cast<int64_t>(r0) * P + col) =
        __floats2bfloat162_rn(yacc[4 * jj], yacc[4 * jj + 1]);
    *reinterpret_cast<__nv_bfloat162*>(yb + static_cast<int64_t>(r1) * P + col) =
        __floats2bfloat162_rn(yacc[4 * jj + 2], yacc[4 * jj + 3]);
  }
}

// a bf16 [d2][d1][d0] map (d0 innermost, contiguous) with [64][64] boxes
cudaError_t encode_map(CUtensorMap* map, const void* base, int d0, int d1, int d2) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0), static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d0) * 2,
                                 static_cast<cuuint64_t>(d1) * d0 * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  return hopper::encode_bf16_map(map, base, 3, dims, strides, box);
}

template <int N>
cudaError_t launch(const void* x, const void* a, const void* b, const void* c, void* y,
                   void* state, void* cl, void* states, void* hi, void* lo, int bh, int s,
                   int chunk, int heads_per_bc, cudaStream_t stream) {
  const int nc = s / chunk;
  const int rows_bc = bh / heads_per_bc;
  CUtensorMap tx, tb, tcm, thi, tlo;
  cudaError_t err = encode_map(&tx, x, P, s, bh);
  if (err == cudaSuccess) err = encode_map(&tb, b, N, s, rows_bc);
  if (err == cudaSuccess) err = encode_map(&tcm, c, N, s, rows_bc);
  if (err == cudaSuccess) err = encode_map(&thi, hi, N, P, bh * nc);
  if (err == cudaSuccess) err = encode_map(&tlo, lo, N, P, bh * nc);
  if (err != cudaSuccess) return err;

  auto k1 = chunk_states_kernel<N>;
  constexpr int bytes1 = states_smem<N>();
  err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes1);
  if (err != cudaSuccess) return err;
  // sequences that share a b/c row share a pass-1 block, up to kMaxGroup
  const int group = heads_per_bc % 4 == 0 ? 4 : heads_per_bc % 2 == 0 ? 2 : 1;
  k1<<<(bh / group) * nc, group * kThreads, bytes1, stream>>>(tx, tb, static_cast<const float*>(a),
                                            static_cast<float*>(cl),
                                            static_cast<float*>(states), s, chunk,
                                            heads_per_bc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int pn = P * N;
  state_pass_kernel<<<bh * (pn / 1024), 256, 0, stream>>>(
      static_cast<const float*>(states), static_cast<const float*>(cl),
      static_cast<__nv_bfloat16*>(hi), static_cast<__nv_bfloat16*>(lo),
      static_cast<float*>(state), s, chunk, pn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto k3 = chunk_scan_kernel<N>;
  constexpr int bytes3 = scan_smem<N>();
  err = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes3);
  if (err != cudaSuccess) return err;
  k3<<<bh * nc, (chunk / TT) * kThreads, bytes3, stream>>>(
      tcm, tb, tx, thi, tlo, static_cast<const float*>(cl), static_cast<__nv_bfloat16*>(y), s,
      chunk, heads_per_bc);
  return cudaGetLastError();
}

}  // namespace tc

// The tensor-core route: x, y [bh, s, 64] and b, c [bh / heads_per_bc, s, n]
// bfloat16; a [bh, s] float32 in (0, 1]; state, if not null, [bh, 64, n]
// float32 receives the state after the last step.  Scratch the caller
// allocates: cl [bh, s] float32, states [bh, s / chunk, 64, n] float32, hi
// and lo [bh, s / chunk, 64, n] bfloat16.  All contiguous; x, b, c, hi and lo
// 16-byte aligned.  Requires n = 64 or 128, chunk % 64 == 0, chunk <= 256 and
// s % chunk == 0.  Returns cudaGetLastError() after each launch, or the error
// of encoding a tensor map or setting the shared-memory size.
extern "C" int atlas_ssd_chunk_tc(const void* x, const void* a, const void* b, const void* c,
                                  void* y, void* state, void* cl, void* states, void* hi,
                                  void* lo, int bh, int s, int n, int chunk, int heads_per_bc,
                                  void* stream) {
  if ((n != 64 && n != 128) || chunk < tc::TT || chunk > tc::kMaxChunk || chunk % tc::TT ||
      s % chunk || heads_per_bc < 1 || bh % heads_per_bc) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* ptrs[5] = {x, b, c, hi, lo};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      n == 64 ? tc::launch<64>(x, a, b, c, y, state, cl, states, hi, lo, bh, s, chunk,
                               heads_per_bc, st)
              : tc::launch<128>(x, a, b, c, y, state, cl, states, hi, lo, bh, s, chunk,
                                heads_per_bc, st);
  return static_cast<int>(err);
}

// ---------------------------------------------------------------- backward
// The gradient of the scan.  It has no Pallas counterpart: the reference
// differentiates its jnp twin (src/repro/models/mamba.py:52, ssd_chunked)
// with XLA.  Per chunk of T steps, with cl, L[t,s] = exp(cl[t]-cl[s]) for
// s <= t, G = C B^T, w[s] = exp(cl[T-1]-cl[s]), S_in the state entering the
// chunk and dS the gradient reaching the state it leaves:
//
//   dX    = (L o G)^T dY + diag(w) B dS^T
//   dC    = (L o dY X^T) B + diag(exp(cl)) dY S_in
//   dB    = (L o dY X^T)^T C + diag(w) X dS
//   dS_in = exp(cl[T-1]) dS + (diag(exp(cl)) dY)^T C
//   dcl   = rowsum(M) - colsum(M) + exp(cl) rowsum(C o dY S_in) - w q,
//           M = L o G o dY X^T, q[s] = <dS, x_s b_s^T>; at T-1 also
//           exp(cl[T-1]) <dS, S_in> + sum_s w[s] q[s]
//   d log a = the reverse cumsum of dcl within the chunk; da = d log a / a.
//
// Two routes, chosen by the Python wrapper (ssd_chunk.bwd_route, the
// forward's rule): the tensor-core route (atlas_ssd_chunk_bwd_tc, below the
// CUDA-core one) and the CUDA-core route (atlas_ssd_chunk_bwd; f32, and bf16
// at other shapes): three launches on the CUDA cores, f32 math, every sum in
// one fixed order (no atomics: the same bits on every run):
//  1. ssd_bwd_states_kernel, 2 * bh blocks: block i < bh walks sequence i's
//     chunks forward and writes the S_in of each; block bh + i walks them in
//     reverse and writes the dS reaching each ([bh][nc][p][n] f32 both).
//  2. ssd_bwd_chunk_kernel, one block per (sequence, chunk): dX, dcl and
//     from it da, and this head's dB and dC as f32 partials [bh][s][n].  The
//     chunk is cut into 64-row tiles; each s-tile walks the t-tiles on and
//     below the diagonal with its dX and dB rows in registers, and each
//     t-tile's dC rows accumulate in the partial, every element read and
//     written by one thread in a fixed order.  The exponential is evaluated
//     only on and below the diagonal, from the difference of cl.
//  3. ssd_bwd_head_sum_kernel: db and dc, the partials of the heads_per_bc
//     heads that share a b/c row added in head order.
// What bounds it: at mamba2-2.7b's shape about 2.5x the forward's operations
// (five T x T products against two), on the CUDA route at the CUDA cores'
// f32 rate, and the per-head f32 partials (2 x bh x s x n x 4 bytes)
// written and read once; the tensor-core route takes the products to
// wgmma and sums db and dc over groups of heads before it writes them.

namespace {
namespace bwd {

constexpr int kStatesSmem = (TT * PP + TT * LDN + kMaxChunk) * static_cast<int>(sizeof(float));
constexpr int kChunkSmem = (PP * LDN + 2 * TT * LDN + 2 * TT * PP + 2 * TT * LDG + 16 * TT +
                            3 * kMaxChunk + kThreads / 32) *
                           static_cast<int>(sizeof(float));

// the sum of v over the 16 lanes of a half warp (thread columns tx), in one
// fixed order; every lane of the warp must call it
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// a [p][n] f32 state into [PP][LDN], zero-padded
__device__ __forceinline__ void load_state(float* dst, const float* __restrict__ src, int p, int n) {
  for (int i = threadIdx.x; i < PP * NP; i += kThreads) {
    const int r = i / NP, col = i % NP;
    dst[r * LDN + col] = (r < p && col < n) ? src[r * n + col] : 0.0f;
  }
}

// pass 1: block i < bh writes S_in of each chunk of sequence i (forward);
// block bh + i writes the dS reaching each chunk of it (reverse).  Both
// are S <- exp(cl[T-1]) S + sum_r u_r v_r^T with u = w o x, v = b forward
// and u = exp(cl) o dy, v = c in reverse.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_states_kernel(const T* __restrict__ x, const float* __restrict__ a,
                      const T* __restrict__ b, const T* __restrict__ c,
                      const T* __restrict__ dy, float* __restrict__ states,
                      float* __restrict__ dstates, int bh, int s, int p, int n, int chunk,
                      int heads_per_bc) {
  extern __shared__ __align__(16) float smem[];
  float* Us = smem;           // [TT][PP] weighted x or dy rows
  float* Vs = Us + TT * PP;   // [TT][LDN] b or c rows
  float* cl = Vs + TT * LDN;  // [kMaxChunk]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool reverse = blockIdx.x >= bh;
  const int64_t seq = reverse ? blockIdx.x - bh : blockIdx.x;
  const int nc = s / chunk;
  const T* us = (reverse ? dy : x) + seq * s * p;
  const T* vs = (reverse ? c : b) + (seq / heads_per_bc) * s * n;
  const float* as = a + seq * s;
  float* out = (reverse ? dstates : states) + seq * nc * p * n;

  float st[4][8];  // rows p = ty + 16*i, columns n = tx + 16*j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) st[i][j] = 0.0f;

  for (int step = 0; step < nc; ++step) {
    const int k = reverse ? nc - 1 - step : step;
    float* o = out + static_cast<int64_t>(k) * p * n;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      if (row >= p) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tx + 16 * j;
        if (col < n) o[row * n + col] = st[i][j];
      }
    }
    if (step + 1 == nc) break;
    const int c0 = k * chunk;
    __syncthreads();  // the previous chunk is done with cl, Us and Vs
    if (threadIdx.x < 32) warp_cumlog(as + c0, chunk, cl);
    __syncthreads();
    const float cl_last = cl[chunk - 1];
    const float g = expf(cl_last);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) st[i][j] *= g;
    for (int r0 = 0; r0 < chunk; r0 += TT) {
      if (r0 > 0) __syncthreads();  // the previous tile is consumed
      for (int i = threadIdx.x; i < TT * PP; i += kThreads) {
        const int r = i / PP, col = i % PP, t = r0 + r;
        float v = 0.0f;
        if (t < chunk && col < p) {
          const float wt = reverse ? expf(cl[t]) : expf(cl_last - cl[t]);  // both <= 1
          v = wt * to_f32(us[static_cast<int64_t>(c0 + t) * p + col]);
        }
        Us[i] = v;
      }
      load_tile<T, NP, LDN>(Vs, vs + static_cast<int64_t>(c0) * n, r0, chunk, n);
      __syncthreads();
      const int rows = min(TT, chunk - r0);
      for (int r = 0; r < rows; ++r) {
        float u[4], v[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) u[i] = Us[r * PP + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = Vs[r * LDN + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) st[i][j] = fmaf(u[i], v[j], st[i][j]);
      }
    }
  }
}

// pass 2: one block per (sequence, chunk).  Thread (ty, tx) of a 16 x 16
// grid owns rows ty + 16*i and columns tx + 16*j of every tile it forms.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ a,
                     const T* __restrict__ b, const T* __restrict__ c,
                     const T* __restrict__ dy, const float* __restrict__ states,
                     const float* __restrict__ dstates, T* __restrict__ dx,
                     float* __restrict__ da, float* __restrict__ dbp, float* __restrict__ dcp,
                     int s, int p, int n, int chunk, int heads_per_bc) {
  extern __shared__ __align__(16) float smem[];
  float* St = smem;              // [PP][LDN] S_in (step A), then dS (step B)
  float* Cs = St + PP * LDN;     // [TT][LDN] C tile, rows t
  float* Bs = Cs + TT * LDN;     // [TT][LDN] B tile, rows s
  float* Xs = Bs + TT * LDN;     // [TT][PP]  x tile, rows s
  float* Ys = Xs + TT * PP;      // [TT][PP]  dy tile, rows t
  float* Gs = Ys + TT * PP;      // [TT][LDG] L o G, rows t, columns s
  float* Ds = Gs + TT * LDG;     // [TT][LDG] L o dY X^T
  float* cpart = Ds + TT * LDG;  // [16][TT]  column sums of M per thread row ty
  float* cl = cpart + 16 * TT;   // [kMaxChunk]
  float* dcl = cl + kMaxChunk;   // [kMaxChunk]
  float* wq = dcl + kMaxChunk;   // [kMaxChunk] w[s] q[s]
  float* red = wq + kMaxChunk;   // [kThreads / 32] warp sums of <dS, S_in>

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nc = s / chunk;
  const int64_t seq = blockIdx.x / nc;
  const int k = blockIdx.x % nc;
  const int64_t row0 = seq * s + static_cast<int64_t>(k) * chunk;  // the chunk's first step
  const int64_t bc0 = (seq / heads_per_bc) * s + static_cast<int64_t>(k) * chunk;
  const T* xc = x + row0 * p;
  const T* dyc = dy + row0 * p;
  const T* bc = b + bc0 * n;
  const T* cc = c + bc0 * n;
  const float* ac = a + row0;
  const float* s_in = states + (seq * nc + k) * p * n;
  const float* d_s = dstates + (seq * nc + k) * p * n;
  T* dxc = dx + row0 * p;
  float* dbc = dbp + row0 * n;
  float* dcc = dcp + row0 * n;

  if (threadIdx.x < 32) warp_cumlog(ac, chunk, cl);
  for (int t = threadIdx.x; t < kMaxChunk; t += kThreads) dcl[t] = 0.0f;
  load_state(St, s_in, p, n);
  float part = 0.0f;  // <dS, S_in>: each thread's elements, then the warps in order
  for (int i = threadIdx.x; i < p * n; i += kThreads) part = fmaf(d_s[i], s_in[i], part);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  if (lane == 0) red[warp] = part;
  __syncthreads();
  const float cl_last = cl[chunk - 1];

  // step A: dC's inter-chunk term exp(cl[t]) (dY S_in)[t] starts the
  // partial, and the readout's term of dcl
  for (int t0 = 0; t0 < chunk; t0 += TT) {
    if (t0 > 0) __syncthreads();  // the previous tile is consumed
    load_tile<T, PP, PP>(Ys, dyc, t0, chunk, p);
    load_tile<T, NP, LDN>(Cs, cc, t0, chunk, n);
    __syncthreads();
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < PP; ++kk) {
      float yv[4], sv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) yv[i] = Ys[(ty + 16 * i) * PP + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) sv[j] = St[kk * LDN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(yv[i], sv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty + 16 * i;
      float r = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) r = fmaf(Cs[(ty + 16 * i) * LDN + tx + 16 * j], acc[i][j], r);
      r = half_warp_sum(r);
      const float e = t < chunk ? expf(cl[t]) : 0.0f;
      if (t >= chunk) continue;
      if (tx == 0) dcl[t] += e * r;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tx + 16 * j;
        if (col < n) dcc[t * n + col] = e * acc[i][j];
      }
    }
  }

  // step B: the s-tiles in order, each with the t-tiles on and below it
  __syncthreads();  // step A is done with St
  load_state(St, d_s, p, n);
  for (int s0 = 0; s0 < chunk; s0 += TT) {
    __syncthreads();  // St loaded, or the previous s-tile consumed
    load_tile<T, NP, LDN>(Bs, bc, s0, chunk, n);
    load_tile<T, PP, PP>(Xs, xc, s0, chunk, p);
    __syncthreads();

    // the state's terms: w[s] (B dS^T)[s] of dX and w[s] (X dS)[s] of dB
    float gx[4][4], gb[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) gx[i][j] = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) gb[i][j] = 0.0f;
    }
#pragma unroll 4
    for (int kk = 0; kk < NP; kk += 4) {
      float4 bv[4], sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        bv[i] = *reinterpret_cast<const float4*>(&Bs[(ty + 16 * i) * LDN + kk]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sv[j] = *reinterpret_cast<const float4*>(&St[(tx + 16 * j) * LDN + kk]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) gx[i][j] = dot4(bv[i], sv[j], gx[i][j]);
    }
#pragma unroll 4
    for (int kk = 0; kk < PP; ++kk) {
      float xv[4], sv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = Xs[(ty + 16 * i) * PP + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) sv[j] = St[kk * LDN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) gb[i][j] = fmaf(xv[i], sv[j], gb[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int sr = s0 + ty + 16 * i;
      float q = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) q = fmaf(Bs[(ty + 16 * i) * LDN + tx + 16 * j], gb[i][j], q);
      q = half_warp_sum(q);
      const float w = sr < chunk ? expf(cl_last - cl[sr]) : 0.0f;
      if (tx == 0 && sr < chunk) wq[sr] = w * q;
#pragma unroll
      for (int j = 0; j < 4; ++j) gx[i][j] *= w;
#pragma unroll
      for (int j = 0; j < 8; ++j) gb[i][j] *= w;
    }

    for (int t0 = s0; t0 < chunk; t0 += TT) {
      __syncthreads();  // the previous t-tile is done with Cs, Ys, Gs, Ds and cpart
      load_tile<T, NP, LDN>(Cs, cc, t0, chunk, n);
      load_tile<T, PP, PP>(Ys, dyc, t0, chunk, p);
      __syncthreads();

      // G = C_t B_s^T and dY_t X_s^T, rows t, columns s
      float g[4][4], d[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) g[i][j] = d[i][j] = 0.0f;
#pragma unroll 4
      for (int kk = 0; kk < NP; kk += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cv[i] = *reinterpret_cast<const float4*>(&Cs[(ty + 16 * i) * LDN + kk]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[j] = *reinterpret_cast<const float4*>(&Bs[(tx + 16 * j) * LDN + kk]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = dot4(cv[i], bv[j], g[i][j]);
      }
#pragma unroll 4
      for (int kk = 0; kk < PP; kk += 4) {
        float4 yv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          yv[i] = *reinterpret_cast<const float4*>(&Ys[(ty + 16 * i) * PP + kk]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          xv[j] = *reinterpret_cast<const float4*>(&Xs[(tx + 16 * j) * PP + kk]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) d[i][j] = dot4(yv[i], xv[j], d[i][j]);
      }

      // the decay, only on and below the diagonal; M's row and column sums
      float csum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 16 * i;
        float rsum = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int sj = s0 + tx + 16 * j;
          const float l = (sj <= t && t < chunk) ? expf(cl[t] - cl[sj]) : 0.0f;
          const float lg = l * g[i][j], ld = l * d[i][j], m = lg * d[i][j];
          Gs[(ty + 16 * i) * LDG + tx + 16 * j] = lg;
          Ds[(ty + 16 * i) * LDG + tx + 16 * j] = ld;
          rsum += m;
          csum[j] += m;
        }
        rsum = half_warp_sum(rsum);
        if (tx == 0 && t < chunk) dcl[t] += rsum;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) cpart[ty * TT + tx + 16 * j] = csum[j];
      __syncthreads();
      if (threadIdx.x < TT) {
        const int sj = s0 + threadIdx.x;
        float cs = 0.0f;
        for (int r = 0; r < 16; ++r) cs += cpart[r * TT + threadIdx.x];
        if (sj < chunk) dcl[sj] -= cs;
      }

      // dX and dB rows of the s-tile: (L o G)^T dY and (L o dY X^T)^T C
#pragma unroll 2
      for (int r = 0; r < TT; ++r) {
        float gv[4], dv[4], yv[4], cv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          gv[i] = Gs[r * LDG + ty + 16 * i];
          dv[i] = Ds[r * LDG + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) yv[j] = Ys[r * PP + tx + 16 * j];
#pragma unroll
        for (int j = 0; j < 8; ++j) cv[j] = Cs[r * LDN + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) gx[i][j] = fmaf(gv[i], yv[j], gx[i][j]);
#pragma unroll
          for (int j = 0; j < 8; ++j) gb[i][j] = fmaf(dv[i], cv[j], gb[i][j]);
        }
      }

      // dC rows of the t-tile: (L o dY X^T) B over this s-tile, into the partial
      float gc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) gc[i][j] = 0.0f;
#pragma unroll 2
      for (int kk = 0; kk < TT; kk += 4) {
        float dv[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(&Ds[(ty + 16 * i) * LDG + kk]);
          dv[i][0] = v.x; dv[i][1] = v.y; dv[i][2] = v.z; dv[i][3] = v.w;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float bv[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) bv[j] = Bs[(kk + e) * LDN + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) gc[i][j] = fmaf(dv[i][e], bv[j], gc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 16 * i;
        if (t >= chunk) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = tx + 16 * j;
          if (col < n) dcc[t * n + col] += gc[i][j];
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int sr = s0 + ty + 16 * i;
      if (sr >= chunk) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        if (col < p) dxc[sr * p + col] = from_f32<T>(gx[i][j]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tx + 16 * j;
        if (col < n) dbc[sr * n + col] = gb[i][j];
      }
    }
  }

  // step C: the state's and the weights' terms at T-1, then da
  __syncthreads();
  if (threadIdx.x == 0) {
    float dss = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) dss += red[w];
    float tot = expf(cl_last) * dss;
    for (int t = 0; t < chunk; ++t) {
      tot += wq[t];
      dcl[t] -= wq[t];
    }
    dcl[chunk - 1] += tot;
    float run = 0.0f;
    for (int t = chunk - 1; t >= 0; --t) {
      run += dcl[t];
      da[row0 + t] = run / ac[t];
    }
  }
}

// pass 3: db and dc of each b/c row, its heads' partials added in head order
template <typename T>
__global__ void __launch_bounds__(256)
ssd_bwd_head_sum_kernel(const float* __restrict__ dbp, const float* __restrict__ dcp,
                        T* __restrict__ db, T* __restrict__ dc, int64_t total, int64_t per_row,
                        int heads_per_bc) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t at = (i / per_row) * heads_per_bc * per_row + i % per_row;
  float sb = 0.0f, sc = 0.0f;
  for (int h = 0; h < heads_per_bc; ++h) {
    sb += dbp[at + h * per_row];
    sc += dcp[at + h * per_row];
  }
  db[i] = from_f32<T>(sb);
  dc[i] = from_f32<T>(sc);
}

template <typename T>
cudaError_t launch(const void* x, const void* a, const void* b, const void* c, const void* dy,
                   void* dx, void* da, void* db, void* dc, void* states, void* dstates,
                   void* dbp, void* dcp, int bh, int s, int p, int n, int chunk,
                   int heads_per_bc, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(b);
  const T* ct = static_cast<const T*>(c);
  const T* dyt = static_cast<const T*>(dy);
  const float* af = static_cast<const float*>(a);
  float* st = static_cast<float*>(states);
  float* dst = static_cast<float*>(dstates);
  float* dbf = static_cast<float*>(dbp);
  float* dcf = static_cast<float*>(dcp);

  auto k1 = ssd_bwd_states_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, kStatesSmem);
  if (err != cudaSuccess) return err;
  k1<<<2 * bh, kThreads, kStatesSmem, stream>>>(xt, af, bt, ct, dyt, st, dst, bh, s, p, n, chunk,
                                                heads_per_bc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto k2 = ssd_bwd_chunk_kernel<T>;
  err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize, kChunkSmem);
  if (err != cudaSuccess) return err;
  k2<<<bh * (s / chunk), kThreads, kChunkSmem, stream>>>(
      xt, af, bt, ct, dyt, st, dst, static_cast<T*>(dx), static_cast<float*>(da), dbf, dcf, s, p,
      n, chunk, heads_per_bc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int64_t per_row = static_cast<int64_t>(s) * n;
  const int64_t total = static_cast<int64_t>(bh / heads_per_bc) * per_row;
  ssd_bwd_head_sum_kernel<T><<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
      dbf, dcf, static_cast<T*>(db), static_cast<T*>(dc), total, per_row, heads_per_bc);
  return cudaGetLastError();
}

}  // namespace bwd

// ---------------------------------------------------------------- backward, tensor-core route
// bf16, P = 64, N = 64 or 128, chunk % 64 == 0 and chunk <= 256 (the
// forward's rule, ssd_chunk.bwd_route).  Seven launches, every sum in one
// fixed order and no float atomics (the same bits on every run):
//  1-2. S_in of every chunk: the forward's passes 1-2 (chunk-local states on
//     wgmma, w o X entered as bf16 hi + lo; the f32 state pass), written as
//     the bf16 hi + lo pair wgmma takes (ssd_bwd_tc_states_kernel,
//     ssd_bwd_tc_carry_kernel).
//  3-4. dS reaching every chunk: their mirror, dS_c = (exp(cl) o dY)^T C on
//     wgmma with exp(cl) o dY entered as hi + lo, then the f32 pass in
//     reverse chunk order: dS[c-1] = exp(cl_last[c]) dS[c] + dS_c[c], again
//     as hi + lo.  Both replace the CUDA-core route's serial walk.
//  5. ssd_bwd_tc_chunk_kernel, one block per (b/c row, chunk, group of up to
//     8 heads that share the row, 64-row tile w), two warpgroups:
//     - warpgroup 0 owns the rows s of tile w: dX_s and dB_s.  It forms the
//       transposed tiles directly, (C B^T)^T = B_s C_t^T (k = N) and
//       (dY X^T)^T = X_s dY_t^T (k = P), for every t-tile on and after w.
//       That costs the k = N product C B^T a second time (warpgroup 1 forms
//       it too), but the decayed tiles land in the accumulator layout whose
//       rows are s, which is the register A operand of dX_s += (L o G)^T dY_t
//       and dB_s += (L o dY X^T)^T C_t: nothing is staged through shared
//       memory and no block-wide barrier sits between the two warpgroups
//       inside a head.  Staging L o G and L o dY X^T as hi + lo tiles would
//       need 64 KB more shared memory per pair, which the tiles below leave
//       no room for.
//     - warpgroup 1 owns the rows t of tile w: dC_t += (L o dY X^T) B_s over
//       the s-tiles up to w, the forward's register-A pattern.
//     The decay is applied to the accumulators in registers, evaluated only
//     on and below the diagonal (above it the exponential overflows, and
//     inf * 0 is NaN); off the diagonal tile it factors through the last
//     step of the earlier tile, both factors <= 1.  M = (L o G) o dY X^T
//     gives dcl its row sums (warpgroup 1) and column sums (warpgroup 0,
//     the row sums of M^T), each a fixed quad tree then t- or s-tiles in
//     order.  The state terms w o (B dS^T), w o (X dS) and
//     exp(cl) o (dY S_in) run on wgmma with dS and S_in as hi + lo; only f32
//     quantities (the decayed tiles, the states) enter as hi + lo, the bf16
//     inputs as they are.  dB and dC of the block's heads are summed in
//     registers in head order and written once per head group as f32
//     partials [rows][groups][s][n].  B and C tiles come by TMA once per
//     block; each head's x and dy tiles and its S_in and dS pairs by TMA
//     into one buffer (~190 KB of shared memory in all: one block an SM).
//  6. ssd_bwd_head_sum_kernel: db and dc, the groups' partials in order.
//  7. ssd_bwd_tc_da_kernel, one warpgroup per (sequence, chunk): dcl and
//     its reverse cumsum by a warpgroup scan (chunk_cumlog reversed), plus
//     the terms at T - 1, over a.

namespace bwd_tc {

using tc::kBoxBytes;
using tc::kLog2e;
using tc::kMaxChunk;
using tc::kMaxTiles;
using tc::kXTile;
using tc::P;
using tc::TT;

constexpr int kWG = tc::kThreads;        // one warpgroup
constexpr int kThreads = 2 * kWG;        // the s-side and the t-side
constexpr int kSlots = kMaxTiles + 1;    // tiles a block holds of each kind
constexpr int kMaxHeads = 8;             // heads a chunk block sums

template <int N>
constexpr int chunk_smem() {
  // 1 KB alignment, B and C tiles, x and dy tiles, S_in and dS as hi + lo,
  // cl and two factor rows, 4 warp sums, 2 barriers
  return 1024 + kSlots * (tc::ntile_bytes<N>() + kXTile) + 4 * P * N * 2 + 3 * kMaxChunk * 4 +
         4 * 4 + 2 * 8;
}

// element (r, n) of a swizzled [64][N] tile made of N / 64 boxes
__device__ __forceinline__ float tile_at(const uint8_t* tile, int r, int n) {
  return tc::swz_at(tile + (n >> 6) * kBoxBytes, r, n & 63);
}

// the sum over the 4 lanes of a quad (the threads of one accumulator row):
// the same bits in all four
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// k step kk (16 columns) of a K-major [64][width] tile
__device__ __forceinline__ uint64_t kmaj(uint32_t addr, int kk) {
  return hopper::desc_sw128(addr + (kk >> 2) * kBoxBytes + (kk & 3) * 32, 16, 1024);
}

// k step kk (16 rows) of an MN-major [64][width] tile (64-column boxes)
__device__ __forceinline__ uint64_t mnmaj(uint32_t addr, int kk) {
  return hopper::desc_sw128(addr + kk * 16 * 128, kBoxBytes, 1024);
}

// d[64 x 64] (+)= A B^T over KS k steps, A and B K-major [64][16 KS] tiles
template <int KS>
__device__ __forceinline__ void mma_nt(float (&d)[32], uint32_t a, uint32_t b, bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    hopper::wgmma_m64n64k16_ss<0>(d, kmaj(a, kk), kmaj(b, kk), accumulate || kk > 0);
}

// d[64 x 64] = A S, A a K-major [64][P] tile, S 64 columns of a [P][N] f32
// state entered as its bf16 hi and lo boxes (MN-major)
__device__ __forceinline__ void mma_state(float (&d)[32], uint32_t a, uint32_t hi, uint32_t lo) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) hopper::wgmma_m64n64k16_ss<1>(d, kmaj(a, kk), mnmaj(hi, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) hopper::wgmma_m64n64k16_ss<1>(d, kmaj(a, kk), mnmaj(lo, kk), 1);
}

// a [64 x 64] f32 accumulator as wgmma's register A operand, a bf16 hi + lo
// pair (hopper.cuh: 16 accumulator columns are one k16 fragment)
__device__ __forceinline__ void split_frags(const float (&v)[32], uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f) tc::split2(v[8 * kk + 2 * f], v[8 * kk + 2 * f + 1], hi[kk][f], lo[kk][f]);
}

// d[64 x W] += F T, F the hi + lo fragments (k = 64), T an MN-major [64][W] tile
template <int W>
__device__ __forceinline__ void mma_frags(float (&d)[W / 2], const uint32_t (&hi)[4][4],
                                          const uint32_t (&lo)[4][4], uint32_t t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t desc = mnmaj(t, kk);
    tc::wgmma_rs_trans<W>(d, hi[kk], desc);
    tc::wgmma_rs_trans<W>(d, lo[kk], desc);
  }
}

// passes 1-4: the forward's passes 1-2 under names of their own, so a
// profile counts them as the backward's
template <int N>
__global__ void __launch_bounds__(tc::kMaxGroup * tc::kThreads)
ssd_bwd_tc_states_kernel(const __grid_constant__ CUtensorMap tu, const __grid_constant__ CUtensorMap tv,
                         const float* __restrict__ a, float* __restrict__ cl_out,
                         float* __restrict__ states, int s, int chunk, int heads_per_bc,
                         int reverse) {
  tc::chunk_states_body<N>(tu, tv, a, cl_out, states, s, chunk, heads_per_bc, reverse != 0);
}

__global__ void __launch_bounds__(256)
ssd_bwd_tc_carry_kernel(const float* __restrict__ states, const float* __restrict__ cl,
                        __nv_bfloat16* __restrict__ hi, __nv_bfloat16* __restrict__ lo, int s,
                        int chunk, int pn, int reverse) {
  tc::state_pass_body(states, cl, hi, lo, nullptr, s, chunk, pn, reverse != 0);
}

// pass 5: block (b/c row, chunk, head group, tile w); warpgroup 0 the rows
// s of tile w (dX, dB, dcl's column sums and w q), warpgroup 1 its rows t
// (dC, dcl's row sums and readout term, and <dS, S_in> on tile 0)
template <int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_tc_chunk_kernel(const __grid_constant__ CUtensorMap tb, const __grid_constant__ CUtensorMap tcm,
                        const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdy,
                        const __grid_constant__ CUtensorMap tsh, const __grid_constant__ CUtensorMap tsl,
                        const __grid_constant__ CUtensorMap tdh, const __grid_constant__ CUtensorMap tdl,
                        const float* __restrict__ cl_g, __nv_bfloat16* __restrict__ dx,
                        float* __restrict__ dcl_t, float* __restrict__ dcl_s,
                        float* __restrict__ wq_g, float* __restrict__ dss,
                        float* __restrict__ dbp, float* __restrict__ dcp, int s, int chunk,
                        int heads_per_bc, int group) {
  constexpr int kNB = tc::ntile_bytes<N>();
  constexpr int kState = P * N * 2;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* bcs = hopper::align_1024(smem_raw);  // B_j at slot j (j <= w), C_i at slot i + 1 (i >= w)
  uint8_t* xys = bcs + kSlots * kNB;             // x_j at slot j, dy_i at slot i + 1
  uint8_t* sts = xys + kSlots * kXTile;          // S_in hi, S_in lo, dS hi, dS lo
  float* cl = reinterpret_cast<float*>(sts + 4 * kState);  // this head's cl * log2(e)
  float* colf = cl + kMaxChunk;  // exp(cl[end of s's tile] - cl[s])
  float* tf = colf + kMaxChunk;  // exp(cl[t] - cl[end of tile w]), t past tile w
  float* red = tf + kMaxChunk;   // warp sums of <dS, S_in>
  uint64_t* bar = reinterpret_cast<uint64_t*>(red + 4);  // [0] B and C tiles, [1] a head's

  const int wg = threadIdx.x / kWG, tid = threadIdx.x % kWG;
  const int warp = tid / 32, lane = tid % 32, q = lane % 4;
  const int nt = chunk / TT, nc = s / chunk, ng = heads_per_bc / group;
  int rest = blockIdx.x;
  const int w = rest % nt;
  rest /= nt;
  const int g = rest % ng;
  rest /= ng;
  const int k = rest % nc;
  const int row = rest / nc;
  const int c0 = k * chunk;
  const bool has_sin = k > 0, has_ds = k + 1 < nc;  // S_in is 0 in chunk 0, dS in the last
  const int me = w * TT + TT - 1;                     // the last step of tile w
  const int r0 = 16 * warp + lane / 4, r1 = r0 + 8;   // this thread's accumulator rows
  const int sr0 = w * TT + r0, sr1 = sr0 + 8;         // ... as steps of the chunk

  if (threadIdx.x == 0) {
    hopper::mbar_init(&bar[0], 1);
    hopper::mbar_init(&bar[1], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hopper::mbar_expect_tx(&bar[0], (nt + 1) * kNB);
    for (int j = 0; j <= w; ++j)
#pragma unroll
      for (int bb = 0; bb < N / 64; ++bb)
        hopper::tma_load_3d(bcs + j * kNB + bb * kBoxBytes, &tb, &bar[0], 64 * bb, c0 + j * TT, row);
    for (int i = w; i < nt; ++i)
#pragma unroll
      for (int bb = 0; bb < N / 64; ++bb)
        hopper::tma_load_3d(bcs + (i + 1) * kNB + bb * kBoxBytes, &tcm, &bar[0], 64 * bb,
                            c0 + i * TT, row);
  }

  float acc[N / 2];  // dB (warpgroup 0) or dC (1) of tile w, the group's heads in order
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;

  for (int hh = 0; hh < group; ++hh) {
    const int seq = row * heads_per_bc + g * group + hh;
    const int64_t step0 = static_cast<int64_t>(seq) * s + c0;  // the chunk's first step
    __syncthreads();  // the previous head is done with its tiles, cl and factors
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(&bar[1], (nt + 1) * kXTile + (has_sin ? 2 * kState : 0) +
                                          (has_ds ? 2 * kState : 0));
      for (int j = 0; j <= w; ++j)
        hopper::tma_load_3d(xys + j * kXTile, &tx, &bar[1], 0, c0 + j * TT, seq);
      for (int i = w; i < nt; ++i)
        hopper::tma_load_3d(xys + (i + 1) * kXTile, &tdy, &bar[1], 0, c0 + i * TT, seq);
      const int slot = seq * nc + k;
#pragma unroll
      for (int bb = 0; bb < N / 64; ++bb) {
        if (has_sin) {
          hopper::tma_load_3d(sts + bb * kBoxBytes, &tsh, &bar[1], 64 * bb, 0, slot);
          hopper::tma_load_3d(sts + kState + bb * kBoxBytes, &tsl, &bar[1], 64 * bb, 0, slot);
        }
        if (has_ds) {
          hopper::tma_load_3d(sts + 2 * kState + bb * kBoxBytes, &tdh, &bar[1], 64 * bb, 0, slot);
          hopper::tma_load_3d(sts + 3 * kState + bb * kBoxBytes, &tdl, &bar[1], 64 * bb, 0, slot);
        }
      }
    }
    for (int t = threadIdx.x; t < chunk; t += kThreads) cl[t] = cl_g[step0 + t] * kLog2e;
    __syncthreads();
    for (int t = threadIdx.x; t < chunk; t += kThreads) {
      colf[t] = exp2f(cl[t | (TT - 1)] - cl[t]);
      tf[t] = t > me ? exp2f(cl[t] - cl[me]) : 0.0f;
    }
    __syncthreads();
    hopper::mbar_wait(&bar[0], 0);
    hopper::mbar_wait(&bar[1], hh & 1);
    const float cl_last = cl[chunk - 1];

    if (wg == 0) {
      // ---- rows s of tile w: dX (this head), dB (the group), -colsum(M) - w q
      const uint8_t* bw = bcs + w * kNB;
      const uint32_t bw_a = hopper::smem_u32(bw), xw_a = hopper::smem_u32(xys + w * kXTile);
      const uint32_t dh_a = hopper::smem_u32(sts + 2 * kState);
      const uint32_t dl_a = hopper::smem_u32(sts + 3 * kState);
      const float cls0 = cl[sr0], cls1 = cl[sr1];
      const float w0 = exp2f(cl_last - cls0), w1 = exp2f(cl_last - cls1);
      const float rf0 = exp2f(cl[me] - cls0), rf1 = exp2f(cl[me] - cls1);
      float xacc[32];
      float qs0 = 0.0f, qs1 = 0.0f;  // q[s] = <dS, x_s b_s^T>
      if (has_ds) {
        // w o (B dS^T): dS [P][N] K-major, k = N
        hopper::wgmma_fence();
        mma_nt<N / 16>(xacc, bw_a, dh_a, false);
        mma_nt<N / 16>(xacc, bw_a, dl_a, true);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(xacc);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          xacc[4 * jj] *= w0;
          xacc[4 * jj + 1] *= w0;
          xacc[4 * jj + 2] *= w1;
          xacc[4 * jj + 3] *= w1;
        }
        // w o (X dS), 64 columns of dS at a time, and q from its rows
#pragma unroll
        for (int bb = 0; bb < N / 64; ++bb) {
          float tmp[32];
          hopper::wgmma_fence();
          mma_state(tmp, xw_a, dh_a + bb * kBoxBytes, dl_a + bb * kBoxBytes);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(tmp);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = 64 * bb + 8 * jj + 2 * q + e;
              const float v0 = tmp[4 * jj + e], v1 = tmp[4 * jj + 2 + e];
              qs0 = fmaf(tile_at(bw, r0, n), v0, qs0);
              qs1 = fmaf(tile_at(bw, r1, n), v1, qs1);
              acc[32 * bb + 4 * jj + e] = fmaf(w0, v0, acc[32 * bb + 4 * jj + e]);
              acc[32 * bb + 4 * jj + 2 + e] = fmaf(w1, v1, acc[32 * bb + 4 * jj + 2 + e]);
            }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) xacc[i] = 0.0f;
      }

      float cs0 = 0.0f, cs1 = 0.0f;  // column sums of M at s
      for (int i = w; i < nt; ++i) {
        const uint32_t ci_a = hopper::smem_u32(bcs + (i + 1) * kNB);
        const uint32_t dyi_a = hopper::smem_u32(xys + (i + 1) * kXTile);
        // (C B^T)^T = B_s C_t^T and (dY X^T)^T = X_s dY_t^T, rows s, columns t
        float gt[32], dt[32];
        hopper::wgmma_fence();
        mma_nt<N / 16>(gt, bw_a, ci_a, false);
        mma_nt<4>(dt, xw_a, dyi_a, false);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(gt);
        hopper::fence_regs(dt);
        const int t0 = i * TT;
        float m0 = 0.0f, m1 = 0.0f;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int t = t0 + 8 * jj + 2 * q + e;
            float l0, l1;
            if (i > w) {  // every t of the tile is after every s
              const float cf = tf[t];
              l0 = rf0 * cf;
              l1 = rf1 * cf;
            } else {  // the diagonal tile: one exponential per element on and below it
              const float clt = cl[t];
              l0 = t >= sr0 ? exp2f(clt - cls0) : 0.0f;
              l1 = t >= sr1 ? exp2f(clt - cls1) : 0.0f;
            }
            const int a0 = 4 * jj + e, a1 = a0 + 2;
            gt[a0] *= l0;
            gt[a1] *= l1;
            m0 = fmaf(gt[a0], dt[a0], m0);
            m1 = fmaf(gt[a1], dt[a1], m1);
            dt[a0] *= l0;
            dt[a1] *= l1;
          }
        cs0 += quad_sum(m0);
        cs1 += quad_sum(m1);
        uint32_t ghi[4][4], glo[4][4], dhi[4][4], dlo[4][4];
        split_frags(gt, ghi, glo);
        split_frags(dt, dhi, dlo);
        hopper::wgmma_fence();
        mma_frags<64>(xacc, ghi, glo, dyi_a);  // dX_s += (L o G)^T dY_t
        mma_frags<N>(acc, dhi, dlo, ci_a);     // dB_s += (L o dY X^T)^T C_t
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(xacc);
        hopper::fence_regs(acc);
      }
      qs0 = quad_sum(qs0);
      qs1 = quad_sum(qs1);
      if (q == 0) {
        dcl_s[step0 + sr0] = -cs0 - w0 * qs0;
        dcl_s[step0 + sr1] = -cs1 - w1 * qs1;
        wq_g[step0 + sr0] = w0 * qs0;
        wq_g[step0 + sr1] = w1 * qs1;
      }
      __nv_bfloat16* dxb = dx + (step0 + w * TT) * P;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = 8 * jj + 2 * q;
        *reinterpret_cast<__nv_bfloat162*>(dxb + r0 * P + col) =
            __floats2bfloat162_rn(xacc[4 * jj], xacc[4 * jj + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dxb + r1 * P + col) =
            __floats2bfloat162_rn(xacc[4 * jj + 2], xacc[4 * jj + 3]);
      }
    } else {
      // ---- rows t of tile w: dC (the group), rowsum(M) + the readout's term
      const uint8_t* cw = bcs + (w + 1) * kNB;
      const uint32_t cw_a = hopper::smem_u32(cw);
      const uint32_t dyw_a = hopper::smem_u32(xys + (w + 1) * kXTile);
      const uint32_t sh_a = hopper::smem_u32(sts), sl_a = hopper::smem_u32(sts + kState);
      const float clt0 = cl[sr0], clt1 = cl[sr1];
      float rs0 = 0.0f, rs1 = 0.0f;
      if (has_sin) {
        // exp(cl) o (dY S_in), 64 columns of S_in at a time, and its readout term
        const float e0 = exp2f(clt0), e1 = exp2f(clt1);
#pragma unroll
        for (int bb = 0; bb < N / 64; ++bb) {
          float tmp[32];
          hopper::wgmma_fence();
          mma_state(tmp, dyw_a, sh_a + bb * kBoxBytes, sl_a + bb * kBoxBytes);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(tmp);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = 64 * bb + 8 * jj + 2 * q + e;
              const float v0 = e0 * tmp[4 * jj + e], v1 = e1 * tmp[4 * jj + 2 + e];
              rs0 = fmaf(tile_at(cw, r0, n), v0, rs0);
              rs1 = fmaf(tile_at(cw, r1, n), v1, rs1);
              acc[32 * bb + 4 * jj + e] += v0;
              acc[32 * bb + 4 * jj + 2 + e] += v1;
            }
        }
        rs0 = quad_sum(rs0);
        rs1 = quad_sum(rs1);
      }

      for (int j = 0; j <= w; ++j) {
        const uint32_t bj_a = hopper::smem_u32(bcs + j * kNB);
        const uint32_t xj_a = hopper::smem_u32(xys + j * kXTile);
        // C_t B_s^T and dY_t X_s^T, rows t, columns s
        float gm[32], dm[32];
        hopper::wgmma_fence();
        mma_nt<N / 16>(gm, cw_a, bj_a, false);
        mma_nt<4>(dm, dyw_a, xj_a, false);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(gm);
        hopper::fence_regs(dm);
        const int s0 = j * TT;
        float f0 = 0.0f, f1 = 0.0f;
        if (j < w) {
          f0 = exp2f(clt0 - cl[s0 + TT - 1]);
          f1 = exp2f(clt1 - cl[s0 + TT - 1]);
        }
        float m0 = 0.0f, m1 = 0.0f;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int sl = s0 + 8 * jj + 2 * q + e;
            float l0, l1;
            if (j < w) {  // every s of the tile is before every t
              const float cf = colf[sl];
              l0 = f0 * cf;
              l1 = f1 * cf;
            } else {  // the diagonal tile
              const float cls = cl[sl];
              l0 = sl <= sr0 ? exp2f(clt0 - cls) : 0.0f;
              l1 = sl <= sr1 ? exp2f(clt1 - cls) : 0.0f;
            }
            const int a0 = 4 * jj + e, a1 = a0 + 2;
            m0 = fmaf(l0 * gm[a0], dm[a0], m0);
            m1 = fmaf(l1 * gm[a1], dm[a1], m1);
            dm[a0] *= l0;
            dm[a1] *= l1;
          }
        rs0 += quad_sum(m0);
        rs1 += quad_sum(m1);
        uint32_t dhi[4][4], dlo[4][4];
        split_frags(dm, dhi, dlo);
        hopper::wgmma_fence();
        mma_frags<N>(acc, dhi, dlo, bj_a);  // dC_t += (L o dY X^T) B_s
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
      }
      if (q == 0) {
        dcl_t[step0 + sr0] = rs0;
        dcl_t[step0 + sr1] = rs1;
      }
      if (w == 0) {  // <dS, S_in> for pass 7, from the hi + lo tiles (one layout for all four)
        float part = 0.0f;
        if (has_sin && has_ds) {
          const __nv_bfloat162* st2 = reinterpret_cast<const __nv_bfloat162*>(sts);
          constexpr int kPairs = kState / 4;  // bf16 pairs per tile
          for (int i = tid; i < kPairs; i += kWG) {
            const float2 sh = __bfloat1622float2(st2[i]), sl = __bfloat1622float2(st2[kPairs + i]);
            const float2 dh = __bfloat1622float2(st2[2 * kPairs + i]);
            const float2 dl = __bfloat1622float2(st2[3 * kPairs + i]);
            part = fmaf(dh.x + dl.x, sh.x + sl.x, part);
            part = fmaf(dh.y + dl.y, sh.y + sl.y, part);
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
        if (lane == 0) red[warp] = part;
        tc::wg_sync(1);
        if (tid == 0) dss[static_cast<int64_t>(seq) * nc + k] = ((red[0] + red[1]) + red[2]) + red[3];
      }
    }
  }

  // the group's dB (warpgroup 0) or dC (1) rows of tile w, once
  float* part = (wg == 0 ? dbp : dcp) +
                (static_cast<int64_t>(row * ng + g) * s + c0 + w * TT) * N;
#pragma unroll
  for (int jj = 0; jj < N / 8; ++jj) {
    const int col = 8 * jj + 2 * q;
    *reinterpret_cast<float2*>(part + r0 * N + col) = make_float2(acc[4 * jj], acc[4 * jj + 1]);
    *reinterpret_cast<float2*>(part + r1 * N + col) =
        make_float2(acc[4 * jj + 2], acc[4 * jj + 3]);
  }
}

// pass 7: da of one chunk of one sequence.  dcl = dcl_t + dcl_s; d log a[t]
// = sum_{t' >= t} dcl[t'] + exp(cl[T-1]) <dS, S_in> + sum_s w q (the terms
// at T - 1), by one warpgroup in one fixed order: position u = T-1-t, each
// thread's consecutive positions, a warp scan, then the warps in order.
__global__ void __launch_bounds__(kWG)
ssd_bwd_tc_da_kernel(const float* __restrict__ dcl_t, const float* __restrict__ dcl_s,
                     const float* __restrict__ wq, const float* __restrict__ dss,
                     const float* __restrict__ cl, const float* __restrict__ a,
                     float* __restrict__ da, int s, int chunk) {
  __shared__ float wsum[2][kWG / 32];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nc = s / chunk;
  const int64_t seq = blockIdx.x / nc;
  const int k = blockIdx.x % nc;
  const int64_t off = seq * s + static_cast<int64_t>(k) * chunk;
  const int per = (chunk + kWG - 1) / kWG;  // 1 or 2
  float loc[2];
  float run = 0.0f, run_w = 0.0f;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int u = tid * per + e;
    if (e < per && u < chunk) {
      const int64_t t = off + chunk - 1 - u;
      run += dcl_t[t] + dcl_s[t];
      run_w += wq[t];
    }
    loc[e] = run;
  }
  float incl = run, incl_w = run_w;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    const float vw = __shfl_up_sync(0xffffffffu, incl_w, o);
    if (lane >= o) {
      incl += v;
      incl_w += vw;
    }
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0f;
  if (lane == 31) {
    wsum[0][warp] = incl;
    wsum[1][warp] = incl_w;
  }
  __syncthreads();
  float base = 0.0f, total_w = 0.0f;
#pragma unroll
  for (int ww = 0; ww < kWG / 32; ++ww) {
    if (ww < warp) base += wsum[0][ww];
    total_w += wsum[1][ww];
  }
  const float tail = expf(cl[off + chunk - 1]) * dss[seq * nc + k] + total_w;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int u = tid * per + e;
    if (e < per && u < chunk) {
      const int64_t t = off + chunk - 1 - u;
      da[t] = ((base + excl + loc[e]) + tail) / a[t];
    }
  }
}

template <int N>
cudaError_t launch(const void* x, const void* a, const void* b, const void* c, const void* dy,
                   void* dx, void* da, void* db, void* dc, void* cl, void* states, void* sin_hi,
                   void* sin_lo, void* ds_hi, void* ds_lo, void* dcl, void* dss, void* dbp,
                   void* dcp, int bh, int s, int chunk, int heads_per_bc, int group,
                   cudaStream_t stream) {
  const int nc = s / chunk, nt = chunk / TT;
  const int rows_bc = bh / heads_per_bc, ng = heads_per_bc / group;
  CUtensorMap tx, tdy, tb, tcm, tsh, tsl, tdh, tdl;
  cudaError_t err = tc::encode_map(&tx, x, P, s, bh);
  if (err == cudaSuccess) err = tc::encode_map(&tdy, dy, P, s, bh);
  if (err == cudaSuccess) err = tc::encode_map(&tb, b, N, s, rows_bc);
  if (err == cudaSuccess) err = tc::encode_map(&tcm, c, N, s, rows_bc);
  if (err == cudaSuccess) err = tc::encode_map(&tsh, sin_hi, N, P, bh * nc);
  if (err == cudaSuccess) err = tc::encode_map(&tsl, sin_lo, N, P, bh * nc);
  if (err == cudaSuccess) err = tc::encode_map(&tdh, ds_hi, N, P, bh * nc);
  if (err == cudaSuccess) err = tc::encode_map(&tdl, ds_lo, N, P, bh * nc);
  if (err != cudaSuccess) return err;
  const float* af = static_cast<const float*>(a);
  float* clf = static_cast<float*>(cl);
  float* stf = static_cast<float*>(states);
  const int pn = P * N;

  // passes 1-4: S_in forwards, then dS in reverse, each as hi + lo
  auto k1 = ssd_bwd_tc_states_kernel<N>;
  constexpr int bytes1 = tc::states_smem<N>();
  err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes1);
  if (err != cudaSuccess) return err;
  const int sgroup = heads_per_bc % 4 == 0 ? 4 : heads_per_bc % 2 == 0 ? 2 : 1;
  for (int rev = 0; rev < 2; ++rev) {
    k1<<<(bh / sgroup) * nc, sgroup * tc::kThreads, bytes1, stream>>>(
        rev ? tdy : tx, rev ? tcm : tb, af, rev ? nullptr : clf, stf, s, chunk, heads_per_bc, rev);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ssd_bwd_tc_carry_kernel<<<bh * (pn / 1024), 256, 0, stream>>>(
        stf, clf, static_cast<__nv_bfloat16*>(rev ? ds_hi : sin_hi),
        static_cast<__nv_bfloat16*>(rev ? ds_lo : sin_lo), s, chunk, pn, rev);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  // pass 5: every (b/c row, chunk, head group, tile)
  float* dclf = static_cast<float*>(dcl);
  const int64_t plane = static_cast<int64_t>(bh) * s;
  auto k5 = ssd_bwd_tc_chunk_kernel<N>;
  constexpr int bytes5 = chunk_smem<N>();
  err = cudaFuncSetAttribute(k5, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes5);
  if (err != cudaSuccess) return err;
  k5<<<rows_bc * nc * ng * nt, kThreads, bytes5, stream>>>(
      tb, tcm, tx, tdy, tsh, tsl, tdh, tdl, clf, static_cast<__nv_bfloat16*>(dx), dclf,
      dclf + plane, dclf + 2 * plane, static_cast<float*>(dss), static_cast<float*>(dbp),
      static_cast<float*>(dcp), s, chunk, heads_per_bc, group);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // pass 6: db and dc, the head groups' partials in order
  const int64_t per_row = static_cast<int64_t>(s) * N;
  const int64_t total = static_cast<int64_t>(rows_bc) * per_row;
  bwd::ssd_bwd_head_sum_kernel<__nv_bfloat16>
      <<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
          static_cast<const float*>(dbp), static_cast<const float*>(dcp),
          static_cast<__nv_bfloat16*>(db), static_cast<__nv_bfloat16*>(dc), total, per_row, ng);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // pass 7: da
  ssd_bwd_tc_da_kernel<<<bh * nc, kWG, 0, stream>>>(dclf, dclf + plane, dclf + 2 * plane,
                                                     static_cast<const float*>(dss), clf, af,
                                                     static_cast<float*>(da), s, chunk);
  return cudaGetLastError();
}

}  // namespace bwd_tc
}  // namespace

// The backward: x, dy, dx [bh, s, p] and b, c, db, dc [bh / heads_per_bc, s, n]
// in one dtype (0 = float32, 1 = bfloat16); a [bh, s] float32 in (0, 1] and da
// [bh, s] float32.  Scratch the caller allocates: states and dstates
// [bh, s / chunk, p, n] float32, dbp and dcp [bh, s, n] float32.  All
// contiguous.  Requires p <= 64, n <= 128, 1 <= chunk <= 256, s % chunk == 0
// and bh % heads_per_bc == 0.  Returns cudaGetLastError() after each launch
// (or the error of setting a shared-memory size).
extern "C" int atlas_ssd_chunk_bwd(const void* x, const void* a, const void* b, const void* c,
                                   const void* dy, void* dx, void* da, void* db, void* dc,
                                   void* states, void* dstates, void* dbp, void* dcp, int bh,
                                   int s, int p, int n, int chunk, int heads_per_bc, int dtype,
                                   void* stream) {
  if (p < 1 || p > PP || n < 1 || n > NP || chunk < 1 || chunk > kMaxChunk || s % chunk != 0 ||
      heads_per_bc < 1 || bh % heads_per_bc != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = bwd::launch<float>(x, a, b, c, dy, dx, da, db, dc, states, dstates, dbp, dcp, bh, s, p,
                             n, chunk, heads_per_bc, st);
  } else if (dtype == 1) {
    err = bwd::launch<__nv_bfloat16>(x, a, b, c, dy, dx, da, db, dc, states, dstates, dbp, dcp,
                                     bh, s, p, n, chunk, heads_per_bc, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// The backward's tensor-core route: x, dy, dx [bh, s, 64] and b, c, db, dc
// [bh / heads_per_bc, s, n] bfloat16; a [bh, s] float32 in (0, 1] and da
// [bh, s] float32.  Scratch the caller allocates: cl [bh, s] float32, states
// [bh, s / chunk, 64, n] float32, sin_hi, sin_lo, ds_hi and ds_lo
// [bh, s / chunk, 64, n] bfloat16, dcl [3, bh, s] float32, dss
// [bh, s / chunk] float32, dbp and dcp [bh / heads_per_bc, heads_per_bc /
// group, s, n] float32.  All contiguous; x, b, c, dy and the four pairs
// 16-byte aligned.  Requires n = 64 or 128, chunk % 64 == 0, chunk <= 256,
// s % chunk == 0, bh % heads_per_bc == 0 and a group of 1 to 8 heads that
// divides heads_per_bc.  Returns cudaGetLastError() after each launch, or
// the error of encoding a tensor map or setting a shared-memory size.
extern "C" int atlas_ssd_chunk_bwd_tc(const void* x, const void* a, const void* b, const void* c,
                                      const void* dy, void* dx, void* da, void* db, void* dc,
                                      void* cl, void* states, void* sin_hi, void* sin_lo,
                                      void* ds_hi, void* ds_lo, void* dcl, void* dss, void* dbp,
                                      void* dcp, int bh, int s, int n, int chunk,
                                      int heads_per_bc, int group, void* stream) {
  if ((n != 64 && n != 128) || chunk < tc::TT || chunk > tc::kMaxChunk || chunk % tc::TT ||
      s % chunk || heads_per_bc < 1 || bh % heads_per_bc || group < 1 ||
      group > bwd_tc::kMaxHeads || heads_per_bc % group) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* ptrs[8] = {x, b, c, dy, sin_hi, sin_lo, ds_hi, ds_lo};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      n == 64 ? bwd_tc::launch<64>(x, a, b, c, dy, dx, da, db, dc, cl, states, sin_hi, sin_lo,
                                   ds_hi, ds_lo, dcl, dss, dbp, dcp, bh, s, chunk, heads_per_bc,
                                   group, st)
              : bwd_tc::launch<128>(x, a, b, c, dy, dx, da, db, dc, cl, states, sin_hi, sin_lo,
                                    ds_hi, ds_lo, dcl, dss, dbp, dcp, bh, s, chunk, heads_per_bc,
                                    group, st);
  return static_cast<int>(err);
}
