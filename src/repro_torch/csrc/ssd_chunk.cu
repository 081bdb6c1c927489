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
// Design: blocks run in no order on Hopper, so one block of 256 threads owns a
// whole (batch*head) sequence and walks its chunks in a loop, with the state
// in shared memory ([64][128] f32, 32 KiB) for the whole sequence.  Per chunk,
// warp 0 forms cl with a warp scan.  The chunk is cut into 64-row t-tiles;
// for each, the block stages C's tile, reads the carried state for the
// inter-chunk term, then walks the 64-row s-tiles up to the diagonal: it
// stages B and x, forms G = (C B^T) * exp(cl[t]-cl[s]) in shared memory with
// the exponential evaluated only where s <= t (above the diagonal it would
// overflow, and inf*0 is NaN), and accumulates G x.  The last t-tile walks
// every s-tile, so it also accumulates the next state there, in registers,
// and writes it back once the chunk's outputs no longer need the old state;
// after the last chunk it also goes out to `state` when the caller asks for
// it (the prefill hands it to the decode cache, so nothing recomputes it).
// Thread (ty, tx) of a 16 x 16 grid owns rows ty + 16*i and columns
// tx + 16*j, which keeps the shared-memory reads conflict-free.  All math in
// f32 (inputs are converted on the way in, as the TPU kernel does); P and N
// are zero-padded to 64 and 128.  b and c may be shared by `heads_per_bc`
// consecutive sequences (Mamba-2's ngroups = 1): sequence i reads row
// i / heads_per_bc, so no per-head copy of them is made.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (repro_torch/kernels/_build.py), loaded by ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  const int lane = threadIdx.x % 32;
  const int64_t seq = blockIdx.x;
  const T* xs = x + seq * s * p;
  const float* as = a + seq * s;
  const T* bs = b + (seq / heads_per_bc) * s * n;
  const T* cs = c + (seq / heads_per_bc) * s * n;
  T* ys = y + seq * s * p;

  for (int i = threadIdx.x; i < PP * LDN; i += kThreads) Ss[i] = 0.0f;

  for (int c0 = 0; c0 < s; c0 += chunk) {
    __syncthreads();  // state written, cl free
    if (threadIdx.x < 32) {
      // inclusive scan of log a over the chunk: lane owns `per` consecutive steps
      const int per = (chunk + 31) / 32;
      float loc[kMaxChunk / 32];
      float run = 0.0f;
#pragma unroll
      for (int e = 0; e < kMaxChunk / 32; ++e) {
        const int t = lane * per + e;
        if (e < per && t < chunk) run += logf(as[c0 + t]);
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
