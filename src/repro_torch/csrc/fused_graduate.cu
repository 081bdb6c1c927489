// K2: the graduation transform out = act(x @ W + b) (Hopper).
//
// Replaces the TPU kernel `_graduate_kernel` (src/repro/kernels/fused_graduate.py),
// which accumulated x@W over a k grid axis in a VMEM f32 scratch and applied
// bias and activation on the last k step.  Here each block owns an output
// tile and walks k inside itself in a fixed order, so results are bitwise
// repeatable (no split-K, no atomics).
//
// What bounds it: operations.  At the GNN path's shapes (x [<=8192, 256|512],
// W [256|512, 256|172]; in memory x [1 M, 128..1024], W up to [1024, 2048])
// it does 2*N*K*M flops on N*K + K*M + N*M values, far above the card's
// ridge point in f32 and in bf16.
//
// Two routes, chosen by the Python wrapper from (dtype, k, m, alignment):
//
// CUDA-core route (atlas_fused_graduate; f32, the GNN main path with TF32 off,
// and bf16 shapes TMA cannot take).  Two kernels, picked by the wrapper's
// tile_for from (n, k, m) and passed as a small integer:
//
// sgemm_kernel_tma (tiles 1-4: f32 with k % 4 == 0 and m % 4 == 0 on 16-byte
// aligned x, W and out, TMA's rules).  A persistent SGEMM fed by TMA: a
// producer warp keeps [BM][32] x stages (128-byte swizzle) and [32][BN] W
// stages in flight through a four-stage mbarrier ring, and the math threads
// issue only shared loads and FMAs, each an 8x8 patch of its block's tile,
// the next group of four k's fragments loading while the current one is
// multiplied.  The tile's width is fitted to m (128 or 176 columns: 172 is
// one 176 tile, 1032 six) and its height to n (64 rows where 128 would leave
// SMs idle), so no main-path shape computes more than 3 % of its columns past
// m.  Blocks walk the tiles, so a tile's epilogue overlaps the next tile's
// loads.  Details at the kernel.
//
// sgemm_kernel (tile 0: bf16, and f32 shapes TMA cannot take).  A
// register-blocked SGEMM: a block of 256
// threads owns a 128x128 output tile and each thread an 8x8 patch, split in
// four 4x4 quadrants (rows ty*4 and 64 + ty*4, columns tx*4 and 64 + tx*4),
// so a warp's 16-byte shared loads of W are contiguous and its loads of x
// touch two rows: no bank conflicts, and 64 FMAs per 4 shared loads (the
// 64x64 tile this replaces did 16 per 2).  k advances in steps of 16 through
// a two-stage cp.async ring: 4-element (16-byte f32, 8-byte bf16) copies
// where k % 4 == 0 and m % 4 == 0 on aligned pointers, zero-filled past the
// edges by cp.async's source size, else one-element loads.  x is kept as
// [128 rows][16 + 4 k] in shared memory and transposed in registers: a thread
// reads four k values of a row at once; the 4-element pad puts the rows a
// warp reads in different banks.  Shared tiles keep the input dtype and
// widen to f32 in registers.
//
// Both accumulate each output as one fmaf chain over k from 0 in order, so
// their outputs are the same bits.  The epilogue adds the bias, applies the
// activation (none, relu, or gelu with the tanh approximation, as
// jax.nn.gelu defaults to) and stores four values at once where m % 4 == 0.
//
// Tensor-core route (atlas_fused_graduate_tc; bf16 with k % 8 == 0 and
// m % 8 == 0 on 16-byte aligned x and W, TMA's stride rule).  A 128x128
// output tile per block: two consumer warpgroups of 64 rows each run wgmma
// m64n128k16 with x (K-major) and W ([K, M] row-major, so MN-major: the
// transpose flag is set) from shared memory; a third warpgroup's first
// thread keeps TMA loads of 128x64 x tiles and 64x128 W tiles (128-byte
// swizzle, W as two 64-column boxes) in flight through a four-stage ring of
// full and empty mbarriers.  TMA fills zeros past n, k and m.  The f32
// accumulators take the bias and activation in registers and are stored as
// bf16 pairs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (repro_torch/kernels/_build.py), loaded by ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

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

// four consecutive values of a shared tile, widened to f32
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

// four values to global memory at once (16 bytes f32, 8 bytes bf16)
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<const uint32_t*>(&lo);
  t.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = t;
}

// ------------------------------------------------------------ CUDA-core route

namespace simt {

constexpr int BM = 128;  // output rows per block
constexpr int BN = 128;  // output columns per block
constexpr int BK = 16;   // k step per ring stage
constexpr int LDA = BK + 4;  // x tile row stride: rows 4 apart land 16 banks apart
constexpr int kThreads = 256;

// one ring stage: x rows [row0, row0 + BM) x k [k0, k0 + BK) and W k rows
// [k0, k0 + BK) x columns [col0, col0 + BN), zero past n, k and m
template <typename T, bool VEC>
__device__ __forceinline__ void load_stage(T (*as)[LDA], T (*bs)[BN], const T* __restrict__ x,
                                           const T* __restrict__ w, int n, int k, int m,
                                           int row0, int col0, int k0) {
  const int tid = threadIdx.x;
  if constexpr (VEC) {
    constexpr int kBytes = 4 * sizeof(T);
#pragma unroll
    for (int l = 0; l < (BM * BK / 4) / kThreads; ++l) {
      const int i = tid + l * kThreads;
      const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
      const int gr = row0 + r, gk = k0 + c;
      const bool ok = gr < n && gk < k;  // k % 4 == 0: a 4-chunk is all in or all out
      hopper::cp_async<kBytes>(&as[r][c], ok ? x + static_cast<int64_t>(gr) * k + gk : x,
                               ok ? kBytes : 0);
    }
#pragma unroll
    for (int l = 0; l < (BK * BN / 4) / kThreads; ++l) {
      const int i = tid + l * kThreads;
      const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
      const int gk = k0 + r, gc = col0 + c;
      const bool ok = gk < k && gc < m;
      hopper::cp_async<kBytes>(&bs[r][c], ok ? w + static_cast<int64_t>(gk) * m + gc : w,
                               ok ? kBytes : 0);
    }
  } else {
    const T zero = from_f32<T>(0.0f);
#pragma unroll 4
    for (int i = tid; i < BM * BK; i += kThreads) {
      const int r = i / BK, c = i % BK;
      const int gr = row0 + r, gk = k0 + c;
      as[r][c] = (gr < n && gk < k) ? x[static_cast<int64_t>(gr) * k + gk] : zero;
    }
#pragma unroll 4
    for (int i = tid; i < BK * BN; i += kThreads) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gc = col0 + c;
      bs[r][c] = (gk < k && gc < m) ? w[static_cast<int64_t>(gk) * m + gc] : zero;
    }
  }
}

template <typename T, int ACT, bool VEC>
__global__ void __launch_bounds__(kThreads)
sgemm_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
             T* __restrict__ out, int n, int k, int m) {
  __shared__ __align__(16) T As[2][BM][LDA];
  __shared__ __align__(16) T Bs[2][BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int nk = (k + BK - 1) / BK;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  load_stage<T, VEC>(As[0], Bs[0], x, w, n, k, m, row0, col0, 0);
  hopper::cp_async_commit();
  for (int t = 0; t < nk; ++t) {
    const int st = t & 1;
    if (t + 1 < nk) load_stage<T, VEC>(As[st ^ 1], Bs[st ^ 1], x, w, n, k, m, row0, col0,
                                       (t + 1) * BK);
    hopper::cp_async_commit();  // possibly empty: keeps "all but the newest group" exact
    hopper::cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float a[8][4];  // rows ty*4 + i and 64 + ty*4 + i, k values kk..kk+3
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        load4(&As[st][ty * 4 + i][kk], a[i]);
        load4(&As[st][64 + ty * 4 + i][kk], a[4 + i]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float bv[8];
        float lo[4], hi[4];
        load4(&Bs[st][kk + e][tx * 4], lo);
        load4(&Bs[st][kk + e][64 + tx * 4], hi);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bv[j] = lo[j];
          bv[4 + j] = hi[j];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i][e], bv[j], acc[i][j]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= n) continue;
    T* orow = out + static_cast<int64_t>(r) * m;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col0 + 64 * h + tx * 4;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = c + e < m ? activate<ACT>(acc[i][4 * h + e] + to_f32(b[c + e])) : 0.0f;
      if (VEC) {
        if (c < m) store4(orow + c, v);  // m % 4 == 0: all four in bounds
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < m) orow[c + e] = from_f32<T>(v[e]);
      }
    }
  }
}

template <typename T, bool VEC>
void launch_act(const T* x, const T* w, const T* b, T* out, int n, int k, int m, int act,
                cudaStream_t stream) {
  const dim3 grid((n + BM - 1) / BM, (m + BN - 1) / BN);
  if (act == 0) {
    sgemm_kernel<T, 0, VEC><<<grid, kThreads, 0, stream>>>(x, w, b, out, n, k, m);
  } else if (act == 1) {
    sgemm_kernel<T, 1, VEC><<<grid, kThreads, 0, stream>>>(x, w, b, out, n, k, m);
  } else {
    sgemm_kernel<T, 2, VEC><<<grid, kThreads, 0, stream>>>(x, w, b, out, n, k, m);
  }
}

template <typename T>
void launch(const void* x, const void* w, const void* b, void* out, int n, int k, int m,
            int act, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* bp = static_cast<const T*>(b);
  T* op = static_cast<T*>(out);
  constexpr uintptr_t kAlign = 4 * sizeof(T);
  const bool vec = k % 4 == 0 && m % 4 == 0 && reinterpret_cast<uintptr_t>(x) % kAlign == 0 &&
                   reinterpret_cast<uintptr_t>(w) % kAlign == 0 &&
                   reinterpret_cast<uintptr_t>(out) % kAlign == 0;
  if (vec) {
    launch_act<T, true>(xp, wp, bp, op, n, k, m, act, stream);
  } else {
    launch_act<T, false>(xp, wp, bp, op, n, k, m, act, stream);
  }
}

// ---- sgemm_kernel_tma: the persistent, TMA-fed f32 SGEMM

constexpr int kBK = 32;      // k values a ring stage: one 128-byte row of x a tile row
constexpr int kStages = 4;   // ring depth

// An output tile of BM = 8·TY rows by BN = 8·TX columns: TX·TY math
// threads, each 8 x 8 outputs, and one producer warp; MINB blocks an SM.  Its
// x stage is [BM][32] f32 under TMA's 128-byte swizzle, its W stage [32][BN]
// f32 unswizzled; both a whole number of KB, so every stage base stays
// 1024-byte aligned.  A thread's columns are tx·4 + j and BN/2 + tx·4 + j
// (j < 4).  Registers: 64 accumulators, one x fragment of 32 and two W
// fragments of 8 fit the 168 a thread that three warps on one SM
// sub-partition's 16 K registers allow (with more, a block of nine or
// twelve warps cannot launch).
template <int TX, int TY, int MINB>
struct Tile {
  static constexpr int BM = 8 * TY;
  static constexpr int BN = 8 * TX;
  static constexpr int kTY = TY;
  static constexpr int kMinBlocks = MINB;
  static constexpr int kMath = TX * TY;
  static constexpr int kThreads = (kMath + 31) / 32 * 32 + 32;
  static constexpr int kTileA = BM * kBK * 4;
  static constexpr int kTileB = kBK * BN * 4;
  static constexpr int kStage = kTileA + kTileB;
  static constexpr int kSmem = 1024 + kStages * kStage + 2 * kStages * 8;
  static_assert(kTileA % 1024 == 0 && kTileB % 1024 == 0, "stages must stay 1024-byte aligned");
  static_assert(BN <= 256 && BM <= 256, "a TMA box is at most 256 a side");
};

// W row kr of a stage at a thread's eight columns
template <int BN>
__device__ __forceinline__ void load_b(float (&bv)[8], const uint8_t* col, int kr) {
  const float* p = reinterpret_cast<const float*>(col + kr * BN * 4);
  float lo[4], hi[4];
  load4(p, lo);
  load4(p + BN / 2, hi);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bv[j] = lo[j];
    bv[4 + j] = hi[j];
  }
}

// Half a stage: groups gb .. gb + 3 of four k of stage `sc`.  The group
// after them is group gn of stage `sn` (`more`: there is one in this tile).
// x rows ty + TY·i sit at a_row + i·TY·128 of a stage, their 16-byte chunk
// g (k values 4g .. 4g + 3) at (g << 4) ^ swz; `bcol` is this thread's first
// column in W's stage.  A group multiplies from `a` while each next k's W
// fragment loads into the other half of `bw`, and reloads each row of `a`
// for the next group right after that row's last multiply.
template <typename T>
__device__ __forceinline__ void half_stage(float (&acc)[8][8], float (&a)[8][4],
                                           float (&bw)[2][8], const uint8_t* sc, int gb,
                                           const uint8_t* sn, int gn, bool more, uint32_t a_row,
                                           uint32_t swz, uint32_t bcol) {
  const uint8_t* bc = sc + bcol + gb * 4 * T::BN * 4;
  const uint32_t xc = a_row + ((static_cast<uint32_t>(gb) << 4) ^ swz);  // gb is 0 or 4
  const uint8_t* xn = sn + a_row + ((static_cast<uint32_t>(gn) << 4) ^ swz);
#pragma unroll
  for (int gg = 0; gg < 4; ++gg) {
    const bool last = gg == 3;
    const bool next = !last || more;
    // the next group's x rows: chunk gb + gg + 1 == gb | (gg + 1) of this stage, or
    // group gn of sn
    const uint8_t* pa = last ? xn : sc + (xc ^ (static_cast<uint32_t>(gg + 1) << 4));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e < 3) {
        load_b<T::BN>(bw[(e + 1) & 1], bc, gg * 4 + e + 1);
      } else if (next) {
        load_b<T::BN>(bw[0], last ? sn + bcol : bc, last ? gn * 4 : gg * 4 + 4);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(a[i][e], bw[e & 1][c], acc[i][c]);
        if (e == 3 && next) load4(reinterpret_cast<const float*>(pa + i * T::kTY * 128), a[i]);
      }
    }
  }
}

// Persistent blocks walk the output tiles (block b takes tiles b, b + grid,
// ..., columns fastest, so the blocks in flight share x's rows in L2).  The
// producer warp's first lane keeps TMA loads of x and W stages in flight
// through a ring of full and empty mbarriers that runs on across tiles, so
// the next tile's stages arrive while the math threads store this one.  A
// math thread owns rows ty + TY·i (i < 8), all of one residue mod 8, so its
// 16-byte reads of x's swizzled rows (four k values of a row) follow one
// XOR pattern and a warp's rows fall in distinct banks; it owns columns
// tx·4 + j and BN/2 + tx·4 + j, read as 16-byte vectors of W's stage.  k
// runs in half stages of four groups of four k (half_stage).  Each output
// is one fmaf chain over k from 0 in order, then + b, then the activation:
// the arithmetic of sgemm_kernel above, bit for bit (the k past the last
// are zeros both sides, and fmaf(0, 0, acc) == acc for an acc that starts
// at +0).
template <typename T, int ACT>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
sgemm_kernel_tma(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
                 const float* __restrict__ b, float* __restrict__ out, int n, int k, int m) {
  constexpr int TX = T::BN / 8, TY = T::kTY;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = hopper::align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * T::kStage);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int col_tiles = (m + T::BN - 1) / T::BN;
  const int tiles = (n + T::BM - 1) / T::BM * col_tiles;  // < 2^31: the wrapper's rule
  const int nk = (k + kBK - 1) / kBK;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], T::kMath);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  constexpr int kProducer = T::kThreads - 32;
  if (tid >= kProducer) {
    if (tid == kProducer) {
      uint32_t j = 0;  // stages issued, counted across tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int row0 = tile / col_tiles * T::BM;
        const int col0 = tile % col_tiles * T::BN;
        for (int t = 0; t < nk; ++t, ++j) {
          const int st = j % kStages;
          if (j >= kStages) hopper::mbar_wait(&empty[st], (j / kStages - 1) & 1);
          uint8_t* stage = ring + st * T::kStage;
          hopper::mbar_expect_tx(&full[st], T::kStage);
          hopper::tma_load_2d(stage, &tmx, &full[st], t * kBK, row0);
          hopper::tma_load_2d(stage + T::kTileA, &tmw, &full[st], col0, t * kBK);
        }
      }
    }
    return;
  }
  if (tid >= T::kMath) return;  // the idle lanes of a last, partial math warp

  const int tx = tid % TX;
  const int ty = tid / TX;
  const uint32_t a_row = ty * 128;         // x row ty of a stage
  const uint32_t swz = (ty & 7) << 4;      // 16-byte chunk c of row r sits at c ^ (r % 8)
  const uint32_t bcol = T::kTileA + tx * 16;

  uint32_t j0 = 0;  // stages consumed before this tile
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, j0 += nk) {
    const int row0 = tile / col_tiles * T::BM;
    const int col0 = tile % col_tiles * T::BN;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;

    float a[8][4];
    float bw[2][8];
    {
      const uint8_t* s0 = ring + j0 % kStages * T::kStage;
      hopper::mbar_wait(&full[j0 % kStages], (j0 / kStages) & 1);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        load4(reinterpret_cast<const float*>(s0 + a_row + swz + i * TY * 128), a[i]);
      load_b<T::BN>(bw[0], s0 + bcol, 0);
    }
    for (int h = 0; h < 2 * nk; ++h) {
      const uint32_t jc = j0 + h / 2;
      const uint8_t* sc = ring + jc % kStages * T::kStage;
      if ((h & 1) == 0) {
        half_stage<T>(acc, a, bw, sc, 0, sc, 4, true, a_row, swz, bcol);
      } else {
        const bool more = h + 1 < 2 * nk;
        const uint8_t* sn = ring + (jc + 1) % kStages * T::kStage;
        if (more) hopper::mbar_wait(&full[(jc + 1) % kStages], ((jc + 1) / kStages) & 1);
        half_stage<T>(acc, a, bw, sc, 4, sn, 0, more, a_row, swz, bcol);
        hopper::mbar_arrive(&empty[jc % kStages]);  // stage jc read out
      }
    }

    // bias, activation, 16-byte stores (m % 4 == 0: four columns all in or all out)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c = col0 + hh * (T::BN / 2) + tx * 4;
      if (c >= m) continue;
      float bias[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) bias[e] = __ldg(b + c + e);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = row0 + ty + TY * i;
        if (r >= n) continue;
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = activate<ACT>(acc[i][4 * hh + e] + bias[e]);
        store4(out + static_cast<int64_t>(r) * m + c, v);
      }
    }
  }
}

// The shared-memory attribute belongs to the current device's context, so it
// is set on every launch (as tc::launch does): a process that drives several
// cards launches on each.  The grid is the current device's SMs times the
// blocks an SM holds.
template <typename T, int ACT>
cudaError_t launch_tma(const CUtensorMap& tmx, const CUtensorMap& tmw, const float* b, float* out,
                       int n, int k, int m, cudaStream_t stream) {
  const auto kernel = sgemm_kernel_tma<T, ACT>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, T::kThreads, T::kSmem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t tiles = static_cast<int64_t>((n + T::BM - 1) / T::BM) * ((m + T::BN - 1) / T::BN);
  const int64_t slots = static_cast<int64_t>(per_sm) * sms;
  kernel<<<static_cast<int>(tiles < slots ? tiles : slots), T::kThreads, T::kSmem, stream>>>(
      tmx, tmw, b, out, n, k, m);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tile(const float* x, const float* w, const float* b, float* out, int n, int k,
                        int m, int act, cudaStream_t stream) {
  const int64_t tiles = static_cast<int64_t>((n + T::BM - 1) / T::BM) * ((m + T::BN - 1) / T::BN);
  if (tiles >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
  CUtensorMap tmx, tmw;
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(n)};
  const cuuint64_t xstrides[1] = {static_cast<cuuint64_t>(k) * 4};
  const cuuint32_t xbox[2] = {kBK, T::BM};
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(m), static_cast<cuuint64_t>(k)};
  const cuuint64_t wstrides[1] = {static_cast<cuuint64_t>(m) * 4};
  const cuuint32_t wbox[2] = {T::BN, kBK};
  cudaError_t err =
      hopper::encode_f32_map(&tmx, x, 2, xdims, xstrides, xbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = hopper::encode_f32_map(&tmw, w, 2, wdims, wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  if (act == 0) return launch_tma<T, 0>(tmx, tmw, b, out, n, k, m, stream);
  if (act == 1) return launch_tma<T, 1>(tmx, tmw, b, out, n, k, m, stream);
  return launch_tma<T, 2>(tmx, tmw, b, out, n, k, m, stream);
}

// The tiles the wrapper's tile_for picks from, by index (0 is sgemm_kernel):
// 128 x 128, 64 x 128 (two blocks an SM), 128 x 176, 64 x 176
cudaError_t launch_tiled(int tile, const float* x, const float* w, const float* b, float* out,
                         int n, int k, int m, int act, cudaStream_t stream) {
  switch (tile) {
    case 1: return launch_tile<Tile<16, 16, 1>>(x, w, b, out, n, k, m, act, stream);
    case 2: return launch_tile<Tile<16, 8, 2>>(x, w, b, out, n, k, m, act, stream);
    case 3: return launch_tile<Tile<22, 16, 1>>(x, w, b, out, n, k, m, act, stream);
    case 4: return launch_tile<Tile<22, 8, 1>>(x, w, b, out, n, k, m, act, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace simt

// ------------------------------------------------------------ tensor-core route

namespace tc {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;      // one 128-byte swizzle row of bf16
constexpr int kStages = 4;
constexpr int kConsumers = 2;  // warpgroups of 64 output rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBoxBytes = 64 * 64 * 2;
constexpr int kTileA = BM * BK * 2;  // x: [128 rows][64 k]
constexpr int kTileB = BK * BN * 2;  // W: two boxes of [64 k][64 columns]
constexpr int kSmemBytes = 1024 + kStages * (kTileA + kTileB) + 16 * kStages;

template <int ACT>
__global__ void __launch_bounds__(kThreads, 1)
graduate_tc_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                   const __nv_bfloat16* __restrict__ b, __nv_bfloat16* __restrict__ out, int n,
                   int k, int m) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* as = hopper::align_1024(smem_raw);
  uint8_t* bs = as + kStages * kTileA;
  uint64_t* full = reinterpret_cast<uint64_t*>(bs + kStages * kTileB);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int nk = (k + BK - 1) / BK;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], 128 * kConsumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: one thread keeps the ring full
    if (tid == 128 * kConsumers) {
      for (int j = 0; j < nk; ++j) {
        const int st = j % kStages;
        if (j >= kStages) hopper::mbar_wait(&empty[st], (j / kStages - 1) & 1);
        hopper::mbar_expect_tx(&full[st], kTileA + kTileB);
        hopper::tma_load_2d(as + st * kTileA, &tx, &full[st], j * BK, row0);
        hopper::tma_load_2d(bs + st * kTileB, &tw, &full[st], col0, j * BK);
        hopper::tma_load_2d(bs + st * kTileB + kBoxBytes, &tw, &full[st], col0 + 64, j * BK);
      }
    }
    return;
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  for (int j = 0; j < nk; ++j) {
    const int st = j % kStages;
    hopper::mbar_wait(&full[st], (j / kStages) & 1);
    const uint32_t a_addr = hopper::smem_u32(as + st * kTileA + wg * 64 * 128);
    const uint32_t b_addr = hopper::smem_u32(bs + st * kTileB);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      hopper::wgmma_m64n128k16_ss<1>(acc, hopper::desc_sw128(a_addr + kk * 32, 16, 1024),
                                     hopper::desc_sw128(b_addr + kk * 16 * 128, kBoxBytes, 1024),
                                     1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(&empty[st]);
  }

  // epilogue from the accumulator fragments (layout in hopper.cuh)
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int r0 = row0 + 64 * wg + 16 * warp + lane / 4;
#pragma unroll
  for (int jj = 0; jj < BN / 8; ++jj) {
    const int c = col0 + 8 * jj + 2 * (lane % 4);
    if (c >= m) continue;  // m % 8 == 0: a column pair is all in or all out
    const float b0 = __bfloat162float(b[c]), b1 = __bfloat162float(b[c + 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r < n)
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<int64_t>(r) * m + c) =
            __floats2bfloat162_rn(activate<ACT>(acc[4 * jj + 2 * h] + b0),
                                  activate<ACT>(acc[4 * jj + 2 * h + 1] + b1));
    }
  }
}

cudaError_t launch(const void* x, const void* w, const void* b, void* out, int n, int k, int m,
                   int act, cudaStream_t stream) {
  CUtensorMap tx, tw;
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(n)};
  const cuuint64_t xstrides[1] = {static_cast<cuuint64_t>(k) * 2};
  const cuuint32_t xbox[2] = {BK, BM};
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(m), static_cast<cuuint64_t>(k)};
  const cuuint64_t wstrides[1] = {static_cast<cuuint64_t>(m) * 2};
  const cuuint32_t wbox[2] = {64, BK};
  cudaError_t err = hopper::encode_bf16_map(&tx, x, 2, xdims, xstrides, xbox);
  if (err == cudaSuccess) err = hopper::encode_bf16_map(&tw, w, 2, wdims, wstrides, wbox);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BM - 1) / BM, (m + BN - 1) / BN);
  const auto* bp = static_cast<const __nv_bfloat16*>(b);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto kernel = act == 0 ? graduate_tc_kernel<0> : act == 1 ? graduate_tc_kernel<1>
                                                            : graduate_tc_kernel<2>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(tx, tw, bp, op, n, k, m);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// The CUDA-core route.  dtype: 0 = float32, 1 = bfloat16 (x, W, b and out
// share it).  act: 0 = none, 1 = relu, 2 = gelu (tanh).  tile: 0 for
// sgemm_kernel; 1-4 for sgemm_kernel_tma's tiles (launch_tiled), f32 only,
// with k % 4 == 0, m % 4 == 0 and x, W and out 16-byte aligned (TMA's
// rules).  Returns cudaGetLastError(), or the error of encoding a tensor map
// or of sizing the grid.
extern "C" int atlas_fused_graduate(const void* x, const void* w, const void* b, void* out,
                                    int n, int k, int m, int dtype, int act, int tile,
                                    void* stream) {
  if (act < 0 || act > 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile != 0) {
    if (dtype != 0 || k < 1 || k % 4 || m % 4 || reinterpret_cast<uintptr_t>(x) % 16 ||
        reinterpret_cast<uintptr_t>(w) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(simt::launch_tiled(
        tile, static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<float*>(out), n, k, m, act, st));
  }
  if (dtype == 0) {
    simt::launch<float>(x, w, b, out, n, k, m, act, st);
  } else if (dtype == 1) {
    simt::launch<__nv_bfloat16>(x, w, b, out, n, k, m, act, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core route: bfloat16 x [n, k], W [k, m], b [m], out [n, m],
// contiguous, x and W 16-byte aligned, k % 8 == 0 and m % 8 == 0.
// Returns cudaGetLastError(), or the error of encoding a tensor map or of
// setting the shared-memory size.
extern "C" int atlas_fused_graduate_tc(const void* x, const void* w, const void* b, void* out,
                                       int n, int k, int m, int act, void* stream) {
  if (act < 0 || act > 2 || k % 8 || m % 8 || k < 1 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 || reinterpret_cast<uintptr_t>(out) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(tc::launch(x, w, b, out, n, k, m, act, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* atlas_fused_graduate_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
