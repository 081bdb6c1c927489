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
// bytes it moves.  With uniform destinations (about 1.3 edges per segment)
// the output is ~90 % of those bytes and its write stream sets the time; the
// feature rows (8 MB) stay in L2.  A power-law graph holds hub segments of
// thousands to a million edges, whose sums in one fixed order would each be
// one serial chain that outlasts the rest of the card: such segments are cut
// into slabs that run side by side (below).
//
// Two kernels, picked by the wrapper's `route` (kernels/edge_block_spmm.py):
//
// "rows" (segment_rows_kernel, then segment_rows_kernel_slabs): f32 or bf16
// rows with d % 4 == 0, d <= 512, feats and out 16-byte aligned.  A warp
// owns whole output rows; a lane holds NQ quads of the row (4 consecutive
// columns: one float4 of output, one 16-byte f32 or 8-byte bf16 load of
// input; 2 quads at d=256, 1 at d=128), so a segment's offsets and edges
// are read once and each store instruction writes 512 contiguous bytes.
// Pass 1: the warps of a grid sized to the card walk tiles of 16
// consecutive segments; lane i loads the tile's offsets[i] and offsets[i+1]
// (the next tile's are loaded before this tile's rows).  Between long
// segments, a tile's edges are one contiguous run: the warp loads their
// (src, w) 32 at a time, one coalesced load each, broadcasts them with
// __shfl_sync, and issues the row loads of 4 edges before their adds,
// across segment boundaries, so several loads a lane are in flight however
// short the segments are.  An edge's segment is the number of the tile's
// segment ends at or before it (one ballot); the warp stores each finished
// row (and a zero row for each empty segment) as it passes it, with
// streaming stores, so the output stream does not push the feature rows out
// of L2.  A tile whose offsets are out of order or out of range takes the
// general kernel's loop, segment by segment.  Long segments (more than 64
// edges), found from the tiles' first and last offsets, leave pass 1.
// Pass 2 takes those of at most kSlabEdges edges: each is split by quads
// into slices spread over the warps, so segments of different tiles and a
// segment's column halves run side by side; a slice is a serial chain in
// edge order, at most kSlabEdges long.  The chain waits on its row loads,
// not its adds, so its quads come through a per-warp ring in shared memory
// by cp.async, eight edges ahead, and no registers wait on them.  Segments
// of more than kSlabEdges edges are split: pass 1 records each in the
// scratch (integer atomics reserve its slabs' rows) and the second
// launch, segment_rows_kernel_slabs, gives each (slab, 32-quad group) to a
// warp, which sums the slab through the same ring into an f32 partial row.
// The warp that finishes a segment's last slab in its group (an integer
// counter per segment and group) sums the segment's partials in slab order
// and stores the row.
//
// "general" (segment_reduce_kernel): every other width and alignment.  A
// warp owns one segment and a tile of 32*VEC columns; lane i reads VEC
// consecutive values of the source row (16-byte loads for f32, 8-byte for
// bf16), one edge after another.
//
// The order of the sum, the same in both kernels.  A segment is cut into
// slabs of L = kSlabEdges consecutive edges counted from its first edge;
// the last slab holds what remains.  Each slab is summed in f32 in edge
// order from 0 with __fadd_rn(acc, __fmul_rn(w, f)), which the compiler
// never contracts into an FMA; the row is slab 0's partial, then each
// further slab's partial added in slab order.  A segment of at most L edges
// is one slab, so its row is the single chain in edge order from 0 that
// both kernels gave before the slabs existed, bit for bit.  No float
// atomics, one fixed order that depends only on the segment's length (not
// on the grid, the card or the launch), so the two kernels agree bit for
// bit and every run gives the same bits.  Source rows outside [0, n_rows)
// add nothing (the TPU kernel's -1 padding sentinel) but count towards
// their slab, the segment bounds are clamped to [0, m), and an empty
// segment gives a zero row, so no input reads out of bounds.
//
// Scratch (rows route only, when m > L): the wrapper allocates
// atlas_segment_rows_scratch_bytes(m, d) bytes.  The split segments are
// disjoint runs of more than L edges each, so they number at most
// m / (L + 1) and their slabs at most 2m / (L + 1) (a segment of n > L
// edges has ceil(n / L) <= 2n / (L + 1) slabs); the f32 partials take
// 4d * 2m / (L + 1) bytes: 12.4 MiB at m = 13 M, d = 256 (12.6 MiB with
// the records).  Offsets that
// overlap could ask for more: a segment whose slabs do not fit is summed in
// the same slab order by the warp of pass 1 that found it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (repro_torch/kernels/_build.py), loaded by ctypes.

#include <algorithm>
#include <climits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kLanes = 32;         // threads across columns: one warp
constexpr int kRowsPerBlock = 8;   // destination segments per block

// L: a segment is summed in slabs of this many consecutive edges, counted
// from its first edge (the header's order of the sum).  It fixes the bits,
// so it is one constant, the same on every card and launch shape.  Chosen on
// the H100 among 2048 and 4096 (1024 would need 25 MiB of scratch at the
// benchmark's 13 M edges); the wrapper reads it through
// atlas_segment_slab_edges.
constexpr int kSlabEdges = 2048;

// the end of the slab that starts at edge s0 of a segment ending at e1
__host__ __device__ __forceinline__ int slab_end(int s0, int e1) {
  return e1 - s0 > kSlabEdges ? s0 + kSlabEdges : e1;
}

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

  // slab by slab: each from 0 in edge order, added to the row in slab order
  float acc[VEC], tot[VEC];
  const int e0 = max(offsets[seg], 0);
  const int e1 = min(offsets[seg + 1], m);
  for (int s0 = e0, s1 = slab_end(e0, e1);; s0 = s1, s1 = slab_end(s1, e1)) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
    for (int e = s0; e < s1; ++e) {
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
#pragma unroll
    for (int v = 0; v < VEC; ++v) tot[v] = s0 == e0 ? acc[v] : __fadd_rn(tot[v], acc[v]);
    if (s1 >= e1) break;
  }

  float* o = out + static_cast<int64_t>(seg) * d + col;
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(o) = make_float4(tot[0], tot[1], tot[2], tot[3]);
  } else {
    o[0] = tot[0];
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


// ------------------------------------------------------------ "rows" route

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsWarps = 8;  // warps per block
constexpr int kSegTile = 16;   // segments per warp tile, one per lane of the first half

// Chosen on the H100 among tiles of 8/16/32 segments, 1-8 edges in flight
// and 1-6 blocks per SM: 4 edges' rows in flight below d=512 (1 at 512,
// where each edge is 4 loads a lane), and the most blocks per SM that
// keep the row loads out of local memory.
template <int NQ> struct RowsShape {
  static constexpr int kEdgesInFlight = NQ >= 4 ? 1 : 4;
  static constexpr int kMinBlocks = NQ == 1 ? 4 : 3;
};

// Segments longer than this many edges (a power-law hub has thousands in
// one chunk) leave the tiles for pass 2, which spreads them over the warps.
constexpr int kLongEdges = 64;
// Pass 2's cp.async ring: edges a group, groups in flight (one more group
// of slots is being read).  Chosen on the H100 among groups of 1 edge (4
// to 10 in flight) and 2 x 3, 2 x 5, 4 x 1 and 4 x 2: 4 x 2 halves a
// hub's chain against 4 edges' loads held in registers, and fills the
// 48 KB of static shared memory at f32 (8 warps x 12 slots x 512 bytes).
constexpr int kHubBatch = 4;
constexpr int kHubGroups = 2;
static_assert(32 % kHubBatch == 0 && kHubGroups * kHubBatch <= 32,
              "a group is fetched from this window of indices or the next");

__device__ __forceinline__ bool is_long(int lo, int hi, int m) {
  return 0 <= lo && lo <= hi && hi <= m && hi - lo > kLongEdges;
}

// whether the edges from lo to hi number more than kLongEdges (for a tile:
// its first and last offsets); a segment is left to pass 2 only in such a
// tile, so both passes decide it from the same two offsets
__device__ __forceinline__ bool wide(int lo, int hi) {
  return static_cast<int64_t>(hi) - lo > kLongEdges;
}

// A lane works on quads: 4 consecutive columns, one float4 of the output
// (so each store instruction of the warp writes 512 contiguous bytes), read
// from feats as one 16-byte (f32) or 8-byte (bf16) load.
template <typename T> struct Quad;
template <> struct Quad<float> {
  using Raw = uint4;
  __device__ __forceinline__ static Raw load(const float* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ static Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ static void unpack(const Raw& r, float (&f)[4]) {
    f[0] = __uint_as_float(r.x); f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z); f[3] = __uint_as_float(r.w);
  }
};
template <> struct Quad<__nv_bfloat16> {
  using Raw = uint2;
  __device__ __forceinline__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ static Raw zero() { return make_uint2(0u, 0u); }
  // a bf16 is the high half of the f32 of the same value (what
  // __bfloat162float computes)
  __device__ __forceinline__ static void unpack(const Raw& r, float (&f)[4]) {
    f[0] = __uint_as_float(r.x << 16); f[1] = __uint_as_float(r.x & 0xffff0000u);
    f[2] = __uint_as_float(r.y << 16); f[3] = __uint_as_float(r.y & 0xffff0000u);
  }
};

// this lane's quads of one row: quad lane + 32 q, q < NQ
template <typename T, int NQ>
__device__ __forceinline__ void load_row(const T* row, int lane, int quads, bool live,
                                         typename Quad<T>::Raw (&raw)[NQ]) {
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int g = lane + 32 * q;
    raw[q] = live && g < quads ? Quad<T>::load(row + 4 * g) : Quad<T>::zero();
  }
}

template <typename T, int NQ>
__device__ __forceinline__ void accumulate(float (&acc)[NQ * 4],
                                           const typename Quad<T>::Raw (&raw)[NQ], float wv) {
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    float f[4];
    Quad<T>::unpack(raw[q], f);
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[4 * q + v] = __fadd_rn(acc[4 * q + v], __fmul_rn(wv, f[v]));
  }
}

// Pass 2's and the slabs' cp.async ring: a warp's slots in shared memory
template <typename T>
using Ring = typename Quad<T>::Raw[(kHubGroups + 1) * kHubBatch][32];

// the indices of the 32 edges from `base` (-1 past e1)
__device__ __forceinline__ void edge_window(const int32_t* __restrict__ src,
                                            const float* __restrict__ w, int lane, int base,
                                            int e1, int& ws, float& ww) {
  ws = -1;
  ww = 0.0f;
  if (base + lane < e1) {
    ws = __ldg(src + base + lane);
    ww = __ldg(w + base + lane);
  }
}

// this lane's quad g of the sum over the edges [e0, e1): one serial chain
// in edge order from 0.  Its quads come through the warp's ring in shared
// memory by cp.async, kHubBatch edges a group and kHubGroups groups in
// flight, so no registers wait on them; the indices of the next 32 edges
// are on the way too.
template <typename T>
__device__ __forceinline__ void chain_sum(const T* __restrict__ feats,
                                          const int32_t* __restrict__ src,
                                          const float* __restrict__ w, Ring<T>& ring, int lane,
                                          int e0, int e1, int g, int quads, int n_rows, int d,
                                          float (&sum)[4]) {
  using Raw = typename Quad<T>::Raw;
  constexpr int B = kHubBatch, G = kHubGroups;
  const bool col = g < quads;
  // source row s's quad into ring slot i (zeros for a row outside [0, n))
  auto fetch = [&](int i, int s) {
    const bool live = s >= 0 && s < n_rows && col;
    hopper::cp_async<sizeof(Raw)>(&ring[i][lane],
                                  live ? feats + static_cast<int64_t>(s) * d + 4 * g : feats,
                                  live ? static_cast<int>(sizeof(Raw)) : 0);
  };
#pragma unroll
  for (int v = 0; v < 4; ++v) sum[v] = 0.0f;
  int my_s, nx_s;
  float my_w, nx_w;
  edge_window(src, w, lane, e0, e1, my_s, my_w);
  edge_window(src, w, lane, e0 + 32, e1, nx_s, nx_w);
#pragma unroll
  for (int q = 0; q < G; ++q) {
#pragma unroll
    for (int u = 0; u < B; ++u) fetch(q * B + u, __shfl_sync(kFull, my_s, q * B + u));
    hopper::cp_async_commit();
  }
  int cg = 0;  // the group consumed next; the one before it (read last step) is refilled
  for (int base = e0; base < e1; base += 32) {  // edges past e1 hold -1: no adds
#pragma unroll
    for (int k = 0; k < 32; k += B) {
      int sv[B], nv[B];
      float wv[B];
#pragma unroll
      for (int u = 0; u < B; ++u) {
        sv[u] = __shfl_sync(kFull, my_s, k + u);
        wv[u] = __shfl_sync(kFull, my_w, k + u);
        const int j = k + G * B + u;  // the edge fetched now, G groups ahead
        nv[u] = j < 32 ? __shfl_sync(kFull, my_s, j) : __shfl_sync(kFull, nx_s, j - 32);
      }
      hopper::cp_async_wait<G - 1>();
      Raw cur[B];
#pragma unroll
      for (int u = 0; u < B; ++u) cur[u] = ring[cg * B + u][lane];
      const int refill = cg == 0 ? G : cg - 1;
#pragma unroll
      for (int u = 0; u < B; ++u) fetch(refill * B + u, nv[u]);
      hopper::cp_async_commit();
      cg = cg == G ? 0 : cg + 1;
#pragma unroll
      for (int u = 0; u < B; ++u) {
        if (sv[u] < 0 || sv[u] >= n_rows) continue;
        float f[4];
        Quad<T>::unpack(cur[u], f);
#pragma unroll
        for (int v = 0; v < 4; ++v) sum[v] = __fadd_rn(sum[v], __fmul_rn(wv[u], f[v]));
      }
    }
    my_s = nx_s;
    my_w = nx_w;
    edge_window(src, w, lane, base + 64, e1, nx_s, nx_w);
  }
  hopper::cp_async_wait<0>();  // the ring is idle before the next chain
}

// ------------------------------------------------ the split of long segments

// The scratch of the split, laid out from m and d alone by slab_layout: at
// most max_segs segments of more than kSlabEdges edges (disjoint runs of
// edges: m / (L + 1)) and max_slabs slabs (2m / (L + 1)).
struct Slabs {
  int* ctl;        // [0] segments recorded, [1] slab rows reserved: 0 before pass 1
  int4* seg;       // [max_segs] (row, first edge, end edge, first slab row)
  int4* done;      // [max_segs] slabs finished, one counter per 32-quad group (d <= 512: 4)
  int* owner;      // [max_slabs] the record of each slab row
  float* partial;  // [max_slabs][d] each slab's sum, f32
  int max_segs, max_slabs;
};

// the bytes of the scratch for m edges of d columns, and, given its base,
// where each part lies (all 16-byte aligned); 0 bytes when m <= kSlabEdges
int64_t slab_layout(int m, int d, void* base, Slabs& sl) {
  sl = Slabs{};
  if (m <= kSlabEdges) return 0;
  const int64_t segs = m / (kSlabEdges + 1);
  const int64_t slabs = 2 * static_cast<int64_t>(m) / (kSlabEdges + 1);
  const int64_t at_seg = 16, at_done = at_seg + 16 * segs, at_owner = at_done + 16 * segs;
  const int64_t at_partial = at_owner + (4 * slabs + 15) / 16 * 16;
  char* b = static_cast<char*>(base);
  if (b != nullptr) {
    sl.ctl = reinterpret_cast<int*>(b);
    sl.seg = reinterpret_cast<int4*>(b + at_seg);
    sl.done = reinterpret_cast<int4*>(b + at_done);
    sl.owner = reinterpret_cast<int*>(b + at_owner);
    sl.partial = reinterpret_cast<float*>(b + at_partial);
    sl.max_segs = static_cast<int>(segs);
    sl.max_slabs = static_cast<int>(slabs);
  }
  return at_partial + 4 * static_cast<int64_t>(d) * slabs;
}

// the slabs of a segment of n edges
__device__ __forceinline__ int slab_count(int n) { return (n - 1) / kSlabEdges + 1; }

template <typename T, int NQ>
__global__ void __launch_bounds__(32 * kRowsWarps, RowsShape<NQ>::kMinBlocks)
segment_rows_kernel(const T* __restrict__ feats, const int32_t* __restrict__ src,
                    const float* __restrict__ w, const int32_t* __restrict__ offsets,
                    float* __restrict__ out, Slabs sl, unsigned long long* __restrict__ split,
                    int num_seg, int n_rows, int m, int d) {
  using Raw = typename Quad<T>::Raw;
  constexpr int kU = RowsShape<NQ>::kEdgesInFlight;
  const int lane = threadIdx.x & 31;
  const int quads = d / 4;
  const int tiles = (num_seg + kSegTile - 1) / kSegTile;
  const int num_warps = gridDim.x * kRowsWarps;

  float acc[NQ * 4];
#pragma unroll
  for (int i = 0; i < NQ * 4; ++i) acc[i] = 0.0f;

  // write the finished row `seg` (streaming: past L2's resident rows) and
  // start the next one from 0
  auto store_row = [&](int seg) {
    float* o = out + static_cast<int64_t>(seg) * d;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int g = lane + 32 * q;
      if (g < quads) {
        __stcs(reinterpret_cast<float4*>(o + 4 * g),
               make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]));
      }
    }
#pragma unroll
    for (int i = 0; i < NQ * 4; ++i) acc[i] = 0.0f;
  };

  // this lane's segment bounds in tile t, as stored (0, 0 past the end)
  auto load_bounds = [&](int t, int& lo, int& hi) {
    const int s = t * kSegTile + lane;
    lo = hi = 0;
    if (t < tiles && lane < kSegTile && s < num_seg) {
      lo = __ldg(offsets + s);
      hi = __ldg(offsets + s + 1);
    }
  };

  // reduce the edges [e0, e1) of the tile's segments from `cur` on, in
  // order, storing each row as the run passes its end; acc is left holding
  // the sum of the segment the run ends in
  auto run = [&](int e0, int e1, int end, int s0, int& cur) {
    for (int base = e0; base < e1; base += 32) {
      const int cnt = min(32, e1 - base);
      int my_s = -1;
      float my_w = 0.0f;
      if (lane < cnt) {
        my_s = __ldg(src + base + lane);
        my_w = __ldg(w + base + lane);
      }
      for (int k = 0; k < cnt; k += kU) {
        Raw raw[kU][NQ];
        int sv[kU];
        float wv[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {  // lanes >= cnt hold -1: no load
          sv[u] = __shfl_sync(kFull, my_s, k + u);
          wv[u] = __shfl_sync(kFull, my_w, k + u);
          const bool live = sv[u] >= 0 && sv[u] < n_rows;
          load_row<T, NQ>(feats + static_cast<int64_t>(live ? sv[u] : 0) * d, lane, quads,
                          live, raw[u]);
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          if (k + u >= cnt) break;
          const int seg = __popc(__ballot_sync(kFull, end <= base + k + u));
          while (cur < seg) store_row(s0 + cur++);
          if (sv[u] >= 0 && sv[u] < n_rows) accumulate<T, NQ>(acc, raw[u], wv[u]);
        }
      }
    }
  };

  // the edges [e0, e1) into acc, one after another
  auto chain = [&](int e0, int e1) {
    for (int e = e0; e < e1; ++e) {
      const int s = __ldg(src + e);
      if (s < 0 || s >= n_rows) continue;
      Raw raw[NQ];
      load_row<T, NQ>(feats + static_cast<int64_t>(s) * d, lane, quads, true, raw);
      accumulate<T, NQ>(acc, raw, __ldg(w + e));
    }
  };

  // row `seg` over the edges [e0, e1), one edge after another in slab
  // order (the general kernel's loop): slab 0's sum is stored, and each
  // further slab's added to the stored row (a path for inputs with offsets
  // out of order, so it keeps no second sum in registers)
  auto serial_row = [&](int seg, int e0, int e1) {
    int s1 = slab_end(e0, e1);
    chain(e0, s1);
    store_row(seg);
    while (s1 < e1) {
      const int s0 = s1;
      s1 = slab_end(s0, e1);
      chain(s0, s1);
      float* o = out + static_cast<int64_t>(seg) * d;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int g = lane + 32 * q;
        if (g < quads) {
          float4 t = *reinterpret_cast<const float4*>(o + 4 * g);
          t = make_float4(__fadd_rn(t.x, acc[4 * q]), __fadd_rn(t.y, acc[4 * q + 1]),
                          __fadd_rn(t.z, acc[4 * q + 2]), __fadd_rn(t.w, acc[4 * q + 3]));
          *reinterpret_cast<float4*>(o + 4 * g) = t;
        }
      }
#pragma unroll
      for (int i = 0; i < NQ * 4; ++i) acc[i] = 0.0f;
    }
  };

  // hand row `seg`, the edges [lo, hi) (more than kSlabEdges, 0 <= lo <=
  // hi <= m), to the second launch: reserve its slab rows, record it with
  // its counters at 0, name it the owner of each slab row, and count it;
  // false when the scratch has no room for it (offsets that overlap)
  auto record = [&](int seg, int lo, int hi) {
    const int n = slab_count(hi - lo);
    int rec = 0, first = -1;
    if (lane == 0 && sl.max_segs > 0) {
      rec = atomicAdd(sl.ctl, 1);
      if (rec < sl.max_segs) {
        for (int cur = atomicAdd(sl.ctl + 1, 0); cur <= sl.max_slabs - n;) {
          const int was = atomicCAS(sl.ctl + 1, cur, cur + n);
          if (was == cur) {
            first = cur;
            break;
          }
          cur = was;
        }
      }
      if (first >= 0) {
        sl.seg[rec] = make_int4(seg, lo, hi, first);
        sl.done[rec] = make_int4(0, 0, 0, 0);
        atomicAdd(split, 1ull);
        atomicAdd(split + 1, static_cast<unsigned long long>(n));
      }
    }
    first = __shfl_sync(kFull, first, 0);
    rec = __shfl_sync(kFull, rec, 0);
    if (first < 0) return false;
    for (int k = lane; k < n; k += 32) sl.owner[first + k] = rec;
    return true;
  };

  // Pass 2 takes the long segments of at most kSlabEdges edges of the
  // tiles whose edges span more than kLongEdges (only such a tile can hold
  // one), each in NQ slices of one quad a lane: item t = h * tiles + k
  // (quads 32h.. of tile k's long segments) goes to warp t % num_warps, so
  // a segment's slices and segments of different tiles run on different
  // warps.  A lane's first item's span is loaded here, in flight during
  // pass 1.
  const int64_t items = static_cast<int64_t>(tiles) * NQ;
  const int warp = blockIdx.x * kRowsWarps + (threadIdx.x >> 5);
  auto item_span = [&](int64_t t0, int& lo, int& hi) {
    const int64_t t = t0 + static_cast<int64_t>(lane) * num_warps;
    lo = hi = 0;
    if (t < items) {
      const int s0 = static_cast<int>(t % tiles) * kSegTile;
      lo = __ldg(offsets + s0);
      hi = __ldg(offsets + min(s0 + kSegTile, num_seg));
    }
  };
  int la, lb;
  item_span(warp, la, lb);

  // pass 1: tiles of kSegTile segments, long segments left to pass 2 or,
  // past kSlabEdges edges, to the second launch
  int tile = warp;
  int a, b;
  load_bounds(tile, a, b);
  for (; tile < tiles; tile += num_warps) {
    int next_a, next_b;
    load_bounds(tile + num_warps, next_a, next_b);  // in flight during this tile
    const int s0 = tile * kSegTile;
    const int nseg = min(kSegTile, num_seg - s0);
    const bool spans_long = wide(__shfl_sync(kFull, a, 0), __shfl_sync(kFull, b, nseg - 1));
    const unsigned longs =
        __ballot_sync(kFull, lane < nseg && is_long(a, b, m)) & (spans_long ? kFull : 0u);
    const bool ordered = __all_sync(kFull, lane >= nseg || (0 <= a && a <= b && b <= m));
    const unsigned splits =
        longs & __ballot_sync(kFull, static_cast<int64_t>(b) - a > kSlabEdges);
    for (unsigned rest = splits; rest; rest &= rest - 1) {
      const int l = __ffs(rest) - 1;
      const int lo = __shfl_sync(kFull, a, l), hi = __shfl_sync(kFull, b, l);
      if (!record(s0 + l, lo, hi)) serial_row(s0 + l, lo, hi);
    }
    if (ordered) {
      // between two long segments the tile's edges are one run; edge e
      // belongs to the tile's segment counting the ends <= e
      const int end = lane < nseg ? b : INT_MAX;
      for (int j = 0; j < nseg;) {
        const unsigned rest = longs >> j;
        const int stop = rest ? j + __ffs(rest) - 1 : nseg;  // the next long segment
        if (stop > j) {
          int cur = j;
          run(__shfl_sync(kFull, a, j), __shfl_sync(kFull, b, stop - 1), end, s0, cur);
          while (cur < stop) store_row(s0 + cur++);
        }
        j = stop + 1;
      }
    } else {
      // offsets out of order or out of range: the general kernel's loop
      for (int j = 0; j < nseg; ++j) {
        if ((longs >> j) & 1u) continue;
        serial_row(s0 + j, max(__shfl_sync(kFull, a, j), 0), min(__shfl_sync(kFull, b, j), m));
      }
    }
    a = next_a;
    b = next_b;
  }

  // pass 2: each slice is one serial chain in edge order through this
  // warp's ring
  __shared__ __align__(16) Ring<T> hub_ring[kRowsWarps];
  Ring<T>& ring = hub_ring[threadIdx.x >> 5];
  for (int64_t t0 = warp; t0 < items; t0 += 32LL * num_warps) {
    if (t0 != warp) item_span(t0, la, lb);
    const bool mine_wide = t0 + static_cast<int64_t>(lane) * num_warps < items && wide(la, lb);
    for (unsigned mine = __ballot_sync(kFull, mine_wide); mine; mine &= mine - 1) {
      const int64_t t = t0 + static_cast<int64_t>(__ffs(mine) - 1) * num_warps;
      const int s0 = static_cast<int>(t % tiles) * kSegTile;
      const int nseg = min(kSegTile, num_seg - s0);
      int a2 = 0, b2 = 0;
      if (lane < nseg) {
        a2 = __ldg(offsets + s0 + lane);
        b2 = __ldg(offsets + s0 + lane + 1);
      }
      for (unsigned longs = __ballot_sync(
               kFull, lane < nseg && is_long(a2, b2, m) && b2 - a2 <= kSlabEdges);
           longs; longs &= longs - 1) {
        const int l = __ffs(longs) - 1;
        const int g = 32 * static_cast<int>(t / tiles) + lane;
        float sum[4];
        chain_sum<T>(feats, src, w, ring, lane, __shfl_sync(kFull, a2, l),
                     __shfl_sync(kFull, b2, l), g, quads, n_rows, d, sum);
        if (g < quads) {
          __stcs(reinterpret_cast<float4*>(out + static_cast<int64_t>(s0 + l) * d + 4 * g),
                 make_float4(sum[0], sum[1], sum[2], sum[3]));
        }
      }
    }
  }
}

// The rows route's second launch: the slabs of the segments pass 1
// recorded.  Item t = h * slabs + i (slab row i, quads 32h..) goes to warp
// t % num_warps, so a segment's slabs run side by side on as many warps.  A
// warp sums its slab through its ring into partial row i; the warp that
// finishes a segment's last slab of group h (the record's integer counter)
// sums the segment's partials of that group in slab order, from slab 0's,
// and stores the row.
template <typename T>
__global__ void __launch_bounds__(32 * kRowsWarps)
segment_rows_kernel_slabs(const T* __restrict__ feats, const int32_t* __restrict__ src,
                          const float* __restrict__ w, float* __restrict__ out, Slabs sl,
                          int n_rows, int d) {
  __shared__ __align__(16) Ring<T> hub_ring[kRowsWarps];
  Ring<T>& ring = hub_ring[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const int quads = d / 4;
  const int slabs = sl.ctl[1];
  const int64_t items = static_cast<int64_t>(slabs) * ((quads + 31) / 32);
  const int64_t num_warps = static_cast<int64_t>(gridDim.x) * kRowsWarps;
  for (int64_t t = blockIdx.x * kRowsWarps + (threadIdx.x >> 5); t < items; t += num_warps) {
    const int i = static_cast<int>(t % slabs);
    const int h = static_cast<int>(t / slabs);
    const int rec = sl.owner[i];
    const int4 r = sl.seg[rec];  // (row, first edge, end edge, first slab row)
    const int e0 = r.y + (i - r.w) * kSlabEdges;
    const int g = 32 * h + lane;
    float sum[4];
    chain_sum<T>(feats, src, w, ring, lane, e0, slab_end(e0, r.z), g, quads, n_rows, d, sum);
    float4* part = reinterpret_cast<float4*>(sl.partial) + g;  // quad g of partial row 0
    const int64_t row = d / 4;                                  // float4s a partial row
    if (g < quads) __stcg(part + i * row, make_float4(sum[0], sum[1], sum[2], sum[3]));
    __threadfence();
    __syncwarp();
    int done = 0;
    if (lane == 0) done = atomicAdd(reinterpret_cast<int*>(sl.done + rec) + h, 1) + 1;
    const int n = slab_count(r.z - r.y);
    if (__shfl_sync(kFull, done, 0) == n) {  // every slab of group h is in
      __threadfence();
      if (g < quads) {  // the row: slab 0's partial, then the others in slab order
        const float4* p = part + r.w * row;
        float4 tot = __ldcg(p);
#pragma unroll 8
        for (int k = 1; k < n; ++k) {
          const float4 q = __ldcg(p + k * row);
          tot = make_float4(__fadd_rn(tot.x, q.x), __fadd_rn(tot.y, q.y),
                            __fadd_rn(tot.z, q.z), __fadd_rn(tot.w, q.w));
        }
        __stcs(reinterpret_cast<float4*>(out + static_cast<int64_t>(r.x) * d + 4 * g), tot);
      }
    }
  }
}

// the grid: one warp per tile, at most the blocks the card holds at once
template <typename T, int NQ>
int rows_grid(int num_seg) {
  static const int max_blocks = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, segment_rows_kernel<T, NQ>,
                                                  32 * kRowsWarps, 0);
    return sms * std::max(per_sm, 1);
  }();
  const int tiles = (num_seg + kSegTile - 1) / kSegTile;
  return std::min((tiles + kRowsWarps - 1) / kRowsWarps, max_blocks);
}

// the second launch's grid: one warp per (slab, 32-quad group) the scratch
// holds, at most the blocks the card holds at once
template <typename T>
int slabs_grid(int max_slabs, int d) {
  static const int max_blocks = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, segment_rows_kernel_slabs<T>,
                                                  32 * kRowsWarps, 0);
    return sms * std::max(per_sm, 1);
  }();
  const int64_t items = static_cast<int64_t>(max_slabs) * ((d / 4 + 31) / 32);
  return static_cast<int>(std::min<int64_t>((items + kRowsWarps - 1) / kRowsWarps, max_blocks));
}

template <typename T, int NQ>
int launch_rows_nq(const void* feats, const void* src, const void* w, const void* offsets,
                   void* out, void* scratch, void* split, int num_seg, int n_rows, int m, int d,
                   cudaStream_t stream) {
  Slabs sl;
  slab_layout(m, d, scratch, sl);
  if (sl.max_segs > 0) {
    const cudaError_t rc = cudaMemsetAsync(sl.ctl, 0, 2 * sizeof(int), stream);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const T* f = static_cast<const T*>(feats);
  const int32_t* s = static_cast<const int32_t*>(src);
  const float* wv = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  segment_rows_kernel<T, NQ><<<rows_grid<T, NQ>(num_seg), 32 * kRowsWarps, 0, stream>>>(
      f, s, wv, static_cast<const int32_t*>(offsets), o, sl,
      static_cast<unsigned long long*>(split), num_seg, n_rows, m, d);
  if (sl.max_segs > 0) {
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
    segment_rows_kernel_slabs<T><<<slabs_grid<T>(sl.max_slabs, d), 32 * kRowsWarps, 0,
                                   stream>>>(f, s, wv, o, sl, n_rows, d);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rows(const void* feats, const void* src, const void* w, const void* offsets,
                void* out, void* scratch, void* split, int num_seg, int n_rows, int m, int d,
                cudaStream_t stream) {
  if (d <= 0 || d % 4 != 0 || d > 512) return static_cast<int>(cudaErrorInvalidValue);
  if (d <= 128) {
    return launch_rows_nq<T, 1>(feats, src, w, offsets, out, scratch, split, num_seg, n_rows,
                                m, d, stream);
  }
  if (d <= 256) {
    return launch_rows_nq<T, 2>(feats, src, w, offsets, out, scratch, split, num_seg, n_rows,
                                m, d, stream);
  }
  return launch_rows_nq<T, 4>(feats, src, w, offsets, out, scratch, split, num_seg, n_rows, m,
                              d, stream);
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

// The "rows" route: f32 or bf16 with d % 4 == 0, d <= 512,
// feats and out 16-byte aligned (the wrapper's route() checks all three).
// scratch: atlas_segment_rows_scratch_bytes(m, d) bytes, 16-byte aligned
// (null when that is 0), used by no other launch until this one's end;
// split: two uint64 counters, segments split and slabs summed, that the
// launch adds to.
extern "C" int atlas_segment_rows(const void* feats, int feats_dtype, const void* src,
                                  const void* w, const void* offsets, void* out, void* scratch,
                                  void* split, int num_seg, int n_rows, int m, int d,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (feats_dtype == 0) {
    return launch_rows<float>(feats, src, w, offsets, out, scratch, split, num_seg, n_rows, m,
                              d, st);
  }
  if (feats_dtype == 1) {
    return launch_rows<__nv_bfloat16>(feats, src, w, offsets, out, scratch, split, num_seg,
                                      n_rows, m, d, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The rows route's scratch for m edges of d columns, from the host alone.
extern "C" long long atlas_segment_rows_scratch_bytes(int m, int d) {
  Slabs sl;
  return slab_layout(m, d, nullptr, sl);
}

// L, the edges of a slab: the order of the sum in both kernels.
extern "C" int atlas_segment_slab_edges() { return kSlabEdges; }

extern "C" const char* atlas_edge_block_spmm_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
