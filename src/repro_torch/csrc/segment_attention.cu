// GAT's attention aggregation as deterministic segmented reductions (Hopper).
//
// Port-only: the JAX package has no attention-weighted aggregation.  For one
// GAT layer (Velickovic et al., ICLR 2018) with H heads of F features, the
// projected rows z (z_v^h = x_v W^h, computed by K2 beforehand) and the edges
// grouped by destination segment, four kernels:
//
//   segment_attention_scores_kernel   s_v^h = <a_src^h, z_v^h>, t_v^h = <a_dst^h, z_v^h>
//   segment_attention_kernel          per (segment slab, head): the slab's max
//                                     m = max_e LeakyReLU(t_seg^h + s_src^h), then
//                                     N = sum_e exp(e - m) z_src^h and
//                                     D = sum_e exp(e - m)
//   segment_attention_combine_kernel  a segment cut into slabs: its slabs'
//                                     (m, N, D) rescaled to the largest m and
//                                     added in slab order
//   segment_attention_normalize_kernel  per destination: the rows that carry
//                                     its (m, N, D) (one per source shard of
//                                     the mesh) rescaled and added in row
//                                     order, y = N / D, then + bias (+ skip),
//                                     ELU or the mean over heads
//
// The softmax is exact per destination over all its in-edges, however they
// are split: every partial carries its own max m, and partials meet by the
// flash-attention rescale exp(m_i - max_j m_j), so no partial waits for a max
// computed elsewhere.  A partial with no edge carries m = kEmpty, N = D = 0;
// a destination with D = 0 gets y = 0.
//
// The order of every sum is fixed, so each run gives the same bits (no float
// atomics): a segment is cut into slabs of L = kSlabEdges consecutive edges
// from its first (K1's L and K1's rule, csrc/edge_block_spmm.cu), each slab
// sums in edge order from 0 with __fadd_rn(acc, __fmul_rn(w, z)), and the
// slabs meet in slab order; the dots of the scores sum each lane's columns in
// order, then the lanes by a fixed xor tree.  Which slab goes to which warp
// is the host's table (kernels/segment_attention.py: (segment, first edge,
// end edge, partial row or -1) per slab), so the table and the rows alone fix
// the bits, never the grid or the card.
//
// What bounds it: memory.  Per edge and head the aggregation reads one F-wide
// slice of a random source row (1 KB at F = 256): the gather of z, as in K1.
// A warp owns one (slab, head); lane i holds quads i + 32 q (four
// consecutive columns, one 16-byte load), and kInFlight edges' loads are
// issued before their adds.  Scores and normalisation stream rows once.
//
// Rows must hold whole quads: F % 4 == 0, row strides % 4 == 0, pointers
// 16-byte aligned, F <= 512 (the wrapper checks).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (repro_torch/kernels/_build.py), loaded by ctypes.

#include <algorithm>

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;           // warps per block
constexpr int kSlabEdges = 2048;    // L: K1's slab (csrc/edge_block_spmm.cu kSlabEdges)
constexpr int kInFlight = 4;        // edges whose row loads are issued before their adds
constexpr float kEmpty = -1e30f;    // the max of a partial with no edge: exp(kEmpty - m) == 0

__device__ __forceinline__ float leaky(float x, float slope) {
  return x > 0.0f ? x : __fmul_rn(slope, x);
}

__device__ __forceinline__ float4 load_quad(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ void axpy(float (&acc)[4], float w, const float4& f) {
  acc[0] = __fadd_rn(acc[0], __fmul_rn(w, f.x));
  acc[1] = __fadd_rn(acc[1], __fmul_rn(w, f.y));
  acc[2] = __fadd_rn(acc[2], __fmul_rn(w, f.z));
  acc[3] = __fadd_rn(acc[3], __fmul_rn(w, f.w));
}

// ------------------------------------------------------------------ scores

// a warp per vertex: for each head its two dots with the attention vectors
__global__ void __launch_bounds__(32 * kWarps)
segment_attention_scores_kernel(const float* __restrict__ z, int64_t ldz,
                                const float* __restrict__ a_src, const float* __restrict__ a_dst,
                                float* __restrict__ s, float* __restrict__ t, int n, int heads,
                                int f) {
  const int lane = threadIdx.x & 31;
  const int quads = f / 4;
  const int64_t v = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (v >= n) return;
  const float* row = z + v * ldz;
  for (int h = 0; h < heads; ++h) {
    float ps = 0.0f, pt = 0.0f;
    for (int g = lane; g < quads; g += 32) {
      const float4 x = load_quad(row + h * f + 4 * g);
      const float4 as = load_quad(a_src + h * f + 4 * g);
      const float4 ad = load_quad(a_dst + h * f + 4 * g);
      ps = __fadd_rn(ps, __fmul_rn(x.x, as.x));
      ps = __fadd_rn(ps, __fmul_rn(x.y, as.y));
      ps = __fadd_rn(ps, __fmul_rn(x.z, as.z));
      ps = __fadd_rn(ps, __fmul_rn(x.w, as.w));
      pt = __fadd_rn(pt, __fmul_rn(x.x, ad.x));
      pt = __fadd_rn(pt, __fmul_rn(x.y, ad.y));
      pt = __fadd_rn(pt, __fmul_rn(x.z, ad.z));
      pt = __fadd_rn(pt, __fmul_rn(x.w, ad.w));
    }
    ps = warp_sum(ps);
    pt = warp_sum(pt);
    if (lane == 0) {
      s[v * heads + h] = ps;
      t[v * heads + h] = pt;
    }
  }
}

// ------------------------------------------------------------- aggregation

// a warp per (slab, head), item = slab * heads + head
template <int NQ>
__global__ void __launch_bounds__(32 * kWarps)
segment_attention_kernel(const float* __restrict__ z, int64_t ldz, const float* __restrict__ s,
                         const float* __restrict__ t_seg, const int32_t* __restrict__ src,
                         const int4* __restrict__ slabs, int64_t items, int heads, int f,
                         int n_rows, float slope, float* __restrict__ num,
                         float* __restrict__ den, float* __restrict__ mx,
                         float* __restrict__ pnum, float* __restrict__ pden,
                         float* __restrict__ pmx) {
  const int lane = threadIdx.x & 31;
  const int quads = f / 4;
  const int64_t hf = static_cast<int64_t>(heads) * f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t item = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       item < items; item += stride) {
    const int64_t k = item / heads;
    const int h = static_cast<int>(item - k * heads);
    const int4 slab = slabs[k];  // (segment, first edge, end edge, partial row or -1)
    const float th = t_seg[static_cast<int64_t>(slab.x) * heads + h];

    // the slab's max logit (exact in any order)
    float m = kEmpty;
    for (int e = slab.y + lane; e < slab.z; e += 32) {
      const int u = __ldg(src + e);
      if (u >= 0 && u < n_rows) {
        m = fmaxf(m, leaky(__fadd_rn(th, __ldg(s + static_cast<int64_t>(u) * heads + h)), slope));
      }
    }
    m = warp_max(m);

    // the weighted sum and the denominator, in edge order from 0
    float acc[NQ][4];
#pragma unroll
    for (int q = 0; q < NQ; ++q) acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.0f;
    float dsum = 0.0f;
    for (int base = slab.y; base < slab.z; base += 32) {
      const int cnt = min(32, slab.z - base);
      int my_u = -1;
      float my_w = 0.0f;
      if (lane < cnt) {
        const int u = __ldg(src + base + lane);
        if (u >= 0 && u < n_rows) {
          my_u = u;
          const float e =
              leaky(__fadd_rn(th, __ldg(s + static_cast<int64_t>(u) * heads + h)), slope);
          my_w = expf(__fsub_rn(e, m));
        }
      }
      for (int j = 0; j < cnt; j += kInFlight) {
        float4 raw[kInFlight][NQ];
        float wv[kInFlight];
        bool live[kInFlight];
#pragma unroll
        for (int i = 0; i < kInFlight; ++i) {
          const int uu = __shfl_sync(kFull, my_u, (j + i) & 31);
          wv[i] = __shfl_sync(kFull, my_w, (j + i) & 31);
          live[i] = j + i < cnt && uu >= 0;
          const float* row = z + static_cast<int64_t>(live[i] ? uu : 0) * ldz + h * f;
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            const int g = lane + 32 * q;
            raw[i][q] = live[i] && g < quads ? load_quad(row + 4 * g)
                                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          }
        }
#pragma unroll
        for (int i = 0; i < kInFlight; ++i) {
          if (!live[i]) continue;
          dsum = __fadd_rn(dsum, wv[i]);
#pragma unroll
          for (int q = 0; q < NQ; ++q) axpy(acc[q], wv[i], raw[i][q]);
        }
      }
    }

    const bool whole = slab.w < 0;
    const int64_t row = whole ? slab.x : slab.w;
    float* out = (whole ? num : pnum) + row * hf + h * f;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int g = lane + 32 * q;
      if (g < quads) {
        __stcs(reinterpret_cast<float4*>(out + 4 * g),
               make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]));
      }
    }
    if (lane == 0) {
      (whole ? den : pden)[row * heads + h] = dsum;
      (whole ? mx : pmx)[row * heads + h] = m;
    }
  }
}

// a warp per (segment cut into slabs, head): its slabs' partials, rescaled
// to their largest max and added in slab order from slab 0's
template <int NQ>
__global__ void __launch_bounds__(32 * kWarps)
segment_attention_combine_kernel(const int4* __restrict__ multis, int64_t items, int heads,
                                 int f, const float* __restrict__ pnum,
                                 const float* __restrict__ pden, const float* __restrict__ pmx,
                                 float* __restrict__ num, float* __restrict__ den,
                                 float* __restrict__ mx) {
  const int lane = threadIdx.x & 31;
  const int quads = f / 4;
  const int64_t hf = static_cast<int64_t>(heads) * f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t item = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       item < items; item += stride) {
    const int64_t k = item / heads;
    const int h = static_cast<int>(item - k * heads);
    const int4 rec = multis[k];  // (segment, first partial row, partial rows, -)
    float m = kEmpty;
    for (int p = lane; p < rec.z; p += 32) {
      m = fmaxf(m, pmx[static_cast<int64_t>(rec.y + p) * heads + h]);
    }
    m = warp_max(m);
    float acc[NQ][4] = {};
    float dsum = 0.0f;
    for (int p = 0; p < rec.z; ++p) {
      const int64_t r = rec.y + p;
      const float c = expf(__fsub_rn(pmx[r * heads + h], m));
      const float d = __fmul_rn(c, pden[r * heads + h]);
      dsum = p == 0 ? d : __fadd_rn(dsum, d);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int g = lane + 32 * q;
        float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (g < quads) x = __ldcg(reinterpret_cast<const float4*>(pnum + r * hf + h * f + 4 * g));
        if (p == 0) {
          acc[q][0] = __fmul_rn(c, x.x); acc[q][1] = __fmul_rn(c, x.y);
          acc[q][2] = __fmul_rn(c, x.z); acc[q][3] = __fmul_rn(c, x.w);
        } else {
          axpy(acc[q], c, x);
        }
      }
    }
    const int64_t seg = rec.x;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int g = lane + 32 * q;
      if (g < quads) {
        __stcs(reinterpret_cast<float4*>(num + seg * hf + h * f + 4 * g),
               make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]));
      }
    }
    if (lane == 0) {
      den[seg * heads + h] = dsum;
      mx[seg * heads + h] = m;
    }
  }
}

// ----------------------------------------------------------- normalisation

// a warp per destination: for each head in order, the destination's rows
// (rows[offsets[v]] .. in their order) rescaled to their largest max and
// added from the first, y = N / D (0 where D = 0), + bias; with concat the
// skip is added, ELU applied and the head's columns written; without, the
// heads' y + bias are added in head order and scaled
template <int NQ>
__global__ void __launch_bounds__(32 * kWarps)
segment_attention_normalize_kernel(const float* __restrict__ num, const float* __restrict__ den,
                                   const float* __restrict__ mx, const int32_t* __restrict__ rows,
                                   const int32_t* __restrict__ offsets, int nv,
                                   const float* __restrict__ bias,
                                   const float* __restrict__ skip, int64_t ldskip,
                                   float* __restrict__ out, int heads, int f, int concat,
                                   int elu, float scale) {
  const int lane = threadIdx.x & 31;
  const int quads = f / 4;
  const int64_t hf = static_cast<int64_t>(heads) * f;
  const int64_t v = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (v >= nv) return;
  const int r0 = __ldg(offsets + v), r1 = __ldg(offsets + v + 1);
  float tot[NQ][4] = {};
  for (int h = 0; h < heads; ++h) {
    float m = kEmpty;
    for (int r = r0; r < r1; ++r) m = fmaxf(m, mx[static_cast<int64_t>(__ldg(rows + r)) * heads + h]);
    float acc[NQ][4];
#pragma unroll
    for (int q = 0; q < NQ; ++q) acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.0f;
    float dsum = 0.0f;
    for (int r = r0; r < r1; ++r) {
      const int64_t row = __ldg(rows + r);
      const float c = expf(__fsub_rn(mx[row * heads + h], m));
      dsum = __fadd_rn(dsum, __fmul_rn(c, den[row * heads + h]));
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int g = lane + 32 * q;
        if (g < quads) axpy(acc[q], c, __ldcs(reinterpret_cast<const float4*>(num + row * hf + h * f + 4 * g)));
      }
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int g = lane + 32 * q;
      if (g >= quads) continue;
      const float4 b = load_quad(bias + h * f + 4 * g);
      float y[4] = {b.x, b.y, b.z, b.w};
      if (dsum > 0.0f) {
#pragma unroll
        for (int c = 0; c < 4; ++c) y[c] = __fadd_rn(__fdiv_rn(acc[q][c], dsum), y[c]);
      }
      if (concat) {
        if (skip != nullptr) {
          const float4 sk = __ldcs(reinterpret_cast<const float4*>(skip + v * ldskip + h * f + 4 * g));
          y[0] = __fadd_rn(y[0], sk.x); y[1] = __fadd_rn(y[1], sk.y);
          y[2] = __fadd_rn(y[2], sk.z); y[3] = __fadd_rn(y[3], sk.w);
        }
        if (elu) {
#pragma unroll
          for (int c = 0; c < 4; ++c) y[c] = y[c] > 0.0f ? y[c] : expm1f(y[c]);
        }
        __stcs(reinterpret_cast<float4*>(out + v * hf + h * f + 4 * g),
               make_float4(y[0], y[1], y[2], y[3]));
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) tot[q][c] = h == 0 ? y[c] : __fadd_rn(tot[q][c], y[c]);
      }
    }
  }
  if (!concat) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int g = lane + 32 * q;
      if (g < quads) {
        __stcs(reinterpret_cast<float4*>(out + v * f + 4 * g),
               make_float4(__fmul_rn(tot[q][0], scale), __fmul_rn(tot[q][1], scale),
                           __fmul_rn(tot[q][2], scale), __fmul_rn(tot[q][3], scale)));
      }
    }
  }
}

// at most the blocks the card holds at once, as many as the items need
template <typename K>
int grid_for(K kernel, int64_t items) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * kWarps, 0);
  const int64_t want = (items + kWarps - 1) / kWarps;
  return static_cast<int>(std::max<int64_t>(1, std::min<int64_t>(want, int64_t(sms) * std::max(per_sm, 1))));
}

template <int NQ>
int aggregate_nq(const float* z, int64_t ldz, const float* s, const float* t_seg,
                 const int32_t* src, const int4* slabs, int64_t n_slabs, const int4* multis,
                 int64_t n_multis, int heads, int f, int n_rows, float slope, float* num,
                 float* den, float* mx, float* pnum, float* pden, float* pmx,
                 cudaStream_t stream) {
  const int64_t items = n_slabs * heads;
  if (items > 0) {
    segment_attention_kernel<NQ><<<grid_for(segment_attention_kernel<NQ>, items), 32 * kWarps, 0,
                                   stream>>>(z, ldz, s, t_seg, src, slabs, items, heads, f,
                                             n_rows, slope, num, den, mx, pnum, pden, pmx);
  }
  const int64_t combine = n_multis * heads;
  if (combine > 0) {
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
    segment_attention_combine_kernel<NQ>
        <<<grid_for(segment_attention_combine_kernel<NQ>, combine), 32 * kWarps, 0, stream>>>(
            multis, combine, heads, f, pnum, pden, pmx, num, den, mx);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int NQ>
int normalize_nq(const float* num, const float* den, const float* mx, const int32_t* rows,
                 const int32_t* offsets, int nv, const float* bias, const float* skip,
                 int64_t ldskip, float* out, int heads, int f, int concat, int elu, float scale,
                 cudaStream_t stream) {
  if (nv > 0) {
    const int blocks = (nv + kWarps - 1) / kWarps;
    segment_attention_normalize_kernel<NQ><<<blocks, 32 * kWarps, 0, stream>>>(
        num, den, mx, rows, offsets, nv, bias, skip, ldskip, out, heads, f, concat, elu, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// z: [n, >= heads * f] with row stride ldz; a_src, a_dst: [heads, f];
// s, t: [n, heads].  Returns cudaGetLastError().
extern "C" int atlas_segment_attention_scores(const void* z, long long ldz, const void* a_src,
                                              const void* a_dst, void* s, void* t, int n,
                                              int heads, int f, void* stream) {
  if (f <= 0 || f % 4 != 0 || ldz % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    segment_attention_scores_kernel<<<(n + kWarps - 1) / kWarps, 32 * kWarps, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(z), ldz, static_cast<const float*>(a_src),
        static_cast<const float*>(a_dst), static_cast<float*>(s), static_cast<float*>(t), n,
        heads, f);
  }
  return static_cast<int>(cudaGetLastError());
}

// The aggregation: slabs [n_slabs] int4 (segment, first edge, end edge,
// partial row or -1), multis [n_multis] int4 (segment, first partial row,
// partial rows, 0) of the segments cut into slabs; num [segments, heads * f],
// den and mx [segments, heads]; pnum, pden, pmx the partial rows' scratch.
extern "C" int atlas_segment_attention(const void* z, long long ldz, const void* s,
                                       const void* t_seg, const void* src, const void* slabs,
                                       long long n_slabs, const void* multis,
                                       long long n_multis, int heads, int f, int n_rows,
                                       float slope, void* num, void* den, void* mx, void* pnum,
                                       void* pden, void* pmx, void* stream) {
  if (f <= 0 || f % 4 != 0 || f > 512 || ldz % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* zz = static_cast<const float*>(z);
  const auto* ss = static_cast<const float*>(s);
  const auto* tt = static_cast<const float*>(t_seg);
  const auto* sr = static_cast<const int32_t*>(src);
  const auto* sl = static_cast<const int4*>(slabs);
  const auto* mu = static_cast<const int4*>(multis);
  auto* o1 = static_cast<float*>(num);
  auto* o2 = static_cast<float*>(den);
  auto* o3 = static_cast<float*>(mx);
  auto* p1 = static_cast<float*>(pnum);
  auto* p2 = static_cast<float*>(pden);
  auto* p3 = static_cast<float*>(pmx);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f <= 128) {
    return aggregate_nq<1>(zz, ldz, ss, tt, sr, sl, n_slabs, mu, n_multis, heads, f, n_rows,
                           slope, o1, o2, o3, p1, p2, p3, st);
  }
  if (f <= 256) {
    return aggregate_nq<2>(zz, ldz, ss, tt, sr, sl, n_slabs, mu, n_multis, heads, f, n_rows,
                           slope, o1, o2, o3, p1, p2, p3, st);
  }
  return aggregate_nq<4>(zz, ldz, ss, tt, sr, sl, n_slabs, mu, n_multis, heads, f, n_rows, slope,
                         o1, o2, o3, p1, p2, p3, st);
}

// The normalisation: num, den, mx as the aggregation writes them; rows and
// offsets [nv + 1] the destinations' rows; bias [heads * f]; skip null or
// [nv, >= heads * f] with row stride ldskip (concat only); out [nv, heads * f]
// (concat) or [nv, f] (the mean: scale * the sum over heads).
extern "C" int atlas_segment_attention_normalize(const void* num, const void* den,
                                                 const void* mx, const void* rows,
                                                 const void* offsets, int nv, const void* bias,
                                                 const void* skip, long long ldskip, void* out,
                                                 int heads, int f, int concat, int elu,
                                                 float scale, void* stream) {
  if (f <= 0 || f % 4 != 0 || f > 512 || ldskip % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* a = static_cast<const float*>(num);
  const auto* b = static_cast<const float*>(den);
  const auto* c = static_cast<const float*>(mx);
  const auto* r = static_cast<const int32_t*>(rows);
  const auto* o = static_cast<const int32_t*>(offsets);
  const auto* bi = static_cast<const float*>(bias);
  const auto* sk = static_cast<const float*>(skip);
  auto* y = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f <= 128) {
    return normalize_nq<1>(a, b, c, r, o, nv, bi, sk, ldskip, y, heads, f, concat, elu, scale, st);
  }
  if (f <= 256) {
    return normalize_nq<2>(a, b, c, r, o, nv, bi, sk, ldskip, y, heads, f, concat, elu, scale, st);
  }
  return normalize_nq<4>(a, b, c, r, o, nv, bi, sk, ldskip, y, heads, f, concat, elu, scale, st);
}

// L, the edges of a slab
extern "C" int atlas_segment_attention_slab_edges() { return kSlabEdges; }

extern "C" const char* atlas_segment_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
