// K6: the RG-LRU linear recurrence h_t = a_t * h_{t-1} + w_t, forward and
// backward, as a chunked scan across blocks (Hopper).
//
// No TPU kernel to replace: the reference runs this recurrence with
// jax.lax.associative_scan (src/repro/models/rglru.py:64, rglru_scan), and
// XLA differentiates it.  This is a port-only kernel of the hybrid family
// (recurrentgemma-9b), in every RG-LRU layer's prefill and training forward.
//
// Layout: a, w and h are [B, S, R] f32, contiguous; h0 and dh0 [B, R] f32.
//
// The arithmetic order (it fixes the bits; rglru_scan_ref and
// rglru_scan_bwd_ref in kernels/ref.py compute the same order):
//   Both directions are one walk s = x_i * s + y_i over walking steps i:
//   forward x_i = a_t, y_i = w_t at t = i; backward x_i = a_{t+1} (0 at
//   t = S-1), y_i = dh_t at t = S-1-i, so s is the gradient g_t of
//   g_t = dh_t + a_{t+1} * g_{t+1}.  The walk is cut into chunks of L steps
//   (L is the caller's CHUNK; the last chunk in walking order is ragged).
//   For chunk j over steps [i0, i1):
//     A_j = x_{i0} * x_{i0+1} * ... * x_{i1-1}, multiplied left to right;
//     H_j = the chunk walked from s = +0;
//     c_0 = the initial state: h0 (or +0) forward, -0 backward (so the
//           first step, 0 * -0 + dh, is dh bit for bit);
//     c_{j+1} = A_j * c_j + H_j, in chunk order;
//   then chunk j is walked again from c_j, writing the outputs.  Every
//   product is __fmul_rn and every sum __fadd_rn (no FMA contraction).
//   With S <= L that is the sequential loop, bit for bit.
//   Backward epilogue: dw_t = g_t, da_t = g_t * h_{t-1} (h_{-1} = h0 or 0),
//   dh0 = a_0 * g_0.
//
// What bounds it: bytes, 12 B per element forward (a, w read, h written) and
// 20 B backward (a, h, dh read, da, dw written).  The simple kernel this
// replaces walked S in one thread per (batch, channel): 128 warps at
// recurrentgemma's [train] shape, bound by memory latency at ~5x the bytes'
// time.  It stays below (rglru_loop_kernel, rglru_loop_bwd_kernel) only for
// chip_smoke.py's comparison; no path launches it.
//
// Design: one launch (not aggregate / carry / walk in three, which reads a
// and w twice, 20 B forward and 28 B backward, and pays two more launches at
// the served wave).  One warp a block, one (batch, 32 consecutive channels,
// chunk) a block, so every step's loads and stores are whole 128-byte lines;
// at S = 4096 and L = 128 that is 32x the old grid.  A block:
//  1. claims a ticket with an integer atomicInc (wrapping at the grid size,
//     so the counter is back at 0 when the launch ends) and takes chunk
//     j = ticket / columns: chunks are handed out in chunk order, so every
//     block of an earlier chunk of the same columns claimed earlier and is
//     resident or done (no deadlock whatever order the card starts blocks);
//  2. copies its chunk's x, y (and h_{t-1}) into shared memory by cp.async,
//     16 bytes a copy where r % 4 == 0 and the tensors are 16-byte aligned
//     (4 otherwise: the same contents, slower; PERF.md), every step in
//     flight at once in kStages commit groups, no registers waiting on
//     them;
//  3. forms (A_j, H_j) a group at a time as the groups land, publishes
//     them, looks back for c_j (decoupled look-back: the nearest published
//     carry, through the published aggregates after it, at most kLookBack
//     chunks, then c_{q+1} = A_q * c_q + H_q replayed up to c_j: the same
//     products and sums in the same order whichever carry it found),
//     publishes c_{j+1}, then walks the chunk from c_j.  The last chunk
//     publishes nothing and walks as its groups land.
// Each published value is a 64-bit word: the call's epoch (a per-stream
// counter the wrapper passes, never 0) in the high half and the f32 in the
// low, written and read whole with relaxed gpu-scope accesses, so a stale
// word of an earlier call never matches and the scratch is never cleared.
// Integer atomics and flags only, no float atomics: the bits depend on the
// order above and not on scheduling.  A wait that outlasts about two
// seconds traps (a fault, never a hang).
// L = 128 was measured fastest of 32, 64 and 128 at the served wave and at
// [train]'s shape on the H100 (PERF.md); at S <= 128 the launch is one chunk.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (repro_torch/kernels/_build.py), loaded by ctypes.

#include <climits>

#include "hopper.cuh"

namespace {

constexpr int kLanes = 32;                    // a block is one warp of 32 consecutive channels
constexpr int kLookBack = 4;                  // chunks a block looks back before it waits on a carry
constexpr int kStages = 4;                    // commit groups of a chunk's copies
constexpr long long kWaitCycles = 1LL << 32;  // ~2 s at the H100's clock: a wait that long is a fault

__device__ __forceinline__ uint64_t ld_relaxed(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ uint64_t tagged(uint32_t epoch, float v) {
  return (static_cast<uint64_t>(epoch) << 32) | __float_as_uint(v);
}

__device__ __forceinline__ bool is_now(uint64_t word, uint32_t epoch) {
  return static_cast<uint32_t>(word >> 32) == epoch;
}

__device__ __forceinline__ float value(uint64_t word) {
  return __uint_as_float(static_cast<uint32_t>(word));
}

__device__ __forceinline__ void pause(long long start) {
  __nanosleep(64);
  if (clock64() - start > kWaitCycles) __trap();
}

// c_j of this lane's channel (j >= 1).  chain[q] holds c_{q+1} of chunk q,
// chain[n + q] and chain[2n + q] its A_q and H_q (n words apart; q indexes
// chunk-major words, `per_chunk` apart).  Chunks q = j-1, j-2, ... are
// looked at in turn: a published carry ends the look, a published
// aggregate is taken and the look goes on; after kLookBack aggregates the
// block waits for the carry of the chunk before them.  Then
// c_{q+1} = A_q * c_q + H_q is replayed from the carry found up to c_j: the
// same products and sums, so the same bits, whichever carry was found.
// Chunk 0 publishes its carry and no aggregate, so the look ends there.
__device__ __forceinline__ float look_back(const uint64_t* chain, int64_t n, int64_t per_chunk,
                                           int j, uint32_t epoch) {
  uint64_t cw[kLookBack], aw[kLookBack], hw[kLookBack];
#pragma unroll
  for (int k = 0; k < kLookBack; ++k) {  // every word of the window in flight at once
    const int64_t q = (j - 1 - k) * per_chunk;
    cw[k] = aw[k] = hw[k] = 0;
    if (j - 1 - k >= 0) {
      cw[k] = ld_relaxed(chain + q);
      aw[k] = ld_relaxed(chain + n + q);
      hw[k] = ld_relaxed(chain + 2 * n + q);
    }
  }
  const long long start = clock64();
  int taken = kLookBack;
  float c = 0.0f;
#pragma unroll
  for (int k = 0; k < kLookBack; ++k) {
    if (taken == kLookBack) {
      const int64_t q = (j - 1 - k) * per_chunk;
      while (!is_now(cw[k], epoch) && !(is_now(aw[k], epoch) && is_now(hw[k], epoch))) {
        pause(start);
        cw[k] = ld_relaxed(chain + q);
        aw[k] = ld_relaxed(chain + n + q);
        hw[k] = ld_relaxed(chain + 2 * n + q);
      }
      if (is_now(cw[k], epoch)) {
        c = value(cw[k]);
        taken = k;
      }
    }
  }
  if (taken == kLookBack) {
    const uint64_t* word = chain + (j - 1 - kLookBack) * per_chunk;
    uint64_t v;
    while (!is_now(v = ld_relaxed(word), epoch)) pause(start);
    c = value(v);
  }
#pragma unroll
  for (int k = kLookBack - 1; k >= 0; --k)
    if (k < taken) c = __fadd_rn(__fmul_rn(value(aw[k]), c), value(hw[k]));
  return c;
}

// Wait for the copies of stages 0..g (of kStages) and make every lane's
// copies visible to the warp.
__device__ __forceinline__ void wait_stage(int g) {
  static_assert(kStages >= 1 && kStages <= 4, "one case below for each group left in flight");
  switch (kStages - 1 - g) {
    case 0: hopper::cp_async_wait<0>(); break;
    case 1: hopper::cp_async_wait<1>(); break;
    case 2: hopper::cp_async_wait<2>(); break;
    default: hopper::cp_async_wait<3>(); break;
  }
  __syncwarp();
}

// One block's chunk, both directions (see the header).  kBwd: y = dh, e = h
// (the forward's output, read at t-1), out = dw, da and dh0 written; else
// y = w, out = h.  kVec: r % 4 == 0 and a, y, e 16-byte aligned, so the
// copies are 16 bytes (8 lanes a row, 4 rows an instruction); else each
// lane copies its own channel, 4 bytes a step.  stage is [2 or 3][len][32]
// f32 of dynamic shared memory, the same contents either way.  The copies
// go out in kStages commit groups of consecutive steps, and the first pass
// over the chunk (the aggregate, or the walk of the last chunk) starts on
// a group as soon as it has landed.
template <bool kBwd, bool kVec>
__device__ __forceinline__ void chunk_scan(float* stage, const float* __restrict__ a,
                                           const float* __restrict__ y,
                                           const float* __restrict__ e,
                                           const float* __restrict__ h0, float* __restrict__ out,
                                           float* __restrict__ da, float* __restrict__ dh0,
                                           uint64_t* __restrict__ chain,
                                           unsigned* __restrict__ ticket, uint32_t epoch, int nb,
                                           int s, int r, int len) {
  const int lane = threadIdx.x;
  unsigned id = 0;
  if (lane == 0) id = atomicInc(ticket, gridDim.x - 1);
  id = __shfl_sync(0xffffffffu, id, 0);
  const int groups = (r + kLanes - 1) / kLanes;
  const unsigned columns = static_cast<unsigned>(nb) * groups;
  const int j = static_cast<int>(id / columns);
  const int col = static_cast<int>(id % columns);
  const int b = col / groups;
  const int c0 = (col % groups) * kLanes;  // this block's first channel
  const int c = c0 + lane;
  const bool live = c < r;  // dead lanes copy for the others, then stop
  const int chunks = (s + len - 1) / len;
  const int i0 = j * len;
  const int n = min(len, s - i0);
  const int64_t stride = r;
  const int64_t state = static_cast<int64_t>(b) * stride + c;
  float* xs = stage + lane;  // step i of this lane at xs[i * kLanes]
  float* ys = xs + len * kLanes;
  float* es = ys + len * kLanes;

  // step i's rows: x at a[t] (forward) or a[t+1] (backward), y at t, e at
  // h[t-1]; the backward's rows outside the sequence (a_S = 0, h_{-1} = h0
  // or 0) are written by their lane, not copied
  constexpr int width = kVec ? 4 : 1;     // channels a copy
  constexpr int step = kVec ? 4 : 1;      // rows between a lane's copies
  const int seg = kVec ? lane & 7 : lane;  // the first of this lane's `width` channels
  const int first = kVec ? lane >> 3 : 0;  // its first row in each stage
  const int ch = c0 + seg * width;
  const int part = (n + 4 * kStages - 1) / (4 * kStages) * 4;  // rows a stage, a multiple of 4
  const int64_t base = static_cast<int64_t>(b) * s * stride + ch;
  float* xd = stage + seg * width;
  float* yd = xd + len * kLanes;
  float* ed = yd + len * kLanes;
#pragma unroll
  for (int g = 0; g < kStages; ++g) {
    const int hi = min(n, (g + 1) * part);
    if (ch < r) {
      for (int i = g * part + first; i < hi; i += step) {
        const int t = kBwd ? s - 1 - (i0 + i) : i0 + i;
        const int64_t at = base + t * stride;
        if (!kBwd) {
          hopper::cp_async<4 * width>(xd + i * kLanes, a + at, 4 * width);
        } else {
          if (t + 1 < s) hopper::cp_async<4 * width>(xd + i * kLanes, a + at + stride, 4 * width);
          if (t >= 1) hopper::cp_async<4 * width>(ed + i * kLanes, e + at - stride, 4 * width);
        }
        hopper::cp_async<4 * width>(yd + i * kLanes, y + at, 4 * width);
      }
    }
    hopper::cp_async_commit();
  }
  if (kBwd && live && j == 0) xs[0] = 0.0f;
  if (kBwd && live && j + 1 == chunks) es[(n - 1) * kLanes] = h0 != nullptr ? h0[state] : 0.0f;

  const int64_t per_chunk = static_cast<int64_t>(nb) * stride;
  const int64_t words = (chunks - 1) * per_chunk;  // carries, then A's, then H's
  uint64_t* mine = chain + j * per_chunk + state;
  const int64_t own = static_cast<int64_t>(b) * s * stride + c;
  float cin = kBwd ? -0.0f : 0.0f;  // c_0, unless h0 gives it
  if (!kBwd && live && j == 0 && h0 != nullptr) cin = h0[state];
  float v;
  const auto walk = [&](int i) {
    const int t = kBwd ? s - 1 - (i0 + i) : i0 + i;
    v = __fadd_rn(__fmul_rn(xs[i * kLanes], v), ys[i * kLanes]);
    out[own + t * stride] = v;
    if (kBwd) da[own + t * stride] = __fmul_rn(v, es[i * kLanes]);
  };
  // the first pass, a stage at a time as the copies land
  const auto staged = [&](const auto& body) {
#pragma unroll
    for (int g = 0; g < kStages; ++g) {
      wait_stage(g);
      if (live)
        for (int i = g * part, hi = min(n, (g + 1) * part); i < hi; ++i) body(i);
    }
  };
  if (j + 1 < chunks) {
    float A = 1.0f, H = 0.0f;  // 1 * x_0 is x_0 and x_0 * +0 + y_0 is H's first step
    staged([&](int i) {
      const float x = xs[i * kLanes];
      A = __fmul_rn(A, x);
      H = __fadd_rn(__fmul_rn(x, H), ys[i * kLanes]);
    });
    if (!live) return;
    if (j > 0) {
      st_relaxed(mine + words, tagged(epoch, A));
      st_relaxed(mine + 2 * words, tagged(epoch, H));
      cin = look_back(chain + state, words, per_chunk, j, epoch);
    }
    st_relaxed(mine, tagged(epoch, __fadd_rn(__fmul_rn(A, cin), H)));
    v = cin;
#pragma unroll 4
    for (int i = 0; i < n; ++i) walk(i);
  } else {
    if (live && j > 0) cin = look_back(chain + state, words, per_chunk, j, epoch);
    v = cin;
    staged(walk);
  }
  // the last walking step of the backward's last chunk is t = 0
  if (kBwd && live && dh0 != nullptr && j + 1 == chunks) dh0[state] = __fmul_rn(a[own], v);
}

template <bool kVec>
__global__ void __launch_bounds__(kLanes)
rglru_chunk_kernel(const float* __restrict__ a, const float* __restrict__ w,
                   const float* __restrict__ h0, float* __restrict__ h,
                   uint64_t* __restrict__ chain, unsigned* __restrict__ ticket, uint32_t epoch,
                   int nb, int s, int r, int len) {
  extern __shared__ float stage[];
  chunk_scan<false, kVec>(stage, a, w, nullptr, h0, h, nullptr, nullptr, chain, ticket, epoch,
                          nb, s, r, len);
}

template <bool kVec>
__global__ void __launch_bounds__(kLanes)
rglru_chunk_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                       const float* __restrict__ dh, const float* __restrict__ h0,
                       float* __restrict__ da, float* __restrict__ dw, float* __restrict__ dh0,
                       uint64_t* __restrict__ chain, unsigned* __restrict__ ticket,
                       uint32_t epoch, int nb, int s, int r, int len) {
  extern __shared__ float stage[];
  chunk_scan<true, kVec>(stage, a, dh, h, h0, dw, da, dh0, chain, ticket, epoch, nb, s, r, len);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The launch of one direction: blocks = chunks * b * ceil(r / 32), one warp
// each, `arrays` [len][32] f32 tiles of shared memory each.
template <typename Kernel, typename... Args>
int launch_chunked(Kernel kernel, int arrays, int b, int s, int r, int len, void* stream,
                   Args... args) {
  if (b < 1 || s < 1 || r < 1 || len < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunks = (static_cast<int64_t>(s) + len - 1) / len;
  const int64_t blocks = chunks * b * ((r + kLanes - 1) / kLanes);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = static_cast<size_t>(arrays) * len * kLanes * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(blocks), kLanes, bytes, static_cast<cudaStream_t>(stream)>>>(
      args..., b, s, r, len);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------------- the sequential kernel
// One thread per (batch, channel) walking all of S, the next kUnroll steps'
// loads in flight: the sequential loop (chunk=None in kernels/ref.py), bit
// for bit.  Kept for chip_smoke.py's same-run comparison; no path runs it.

constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kLanes)
rglru_loop_kernel(const float* __restrict__ a, const float* __restrict__ w,
                  const float* __restrict__ h0, float* __restrict__ h, int s, int r) {
  const int c = blockIdx.x * kLanes + threadIdx.x;
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
    an[u] = u < s ? __ldg(ab + u * stride) : 0.0f;
    wn[u] = u < s ? __ldg(wb + u * stride) : 0.0f;
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
    for (int u = 0; u < kUnroll; ++u) {
      an[u] = t1 + u < s ? __ldg(ab + (t1 + u) * stride) : 0.0f;
      wn[u] = t1 + u < s ? __ldg(wb + (t1 + u) * stride) : 0.0f;
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

__global__ void __launch_bounds__(kLanes)
rglru_loop_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                      const float* __restrict__ dh, const float* __restrict__ h0,
                      float* __restrict__ da, float* __restrict__ dw, float* __restrict__ dh0,
                      int s, int r) {
  const int c = blockIdx.x * kLanes + threadIdx.x;
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

  float dn[kUnroll], hn[kUnroll], an[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int t = s - 1 - u;
    dn[u] = t >= 0 ? __ldg(db + t * stride) : 0.0f;
    hn[u] = t >= 1 ? __ldg(hb + (t - 1) * stride) : hinit;
    an[u] = t >= 0 && t + 1 < s ? __ldg(ab + (t + 1) * stride) : 0.0f;
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
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t1 - u;
      dn[u] = t >= 0 ? __ldg(db + t * stride) : 0.0f;
      hn[u] = t >= 1 ? __ldg(hb + (t - 1) * stride) : hinit;
      an[u] = t >= 0 ? __ldg(ab + (t + 1) * stride) : 0.0f;
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

// a, w, h [b, s, r] float32, contiguous; h0 null or [b, r] float32; chain
// at least 3 * (ceil(s / chunk) - 1) * b * r words of 64 bits (carries,
// then A's, then H's), none tagged with `epoch` (never 0); ticket one
// 32-bit counter at 0, left at 0.  No other launch may use chain or ticket
// until this one ends.  Returns cudaGetLastError() after the launch.
extern "C" int atlas_rglru_scan(const void* a, const void* w, const void* h0, void* h,
                                void* chain, void* ticket, unsigned epoch, int b, int s, int r,
                                int chunk, void* stream) {
  if (epoch == 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = r % 4 == 0 && aligned16(a) && aligned16(w);
  return launch_chunked(vec ? rglru_chunk_kernel<true> : rglru_chunk_kernel<false>, 2, b, s, r,
                        chunk, stream, static_cast<const float*>(a),
                        static_cast<const float*>(w), static_cast<const float*>(h0),
                        static_cast<float*>(h), static_cast<uint64_t*>(chain),
                        static_cast<unsigned*>(ticket), static_cast<uint32_t>(epoch));
}

// The backward: a, h (the forward's output), dh, da, dw [b, s, r] float32,
// contiguous; h0 and dh0 both null or both [b, r] float32; chain, ticket and
// epoch as for atlas_rglru_scan.  Returns cudaGetLastError() after the launch.
extern "C" int atlas_rglru_scan_bwd(const void* a, const void* h, const void* dh, const void* h0,
                                    void* da, void* dw, void* dh0, void* chain, void* ticket,
                                    unsigned epoch, int b, int s, int r, int chunk,
                                    void* stream) {
  if (epoch == 0 || (h0 == nullptr) != (dh0 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = r % 4 == 0 && aligned16(a) && aligned16(h) && aligned16(dh);
  return launch_chunked(vec ? rglru_chunk_bwd_kernel<true> : rglru_chunk_bwd_kernel<false>, 3, b,
                        s, r, chunk, stream, static_cast<const float*>(a),
                        static_cast<const float*>(h), static_cast<const float*>(dh),
                        static_cast<const float*>(h0), static_cast<float*>(da),
                        static_cast<float*>(dw), static_cast<float*>(dh0),
                        static_cast<uint64_t*>(chain), static_cast<unsigned*>(ticket),
                        static_cast<uint32_t>(epoch));
}

// The sequential kernels, arguments as above without the chain's.
extern "C" int atlas_rglru_scan_loop(const void* a, const void* w, const void* h0, void* h, int b,
                                     int s, int r, void* stream) {
  if (b < 1 || s < 1 || r < 1 || b > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((r + kLanes - 1) / kLanes, b);
  rglru_loop_kernel<<<grid, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(w), static_cast<const float*>(h0),
      static_cast<float*>(h), s, r);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int atlas_rglru_scan_bwd_loop(const void* a, const void* h, const void* dh,
                                         const void* h0, void* da, void* dw, void* dh0, int b,
                                         int s, int r, void* stream) {
  if (b < 1 || s < 1 || r < 1 || b > 65535 || (h0 == nullptr) != (dh0 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((r + kLanes - 1) / kLanes, b);
  rglru_loop_bwd_kernel<<<grid, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(h), static_cast<const float*>(dh),
      static_cast<const float*>(h0), static_cast<float*>(da), static_cast<float*>(dw),
      static_cast<float*>(dh0), s, r);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* atlas_rglru_scan_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
