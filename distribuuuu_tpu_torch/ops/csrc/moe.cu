// Switch-MoE dispatch (K6) and combine (K7), and their backward passes, for
// Hopper (sm_90a).
//
// Replaces distribuuuu_tpu/ops/moe_kernel.py::_dispatch_kernel and
// ::_combine_kernel (the Pallas TPU kernels behind fused_moe_dispatch and
// fused_moe_combine) and the XLA recompute their custom_vjp runs backward
// (::_dispatch_bwd, ::_combine_bwd). For x [n, D] (f32 or bf16) and the
// router gate [D, E] (f32), dispatch computes per token
//
//     logits = f32(x) . gate            probs = softmax(logits)
//     top    = lowest index of max(probs), top_p = probs[top]
//     pos    = number of earlier tokens with the same top (int32)
//     keep   = pos < C,  pos_c = min(pos, C - 1),  w = keep ? top_p : 0
//     send[top, pos_c, :] = f32(x)  for kept tokens, zeros in every other slot
//     fp_sum = [sum of one-hot(top), sum of probs] over tokens
//
// and combine computes out[t, :] = w[t] * back[top[t], pos[t], :].
//
// What bounds them on this card. Each kernel's bytes bound is a few µs
// (dispatch at n 8192, E 8, C 1280, f32: 9.5 MB at D 128, 57 MB at D 768),
// and dispatch's 2.n.D.E f32 flops are ~10 % of its bytes time at D 768. At
// these sizes what a launch costs is latency: dependent steps in each block
// (copy in, route, publish, look back, scatter, zero) and the wait for the
// last tile, not the memory rate (PERF.md section 6 has the measured times).
//
// K6 design: one launch that reads x from HBM once.
//
//  * A grid of no more blocks than fit on the card at once takes tiles of
//    kTile tokens by an atomic ticket, so tiles are numbered in the order
//    blocks take them and a block only ever waits on tiles that running
//    blocks hold: no deadlock, whatever the grid or the co-residency.
//  * A tile's x rows come into shared memory by cp.async (16 bytes a thread,
//    all in flight) when x and D*itemsize are 16-byte aligned, else by plain
//    loads. Where two tiles and the gate fit, the next tile's copy starts as
//    soon as this one has arrived and runs while it is routed and scattered.
//    The [D, E] gate sits transposed in shared memory ([E, D]: neighbouring
//    lanes read neighbouring words).
//  * Logits: a thread owns TM tokens and 4-feature chunks of D (KS threads
//    split one token group's D), so each gate float4 read from shared memory
//    feeds TM tokens' FMAs. f32 FMAs on the CUDA cores, no TF32: on dyadic
//    inputs every logit is exact in any order, so routing is bitwise the
//    plain version's. A reduce-scatter over the KS lanes (31 shuffles a lane
//    at E 8, in place of a 160-shuffle butterfly) leaves each logit in one
//    lane; warp 0, a lane per token, takes the softmax, the lowest-index
//    argmax and the drop rule as in the plain version.
//  * Slots: a token's rank within its tile among earlier tokens of the same
//    expert comes from __match_any_sync and a popcount (in order, no
//    atomics). Each tile publishes its per-expert counts and then finds its
//    exclusive offsets by a decoupled look-back (a warp per expert reads 128
//    predecessors' words at once and stops at the first inclusive prefix).
//    Counts are int32, so any association gives the same offsets.
//  * Every published word holds its flag and its value in one 64-bit store
//    (relaxed), so a reader that sees the flag sees the value: no fence, and
//    no wait for the block's earlier stores (a release or a __threadfence
//    made each publish wait for the previous tile's scatter to drain).
//  * Scatter: each kept row goes from shared memory to send[top, pos] with
//    16-byte stores, so x is read from HBM once.
//  * Zero fill: the slots no token fills, c >= min(total_j, C), are known
//    only once the last tile has published. The first zero_blocks blocks
//    (about 64 KB of send each) wait for that and zero their share of those
//    rows (each expert's are one contiguous range); the other blocks are
//    done. send is written once.
//  * fp_sum[1] is deterministic: each tile publishes its probability sums
//    (in token order, a fixed tree) as words of their own, and the block
//    that holds the last tile adds them in tile order.
//  * The ticket and the words start at zero: the launch function clears
//    them with cudaMemsetAsync on the same stream (a memset node, not a
//    kernel; capturable in a CUDA graph, nothing from the host between
//    calls).
//
// K7 (combine): a warp per row, kRowLoads 16-byte gathers of its row of back
// in flight a lane.
//
// Backward. K6's is K7's gather pattern: a warp per token forms
// d_logits = probs * (d_probs - <d_probs, probs>) from the probabilities the
// forward saved ([n, E] f32) and d_x = d_logits . gate^T + keep * d_send[top,
// pos] with the gate transposed in shared memory; d_gate = x^T . d_logits is
// a plain matrix product left to the caller (XLA's, outside any Pallas
// kernel, in the JAX backward). K7's is K6's scatter pattern: a warp per
// token computes d_w = <g, back[top, pos]> and, if w != 0, claims its slot
// with an atomic count; the first claimant writes d_back[top, pos] = w * g.
// Once every token is counted, the first zero_blocks blocks zero the slots
// no token claimed and rewrite the rare slot two tokens claimed as their sum
// in token order (fused_moe_dispatch never routes two kept tokens to one
// slot). Whatever top, pos and w the caller passes, d_back is the plain
// version's; on dispatch's routing each byte of it is written once.
//
// Every kernel adds +0.0f to what it copies or scales into a slot, so a -0
// comes out as +0, as from the plain version's one-hot contraction; every
// other value is unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <unordered_map>

namespace {

enum DType : int { kF32 = 0, kBF16 = 1 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxExperts = 32;
constexpr int kRowsPerTicket = kWarps;  // combine backward: a row a warp
constexpr int kRowLoads = 4;       // row kernels: 16-byte loads in flight a lane
constexpr int kTile = 32;          // dispatch: tokens a tile, the slot scan's granularity
constexpr unsigned kFull = 0xffffffffu;
// look-back status word: flag in the high 32 bits, int32 count in the low
constexpr unsigned kAggregate = 1u, kInclusive = 2u;
constexpr int kLookBack = 128;  // predecessors one look-back read covers (4 a lane)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// four consecutive values of T from shared memory as floats (16-byte aligned
// for f32, 8-byte for bf16)
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned*>(&lo);
  raw.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}
__device__ __forceinline__ float4 plus_zero(float4 v) {
  return make_float4(__fadd_rn(v.x, 0.f), __fadd_rn(v.y, 0.f), __fadd_rn(v.z, 0.f),
                     __fadd_rn(v.w, 0.f));
}

// relaxed: several polls are in flight at once, and no published word needs
// another to be read in order
__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ int ld_relaxed_i32(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
// a published word: the flag in the high half, the value in the low half,
// one 64-bit store, so a reader that sees the flag sees the value (no fence)
__device__ __forceinline__ unsigned long long word(unsigned flag, unsigned value) {
  return ((unsigned long long)flag << 32) | value;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// this thread's share of `bytes` (a multiple of 16) global -> shared, 16
// bytes a cp.async, all in flight at once; cp_async_wait() then a barrier
// makes the whole copy visible
__device__ __forceinline__ void cp_async_copy(void* dst, const void* src, unsigned bytes) {
  for (unsigned i = 16u * threadIdx.x; i < bytes; i += 16u * kThreads)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     smem_u32(static_cast<char*>(dst) + i)),
                 "l"(static_cast<const char*>(src) + i)
                 : "memory");
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// The [d, e] f32 gate into shared memory as [EP, dp] (transposed, zero
// padded): coalesced loads, kStageLoads of them in flight a thread.
constexpr int kStageLoads = 8;
template <int EP>
__device__ void stage_gate(float* __restrict__ gs, const float* __restrict__ gate, int d, int dp,
                           int e) {
  const int total = d * e;
  for (int base = 0; base < total; base += kThreads * kStageLoads) {
    float v[kStageLoads];
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      v[u] = i < total ? __ldg(gate + i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      if (i < total) {
        const int k = i / e;
        gs[(i - k * e) * dp + k] = v[u];
      }
    }
  }
  for (int i = threadIdx.x; i < (EP - e) * dp; i += kThreads) gs[e * dp + i] = 0.f;
  if (dp > d)
    for (int i = threadIdx.x; i < e * (dp - d); i += kThreads) {
      const int j = i / (dp - d);
      gs[j * dp + d + (i - j * (dp - d))] = 0.f;
    }
}

// Zero this block's share of the rows [fill[j], cap) of every expert j of a
// [e, cap, d] f32 buffer (each expert's rows are one contiguous range).
// The ranges are split evenly, in 16-byte units where d allows, over the
// first `blocks` blocks of the grid.
__device__ void zero_unfilled(float* __restrict__ buf, const int* fill, int e, int cap, int d,
                              int blocks) {
  const bool vec = (d & 3) == 0;
  const int64_t unit = vec ? 4 : 1;
  const int64_t row_units = d / unit;
  int64_t total = 0;
  for (int j = 0; j < e; ++j) total += (int64_t)(cap - fill[j]) * row_units;
  const int64_t lo = total * blockIdx.x / blocks, hi = total * (blockIdx.x + 1) / blocks;
  int64_t start = 0;  // expert j's first unit in the flattened ranges
  for (int j = 0; j < e && start < hi; ++j) {
    const int64_t len = (int64_t)(cap - fill[j]) * row_units;
    const int64_t a = max(lo, start), b = min(hi, start + len);
    const int64_t base = ((int64_t)j * cap + fill[j]) * row_units - start;  // unit index in buf
    if (vec) {
      float4* p = reinterpret_cast<float4*>(buf);
      for (int64_t u = a + threadIdx.x; u < b; u += kThreads) p[base + u] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (int64_t u = a + threadIdx.x; u < b; u += kThreads) buf[base + u] = 0.f;
    }
    start += len;
  }
}

// ---------------------------------------------------------------------------
// K6: dispatch
// ---------------------------------------------------------------------------

struct DispatchArgs {
  const void* x;
  const float* gate;
  float* send;
  int* top;
  int* pos;
  float* w;
  float* fp_sum;
  float* probs;  // [n, e], written when not null (the backward reads it)
  int* ticket;   // zeroed before the launch
  unsigned long long* status;  // [e, tiles] counts, then [e, tiles] sums of probs; zeroed
  long long n;
  int d, dp, e, cap, tiles;
  int async_copy;    // x and D * itemsize 16-byte aligned: cp.async, else plain loads
  int vec_out;       // D % 4 == 0: 16-byte stores into send
  int nbuf;          // x tiles in shared memory: 2 when the next tile's copy overlaps
  int zero_blocks;   // the blocks that zero the unfilled slots (~64 KB each)
};

// Reduce-scatter of V values over the lanes that differ in the bits below
// 2 * O: each round a lane keeps half of its values and adds its partner's
// copy of them (a fixed tree: deterministic), so after the rounds a lane with
// index ks among them holds the sums of values [ks * V', (ks + 1) * V'),
// V' = V / (2 * O), in v[0, V').
template <int O, int H, int V>
__device__ __forceinline__ void reduce_scatter(float (&v)[V], int ks) {
  if constexpr (O >= 1) {
    const bool upper = (ks & O) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = upper ? v[i] : v[i + H];
      const float keep = upper ? v[i + H] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, O);
    }
    reduce_scatter<O / 2, H / 2, V>(v, ks);
  }
}

// TM tokens a thread; KS threads split one token group's D
template <int EP>
struct RouteShape {
  static constexpr int TM = EP == 8 ? 4 : (EP == 16 ? 2 : 1);
  static constexpr int KS = kThreads * TM / kTile;
  static constexpr int V = TM * EP;  // partial logits a thread holds
  static_assert(KS <= 32 && 32 % KS == 0 && V >= KS, "thread layout");
};

template <typename T, int EP>
__global__ void __launch_bounds__(kThreads) moe_dispatch_kernel(const DispatchArgs a) {
  using RS = RouteShape<EP>;
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t buf_elems = (size_t)kTile * a.dp;
  T* xbuf = reinterpret_cast<T*>(smem);                                        // [nbuf, kTile, dp]
  float* gs = reinterpret_cast<float*>(smem + a.nbuf * buf_elems * sizeof(T));  // [EP, dp]
  __shared__ int s_next;
  __shared__ int s_top[kTile], s_dst[kTile];
  __shared__ float s_topp[kTile];
  __shared__ float s_logit[kTile][EP], s_prob[kTile][EP];
  __shared__ int s_cnt[EP], s_excl[EP], s_fill[EP];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int e = a.e, d = a.d, dp = a.dp;
  const T* x = static_cast<const T*>(a.x);

  // tile `tile` into buffer `b`: cp.async, or plain loads (D padded)
  auto load = [&](int tile, int b) {
    const int64_t t0 = (int64_t)tile * kTile;
    const int rows = (int)min((long long)kTile, a.n - (long long)t0);
    T* xs = xbuf + b * buf_elems;
    if (a.async_copy) {
      cp_async_copy(xs, x + t0 * d, (unsigned)(rows * d * sizeof(T)));
    } else {
      for (int i = tid; i < rows * dp; i += kThreads) {
        const int r = i / dp, k = i - r * dp;
        xs[i] = k < d ? x[(t0 + r) * d + k] : from_f32<T>(0.f);
      }
    }
  };
  auto next_ticket = [&]() {
    if (tid == 0) s_next = atomicAdd(a.ticket, 1);
    __syncthreads();
    return s_next;
  };

  int tile = next_ticket();
  if (tile < a.tiles) {
    load(tile, 0);
    stage_gate<EP>(gs, a.gate, d, dp, e);
  }
  int b = 0;
  while (tile < a.tiles) {
    cp_async_wait();  // this thread's copies of the tile (none on the plain path)
    __syncthreads();  // everyone's, and the gate; every warp is done with the other buffer
    // with two buffers, the next tile's copy starts once this one has
    // arrived (so the two do not share the bandwidth) and runs while this
    // one is routed and scattered
    int next = a.tiles;
    if (a.nbuf == 2) {
      next = next_ticket();
      if (next < a.tiles) load(next, b ^ 1);
    }
    const T* xs = xbuf + b * buf_elems;
    const int64_t t0 = (int64_t)tile * kTile;
    const int rows = (int)min((long long)kTile, a.n - (long long)t0);

    // partial logits of TM tokens over this thread's 4-feature chunks of D
    {
      const int g = tid / RS::KS, ks = tid % RS::KS;
      float v[RS::V];  // v[m * EP + j]
#pragma unroll
      for (int i = 0; i < RS::V; ++i) v[i] = 0.f;
      for (int q = ks; q < (dp >> 2); q += RS::KS) {
        float4 xv[RS::TM];
#pragma unroll
        for (int m = 0; m < RS::TM; ++m) xv[m] = load4(xs + (g * RS::TM + m) * dp + 4 * q);
#pragma unroll
        for (int j = 0; j < EP; ++j) {
          const float4 gv = reinterpret_cast<const float4*>(gs + j * dp)[q];
#pragma unroll
          for (int m = 0; m < RS::TM; ++m) {
            float& acc = v[m * EP + j];
            acc = fmaf(xv[m].x, gv.x, acc);
            acc = fmaf(xv[m].y, gv.y, acc);
            acc = fmaf(xv[m].z, gv.z, acc);
            acc = fmaf(xv[m].w, gv.w, acc);
          }
        }
      }
      reduce_scatter<RS::KS / 2, RS::V / 2>(v, ks);
      float* out = &s_logit[g * RS::TM][0] + ks * (RS::V / RS::KS);
#pragma unroll
      for (int i = 0; i < RS::V / RS::KS; ++i) out[i] = v[i];
    }
    __syncthreads();

    // warp 0, a lane per token: softmax, the lowest-index argmax, and the
    // token's rank among the tile's earlier tokens of its expert
    if (warp == 0) {
      const int tl = lane;
      int best = -1;
      if (tl < rows) {
        float l[EP];
#pragma unroll
        for (int j = 0; j < EP; ++j) l[j] = s_logit[tl][j];
        float mx = l[0];
#pragma unroll
        for (int j = 1; j < EP; ++j)
          if (j < e) mx = fmaxf(mx, l[j]);
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < EP; ++j) {
          l[j] = j < e ? expf(l[j] - mx) : 0.f;
          s += l[j];
        }
        best = 0;
        float best_p = l[0] / s;
        s_prob[tl][0] = best_p;
#pragma unroll
        for (int j = 1; j < EP; ++j) {
          const float p = j < e ? l[j] / s : 0.f;
          s_prob[tl][j] = p;
          if (j < e && p > best_p) {
            best_p = p;
            best = j;
          }
        }
        s_topp[tl] = best_p;
      } else {  // the ragged last tile: claims no slot, adds nothing
#pragma unroll
        for (int j = 0; j < EP; ++j) s_prob[tl][j] = 0.f;
      }
      s_top[tl] = best;
      if (lane < EP) s_cnt[lane] = 0;
      const unsigned same = __match_any_sync(kFull, best);
      const int rank = __popc(same & ((1u << lane) - 1u));
      __syncwarp();
      if (best >= 0 && rank == 0) s_cnt[best] = __popc(same);
      s_dst[tl] = rank;  // the rank for now; the slot below
    }
    __syncthreads();
    if (a.probs)
      for (int i = tid; i < rows * e; i += kThreads) {
        const int r = i / e;
        a.probs[t0 * e + i] = s_prob[r][i - r * e];
      }

    // a warp per expert: publish the tile's count and probability sum
    // (inclusive at once for the first tile), then look back for the
    // exclusive offset, kLookBack predecessors a read
    for (int j = warp; j < e; j += kWarps) {
      float ps = s_prob[lane][j];  // token order within the tile, a fixed tree
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(kFull, ps, off);
      const int c = s_cnt[j];
      unsigned long long* st = a.status + (int64_t)j * a.tiles;
      if (lane == 0) {
        st_relaxed(a.status + (int64_t)(e + j) * a.tiles + tile, word(kAggregate, __float_as_uint(ps)));
        st_relaxed(st + tile, word(tile == 0 ? kInclusive : kAggregate, (unsigned)c));
      }
      int excl = 0;
      if (tile > 0) {
        int hi = tile - 1;
        for (;;) {
          unsigned long long v[kLookBack / 32];
#pragma unroll
          for (int r = 0; r < kLookBack / 32; ++r) {
            const int k = hi - 32 * r - lane;
            v[r] = k >= 0 ? ld_relaxed(st + k) : word(kInclusive, 0u);
          }
          // the newest inclusive prefix ends the walk; every word up to it
          // must be published
          bool found = false, wait = false;
          int part = 0;
#pragma unroll
          for (int r = 0; r < kLookBack / 32; ++r) {
            const unsigned flag = (unsigned)(v[r] >> 32);
            const unsigned inc = __ballot_sync(kFull, flag == kInclusive);
            const unsigned zero = __ballot_sync(kFull, flag == 0u);
            if (!found) {
              const unsigned region = inc ? (((inc & (0u - inc)) << 1) - 1u) : kFull;
              wait |= (zero & region) != 0u;
              if ((region >> lane) & 1u) part += (int)(unsigned)v[r];
              found = inc != 0u;
            }
          }
          if (wait) {  // a predecessor has not published yet: read again
            __nanosleep(20);
            continue;
          }
          excl += __reduce_add_sync(kFull, part);
          if (found) break;
          hi -= kLookBack;
        }
        if (lane == 0) st_relaxed(st + tile, word(kInclusive, (unsigned)(excl + c)));
      }
      if (lane == 0) s_excl[j] = excl;
    }
    __syncthreads();

    // the last tile's block has seen every tile publish: fp_sum, with the
    // tiles' probability sums added in a fixed order
    if (tile == a.tiles - 1) {
      for (int j = warp; j < e; j += kWarps) {
        const unsigned long long* sp = a.status + (int64_t)(e + j) * a.tiles;
        float ps = 0.f;
        for (int k0 = lane; k0 < a.tiles; k0 += 32 * kStageLoads) {
          unsigned long long v[kStageLoads];
#pragma unroll
          for (int u = 0; u < kStageLoads; ++u) {
            const int k = k0 + 32 * u;
            v[u] = k < a.tiles ? ld_relaxed(sp + k) : word(kAggregate, 0u);
          }
#pragma unroll
          for (int u = 0; u < kStageLoads; ++u) {
            const int k = k0 + 32 * u;
            while ((unsigned)(v[u] >> 32) == 0u) {  // published, but not yet seen here
              __nanosleep(20);
              v[u] = ld_relaxed(sp + k);
            }
            ps += __uint_as_float((unsigned)v[u]);
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(kFull, ps, off);
        if (lane == 0) {
          a.fp_sum[j] = (float)(s_excl[j] + s_cnt[j]);
          a.fp_sum[e + j] = ps;
        }
      }
    }
    // per token: pos, the drop rule, w; the row's slot in send
    if (tid < rows) {
      const int tp = s_top[tid];
      const int p = s_excl[tp] + s_dst[tid];
      const bool keep = p < a.cap;
      const int64_t t = t0 + tid;
      a.top[t] = tp;
      a.pos[t] = keep ? p : a.cap - 1;
      a.w[t] = keep ? s_topp[tid] : 0.f;
      s_dst[tid] = keep ? tp * a.cap + p : -1;
    }
    __syncthreads();
    // scatter the kept rows from shared memory
    for (int r = warp; r < rows; r += kWarps) {
      const int dst = s_dst[r];
      if (dst < 0) continue;
      const T* src = xs + r * dp;
      float* out = a.send + (int64_t)dst * d;
      if (a.vec_out) {
        for (int q = lane; q < (d >> 2); q += 32) store4(out + 4 * q, plus_zero(load4(src + 4 * q)));
      } else {
        for (int k = lane; k < d; k += 32) out[k] = __fadd_rn(to_f32(src[k]), 0.f);
      }
    }
    if (a.nbuf == 2) {
      tile = next;
      b ^= 1;
    } else {  // the buffer is free once every warp is past the ticket's barrier
      tile = next_ticket();
      if (tile < a.tiles) load(tile, 0);
    }
  }

  // zero fill, by the first zero_blocks blocks (the rest are done): wait for
  // the last tile's inclusive counts (the totals)
  if (blockIdx.x >= a.zero_blocks) return;
  if (tid < e) {
    int total = 0;
    if (a.tiles > 0) {
      const unsigned long long* st = a.status + (int64_t)tid * a.tiles + a.tiles - 1;
      unsigned long long v;
      while ((unsigned)((v = ld_relaxed(st)) >> 32) != kInclusive) __nanosleep(64);
      total = (int)(unsigned)v;
    } else if (blockIdx.x == 0) {
      a.fp_sum[tid] = 0.f;
      a.fp_sum[e + tid] = 0.f;
    }
    s_fill[tid] = min(total, a.cap);
  }
  __syncthreads();
  zero_unfilled(a.send, s_fill, e, a.cap, d, a.zero_blocks);
}

// ---------------------------------------------------------------------------
// K7: combine
// ---------------------------------------------------------------------------

// A top or pos outside [0, E) x [0, C) combines to zeros, as its one-hot row
// in the TPU kernel's mask would. A warp per row; each lane keeps kRowLoads
// 16-byte loads in flight.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    moe_combine_kernel(const float* __restrict__ back, const int* __restrict__ top,
                       const int* __restrict__ pos, const float* __restrict__ w,
                       float* __restrict__ out, int64_t n, int d, int e, int cap) {
  const int lane = threadIdx.x & 31;
  const int64_t t = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= n) return;
  const int tp = top[t], pc = pos[t];
  const bool valid = tp >= 0 && tp < e && pc >= 0 && pc < cap;
  const float wt = valid ? w[t] : 0.f;
  const float* src = back + (valid ? ((int64_t)tp * cap + pc) * d : 0);
  float* dst = out + t * d;
  if constexpr (VEC) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int q0 = lane; q0 < (d >> 2); q0 += 32 * kRowLoads) {
      float4 b[kRowLoads];
#pragma unroll
      for (int u = 0; u < kRowLoads; ++u) {
        const int q = q0 + 32 * u;
        b[u] = (valid && q < (d >> 2)) ? __ldg(s4 + q) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kRowLoads; ++u) {
        const int q = q0 + 32 * u;
        if (q < (d >> 2))
          store4(dst + 4 * q, plus_zero(make_float4(__fmul_rn(wt, b[u].x), __fmul_rn(wt, b[u].y),
                                                    __fmul_rn(wt, b[u].z), __fmul_rn(wt, b[u].w))));
      }
    }
  } else {
    for (int k = lane; k < d; k += 32)
      dst[k] = valid ? __fadd_rn(__fmul_rn(wt, __ldg(src + k)), 0.f) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// K6 backward: a warp per token
// ---------------------------------------------------------------------------

struct DispatchBwdArgs {
  const float* probs;   // [n, e], saved by the forward
  const int* top;
  const int* pos;
  const float* w;
  const float* d_send;  // [e, cap, d]
  const float* d_w;     // [n]
  const float* d_fp1;   // [e]: the cotangent of fp_sum[1]
  const float* gate;    // [d, e]
  void* d_x;            // [n, d] in x's dtype, or null (x needs no gradient)
  float* d_logits;      // [n, e]
  long long n;
  int d, dp, e, cap;
};

template <typename T, int EP, bool VEC>
__global__ void __launch_bounds__(kThreads) moe_dispatch_bwd_kernel(const DispatchBwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* gs = reinterpret_cast<float*>(smem);  // [EP, dp]: the gate transposed
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e = a.e, d = a.d, dp = a.dp;
  if (a.d_x) {
    stage_gate<EP>(gs, a.gate, d, dp, e);
    __syncthreads();
  }
  for (int64_t t = (int64_t)blockIdx.x * kWarps + warp; t < a.n; t += (int64_t)gridDim.x * kWarps) {
    const int tp = a.top[t];
    const bool keep = a.w[t] != 0.f;  // w = top_p * keep, and top_p >= 1/E > 0
    float p = 0.f, dpr = 0.f;
    if (lane < e) {
      p = a.probs[t * e + lane];
      // fp_sum[1] = sum of probs; w = probs[top] * keep (to the argmax alone)
      dpr = a.d_fp1[lane];
      if (lane == tp && keep) dpr += a.d_w[t];
    }
    float dot = dpr * p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(kFull, dot, off);
    const float dl = p * (dpr - dot);
    if (lane < e) a.d_logits[t * e + lane] = dl;
    if (!a.d_x) continue;
    float dlj[EP];
#pragma unroll
    for (int j = 0; j < EP; ++j) dlj[j] = __shfl_sync(kFull, dl, j);
    const float* row = keep ? a.d_send + ((int64_t)tp * a.cap + a.pos[t]) * d : nullptr;
    T* out = static_cast<T*>(a.d_x) + t * d;
    if constexpr (VEC) {
      const float4* r4 = reinterpret_cast<const float4*>(row);
      for (int q0 = lane; q0 < (d >> 2); q0 += 32 * kRowLoads) {
        float4 r[kRowLoads];
#pragma unroll
        for (int u = 0; u < kRowLoads; ++u) {
          const int q = q0 + 32 * u;
          r[u] = (row && q < (d >> 2)) ? __ldg(r4 + q) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kRowLoads; ++u) {
          const int q = q0 + 32 * u;
          if (q >= (d >> 2)) break;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int j = 0; j < EP; ++j) {
            if (j >= e) break;
            const float4 g = reinterpret_cast<const float4*>(gs + j * dp)[q];
            v.x = fmaf(dlj[j], g.x, v.x);
            v.y = fmaf(dlj[j], g.y, v.y);
            v.z = fmaf(dlj[j], g.z, v.z);
            v.w = fmaf(dlj[j], g.w, v.w);
          }
          if (row) {
            v.x += r[u].x;
            v.y += r[u].y;
            v.z += r[u].z;
            v.w += r[u].w;
          }
          store4(out + 4 * q, v);
        }
      }
    } else {
      for (int k = lane; k < d; k += 32) {
        float v = 0.f;
#pragma unroll
        for (int j = 0; j < EP; ++j) {
          if (j >= e) break;
          v = fmaf(dlj[j], gs[j * dp + k], v);
        }
        if (row) v += __ldg(row + k);
        out[k] = from_f32<T>(v);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K7 backward: a warp per token, rows taken kRowsPerTicket at a time by ticket
// ---------------------------------------------------------------------------

struct CombineBwdArgs {
  const float* back;  // [e, cap, d]
  const int* top;
  const int* pos;
  const float* w;
  const float* g;     // [n, d]
  float* d_back;      // [e, cap, d], or null (back needs no gradient)
  float* d_w;         // [n], or null
  int* ticket;        // [2]: the chunk ticket, then the chunks done; zeroed before the launch
  int* claims;        // [e * cap]: tokens with w != 0 per slot; zeroed before the launch
  long long n;
  int d, e, cap, chunks;
  int zero_blocks;
};

// The slot's row of d_back as the plain version's index_add_ forms it: the
// sum, in token order, of w * g over the tokens with w != 0 routed to it.
// A warp scans every token: only for a slot two or more tokens claimed.
__device__ void combine_bwd_sum(const CombineBwdArgs& a, int64_t slot) {
  constexpr int kCols = 4;  // columns a lane
  const int lane = threadIdx.x & 31;
  float* dst = a.d_back + slot * a.d;
  for (int k0 = 0; k0 < a.d; k0 += 32 * kCols) {
    float acc[kCols];
#pragma unroll
    for (int u = 0; u < kCols; ++u) acc[u] = 0.f;
    for (int64_t t0 = 0; t0 < a.n; t0 += 32) {
      const int64_t t = t0 + lane;
      bool hit = false;
      float wt = 0.f;
      if (t < a.n) {
        const int tp = a.top[t], pc = a.pos[t];
        wt = a.w[t];
        hit = wt != 0.f && tp >= 0 && tp < a.e && pc >= 0 && pc < a.cap &&
              (int64_t)tp * a.cap + pc == slot;
      }
      for (unsigned m = __ballot_sync(kFull, hit); m; m &= m - 1u) {
        const int src = __ffs(m) - 1;
        const float ws = __shfl_sync(kFull, wt, src);
        const float* gr = a.g + (t0 + src) * a.d;
#pragma unroll
        for (int u = 0; u < kCols; ++u) {
          const int k = k0 + 32 * u + lane;
          if (k < a.d) acc[u] = __fadd_rn(acc[u], __fmul_rn(__ldg(gr + k), ws));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      const int k = k0 + 32 * u + lane;
      if (k < a.d) dst[k] = __fadd_rn(acc[u], 0.f);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads) moe_combine_bwd_kernel(const CombineBwdArgs a) {
  __shared__ int s_chunk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int d = a.d;
  int mine = 0;  // chunks this block did
  for (;;) {
    if (tid == 0) s_chunk = atomicAdd(a.ticket, 1);
    __syncthreads();
    const int chunk = s_chunk;
    if (chunk >= a.chunks) break;
    ++mine;
    for (int i = warp; i < kRowsPerTicket; i += kWarps) {
      const int64_t t = (int64_t)chunk * kRowsPerTicket + i;
      if (t >= a.n) break;
      const int tp = a.top[t], pc = a.pos[t];
      const float wt = a.w[t];
      const bool valid = tp >= 0 && tp < a.e && pc >= 0 && pc < a.cap;
      const int64_t slot = valid ? (int64_t)tp * a.cap + pc : 0;
      // a token with w != 0 claims its slot; the first claimant writes it
      int claim = 1;
      if (a.d_back && valid && wt != 0.f && lane == 0) claim = atomicAdd(a.claims + slot, 1);
      const float* gr = a.g + t * d;
      const float* br = a.back + slot * d;
      float dot = 0.f;
      const bool need_b = a.d_w && valid;
      float* dr = nullptr;
      if constexpr (VEC) {
        const float4* g4 = reinterpret_cast<const float4*>(gr);
        const float4* b4 = reinterpret_cast<const float4*>(br);
        for (int q0 = 0; q0 < (d >> 2); q0 += 32 * kRowLoads) {  // the same trips for every lane
          float4 gv[kRowLoads], bv[kRowLoads];
#pragma unroll
          for (int u = 0; u < kRowLoads; ++u) {
            const int q = q0 + 32 * u + lane;
            const bool in = q < (d >> 2);
            gv[u] = in ? __ldg(g4 + q) : make_float4(0.f, 0.f, 0.f, 0.f);
            bv[u] = (in && need_b) ? __ldg(b4 + q) : make_float4(0.f, 0.f, 0.f, 0.f);
          }
          // the claim's answer, once the first loads are in flight
          if (q0 == 0) dr = __shfl_sync(kFull, claim, 0) == 0 ? a.d_back + slot * d : nullptr;
#pragma unroll
          for (int u = 0; u < kRowLoads; ++u) {
            const int q = q0 + 32 * u + lane;
            if (q >= (d >> 2)) break;
            dot = fmaf(gv[u].x, bv[u].x, dot);
            dot = fmaf(gv[u].y, bv[u].y, dot);
            dot = fmaf(gv[u].z, bv[u].z, dot);
            dot = fmaf(gv[u].w, bv[u].w, dot);
            if (dr)
              store4(dr + 4 * q, plus_zero(make_float4(__fmul_rn(gv[u].x, wt), __fmul_rn(gv[u].y, wt),
                                                       __fmul_rn(gv[u].z, wt), __fmul_rn(gv[u].w, wt))));
          }
        }
      } else {
        dr = __shfl_sync(kFull, claim, 0) == 0 ? a.d_back + slot * d : nullptr;
        for (int k = lane; k < d; k += 32) {
          const float gs = __ldg(gr + k);
          if (need_b) dot = fmaf(gs, __ldg(br + k), dot);
          if (dr) dr[k] = __fadd_rn(__fmul_rn(gs, wt), 0.f);
        }
      }
      if (a.d_w) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(kFull, dot, off);
        if (lane == 0) a.d_w[t] = dot;
      }
    }
    __syncthreads();  // every warp is done with s_chunk before it is written again
  }
  if (!a.d_back) return;
  // publish: this block's rows of d_back, then its chunks done
  __threadfence();
  __syncthreads();
  if (tid == 0 && mine) atomicAdd(a.ticket + 1, mine);
  if (blockIdx.x >= a.zero_blocks) return;  // the first zero_blocks blocks (~64 KB each) finish
  if (tid == 0)
    while (ld_relaxed_i32(a.ticket + 1) < a.chunks) __nanosleep(64);
  __syncthreads();
  __threadfence();  // every claim and first write is seen before the slots are read
  // this block's share of the slots: zero the unclaimed, sum the shared
  const int64_t slots = (int64_t)a.e * a.cap;
  const int64_t lo = slots * blockIdx.x / a.zero_blocks, hi = slots * (blockIdx.x + 1) / a.zero_blocks;
  for (int64_t s0 = lo + 32 * warp; s0 < hi; s0 += 32 * kWarps) {
    const int64_t s = s0 + lane;
    const int c = s < hi ? __ldcg(a.claims + s) : 1;
    for (unsigned m = __ballot_sync(kFull, c != 1); m; m &= m - 1u) {
      const int r = __ffs(m) - 1;
      const int64_t slot = s0 + r;
      if (__shfl_sync(kFull, c, r) == 0) {
        float* dr = a.d_back + slot * d;
        if constexpr (VEC) {
          for (int q = lane; q < (d >> 2); q += 32) store4(dr + 4 * q, make_float4(0.f, 0.f, 0.f, 0.f));
        } else {
          for (int k = lane; k < d; k += 32) dr[k] = 0.f;
        }
      } else {
        combine_bwd_sum(a, slot);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

std::mutex g_mu;  // guards the caches below

int current_device() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev >= 0 && dev < 64 ? dev : 0;
}

int sm_count() {
  static int per_device[64] = {0};
  const int dev = current_device();
  std::lock_guard<std::mutex> lock(g_mu);
  if (!per_device[dev]) cudaDeviceGetAttribute(&per_device[dev], cudaDevAttrMultiProcessorCount, dev);
  return per_device[dev] > 0 ? per_device[dev] : 1;
}

// Per kernel instantiation and device: opt in to all the shared memory it
// may use (once), and the blocks of kThreads that fit on one SM at `dyn`
// bytes of dynamic shared memory (cached). 0 if `dyn` does not fit.
template <typename Kernel>
int resident_blocks(Kernel kernel, size_t dyn, cudaError_t* err) {
  struct Entry {
    bool init = false;
    size_t max_dyn = 0;
    std::unordered_map<size_t, int> blocks;
  };
  static std::unordered_map<const void*, Entry> cache[64];
  const int dev = current_device();
  std::lock_guard<std::mutex> lock(g_mu);
  Entry& ent = cache[dev][(const void*)kernel];
  if (!ent.init) {
    int optin = 0;
    cudaFuncAttributes attr;
    if ((*err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
        cudaSuccess)
      return 0;
    if ((*err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return 0;
    ent.max_dyn = (size_t)optin - attr.sharedSizeBytes;
    if ((*err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)ent.max_dyn)) != cudaSuccess)
      return 0;
    ent.init = true;
  }
  if (dyn > ent.max_dyn) return 0;
  auto it = ent.blocks.find(dyn);
  if (it != ent.blocks.end()) return it->second;
  int b = 0;
  if ((*err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kernel, kThreads, dyn)) !=
      cudaSuccess)
    return 0;
  ent.blocks[dyn] = b;
  return b;
}

int64_t clamp_grid(int64_t want, int per_sm) {
  const int64_t most = (int64_t)per_sm * sm_count();
  return want < 1 ? 1 : (want < most ? want : most);
}

// enough blocks to zero `bytes` of unfilled rows at ~64 KB a block
int64_t fill_blocks(int64_t bytes) { return (bytes + 65535) / 65536; }

// Two x buffers (the next tile's copy overlaps this one's work) where
// they and the gate fit in one block's shared memory, else one.
template <typename T, int EP>
cudaError_t dispatch_ep(DispatchArgs a, cudaStream_t s) {
  auto kernel = moe_dispatch_kernel<T, EP>;
  cudaError_t err = cudaSuccess;
  int per_sm = 0;
  size_t dyn = 0;
  for (a.nbuf = a.async_copy ? 2 : 1; a.nbuf >= 1; --a.nbuf) {
    dyn = (size_t)a.nbuf * kTile * a.dp * sizeof(T) + (size_t)EP * a.dp * sizeof(float);
    per_sm = resident_blocks(kernel, dyn, &err);
    if (err != cudaSuccess) return err;
    if (per_sm > 0) break;
  }
  if (per_sm == 0) return cudaErrorInvalidValue;
  a.tiles = (int)((a.n + kTile - 1) / kTile);
  err = cudaMemsetAsync(a.ticket, 0, sizeof(int) * 2 + sizeof(unsigned long long) * 2 * a.e * a.tiles, s);
  if (err != cudaSuccess) return err;
  const int64_t fill = fill_blocks((int64_t)a.e * a.cap * a.d * 4);
  const int64_t grid = clamp_grid(a.tiles > fill ? a.tiles : fill, per_sm);
  a.zero_blocks = (int)(fill < grid ? fill : grid);
  kernel<<<(unsigned)grid, kThreads, dyn, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_t(DispatchArgs a, cudaStream_t s) {
  if (a.e <= 8) return dispatch_ep<T, 8>(a, s);
  if (a.e <= 16) return dispatch_ep<T, 16>(a, s);
  return dispatch_ep<T, 32>(a, s);
}

template <typename T, int EP>
cudaError_t dispatch_bwd_ep(DispatchBwdArgs a, bool vec, cudaStream_t s) {
  const size_t dyn = a.d_x ? (size_t)EP * a.dp * sizeof(float) : 0;
  cudaError_t err = cudaSuccess;
  auto kernel = vec ? moe_dispatch_bwd_kernel<T, EP, true> : moe_dispatch_bwd_kernel<T, EP, false>;
  const int per_sm = resident_blocks(kernel, dyn, &err);
  if (err != cudaSuccess) return err;
  if (per_sm == 0) return cudaErrorInvalidValue;
  kernel<<<(unsigned)clamp_grid((a.n + kWarps - 1) / kWarps, per_sm), kThreads, dyn, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd_t(DispatchBwdArgs a, bool vec, cudaStream_t s) {
  if (a.e <= 8) return dispatch_bwd_ep<T, 8>(a, vec, s);
  if (a.e <= 16) return dispatch_bwd_ep<T, 16>(a, vec, s);
  return dispatch_bwd_ep<T, 32>(a, vec, s);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// Plain C entry points for ctypes; each returns the first CUDA error of its
// launch (0 = ok). x dtype codes: 0 = float32, 1 = bfloat16.
//
// Dispatch: send [e, cap, d], top/pos/w [n], fp_sum [2, e], probs [n, e] or
// null; scratch: status int32 [2 + 4 * e * ceil(n / 32)] (32 = kTile),
// 8-byte aligned: the ticket, then the tiles' 64-bit count and probability-
// sum words (cleared here on the stream).
extern "C" int dtpu_moe_dispatch_launch(const void* x, int x_dt, const float* gate, float* send,
                                        int* top, int* pos, float* w, float* fp_sum, float* probs,
                                        int* status, long long n, int d, int e, int cap,
                                        void* stream) {
  if (n < 0 || d <= 0 || e <= 0 || e > kMaxExperts || cap <= 0) return (int)cudaErrorInvalidValue;
  if (x_dt != kF32 && x_dt != kBF16) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(status) & 7u) return (int)cudaErrorInvalidValue;
  const int item = x_dt == kF32 ? 4 : 2;
  DispatchArgs a{x, gate, send, top, pos, w, fp_sum, probs, status,
                 reinterpret_cast<unsigned long long*>(status + 2), n, d, (d + 3) & ~3, e, cap, 0,
                 aligned16(x) && (d * item) % 16 == 0, (d & 3) == 0, 1, 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(x_dt == kF32 ? dispatch_t<float>(a, s) : dispatch_t<__nv_bfloat16>(a, s));
}

// Combine: back [e, cap, d] f32, top/pos int32 and w f32 [n] -> out [n, d] f32.
extern "C" int dtpu_moe_combine_launch(const float* back, const int* top, const int* pos,
                                       const float* w, float* out, long long n, int d, int e,
                                       int cap, void* stream) {
  if (n <= 0 || d <= 0 || e <= 0 || cap <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t blocks = (n + kWarps - 1) / kWarps;
  if (d % 4 == 0 && aligned16(back) && aligned16(out))
    moe_combine_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(back, top, pos, w, out, n, d, e, cap);
  else
    moe_combine_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(back, top, pos, w, out, n, d, e, cap);
  return (int)cudaGetLastError();
}

// Dispatch backward: probs [n, e] (the forward's), top/pos/w/d_w [n], d_send
// [e, cap, d], d_fp1 [e], gate [d, e] -> d_logits [n, e] f32 and, unless
// d_x is null, d_x [n, d] in x's dtype.
extern "C" int dtpu_moe_dispatch_bwd_launch(const float* probs, const int* top, const int* pos,
                                            const float* w, const float* d_send, const float* d_w,
                                            const float* d_fp1, const float* gate, void* d_x,
                                            int x_dt, float* d_logits, long long n, int d, int e,
                                            int cap, void* stream) {
  if (n <= 0 || d <= 0 || e <= 0 || e > kMaxExperts || cap <= 0) return (int)cudaErrorInvalidValue;
  if (x_dt != kF32 && x_dt != kBF16) return (int)cudaErrorInvalidValue;
  DispatchBwdArgs a{probs, top, pos, w, d_send, d_w, d_fp1, gate, d_x, d_logits, n, d,
                    (d + 3) & ~3, e, cap};
  const int item = x_dt == kF32 ? 4 : 2;
  const bool vec = d % 4 == 0 && aligned16(d_send) &&
                   (d_x == nullptr || (aligned16(d_x) && (d * item) % 8 == 0));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(x_dt == kF32 ? dispatch_bwd_t<float>(a, vec, s)
                            : dispatch_bwd_t<__nv_bfloat16>(a, vec, s));
}

// Combine backward: back [e, cap, d], top/pos/w [n], g [n, d] -> d_back
// [e, cap, d] (or null) and d_w [n] (or null); scratch int32 [2 + e * cap]
// (the ticket, the chunks done, then a claim count per slot; cleared here on
// the stream).
extern "C" int dtpu_moe_combine_bwd_launch(const float* back, const int* top, const int* pos,
                                           const float* w, const float* g, float* d_back,
                                           float* d_w, int* scratch, long long n, int d, int e,
                                           int cap, void* stream) {
  if (n < 0 || d <= 0 || e <= 0 || e > kMaxExperts || cap <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CombineBwdArgs a{back, top, pos, w, g, d_back, d_w, scratch, scratch + 2, n, d, e, cap,
                   (int)((n + kRowsPerTicket - 1) / kRowsPerTicket), 0};
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(int) * (2 + (d_back ? (size_t)e * cap : 0)), s);
  if (err != cudaSuccess) return (int)err;
  const bool vec = d % 4 == 0 && aligned16(back) && aligned16(g) && (!d_back || aligned16(d_back));
  auto kernel = vec ? moe_combine_bwd_kernel<true> : moe_combine_bwd_kernel<false>;
  const int per_sm = resident_blocks(kernel, 0, &err);
  if (err != cudaSuccess) return (int)err;
  const int64_t fill = d_back ? fill_blocks((int64_t)e * cap * d * 4) : 0;
  const int64_t grid = clamp_grid(a.chunks > fill ? a.chunks : fill, per_sm);
  a.zero_blocks = (int)(fill < grid ? fill : grid);
  kernel<<<(unsigned)grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
