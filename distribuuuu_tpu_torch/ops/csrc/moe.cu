// Switch-MoE dispatch (K6) and combine (K7) for Hopper (sm_90a).
//
// Replaces distribuuuu_tpu/ops/moe_kernel.py::_dispatch_kernel and
// ::_combine_kernel (the Pallas TPU kernels behind fused_moe_dispatch and
// fused_moe_combine). For x [n, D] (f32 or bf16) and the router gate [D, E]
// (f32), dispatch computes per token
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
// What bounds them on this card: bytes and launches. Dispatch does 2.n.D.E
// flops (0.017 GFLOP at n 8192, D 128, E 8) against reading x and writing
// send; combine is a gather. Both are a few MB, microseconds at HBM rate,
// so the fixed cost of each launch is what a caller sees.
//
// Design. The TPU kernel walks the token tiles in order and carries each
// expert's running slot count in SMEM from one tile to the next. Hopper
// blocks run in no order, so dispatch is three launches on one stream:
//
//  (a) route: one block per tile of kTile tokens, the gate staged in shared
//      memory, one warp per token (its lanes split D, a butterfly sums the E
//      partial logits). Each token's rank among the earlier tokens of its
//      tile that chose the same expert comes from __match_any_sync and a
//      popcount, plus the counts of earlier warps from shared memory: an
//      in-order count with no atomics (atomic order would scramble slots).
//      The block writes top, top_p and the rank per token, and its tile's
//      per-expert counts and sums of probs.
//  (b) scan: one warp per expert turns the tile counts into exclusive int32
//      offsets and sums the tiles' probs in a fixed order, so fp_sum is
//      deterministic.
//  (c) scatter: pos = offset + rank, the drop rule, and a copy of each kept
//      row into send with 16-byte accesses where the row allows; the slots
//      past each expert's count are zeroed by the same launch, so send is
//      written once and needs no memset.
//
// Combine is one launch, one warp per token, 16-byte loads and stores where
// the row allows. Both kernels add +0.0f to what they store, so a -0 comes
// out as +0, as from the plain version's one-hot contraction; every other
// value is unchanged, which keeps the card's results bitwise equal to the
// plain version's on the same routing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum DType : int { kF32 = 0, kBF16 = 1 };

constexpr int kTile = 64;           // tokens per route block; the slot scan's granularity
constexpr int kRouteWarps = 8;      // 256 threads; kTile / kRouteWarps tokens per warp
constexpr int kTokPerWarp = kTile / kRouteWarps;
constexpr int kRankWarps = kTile / 32;
constexpr int kRowWarps = 8;        // scatter and combine: 256 threads, one warp per row
constexpr int kRowsPerBlock = 32;
constexpr int kMaxExperts = 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// ---------------------------------------------------------------------------
// (a) route
// ---------------------------------------------------------------------------

// EP: E padded to a multiple of 4, so each gate row is float4-aligned in
// shared memory; the padding columns are zero and never chosen.
template <typename T, int EP>
__global__ void __launch_bounds__(kRouteWarps * 32)
    moe_route_kernel(const T* __restrict__ x, const float* __restrict__ gate,
                     int* __restrict__ top, float* __restrict__ top_p, int* __restrict__ rank,
                     int* __restrict__ counts, float* __restrict__ psum, int64_t n, int d,
                     int e) {
  extern __shared__ float4 smem4[];
  float* sg = reinterpret_cast<float*>(smem4);  // [d, EP]
  __shared__ int s_top[kTile];
  __shared__ int s_wcnt[kRankWarps][EP];
  __shared__ float s_psum[kRouteWarps][EP];

  for (int i = threadIdx.x; i < d * EP; i += blockDim.x) {
    const int k = i / EP, j = i - k * EP;
    sg[i] = j < e ? gate[(int64_t)k * e + j] : 0.f;
  }
  for (int i = threadIdx.x; i < kRankWarps * EP; i += blockDim.x) (&s_wcnt[0][0])[i] = 0;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t tile0 = (int64_t)blockIdx.x * kTile;
  float psum_lane = 0.f;  // lane j < e: probs[:, j] summed over this warp's tokens in order
  for (int i = 0; i < kTokPerWarp; ++i) {
    const int local = warp * kTokPerWarp + i;
    const int64_t t = tile0 + local;
    if (t >= n) {  // the ragged last tile: claims no slot, adds nothing
      if (lane == 0) s_top[local] = -1;
      continue;
    }
    float acc[EP];
#pragma unroll
    for (int j = 0; j < EP; ++j) acc[j] = 0.f;
    const T* xr = x + t * d;
    for (int k = lane; k < d; k += 32) {
      const float xv = to_f32(xr[k]);
      const float4* g4 = reinterpret_cast<const float4*>(sg + k * EP);
#pragma unroll
      for (int q = 0; q < EP / 4; ++q) {
        const float4 g = g4[q];
        acc[4 * q + 0] = fmaf(xv, g.x, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(xv, g.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(xv, g.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(xv, g.w, acc[4 * q + 3]);
      }
    }
    // a xor butterfly adds the same pairs in the same order on every lane,
    // so all lanes end with identical logits
#pragma unroll
    for (int j = 0; j < EP; ++j) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[j] += __shfl_xor_sync(kFull, acc[j], off);
    }
    float m = acc[0];
#pragma unroll
    for (int j = 1; j < EP; ++j)
      if (j < e) m = fmaxf(m, acc[j]);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < EP; ++j) {
      acc[j] = j < e ? expf(acc[j] - m) : 0.f;
      s += acc[j];
    }
    // argmax over the probabilities, ties to the lowest index (jnp.argmax)
    int best = 0;
    float best_p = acc[0] / s;
    if (lane == 0) psum_lane += best_p;
#pragma unroll
    for (int j = 1; j < EP; ++j) {
      if (j < e) {
        const float p = acc[j] / s;
        if (p > best_p) {
          best_p = p;
          best = j;
        }
        if (lane == j) psum_lane += p;
      }
    }
    if (lane == 0) {
      top[t] = best;
      top_p[t] = best_p;
      s_top[local] = best;
    }
  }
  if (lane < EP) s_psum[warp][lane] = psum_lane;
  __syncthreads();

  // rank within the tile: lanes of the same expert in this warp below me,
  // then the earlier warps' counts of that expert
  int tp = -1, r = 0;
  if (threadIdx.x < kTile) {  // whole warps: the match is warp-uniform
    tp = s_top[threadIdx.x];
    const unsigned same = __match_any_sync(kFull, tp);
    r = __popc(same & ((1u << lane) - 1u));
    if (tp >= 0 && r == 0) s_wcnt[warp][tp] = __popc(same);
  }
  __syncthreads();
  if (threadIdx.x < kTile && tp >= 0) {
    for (int w = 0; w < warp; ++w) r += s_wcnt[w][tp];
    rank[tile0 + threadIdx.x] = r;
  }
  if (threadIdx.x < e) {
    int c = 0;
    float ps = 0.f;
    for (int w = 0; w < kRankWarps; ++w) c += s_wcnt[w][threadIdx.x];
    for (int w = 0; w < kRouteWarps; ++w) ps += s_psum[w][threadIdx.x];
    counts[(int64_t)blockIdx.x * e + threadIdx.x] = c;
    psum[(int64_t)blockIdx.x * e + threadIdx.x] = ps;
  }
}

// ---------------------------------------------------------------------------
// (b) scan: warp j owns expert j
// ---------------------------------------------------------------------------

__global__ void moe_scan_kernel(int* __restrict__ counts, const float* __restrict__ psum,
                                int* __restrict__ totals, float* __restrict__ fp_sum,
                                int64_t tiles, int e) {
  const int j = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (j >= e) return;
  int carry = 0;
  float ps = 0.f;
  for (int64_t base = 0; base < tiles; base += 32) {
    const int64_t i = base + lane;
    const int v = i < tiles ? counts[i * e + j] : 0;
    int incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    if (i < tiles) {
      counts[i * e + j] = carry + incl - v;  // exclusive: tokens of expert j in earlier tiles
      ps += psum[i * e + j];
    }
    carry += __shfl_sync(kFull, incl, 31);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(kFull, ps, off);
  if (lane == 0) {
    totals[j] = carry;
    fp_sum[j] = (float)carry;
    fp_sum[e + j] = ps;
  }
}

// ---------------------------------------------------------------------------
// (c) scatter
// ---------------------------------------------------------------------------

// VEC: 16-byte accesses (the wrapper checks D and the alignment of x)
template <typename T, bool VEC>
__device__ __forceinline__ void copy_row(const T* __restrict__ src, float* __restrict__ dst,
                                         int d, int lane) {
  if constexpr (VEC && sizeof(T) == 4) {
    for (int k = lane * 4; k < d; k += 128) {
      float4 v = *reinterpret_cast<const float4*>(src + k);
      v.x = __fadd_rn(v.x, 0.f);
      v.y = __fadd_rn(v.y, 0.f);
      v.z = __fadd_rn(v.z, 0.f);
      v.w = __fadd_rn(v.w, 0.f);
      *reinterpret_cast<float4*>(dst + k) = v;
    }
  } else if constexpr (VEC) {  // bf16: 8 values a load
    for (int k = lane * 8; k < d; k += 256) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + k);
      const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&raw);
      float4 lo, hi;
      lo.x = __fadd_rn(to_f32(b[0]), 0.f);
      lo.y = __fadd_rn(to_f32(b[1]), 0.f);
      lo.z = __fadd_rn(to_f32(b[2]), 0.f);
      lo.w = __fadd_rn(to_f32(b[3]), 0.f);
      hi.x = __fadd_rn(to_f32(b[4]), 0.f);
      hi.y = __fadd_rn(to_f32(b[5]), 0.f);
      hi.z = __fadd_rn(to_f32(b[6]), 0.f);
      hi.w = __fadd_rn(to_f32(b[7]), 0.f);
      *reinterpret_cast<float4*>(dst + k) = lo;
      *reinterpret_cast<float4*>(dst + k + 4) = hi;
    }
  } else {
    for (int k = lane; k < d; k += 32) dst[k] = __fadd_rn(to_f32(src[k]), 0.f);
  }
}

template <bool VEC>
__device__ __forceinline__ void zero_row(float* __restrict__ dst, int d, int lane) {
  if constexpr (VEC) {
    for (int k = lane * 4; k < d; k += 128)
      *reinterpret_cast<float4*>(dst + k) = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int k = lane; k < d; k += 32) dst[k] = 0.f;
  }
}

// pos holds each token's in-tile rank on entry and pos_c on exit; w holds
// top_p on entry and w on exit
template <typename T, bool VEC>
__global__ void __launch_bounds__(kRowWarps * 32)
    moe_scatter_kernel(const T* __restrict__ x, const int* __restrict__ top,
                       int* __restrict__ pos, float* __restrict__ w,
                       const int* __restrict__ offsets, const int* __restrict__ totals,
                       float* __restrict__ send, int64_t n, int d, int e, int cap) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < kRowsPerBlock; i += kRowWarps) {
    const int64_t t = (int64_t)blockIdx.x * kRowsPerBlock + i;
    if (t >= n) break;
    const int tp = top[t];
    const int p = offsets[(t / kTile) * e + tp] + pos[t];
    __syncwarp();  // every lane has read pos[t] before lane 0 overwrites it
    const bool keep = p < cap;
    if (lane == 0) {
      pos[t] = keep ? p : cap - 1;
      if (!keep) w[t] = 0.f;
    }
    if (keep) copy_row<T, VEC>(x + t * d, send + ((int64_t)tp * cap + p) * d, d, lane);
  }
  // the slots no token filled: (j, c) with c >= totals[j]
  const int64_t rows = (int64_t)e * cap;
  for (int64_t r = (int64_t)blockIdx.x * kRowWarps + warp; r < rows;
       r += (int64_t)gridDim.x * kRowWarps) {
    const int j = (int)(r / cap);
    const int c = (int)(r - (int64_t)j * cap);
    if (c >= totals[j]) zero_row<VEC>(send + r * d, d, lane);
  }
}

// ---------------------------------------------------------------------------
// K7: combine
// ---------------------------------------------------------------------------

// A top or pos outside [0, E) x [0, C) combines to zeros, as its one-hot row
// in the TPU kernel's mask would.
template <bool VEC>
__global__ void __launch_bounds__(kRowWarps * 32)
    moe_combine_kernel(const float* __restrict__ back, const int* __restrict__ top,
                       const int* __restrict__ pos, const float* __restrict__ w,
                       float* __restrict__ out, int64_t n, int d, int e, int cap) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < kRowsPerBlock; i += kRowWarps) {
    const int64_t t = (int64_t)blockIdx.x * kRowsPerBlock + i;
    if (t >= n) break;
    const int tp = top[t], pc = pos[t];
    float* dst = out + t * d;
    if (tp < 0 || tp >= e || pc < 0 || pc >= cap) {
      zero_row<VEC>(dst, d, lane);
      continue;
    }
    const float wt = w[t];
    const float* src = back + ((int64_t)tp * cap + pc) * d;
    if constexpr (VEC) {
      for (int k = lane * 4; k < d; k += 128) {
        const float4 b = __ldg(reinterpret_cast<const float4*>(src + k));
        float4 o;
        o.x = __fadd_rn(__fmul_rn(wt, b.x), 0.f);
        o.y = __fadd_rn(__fmul_rn(wt, b.y), 0.f);
        o.z = __fadd_rn(__fmul_rn(wt, b.z), 0.f);
        o.w = __fadd_rn(__fmul_rn(wt, b.w), 0.f);
        *reinterpret_cast<float4*>(dst + k) = o;
      }
    } else {
      for (int k = lane; k < d; k += 32) dst[k] = __fadd_rn(__fmul_rn(wt, __ldg(src + k)), 0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename T, int EP>
cudaError_t launch_route(const void* x, const float* gate, int* top, float* top_p, int* rank,
                         int* counts, float* psum, int64_t n, int d, int e, int64_t tiles,
                         cudaStream_t s) {
  const size_t smem = (size_t)d * EP * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_route_kernel<T, EP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  moe_route_kernel<T, EP><<<(unsigned)tiles, kRouteWarps * 32, smem, s>>>(
      static_cast<const T*>(x), gate, top, top_p, rank, counts, psum, n, d, e);
  return cudaGetLastError();
}

template <typename T>
cudaError_t route(const void* x, const float* gate, int* top, float* top_p, int* rank,
                  int* counts, float* psum, int64_t n, int d, int e, int64_t tiles,
                  cudaStream_t s) {
  if (e <= 4) return launch_route<T, 4>(x, gate, top, top_p, rank, counts, psum, n, d, e, tiles, s);
  if (e <= 8) return launch_route<T, 8>(x, gate, top, top_p, rank, counts, psum, n, d, e, tiles, s);
  if (e <= 16)
    return launch_route<T, 16>(x, gate, top, top_p, rank, counts, psum, n, d, e, tiles, s);
  return launch_route<T, 32>(x, gate, top, top_p, rank, counts, psum, n, d, e, tiles, s);
}

template <typename T>
cudaError_t scatter(const void* x, const int* top, int* pos, float* w, const int* offsets,
                    const int* totals, float* send, int64_t n, int d, int e, int cap, int vec,
                    cudaStream_t s) {
  // enough blocks for the tokens, and for the zero fill when n is small
  int64_t blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  const int64_t fill = ((int64_t)e * cap + 8 * kRowWarps - 1) / (8 * kRowWarps);
  if (blocks < fill) blocks = fill;
  const T* xt = static_cast<const T*>(x);
  if (vec)
    moe_scatter_kernel<T, true><<<(unsigned)blocks, kRowWarps * 32, 0, s>>>(
        xt, top, pos, w, offsets, totals, send, n, d, e, cap);
  else
    moe_scatter_kernel<T, false><<<(unsigned)blocks, kRowWarps * 32, 0, s>>>(
        xt, top, pos, w, offsets, totals, send, n, d, e, cap);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes; each returns the first CUDA error of its
// launches (0 = ok). x dtype codes: 0 = float32, 1 = bfloat16.
//
// Dispatch: send [e, cap, d], top/pos/w [n], fp_sum [2, e]; scratch: counts
// int32 [tiles * e + e] and psum f32 [tiles * e], tiles = ceil(n / 64).
extern "C" int dtpu_moe_dispatch_launch(const void* x, int x_dt, const float* gate, float* send,
                                        int* top, int* pos, float* w, float* fp_sum, int* counts,
                                        float* psum, long long n, int d, int e, int cap, int vec,
                                        void* stream) {
  if (n < 0 || d <= 0 || e <= 0 || e > kMaxExperts || cap <= 0) return (int)cudaErrorInvalidValue;
  if (x_dt != kF32 && x_dt != kBF16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = (n + kTile - 1) / kTile;
  int* totals = counts + tiles * e;
  cudaError_t err = cudaSuccess;
  if (tiles > 0) {
    err = x_dt == kF32 ? route<float>(x, gate, top, w, pos, counts, psum, n, d, e, tiles, s)
                       : route<__nv_bfloat16>(x, gate, top, w, pos, counts, psum, n, d, e, tiles, s);
    if (err != cudaSuccess) return (int)err;
  }
  moe_scan_kernel<<<1, 32 * e, 0, s>>>(counts, psum, totals, fp_sum, tiles, e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = x_dt == kF32
            ? scatter<float>(x, top, pos, w, counts, totals, send, n, d, e, cap, vec, s)
            : scatter<__nv_bfloat16>(x, top, pos, w, counts, totals, send, n, d, e, cap, vec, s);
  return (int)err;
}

// Combine: back [e, cap, d] f32, top/pos int32 and w f32 [n] -> out [n, d] f32.
extern "C" int dtpu_moe_combine_launch(const float* back, const int* top, const int* pos,
                                       const float* w, float* out, long long n, int d, int e,
                                       int cap, int vec, void* stream) {
  if (n <= 0 || d <= 0 || e <= 0 || cap <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  if (vec)
    moe_combine_kernel<true><<<(unsigned)blocks, kRowWarps * 32, 0, s>>>(back, top, pos, w, out,
                                                                        n, d, e, cap);
  else
    moe_combine_kernel<false><<<(unsigned)blocks, kRowWarps * 32, 0, s>>>(back, top, pos, w,
                                                                         out, n, d, e, cap);
  return (int)cudaGetLastError();
}
