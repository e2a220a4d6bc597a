// Fused biased attention for Hopper (sm_90a): out = softmax(q.k^T + bias) . v.
//
// Replaces the four Pallas TPU kernels of distribuuuu_tpu/ops/attention.py:
//   _attn_kernel          (:188)  K2  one (batch*head) tile, bias tensor
//   _attn_kernel_blk      (:278)  K4  blockwise online softmax, bias tensor
//   _attn_kernel_abs_blk  (:311)  K5  K4 with the bias formed from the [L, D] table
//   _attn_kernel_abs      (:462)  K3  K2 with the bias formed from the [L, D] table
// The TPU needed two tilings because a whole [L, L] tile had to fit VMEM; here
// one kernel covers both: a thread block owns one (batch*head, 64-query tile)
// and loops over 64-key tiles with an online softmax, so any L runs the same
// code. The last query and key tiles are ragged (196 = 3 * 64 + 4) and masked.
//
// Per (query row r, key tile):
//     s   = q_r . k_c (f32 accumulate)  + bias[r, c]       (bias mode)
//     s   = q_r . (k_c + emb_c)         (f32)              (table mode: = q.k + q.emb)
//     m'  = max(m, max_c s);  p_c = exp(s - m');  alpha = exp(m - m')
//     l   = l * alpha + sum_c p_c
//     acc = acc * alpha + sum_c round_to(T, p_c) * v_c    (f32 accumulate)
// and at the end out_r = round_to(T, acc / l). This is K4's rounding: p is
// cast to the value dtype before it is normalised. K2 normalises first; the
// two differ by one rounding of p, which the tests' tolerances cover.
//
// What bounds it on this card: the function moves q, k, v, the bias and the
// output once (at batch 128, 224^2: 102.8 MB of bf16 q/k/v/out plus a 39.3 MB
// bf16 bias) and does 10.1 GFLOP, which the tensor cores would finish in about
// a quarter of the bytes' time: the function is bound by bytes. What the
// design does about the bytes: the logits and p never leave shared memory; the
// bias is read in the dtype the model produced (bf16 widens exactly to f32,
// half the bytes of widening it first, as the TPU path did); in table mode the
// [B, N, L, L] product is never formed in device memory at all. This first
// version runs its products as scalar f32 FMAs on CUDA cores (register tiles of
// 4 x 4 logits and 4 x 8 outputs per thread, operands from shared memory), so
// it is bound by those FMAs (>= 150 us at the shape above), not by bytes.
// Tiles of q, k, v go from device to shared memory as 16-byte loads where the
// rows allow (the MHSA shapes), a batch of them in flight per thread before
// any is stored, so that load latency is not paid once per element.
// Tensor cores (mma.sync / wgmma), TMA loads and a pipelined key loop are
// later work. No fast-math: expf and the division are the accurate ones.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum DType : int { kF32 = 0, kBF16 = 1, kTable = -1 };

constexpr int BQ = 64;          // queries per block
constexpr int BK = 64;          // keys per tile
constexpr int DMAX = 128;       // largest D and Dv the kernel takes
constexpr int THREADS = 256;    // 16 x 16: each thread owns 4 rows x (4 keys | 8 values)
constexpr int QK_STRIDE = DMAX + 4;  // f32 row stride of the Q and K/V tiles (16-byte rows,
                                     // conflict-free float4 reads down a column of rows)
constexpr int S_STRIDE = BK + 16;    // f32 row stride of the logits tile: rows ty and ty + 1
                                     // of one warp land 16 banks apart
constexpr size_t SMEM_BYTES =
    sizeof(float) * (size_t)(BQ * QK_STRIDE + BK * QK_STRIDE + BQ * S_STRIDE + 3 * BQ);

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

// round_to(T, x) kept in f32: the value p takes after p.astype(v.dtype)
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f32(from_f32<T>(v)); }

struct Params {
  const void* q;
  long long q_sb, q_sn, q_sl;
  const void* k;
  long long k_sb, k_sn, k_sl;
  const void* v;
  long long v_sb, v_sn, v_sl;
  const void* bias;  // [B, N, L, L] (bias mode)
  long long b_sb, b_sn, b_sl;
  const void* emb;   // [L, D] (table mode)
  long long e_sl;
  void* out;         // contiguous [B, N, L, Dv]
  int heads, L, D, Dv;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Elements of T in one 16-byte load.
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int N = 4;
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
};

template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float (&out)[Chunk<T>::N]);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& raw, float (&out)[4]) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& raw, float (&out)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Stage rows [0, nrows) x cols [0, ncols) of a row-major tile of T (row stride
// sl, 16-byte aligned rows, ncols a multiple of Chunk<T>::N) into a 64-row f32
// tile in shared memory (row stride QK_STRIDE); rows [nrows, 64) become 0. With
// ADD a second tile of the same shape is added (table mode: k + emb). Loads go
// in batches of 4 per thread, all issued before the batch's stores, so their
// latencies overlap.
template <typename T, bool ADD>
__device__ __forceinline__ void stage_tile(float* dst, const T* src, long long sl, const T* src2,
                                           long long sl2, int nrows, int ncols, int tid) {
  constexpr int E = Chunk<T>::N;
  constexpr int PER = 64 * DMAX / E / THREADS;  // chunks per thread at the widest tile
  constexpr int BATCH = 4;
  const int cpr = ncols / E;  // chunks per row
#pragma unroll
  for (int u0 = 0; u0 < PER; u0 += BATCH) {
    uint4 a[BATCH], b[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int idx = tid + (u0 + u) * THREADS, r = idx / cpr, c = idx - r * cpr;
      a[u] = b[u] = make_uint4(0u, 0u, 0u, 0u);
      if (r < nrows) {
        a[u] = __ldg(reinterpret_cast<const uint4*>(src + r * sl + c * E));
        if (ADD) b[u] = __ldg(reinterpret_cast<const uint4*>(src2 + r * sl2 + c * E));
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int idx = tid + (u0 + u) * THREADS, r = idx / cpr, c = idx - r * cpr;
      if (r >= 64) continue;
      float f[E];
      unpack<T>(a[u], f);
      if (ADD) {
        float g[E];
        unpack<T>(b[u], g);
#pragma unroll
        for (int e = 0; e < E; ++e) f[e] += g[e];
      }
      float4* d = reinterpret_cast<float4*>(dst + r * QK_STRIDE + c * E);
#pragma unroll
      for (int e = 0; e < E / 4; ++e)
        d[e] = make_float4(f[4 * e], f[4 * e + 1], f[4 * e + 2], f[4 * e + 3]);
    }
  }
}

// T: q/k/v/out (and table) dtype; BT: bias dtype (unused in table mode); VEC:
// every row of q, k, v (and the table) is 16-byte aligned and D, Dv are
// multiples of Chunk<T>::N, so tiles are staged with 16-byte loads (the MHSA
// shapes); otherwise one element per load.
template <typename T, typename BT, bool TABLE, bool VEC>
__global__ void __launch_bounds__(THREADS, 2) attention_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][QK_STRIDE]
  float* KVs = Qs + BQ * QK_STRIDE;             // [BK][QK_STRIDE]: K (+emb), then V
  float* Ss = KVs + BK * QK_STRIDE;             // [BQ][S_STRIDE]: bias, logits, then p
  float* m_s = Ss + BQ * S_STRIDE;              // running max per row
  float* l_s = m_s + BQ;                        // running sum per row
  float* a_s = l_s + BQ;                        // this tile's rescale per row

  const int bh = blockIdx.x;
  const int b = bh / p.heads, n = bh - b * p.heads;
  const int q0 = blockIdx.y * BQ;
  const int qn = min(BQ, p.L - q0);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int D4 = (p.D + 3) & ~3, Dv4 = (p.Dv + 3) & ~3;
  const int ni = min(4, (qn + 15) >> 4);  // row groups of 16 holding valid queries
  const int rows = ni << 4;               // rows this block computes (>= qn)

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + n * p.q_sn + (long long)q0 * p.q_sl;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + n * p.k_sn;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + n * p.v_sn;

  if (VEC) {
    stage_tile<T, false>(Qs, q, p.q_sl, nullptr, 0, qn, p.D, tid);
  } else {
    for (int r = warp; r < BQ; r += THREADS / 32)
      for (int d = lane; d < D4; d += 32)
        Qs[r * QK_STRIDE + d] = (r < qn && d < p.D) ? to_f32(q[r * p.q_sl + d]) : 0.f;
  }
  for (int r = tid; r < BQ; r += THREADS) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.L; k0 += BK) {
    const int kn = min(BK, p.L - k0);
    const int nj = (kn + 15) >> 4;  // key groups of 16 holding valid keys
    __syncthreads();                // the previous tile's p and V are consumed

    // ---- stage K (+ emb) and the bias tile ------------------------------
    const T* emb = static_cast<const T*>(p.emb);
    if (VEC) {
      stage_tile<T, TABLE>(KVs, k + (long long)k0 * p.k_sl, p.k_sl,
                           TABLE ? emb + (long long)k0 * p.e_sl : nullptr, p.e_sl, kn, p.D, tid);
    } else {
      for (int c = warp; c < BK; c += THREADS / 32)
        for (int d = lane; d < D4; d += 32) {
          float kv = 0.f;
          if (c < kn && d < p.D) {
            kv = to_f32(k[(long long)(k0 + c) * p.k_sl + d]);
            if (TABLE) kv += to_f32(emb[(long long)(k0 + c) * p.e_sl + d]);
          }
          KVs[c * QK_STRIDE + d] = kv;
        }
    }
    if (!TABLE) {  // one element per load (rows of L elements need not be aligned),
                   // all 16 of a thread's loads issued before its stores
      const BT* bias = static_cast<const BT*>(p.bias) + b * p.b_sb + n * p.b_sn +
                       (long long)q0 * p.b_sl + k0;
      constexpr int PB = BQ * BK / THREADS;
      float bv[PB];
#pragma unroll
      for (int u = 0; u < PB; ++u) {
        const int idx = tid + u * THREADS, r = idx / BK, c = idx % BK;
        bv[u] = (r < qn && c < kn) ? to_f32(bias[(long long)r * p.b_sl + c]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < PB; ++u) {
        const int idx = tid + u * THREADS, r = idx / BK, c = idx % BK;
        if (r < rows) Ss[r * S_STRIDE + c] = bv[u];
      }
    }
    __syncthreads();

    // ---- logits: rows ty + 16 i, keys tx + 16 j ---------------------------
    {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      for (int d = 0; d < D4; d += 4) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * QK_STRIDE + d]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] = *reinterpret_cast<const float4*>(&KVs[(tx + 16 * j) * QK_STRIDE + d]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i >= ni) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j >= nj) continue;
            s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          if (i < ni && c < kn) {
            float* dst = &Ss[r * S_STRIDE + c];
            *dst = TABLE ? s[i][j] : s[i][j] + *dst;
          }
        }
    }
    __syncthreads();

    // ---- online softmax per row (one warp per row), V staged meanwhile ----
    for (int r = warp; r < rows; r += THREADS / 32) {
      float* srow = &Ss[r * S_STRIDE];
      float mx = -INFINITY;
      for (int c = lane; c < kn; c += 32) mx = fmaxf(mx, srow[c]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < kn; c += 32) {
        const float e = expf(srow[c] - m_new);
        sum += e;
        srow[c] = round_to<T>(e);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);  // first tile: exp(-inf) = 0
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    if (VEC) {
      stage_tile<T, false>(KVs, v + (long long)k0 * p.v_sl, p.v_sl, nullptr, 0, kn, p.Dv, tid);
    } else {
      for (int c = warp; c < kn; c += THREADS / 32)
        for (int d = lane; d < Dv4; d += 32)
          KVs[c * QK_STRIDE + d] = d < p.Dv ? to_f32(v[(long long)(k0 + c) * p.v_sl + d]) : 0.f;
    }
    __syncthreads();

    // ---- acc = acc * alpha + p . V: rows ty + 16 i, values 4 tx + 64 h + {0..3}
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i >= ni) continue;
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
    }
    for (int c = 0; c < kn; ++c) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = Ss[(ty + 16 * i) * S_STRIDE + c];
      const float4 v0 = *reinterpret_cast<const float4*>(&KVs[c * QK_STRIDE + 4 * tx]);
      const float4 v1 = *reinterpret_cast<const float4*>(&KVs[c * QK_STRIDE + 4 * tx + 64]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i >= ni) continue;
        acc[i][0] = fmaf(pr[i], v0.x, acc[i][0]);
        acc[i][1] = fmaf(pr[i], v0.y, acc[i][1]);
        acc[i][2] = fmaf(pr[i], v0.z, acc[i][2]);
        acc[i][3] = fmaf(pr[i], v0.w, acc[i][3]);
        acc[i][4] = fmaf(pr[i], v1.x, acc[i][4]);
        acc[i][5] = fmaf(pr[i], v1.y, acc[i][5]);
        acc[i][6] = fmaf(pr[i], v1.z, acc[i][6]);
        acc[i][7] = fmaf(pr[i], v1.w, acc[i][7]);
      }
    }
  }

  // ---- out = acc / l ------------------------------------------------------
  T* out = static_cast<T*>(p.out) + ((long long)bh * p.L + q0) * p.Dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (i >= ni || r >= qn) continue;
    const float l = l_s[r];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 4 * tx + 64 * (j >> 2) + (j & 3);
      if (c < p.Dv) out[(long long)r * p.Dv + c] = from_f32<T>(acc[i][j] / l);
    }
  }
}

template <typename T, typename BT, bool TABLE, bool VEC>
cudaError_t launch(const Params& p, int bn, cudaStream_t stream) {
  // the opt-in to more than 48 KB of dynamic shared memory (the current device)
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<T, BT, TABLE, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)bn, (unsigned)((p.L + BQ - 1) / BQ));
  attention_kernel<T, BT, TABLE, VEC><<<grid, THREADS, SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t dispatch_bias(const Params& p, int bias_dt, int bn, cudaStream_t s) {
  switch (bias_dt) {
    case kTable:
      return launch<T, T, true, VEC>(p, bn, s);
    case kF32:
      return launch<T, float, false, VEC>(p, bn, s);
    case kBF16:
      return launch<T, __nv_bfloat16, false, VEC>(p, bn, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Whether every row a block reads of this [B, N, L, *] tensor starts on 16 bytes.
bool rows_aligned(const void* ptr, long long sb, long long sn, long long sl, int per_chunk) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % per_chunk == 0 &&
         sn % per_chunk == 0 && sl % per_chunk == 0;
}

template <typename T>
cudaError_t dispatch_vec(const Params& p, int bias_dt, int bn, cudaStream_t s) {
  constexpr int E = Chunk<T>::N;
  const bool vec = p.D % E == 0 && p.Dv % E == 0 && rows_aligned(p.q, p.q_sb, p.q_sn, p.q_sl, E) &&
                   rows_aligned(p.k, p.k_sb, p.k_sn, p.k_sl, E) &&
                   rows_aligned(p.v, p.v_sb, p.v_sn, p.v_sl, E) &&
                   (bias_dt != kTable || rows_aligned(p.emb, 0, 0, p.e_sl, E));
  return vec ? dispatch_bias<T, true>(p, bias_dt, bn, s) : dispatch_bias<T, false>(p, bias_dt, bn, s);
}

}  // namespace

// Plain C entry point for ctypes. q/k/v/bias are [B, N, L, *] with the last
// axis contiguous and the given element strides of B, N and L; emb is [L, D]
// with row stride e_sl. dt: 0 = float32, 1 = bfloat16 for q, k, v, emb and
// out; bias_dt: the same codes, or -1 for table mode (bias = q . emb^T).
// Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int dtpu_attention_launch(
    const void* q, long long q_sb, long long q_sn, long long q_sl,
    const void* k, long long k_sb, long long k_sn, long long k_sl,
    const void* v, long long v_sb, long long v_sn, long long v_sl,
    const void* bias, long long b_sb, long long b_sn, long long b_sl, int bias_dt,
    const void* emb, long long e_sl, void* out, int dt, int batch, int heads, int L,
    int D, int Dv, void* stream) {
  if (batch <= 0 || heads <= 0 || L <= 0 || D <= 0 || D > DMAX || Dv <= 0 || Dv > DMAX ||
      (long long)batch * heads > 0x7fffffffLL || (L + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{q,    q_sb, q_sn, q_sl, k,   k_sb,  k_sn, k_sl, v, v_sb, v_sn,
                 v_sl, bias, b_sb, b_sn, b_sl, emb, e_sl, out,  heads, L, D,  Dv};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dt) {
    case kF32:
      return (int)dispatch_vec<float>(p, bias_dt, batch * heads, s);
    case kBF16:
      return (int)dispatch_vec<__nv_bfloat16>(p, bias_dt, batch * heads, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
