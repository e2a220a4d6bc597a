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
//     s   = q_r . k_c + q_r . emb_c     (f32 accumulate)   (table mode)
//     m'  = max(m, max_c s);  p_c = exp(s - m');  alpha = exp(m - m')
//     l   = l * alpha + sum_c p_c
//     acc = acc * alpha + sum_c round_to(T, p_c) * v_c    (f32 accumulate)
// and at the end out_r = round_to(T, acc / l). This is K4's rounding: p is
// cast to the value dtype before it is normalised, and l sums the unrounded p.
// K2 normalises first; the two differ by one rounding of p, which the tests'
// tolerances cover. No fast-math: exp (expf in f32, exp2f(x log2 e) in bf16)
// and the division are the accurate ones.
//
// Two kernels, chosen by the dtype of q/k/v:
//
// bf16 (serving): attention_mma_kernel, on the tensor cores. What bounds it at
// the MHSA shapes (4 heads of 128; H100 SXM, 3.35 TB/s, 989 TFLOP/s bf16):
//   K2  bias, B*N 512,  L 196:  142 MB (q, k, v, out and a 39 MB bf16 bias)
//       = 42 us of bytes against 10.1 GFLOP = 10 us of products: bytes.
//   K3  table, B*N 512, L 196:  103 MB = 31 us against 10 us (15 with the
//       table product): bytes.
//   K4  bias, B*N 32,   L 1024: 101 MB = 30 us against 17 us: bytes.
//   K5  table, B*N 32,  L 1024:  34 MB = 10 us against 17 us (26 with the
//       table product): operations.
// What the design does about it:
//   - Four warps own 16 query rows each. Q.K^T and P.V are
//     mma.sync.m16n8k16 bf16 -> f32, fed by ldmatrix (ldmatrix.trans for V)
//     from bf16 tiles whose 16-byte chunks are XOR-swizzled by row, so the
//     8 rows an ldmatrix reads hit 8 different bank groups. Q stays in
//     registers as A fragments. The logits, the running max and sum stay in
//     registers; a row max is two __shfl_xor in the quad that shares a row.
//     p is rounded to bf16 in registers and is the A fragment of P.V
//     directly: the m16n8 accumulator layout of two key blocks is the A
//     layout of one k-step (the FlashAttention-2 arrangement). Every bf16 x
//     bf16 product is exact in f32, so against the plain version only the
//     order of summation differs.
//   - Table mode runs a second mma pass of the same Q fragments over the emb
//     tile into the same f32 logits: q.emb is never rounded to bf16, and the
//     [B, N, L, L] product is never formed in device memory. K5 pays the
//     second pass (it is bound by operations).
//   - K, V and the bias (or emb) tile go to shared memory by cp.async into a
//     two-stage ring: tile j + 1 is in flight while tile j computes, with one
//     cp.async.wait_group and one __syncthreads per tile. The copy width is
//     the widest of 16, 8 and 4 bytes that the base, strides and row length
//     allow (computed per launch from the wrapper's strides): 16 for q/k/v in
//     the MHSA layout and for the bias at L 1024 or in f32, 8 for a bf16 bias
//     row of 196 (392 bytes); an odd bf16 row length takes a 2-byte synchronous
//     path inside the same kernel. Bytes past D (or Dv) up to 128 values, and
//     rows past L, are zero-filled (src-size 0). The bias tile is read in its
//     own dtype (a bf16 bias is half the bytes).
//   - The products run every k-step of a 128-wide row, so their loops have
//     fixed trip counts: a bound checked between an ldmatrix and its mma
//     splits them into basic blocks, and each mma then waits out its load
//     (about 1.5x slower at the MHSA shapes). A key tile is
//     compiled twice, full and ragged, and only the ragged one (the last tile
//     when L is not a multiple of 64) checks bounds: its keys >= L are -inf
//     before the row max, and it skips 8-key blocks (Q.K^T) and 16-key steps
//     (P.V) that hold no valid key.
//   - Query rows >= L are computed but not stored; a warp whose 16 rows all
//     lie past L skips the products. At L 196 the query tiles are 64, 64, 64,
//     4: 13 warps of 16 rows compute 208 rows for 196 (6 % wasted), and the
//     last key tile computes 16 keys for 4.
//   - The output goes through shared memory (a free stage of the ring) so
//     that each warp writes its rows with 16-byte stores.
//   Shared memory: two stages of K, V (16 KB each) and the bias (9 KB bf16,
//   18 KB f32) or emb (16 KB) tile; Q is staged once in the second stage
//   before the ring starts. 82-100 KB, two blocks per SM. Registers (nvcc
//   -Xptxas -v, the [build] line of chip_smoke.py): 204-215 per thread, no
//   spills.
//
// f32 (the card-against-CPU checks): attention_kernel, scalar f32 FMAs on CUDA
// cores (register tiles of 4 x 4 logits and 4 x 8 outputs per thread, operands
// from f32 shared-memory tiles; 16-byte staging loads where rows allow).
// Tensor cores would round f32 to TF32, outside those checks' 2e-5.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

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
  // bf16 kernel only: copy width in bytes (16, 8, 4 or 2) of q, k, v, the
  // bias or table, and the output
  int wq, wk, wv, wx, wo;
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

// ===========================================================================
// f32 q/k/v: scalar FMAs on the CUDA cores
// ===========================================================================

// Elements of T in one 16-byte load.
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int N = 4;
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

// ===========================================================================
// bf16 q/k/v: mma.sync on the tensor cores, cp.async ring
// ===========================================================================

constexpr int MMA_THREADS = 128;  // 4 warps x 16 query rows
constexpr int MBK = 64;           // keys per tile
constexpr int STAGES = 2;         // tiles in the cp.async ring
constexpr int ROW_BYTES = 256;    // a Q/K/V/emb row in shared memory: 128 bf16

// Row stride in shared memory of the bias tile: MBK values plus 16 (bf16) or
// 32 (f32) bytes, so the 8 rows x 4 column pairs that one accumulator read of
// a warp touches fall in 32 different banks.
template <typename BT>
struct BiasRow {
  static constexpr int BYTES = (MBK + 8) * (int)sizeof(BT);
};

template <typename BT, bool TABLE>
struct MmaSmem {
  static constexpr int KV = MBK * ROW_BYTES;  // one K or V tile
  static constexpr int X = TABLE ? KV : BQ * BiasRow<BT>::BYTES;
  static constexpr int STAGE = 2 * KV + X;  // K, V, then the bias or emb tile
  static constexpr int BYTES = STAGES * STAGE;
  static_assert(2 * KV >= BQ * ROW_BYTES, "Q and the output are staged in a stage's K and V");
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// Byte offset within a swizzled 256-byte row: 16-byte chunk c of row r lives
// at chunk c ^ (r & 7).
__device__ __forceinline__ int swz(int r, int byte) {
  return (((byte >> 4) ^ (r & 7)) << 4) | (byte & 15);
}

template <int W>
__device__ __forceinline__ void copy_unit(uint32_t s, const unsigned char* g, bool valid) {
  const int n = valid ? W : 0;
  if (W == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(g), "r"(n)
                 : "memory");
  else if (W == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(g), "r"(n)
                 : "memory");
  else if (W == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(g), "r"(n)
                 : "memory");
  else
    asm volatile("{\n .reg .pred p;\n .reg .b16 h;\n setp.ne.b32 p, %2, 0;\n mov.b16 h, 0;\n"
                 " @p ld.global.b16 h, [%1];\n st.shared.b16 [%0], h;\n}\n" ::"r"(s), "l"(g),
                 "r"((int)valid)
                 : "memory");
}

// Thread tid of NT copies W-byte unit u = tid % 16 (+ 16, ...) of rows
// tid / 16, + NT / 16, ...: the swizzled column is the same down its rows
// (they step by a multiple of 8).
template <int W, bool SWZ, int NT>
__device__ __forceinline__ void copy_rows(uint32_t dst, const unsigned char* src, long long gs,
                                          int rows, int nrows, int nbytes, int pbytes, int rb,
                                          int tid) {
  constexpr int STEP = NT / 16;
  const int r0 = tid >> 4;
  for (int byte = (tid & 15) * W; byte < pbytes; byte += 16 * W) {
    const bool col = byte < nbytes;
    uint32_t s = dst + r0 * rb + (SWZ ? swz(r0, byte) : byte);
    const unsigned char* g = src + r0 * gs + byte;
    for (int r = r0; r < rows; r += STEP, s += STEP * rb, g += STEP * gs) {
      const bool valid = col && r < nrows;
      copy_unit<W>(s, valid ? g : src, valid);
    }
  }
}

// Stage rows [0, nrows) x bytes [0, nbytes) of a row-major global tile (row
// stride gs bytes) into a `rows`-row shared tile (row stride rb bytes; SWZ:
// chunks swizzled by swz) in units of w bytes: 16, 8 or 4 by cp.async, 2 by
// a synchronous load and store. Bytes [nbytes, pbytes) of each row and rows
// [nrows, rows) are zero-filled (cp.async with src-size 0). The base, gs and
// nbytes are multiples of w; pbytes is a multiple of 16. NT: the block's
// threads, all of which take part.
template <bool SWZ, int NT = MMA_THREADS>
__device__ __forceinline__ void stage_rows(unsigned char* dst, const unsigned char* src,
                                           long long gs, int rows, int nrows, int nbytes,
                                           int pbytes, int rb, int w, int tid) {
  const uint32_t d = smem_u32(dst);
  switch (w) {
    case 16:
      return copy_rows<16, SWZ, NT>(d, src, gs, rows, nrows, nbytes, pbytes, rb, tid);
    case 8:
      return copy_rows<8, SWZ, NT>(d, src, gs, rows, nrows, nbytes, pbytes, rb, tid);
    case 4:
      return copy_rows<4, SWZ, NT>(d, src, gs, rows, nrows, nbytes, pbytes, rb, tid);
    default:
      return copy_rows<2, SWZ, NT>(d, src, gs, rows, nrows, nbytes, pbytes, rb, tid);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a . b for one m16n8k16 tile, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float2 bias_pair(const unsigned char* row, int c, float) {
  return *reinterpret_cast<const float2*>(row + 4 * c);
}
__device__ __forceinline__ float2 bias_pair(const unsigned char* row, int c, __nv_bfloat16) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + 2 * c));
}

// exp(x) as exp2f(x log2 e): the accurate exp2f (not the fast-math
// intrinsic), a few instructions shorter than expf
__device__ __forceinline__ float exp_of(float x) { return exp2f(x * 1.4426950408889634f); }

// c += rows [16 w, 16 w + 16) of Q times the MBK-row tile at `tile`: key
// blocks of 8, 8 k-steps of 16 (D is zero-padded to 128 in shared memory).
// FULL: every key is valid, and the loops have fixed trip counts so that the
// ldmatrix loads run ahead of the mma that use them; otherwise key blocks from
// nsb on hold no valid key and are skipped.
template <bool FULL>
__device__ __forceinline__ void qk_pass(float (&s)[MBK / 8][4], const uint32_t (&qf)[8][4],
                                        uint32_t tile, int nsb, int lane) {
  const int mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int jp = 0; jp < MBK / 16; ++jp) {
      if (!FULL && 2 * jp >= nsb) break;
      const int row = (2 * jp + (mi >> 1)) * 8 + (lane & 7);
      uint32_t b[4];
      ldsm_x4(b, tile + row * ROW_BYTES + swz(row, (2 * kk + (mi & 1)) * 16));
      mma_bf16(s[2 * jp], qf[kk], b[0], b[1]);
      mma_bf16(s[2 * jp + 1], qf[kk], b[2], b[3]);
    }
  }
}

// acc += P.T over 128 columns, P the warp's 16 x 64 tile as bf16 A fragments
// (pa[kj]: k-step kj of 16 rows of `tile`), T the 64-row tile at `tile`;
// k-steps from nks on are skipped unless FULL.
template <bool FULL>
__device__ __forceinline__ void pv_pass(float (&acc)[16][4], const uint32_t (&pa)[4][4],
                                        uint32_t tile, int nks, int lane) {
  const int mi = lane >> 3;
#pragma unroll
  for (int kj = 0; kj < 4; ++kj) {
    if (!FULL && kj >= nks) break;
    const int row = kj * 16 + (mi & 1) * 8 + (lane & 7);
#pragma unroll
    for (int hp = 0; hp < 8; ++hp) {
      uint32_t bv[4];
      ldsm_x4_trans(bv, tile + row * ROW_BYTES + swz(row, (2 * hp + (mi >> 1)) * 16));
      mma_bf16(acc[2 * hp], pa[kj], bv[0], bv[1]);
      mma_bf16(acc[2 * hp + 1], pa[kj], bv[2], bv[3]);
    }
  }
}

// One key tile of the online softmax for this warp's 16 rows: the stage at
// `st` holds K, V and the bias or emb tile; kn keys are valid (all of them
// when FULL).
template <typename BT, bool TABLE, bool FULL>
__device__ __forceinline__ void tile_step(const unsigned char* st, const uint32_t (&qf)[8][4],
                                          float (&acc)[16][4], float& m0, float& m1, float& l0,
                                          float& l1, int kn, int warp, int lane) {
  using Smem = MmaSmem<BT, TABLE>;
  constexpr int NB = MBK / 8;  // key blocks of 8 per tile
  const int g = lane >> 2, t4 = lane & 3;
  const int nsb = FULL ? NB : (kn + 7) >> 3;  // key blocks of 8 holding a valid key
  const uint32_t sk = smem_u32(st);

  // ---- logits -------------------------------------------------------------
  float s[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  qk_pass<FULL>(s, qf, sk, nsb, lane);
  if (TABLE) qk_pass<FULL>(s, qf, sk + 2 * Smem::KV, nsb, lane);
  if (!TABLE) {
    const unsigned char* r0 = st + 2 * Smem::KV + (warp * 16 + g) * BiasRow<BT>::BYTES;
    const unsigned char* r1 = r0 + 8 * BiasRow<BT>::BYTES;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (!FULL && j >= nsb) break;
      const float2 b0 = bias_pair(r0, 8 * j + 2 * t4, BT());
      const float2 b1 = bias_pair(r1, 8 * j + 2 * t4, BT());
      s[j][0] += b0.x;
      s[j][1] += b0.y;
      s[j][2] += b1.x;
      s[j][3] += b1.y;
    }
  }
  if (!FULL) {  // keys >= L
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * j + 2 * t4 + (e & 1) >= kn) s[j][e] = -INFINITY;
  }

  // ---- online softmax in registers ------------------------------------------
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {  // the quad that shares rows g and g + 8
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  const float a0 = exp_of(m0 - mn0), a1 = exp_of(m1 - mn1);  // first tile: exp(-inf) = 0
  m0 = mn0;
  m1 = mn1;
  uint32_t pa[NB / 2][4];  // p in bf16 as the A fragments of the key steps of P.V
  float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    float e0 = 0.f, e1 = 0.f, e2 = 0.f, e3 = 0.f;
    if (FULL || j < nsb) {
      e0 = exp_of(s[j][0] - mn0);
      e1 = exp_of(s[j][1] - mn0);
      e2 = exp_of(s[j][2] - mn1);
      e3 = exp_of(s[j][3] - mn1);
    }
    ls0 += e0 + e1;
    ls1 += e2 + e3;
    pa[j >> 1][2 * (j & 1)] = pack_bf16(e0, e1);      // row g, keys 8 j + 2 t4, +1
    pa[j >> 1][2 * (j & 1) + 1] = pack_bf16(e2, e3);  // row g + 8
  }
  l0 = l0 * a0 + ls0;
  l1 = l1 * a1 + ls1;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    acc[j][0] *= a0;
    acc[j][1] *= a0;
    acc[j][2] *= a1;
    acc[j][3] *= a1;
  }

  // ---- acc += p . V (Dv zero-padded to 128; key steps of 16 holding a valid key)
  pv_pass<FULL>(acc, pa, sk + Smem::KV, FULL ? NB / 2 : (kn + 15) >> 4, lane);
}

// BT: bias dtype (unused in table mode).
template <typename BT, bool TABLE>
__global__ void __launch_bounds__(MMA_THREADS, 2) attention_mma_kernel(const Params p) {
  using Smem = MmaSmem<BT, TABLE>;
  extern __shared__ __align__(128) unsigned char smem[];

  const int nq = (p.L + BQ - 1) / BQ;
  const int bh = blockIdx.x / nq, qt = blockIdx.x - bh * nq;  // a head's query tiles run
  const int b = bh / p.heads, n = bh - b * p.heads;           // together: K, V stay in L2
  const int q0 = qt * BQ, qn = min(BQ, p.L - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // accumulator row g (and g + 8), columns 2 t4, +1
  const bool active = warp * 16 < qn;      // the warp holds a valid query row
  const int nt = (p.L + MBK - 1) / MBK;

  const unsigned char* q = static_cast<const unsigned char*>(p.q) +
                           2 * (b * p.q_sb + n * p.q_sn + (long long)q0 * p.q_sl);
  const unsigned char* k = static_cast<const unsigned char*>(p.k) + 2 * (b * p.k_sb + n * p.k_sn);
  const unsigned char* v = static_cast<const unsigned char*>(p.v) + 2 * (b * p.v_sb + n * p.v_sn);
  const unsigned char* x;  // the bias rows of this query tile, or the table
  long long xs;            // its row stride in bytes
  if (TABLE) {
    x = static_cast<const unsigned char*>(p.emb);
    xs = 2 * p.e_sl;
  } else {
    x = static_cast<const unsigned char*>(p.bias) +
        sizeof(BT) * (b * p.b_sb + n * p.b_sn + (long long)q0 * p.b_sl);
    xs = sizeof(BT) * p.b_sl;
  }

  // stage s: K at s * STAGE, V at + KV, the bias or emb tile at + 2 KV; each
  // tile is one cp.async group (an empty one past the last tile). Rows are
  // zero-filled past D or Dv up to 128 values and past L.
  auto load_tile = [&](int t) {
    if (t < nt) {
      const int k0 = t * MBK, kn = min(MBK, p.L - k0);
      unsigned char* st = smem + (t % STAGES) * Smem::STAGE;
      stage_rows<true>(st, k + 2 * k0 * p.k_sl, 2 * p.k_sl, MBK, kn, 2 * p.D, ROW_BYTES,
                       ROW_BYTES, p.wk, tid);
      stage_rows<true>(st + Smem::KV, v + 2 * k0 * p.v_sl, 2 * p.v_sl, MBK, kn, 2 * p.Dv,
                       ROW_BYTES, ROW_BYTES, p.wv, tid);
      if (TABLE)
        stage_rows<true>(st + 2 * Smem::KV, x + k0 * xs, xs, MBK, kn, 2 * p.D, ROW_BYTES,
                         ROW_BYTES, p.wx, tid);
      else
        stage_rows<false>(st + 2 * Smem::KV, x + sizeof(BT) * k0, xs, BQ, qn,
                          (int)sizeof(BT) * kn, (int)sizeof(BT) * MBK, BiasRow<BT>::BYTES, p.wx,
                          tid);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // Q goes to the last stage's K and V slots; it is read into registers
  // before a tile is loaded there
  unsigned char* sq = smem + (STAGES - 1) * Smem::STAGE;
  stage_rows<true>(sq, q, 2 * p.q_sl, BQ, qn, 2 * p.D, ROW_BYTES, ROW_BYTES, p.wq, tid);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) load_tile(t);

  uint32_t qf[8][4];  // A fragments of this warp's 16 query rows, k-step kk
  float acc[16][4];   // out rows g, g + 8; values 8 j + 2 t4, +1
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's share of their running sums

  for (int t = 0; t < nt; ++t) {
    // tile t has landed (the STAGES - 2 newer groups may be in flight) and
    // every warp is done with tile t - 1's stage
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    __syncthreads();
    if (t == 0) {
      if (active) {
        const uint32_t a = smem_u32(sq);
        const int row = warp * 16 + (lane & 15);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          ldsm_x4(qf[kk], a + row * ROW_BYTES + swz(row, (2 * kk + (lane >> 4)) * 16));
      }
      if (nt >= STAGES) __syncthreads();  // Q is in registers: its slots may take a tile
    }
    load_tile(t + STAGES - 1);
    if (!active) continue;
    const int kn = min(MBK, p.L - t * MBK);
    const unsigned char* st = smem + (t % STAGES) * Smem::STAGE;
    if (kn == MBK)
      tile_step<BT, TABLE, true>(st, qf, acc, m0, m1, l0, l1, kn, warp, lane);
    else
      tile_step<BT, TABLE, false>(st, qf, acc, m0, m1, l0, l1, kn, warp, lane);
  }
  if (!active) return;

  // ---- out = acc / l, through a free stage to 16-byte stores ----------------
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  // the stage of tile nt - 2 (every warp finished it before the last barrier,
  // and no copy is in flight), or for nt == 1 the Q slots; either way this
  // warp writes only its own rows
  unsigned char* so = smem + ((nt - 2 + STAGES) % STAGES) * Smem::STAGE;
  const int r0 = warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int byte = 2 * (8 * j + 2 * t4);
    *reinterpret_cast<__nv_bfloat162*>(so + r0 * ROW_BYTES + swz(r0, byte)) =
        __floats2bfloat162_rn(acc[j][0] / l0, acc[j][1] / l0);
    *reinterpret_cast<__nv_bfloat162*>(so + r1 * ROW_BYTES + swz(r1, byte)) =
        __floats2bfloat162_rn(acc[j][2] / l1, acc[j][3] / l1);
  }
  __syncwarp();
  const int ob = 2 * p.Dv, units = ob / p.wo;
  unsigned char* out = static_cast<unsigned char*>(p.out) + ((long long)bh * p.L + q0) * ob;
  for (int i = lane; i < 16 * units; i += 32) {
    const int rr = i / units, r = warp * 16 + rr, byte = (i - rr * units) * p.wo;
    if (r >= qn) break;  // rows ascend with i
    const unsigned char* src = so + r * ROW_BYTES + swz(r, byte);
    unsigned char* dst = out + (long long)r * ob + byte;
    switch (p.wo) {
      case 16:
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        break;
      case 8:
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
        break;
      case 4:
        *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src);
        break;
      default:
        *reinterpret_cast<uint16_t*>(dst) = *reinterpret_cast<const uint16_t*>(src);
    }
  }
}

template <typename BT, bool TABLE>
cudaError_t launch_mma(const Params& p, int bn, cudaStream_t stream) {
  constexpr int bytes = MmaSmem<BT, TABLE>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(attention_mma_kernel<BT, TABLE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)bn * ((p.L + BQ - 1) / BQ);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  attention_mma_kernel<BT, TABLE><<<(unsigned)blocks, MMA_THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

// The widest copy (16, 8, 4 or 2 bytes) that starts every row on its own
// width: it divides the base address and every byte stride and row length.
int copy_width(const void* ptr, std::initializer_list<long long> bytes) {
  for (int w : {16, 8, 4}) {
    bool ok = reinterpret_cast<uintptr_t>(ptr) % w == 0;
    for (long long n : bytes) ok = ok && n % w == 0;
    if (ok) return w;
  }
  return 2;
}

cudaError_t dispatch_mma(Params p, int bias_dt, int bn, cudaStream_t s) {
  p.wq = copy_width(p.q, {2 * p.q_sb, 2 * p.q_sn, 2 * p.q_sl, 2LL * p.D});
  p.wk = copy_width(p.k, {2 * p.k_sb, 2 * p.k_sn, 2 * p.k_sl, 2LL * p.D});
  p.wv = copy_width(p.v, {2 * p.v_sb, 2 * p.v_sn, 2 * p.v_sl, 2LL * p.Dv});
  p.wo = copy_width(p.out, {2LL * p.Dv});
  switch (bias_dt) {
    case kTable:
      p.wx = copy_width(p.emb, {2 * p.e_sl, 2LL * p.D});
      return launch_mma<__nv_bfloat16, true>(p, bn, s);
    case kF32:
      p.wx = copy_width(p.bias, {4 * p.b_sb, 4 * p.b_sn, 4 * p.b_sl, 4LL * p.L});
      return launch_mma<float, false>(p, bn, s);
    case kBF16:
      p.wx = copy_width(p.bias, {2 * p.b_sb, 2 * p.b_sn, 2 * p.b_sl, 2LL * p.L});
      return launch_mma<__nv_bfloat16, false>(p, bn, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// ===========================================================================
// Backward: dq, dk, dv and dbias (or demb) of softmax(q.k^T + bias).v
// (the custom_vjp of K2/K4, and of K3/K5 in table mode)
// ===========================================================================
//
// What it computes is the JAX backward term for term (`_bwd`,
// distribuuuu_tpu/ops/attention.py:241-258, and `_abs_bwd`, :514-535), with
// s, p, dp, ds and the softmax statistics in f32:
//     s = q.k^T + bias,  p = softmax_y(s),  dp = g.v^T,
//     delta_x = sum_y dp * p,  ds = p * (dp - delta)
//     dv = p^T.g,  dq = ds.k,  dk = ds^T.q,  dbias = ds
// In table mode (bias = q.emb^T from the shared [L, D] table) s = q.k^T +
// q.emb^T, dq = ds.k + ds.emb and demb = sum_{b,n} ds^T.q: the sum over heads
// of each head's f32 dk before it is rounded. Every route writes that f32 dk
// into a [B*N, L, D] partial, and the demb kernels below sum it over B*N.
// The delta is JAX's sum_y dp * p, not flash-attention's sum dO * O: the
// forward rounds p and the output to the value dtype, so dO * O would differ
// from JAX's value by those roundings.
//
// No float atomics: every gradient is summed in one fixed order, so a call
// repeats bitwise. Three routes, chosen by the dtype and L alone (the wrapper
// names the route and the entry point refuses any other):
//   cluster   (bf16, L <= 256): one launch, one thread-block cluster a head;
//             below.
//   blockwise (bf16, L > 256): three launches on the tensor cores (a
//             statistics pass over the query rows, a key-column pass that
//             forms every (query tile, key tile) pair once for dk, dv and
//             dbias, and a dq pass over the ds it wrote); below, after the
//             cluster route.
//   scalar    (f32: an f32 model, the card-against-CPU checks): two passes
//             on scalar FMAs, a warp a row:
//     rows:    per query row, sweep the keys once for the softmax's max m, its
//              sum l and u = sum_y dp * exp(s - m) (online, rescaled as the max
//              moves), so delta = u / l; write (m, l, delta) to the f32 stats;
//              sweep again for p and ds, write the dbias row and accumulate dq.
//     columns: per key row, walk the query rows, recompute s, p = exp(s - m_x) /
//              l_x and ds from the stats, and accumulate dk and dv.
//            A lane owns the head dimensions d = lane + 32 i (i < 4, so D, Dv
//            <= 128); a dot product is four FMAs a lane then a xor butterfly
//            over the warp, which leaves the same bits in every lane, and both
//            passes form s and dp with the same lanes, order and butterfly, so
//            the p and ds of the columns pass are bitwise those of the rows
//            pass. It is bound by its scalar operations.
// The rows of q, k, v, g, the bias and the table take any strides with a
// contiguous last axis; dq, dk, dv, dbias and demb are contiguous.

struct BwdParams {
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
  const void* g;
  long long g_sb, g_sn, g_sl;
  void* dq;     // contiguous [B, N, L, D]
  void* dk;     // contiguous [B, N, L, D]
  void* dv;     // contiguous [B, N, L, Dv]
  void* dbias;  // contiguous [B, N, L, L] (bias mode)
  float* demb_part;  // contiguous [B*N, L, D]: each head's f32 dk (table mode)
  float* stats;  // [3][B*N][L]: m, l, delta of each query row (blockwise and scalar routes)
  void* ds;      // [B*N, L, L] bf16: ds as the blockwise route's dq pass reads it (dbias
                 // itself for a bf16 bias, else a scratch)
  long long rows;  // B * N * L
  int heads, L, D, Dv;
};

constexpr int BWD_WARPS = 8;  // warps (rows or key columns) a block

// Row r of a [B, N, L, *] tensor with element strides (sb, sn, sl).
template <typename T>
__device__ __forceinline__ const T* row_ptr(const void* base, long long sb, long long sn,
                                            long long sl, int b, int n, int r) {
  return static_cast<const T*>(base) + b * sb + n * sn + (long long)r * sl;
}

// Elements d = lane + 32 i of a row of n values, as f32 (0 past n).
template <typename T>
__device__ __forceinline__ void load_lanes(float (&out)[4], const T* row, int n, int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = lane + 32 * i;
    out[i] = d < n ? to_f32(row[d]) : 0.f;
  }
}

// sum_d a[d] b[d] over the warp: a then b in each FMA, the same in every lane.
__device__ __forceinline__ float warp_dot(const float (&a)[4], const float (&b)[4]) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) s = fmaf(a[i], b[i], s);
  return warp_sum(s);
}

// f32 q/k/v/g; BT: the bias dtype (unused in table mode). Table mode: s = q.k
// + q.emb (two warp dots), dq += ds k + ds emb, no dbias.
template <typename BT, bool TABLE>
__global__ void __launch_bounds__(BWD_WARPS * 32) attention_bwd_rows_kernel(const BwdParams p) {
  using T = float;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * BWD_WARPS + warp;  // over B * N * L
  if (row >= p.rows) return;
  const int bh = (int)(row / p.L), x = (int)(row - (long long)bh * p.L);
  const int b = bh / p.heads, n = bh - b * p.heads;
  float qv[4], gv[4], kr[4], vr[4], er[4];
  load_lanes(qv, row_ptr<T>(p.q, p.q_sb, p.q_sn, p.q_sl, b, n, x), p.D, lane);
  load_lanes(gv, row_ptr<T>(p.g, p.g_sb, p.g_sn, p.g_sl, b, n, x), p.Dv, lane);
  const BT* bias = TABLE ? nullptr : row_ptr<BT>(p.bias, p.b_sb, p.b_sn, p.b_sl, b, n, x);
  auto logit = [&](int y) {  // s = q.k + bias (or + q.emb); loads k (and emb) row y
    load_lanes(kr, row_ptr<T>(p.k, p.k_sb, p.k_sn, p.k_sl, b, n, y), p.D, lane);
    if (TABLE) {
      load_lanes(er, static_cast<const T*>(p.emb) + (long long)y * p.e_sl, p.D, lane);
      return warp_dot(qv, kr) + warp_dot(qv, er);
    }
    return warp_dot(qv, kr) + to_f32(bias[y]);
  };

  // sweep 1: m, l and u = sum_y dp * exp(s - m), rescaled as m grows
  float m = -INFINITY, l = 0.f, u = 0.f;
  for (int y = 0; y < p.L; ++y) {
    load_lanes(vr, row_ptr<T>(p.v, p.v_sb, p.v_sn, p.v_sl, b, n, y), p.Dv, lane);
    const float s = logit(y);
    const float dp = warp_dot(gv, vr);
    const float mn = fmaxf(m, s);
    const float a = expf(m - mn), e = expf(s - mn);  // first key: exp(-inf) = 0
    l = l * a + e;
    u = u * a + e * dp;
    m = mn;
  }
  const float delta = u / l;
  if (lane == 0) {
    p.stats[row] = m;
    p.stats[p.rows + row] = l;
    p.stats[2 * p.rows + row] = delta;
  }

  // sweep 2: p, ds; the dbias row and dq
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  BT* dbias = TABLE ? nullptr : static_cast<BT*>(p.dbias) + row * p.L;
  for (int y = 0; y < p.L; ++y) {
    load_lanes(vr, row_ptr<T>(p.v, p.v_sb, p.v_sn, p.v_sl, b, n, y), p.Dv, lane);
    const float s = logit(y);
    const float dp = warp_dot(gv, vr);
    const float pr = expf(s - m) / l;
    const float ds = pr * (dp - delta);
    if (!TABLE && lane == (y & 31)) dbias[y] = from_f32<BT>(ds);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[i] = fmaf(ds, kr[i], acc[i]);
      if (TABLE) acc[i] = fmaf(ds, er[i], acc[i]);
    }
  }
  T* dq = static_cast<T*>(p.dq) + row * p.D;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (lane + 32 * i < p.D) dq[lane + 32 * i] = from_f32<T>(acc[i]);
}

template <typename BT, bool TABLE>
__global__ void __launch_bounds__(BWD_WARPS * 32) attention_bwd_cols_kernel(const BwdParams p) {
  using T = float;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long col = (long long)blockIdx.x * BWD_WARPS + warp;  // key rows, over B * N * L
  if (col >= p.rows) return;
  const int bh = (int)(col / p.L), y = (int)(col - (long long)bh * p.L);
  const int b = bh / p.heads, n = bh - b * p.heads;
  float kr[4], vr[4], er[4], qx[4], gx[4];
  load_lanes(kr, row_ptr<T>(p.k, p.k_sb, p.k_sn, p.k_sl, b, n, y), p.D, lane);
  load_lanes(vr, row_ptr<T>(p.v, p.v_sb, p.v_sn, p.v_sl, b, n, y), p.Dv, lane);
  if (TABLE) load_lanes(er, static_cast<const T*>(p.emb) + (long long)y * p.e_sl, p.D, lane);
  const float* m = p.stats + (long long)bh * p.L;
  const float* l = m + p.rows;
  const float* delta = l + p.rows;
  float dk[4] = {0.f, 0.f, 0.f, 0.f}, dv[4] = {0.f, 0.f, 0.f, 0.f};
  for (int x = 0; x < p.L; ++x) {
    load_lanes(qx, row_ptr<T>(p.q, p.q_sb, p.q_sn, p.q_sl, b, n, x), p.D, lane);
    load_lanes(gx, row_ptr<T>(p.g, p.g_sb, p.g_sn, p.g_sl, b, n, x), p.Dv, lane);
    const float s = TABLE ? warp_dot(qx, kr) + warp_dot(qx, er)
                          : warp_dot(qx, kr) + to_f32(row_ptr<BT>(p.bias, p.b_sb, p.b_sn, p.b_sl,
                                                                  b, n, x)[y]);
    const float dp = warp_dot(gx, vr);
    const float pr = expf(s - m[x]) / l[x];
    const float ds = pr * (dp - delta[x]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dv[i] = fmaf(pr, gx[i], dv[i]);
      dk[i] = fmaf(ds, qx[i], dk[i]);
    }
  }
  T* dkr = static_cast<T*>(p.dk) + col * p.D;
  T* dvr = static_cast<T*>(p.dv) + col * p.Dv;
  float* dpart = TABLE ? p.demb_part + col * p.D : nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = lane + 32 * i;
    if (d < p.D) {
      dkr[d] = from_f32<T>(dk[i]);
      if (TABLE) dpart[d] = dk[i];
    }
    if (d < p.Dv) dvr[d] = from_f32<T>(dv[i]);
  }
}

// ---------------------------------------------------------------------------
// bf16 helpers of the cluster and blockwise routes
// ---------------------------------------------------------------------------

__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// a and b to dst[0] and dst[1] where ok0 and ok1 (ok1 implies ok0), one
// store where the pair is aligned
template <typename T>
__device__ __forceinline__ void store_row_pair(T* dst, float a, float b, bool ok0, bool ok1,
                                               bool aligned) {
  if (aligned && ok1) {
    store_pair(dst, a, b);
  } else {
    if (ok0) dst[0] = from_f32<T>(a);
    if (ok1) dst[1] = from_f32<T>(b);
  }
}

// Rows g and g + 8 of a 16 x (8 NJ) accumulator tile (columns col0 + 8 j +
// 2 t4, +1) to a contiguous [*, n] array of T at rows `row0` + 0 and + 8
// (only rows < rows_left, columns < n), rounded once to T.
template <typename T, int NJ>
__device__ __forceinline__ void store_tile(T* out, const float (&acc)[NJ][4], long long row0,
                                           int rows_left, int col0, int n, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (g + 8 * h >= rows_left) continue;
    T* dst = out + (row0 + g + 8 * h) * n;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = col0 + 8 * j + 2 * t4;
      store_row_pair(dst + c, acc[j][2 * h], acc[j][2 * h + 1], c < n, c + 1 < n, (n & 1) == 0);
    }
  }
}

struct BwdWidths {
  int wq, wk, wv, wg, wx;  // copy widths (bytes) of q, k, v, g and the bias or emb rows
  int wds;                 // of the rows of ds (blockwise route)
};

// ---------------------------------------------------------------------------
// bf16 at L <= 256: one pass, a thread-block cluster a head
// ---------------------------------------------------------------------------
//
// Replaces, for bf16 at L <= 256, the XLA recompute of the JAX custom_vjp of
// K2 (`_bwd`, distribuuuu_tpu/ops/attention.py:241) and of K3 (`_abs_bwd`,
// :514): BoTNet-50's MHSA at 224^2 (L 196) in training.
//
// What bounds it (H100 SXM, 3.35 TB/s, 989 TFLOP/s bf16): at BoTNet-50
// training's shape (B*N 128, L 196, D = Dv = 128) the call must move 64.6 MB
// in bias mode (19 us; q, k, v, g read once, dq, dk, dv written once, the
// [B, N, L, L] bias read and dbias written once) and do 6.3 GFLOP of
// products (6.4 us): bytes. In table mode the L^2 terms go: 45.1 MB (13.5
// us), still bytes (the table folds into q.(k + emb)^T and ds.(k + emb), so
// the products stay 6.3 GFLOP).
// On the card this kernel is bound by neither: it is bound by latency.
// Each query tile passes seven phases in turn, each behind a barrier (two
// of them cluster-wide): S and dP, the statistics' exchange, p and ds, the
// products, the dQ exchange. Timed with %globaltimer stamps
// (scripts/torch_attention_bwd_phases.py) a CTA spends ~8 us a tile (S/dP
// 1.75, products 1.25-1.5, each cluster barrier 0.75-1.0, the dQ sum and
// the next tile's wait 1.25-2); 30 clusters of 4 are resident. Three variants were
// timed against this one and were slower at L 196: two CTAs an SM (a
// shared-memory diet to 98 KB, 128 registers, spills), 16 warps a CTA, and
// pushing the partials into their owners' shared memory by remote stores
// (the products phase then waits on the stores). The phases are held by
// shared-memory bandwidth (ldmatrix) and the barriers' and remote reads'
// latency, not by the length of a warp's chains. What would move it is
// overlapping one tile's products with the next tile's S phase (warp
// specialisation), not done here.
//
// The design:
//   - A head's keys fit at most 4 tiles of 64, so one cluster of
//     ceil(L / 64) CTAs (cudaLaunchKernelEx with a cluster dimension) holds
//     them all: CTA j keeps key tile j's K and V (and emb rows) resident in
//     its shared memory, accumulates its dK and dV in registers, and the
//     cluster walks the query tiles of 64 together. Every input is read once
//     from device memory (Q and G by each CTA of the cluster, from the L2
//     after the first), and S = Q.K_j^T (+ bias | + Q.E_j^T) and dP = G.V_j^T
//     are formed once, on mma.sync.m16n8k16 (bf16 -> f32) fed by ldmatrix.
//   - Eight warps: in the S phase a warp owns 16 query rows x 32 keys; in the
//     products phase 16 keys (or 16 query rows) x 64 columns, so the f32 dK
//     and dV accumulators take 64 registers a thread. The logits are taken
//     in log2 units and each warp keeps e = exp(s - m_warp) of its keys, so
//     p = e exp(m_warp - m) / l costs one exponential and one division a
//     row. p and ds go through shared memory as bf16 tiles (swizzled
//     128-byte rows): the products read P^T and dS^T as A fragments by
//     ldmatrix.trans, dS by ldmatrix.
//   - Row statistics across the cluster: each warp writes the partial (m, l,
//     u = sum dp exp(s - m)) of its 16 rows over its 32 keys to shared
//     memory; after a cluster barrier 64 threads of each CTA read the 2 x
//     ceil(L / 64) partials of their row through distributed shared memory
//     and combine them in key order, so every CTA holds the same bits of m,
//     l and JAX's delta = u / l. A query past L takes m = +inf: p = ds = 0.
//   - dQ across the cluster: each CTA writes its f32 partial ds.K_j (+
//     ds.E_j) of the query tile to shared memory; after a second cluster
//     barrier each CTA sums, for its share of 16-row chunks, the partials of
//     every CTA in key-tile order (all remote loads in flight at once) and
//     stores the rows as bf16. No float atomics: a call repeats bitwise. A
//     third cluster barrier at the end keeps every CTA's shared memory alive
//     until the last remote read.
//   - The next query tile's Q, G and bias tile are in flight (cp.async, a
//     two-stage ring) while the current one computes. dbias goes to device
//     memory from the S phase's registers. At the end of the walk dK and dV
//     are rounded once and stored; in table mode the unrounded dK goes to
//     the f32 partial that the demb kernels sum over heads.
//   - Ragged L, D and Dv: rows past L and columns past D or Dv are
//     zero-filled in shared memory; a warp whose rows or keys all lie past L
//     skips its products, and k-steps past the last valid row are skipped.
// Shared memory a CTA: K, V (16 KB each; + 16 KB emb), two stages of Q, G
// (16 KB each) and the bias tile (9 KB bf16, 18 KB f32), P and dS (8 KB
// each), the dQ partial (34 KB) and the statistics (2.3 KB): 166 KB (bf16
// bias), 184 KB (f32 bias), 164 KB (table); one CTA an SM. Registers
// (nvcc -Xptxas -v, the [build] line of chip_smoke.py): 197-214 a thread,
// no spills. The wrapper checks cudaOccupancyMaxActiveClusters > 0 before
// a shape's first launch (30 clusters of 4 on an H100 SXM).

constexpr int CL_THREADS = 256;     // 8 warps
constexpr float kLog2e = 1.4426950408889634f;
constexpr int CL_MAX_L = 4 * BK;    // the route's largest L: a cluster of at most 4 CTAs
constexpr int PS_ROW = 2 * BK;      // bytes of a P or dS row in shared memory (64 bf16)
constexpr int DQ_STRIDE = DMAX + 8;  // f32 row stride of the dQ partial: 8 rows of a
                                     // float2 store fall in two 128-byte wavefronts

template <typename BT, bool TABLE>
struct ClusterSmem {
  static constexpr int KV = BK * ROW_BYTES;                      // a 64-row bf16 tile
  static constexpr int X = TABLE ? 0 : BQ * BiasRow<BT>::BYTES;  // the bias tile
  static constexpr int RES = (TABLE ? 3 : 2) * KV;               // K, V (and emb) of key tile j
  static constexpr int STAGE = 2 * KV + X;                       // Q, G and the bias tile
  static constexpr int PDS = 2 * BQ * PS_ROW;                    // P, dS
  static constexpr int DQ = BQ * DQ_STRIDE * 4;                  // this CTA's dQ partial
  static constexpr int XCH = 2 * 3 * BQ * 4;  // (m, l, u) of each row, per 32-key half
  static constexpr int FIN = 3 * BQ * 4;      // (m, l, delta) of each row
  static constexpr int BYTES = RES + 2 * STAGE + PDS + DQ + XCH + FIN;
};

// c += A.B^T (and + A.B2^T with TWO) over 128 columns: A the 16 rows from
// a_row0 of the tile at `a`, B the 16 JP rows from b_row0 of the tile at `b`
// (and `b2`); 256-byte swizzled rows, fixed trip counts.
template <int JP, bool TWO>
__device__ __forceinline__ void abt(float (&c)[2 * JP][4], uint32_t a, int a_row0, uint32_t b,
                                    uint32_t b2, int b_row0, int lane) {
  const int mi = lane >> 3;
  const int arow = a_row0 + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a + arow * ROW_BYTES + swz(arow, (2 * kk + (lane >> 4)) * 16));
#pragma unroll
    for (int jp = 0; jp < JP; ++jp) {
      const int row = b_row0 + (2 * jp + (mi >> 1)) * 8 + (lane & 7);
      const int off = row * ROW_BYTES + swz(row, (2 * kk + (mi & 1)) * 16);
      uint32_t bf[4];
      ldsm_x4(bf, b + off);
      mma_bf16(c[2 * jp], af, bf[0], bf[1]);
      mma_bf16(c[2 * jp + 1], af, bf[2], bf[3]);
      if (TWO) {
        ldsm_x4(bf, b2 + off);
        mma_bf16(c[2 * jp], af, bf[0], bf[1]);
        mma_bf16(c[2 * jp + 1], af, bf[2], bf[3]);
      }
    }
  }
}

// c += A.B over 16 HP columns (col0 ..): A the 16 x 16 fragments `a` of
// k-step kk, B the 256-byte swizzled tile at `b` (rows 16 kk .., read by
// ldmatrix.trans).
template <int HP>
__device__ __forceinline__ void ab(float (&c)[2 * HP][4], const uint32_t (&a)[4], uint32_t b,
                                   int kk, int col0, int lane) {
  const int mi = lane >> 3;
  const int row = kk * 16 + (mi & 1) * 8 + (lane & 7);
#pragma unroll
  for (int hp = 0; hp < HP; ++hp) {
    uint32_t bv[4];
    ldsm_x4_trans(bv, b + row * ROW_BYTES + swz(row, col0 * 2 + (2 * hp + (mi >> 1)) * 16));
    mma_bf16(c[2 * hp], a, bv[0], bv[1]);
    mma_bf16(c[2 * hp + 1], a, bv[2], bv[3]);
  }
}

template <typename BT, bool TABLE>
__global__ void __launch_bounds__(CL_THREADS, 1)
    attention_bwd_cluster_kernel(const BwdParams p, const BwdWidths w) {
  using Smem = ClusterSmem<BT, TABLE>;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ks = smem;
  unsigned char* vs = ks + Smem::KV;
  unsigned char* es = vs + Smem::KV;  // table mode
  unsigned char* ring = smem + Smem::RES;
  unsigned char* ps = ring + 2 * Smem::STAGE;
  unsigned char* dss = ps + BQ * PS_ROW;
  float* dqp = reinterpret_cast<float*>(ps + Smem::PDS);
  float* xch = dqp + BQ * DQ_STRIDE;  // [half][m, l, u][row]
  float* fin = xch + 2 * 3 * BQ;      // [m, l, delta][row]

  const int nk = (p.L + BK - 1) / BK;  // the cluster's CTAs, = key tiles = query tiles
  const int j = (int)cluster.block_rank();
  const int bh = blockIdx.x / nk;
  const int b = bh / p.heads, n = bh - b * p.heads;
  const int k0 = j * BK, kn = min(BK, p.L - k0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, mi = lane >> 3;
  // S phase: query rows 16 grp .. x keys 32 half ..; products: keys (dK, dV)
  // or query rows (dQ) 16 grp .. x columns 64 half ..
  const int grp = warp & 3, half = warp >> 2;

  const unsigned char* q = static_cast<const unsigned char*>(p.q) + 2 * (b * p.q_sb + n * p.q_sn);
  const unsigned char* gg = static_cast<const unsigned char*>(p.g) + 2 * (b * p.g_sb + n * p.g_sn);
  const unsigned char* xb =
      TABLE ? nullptr
            : static_cast<const unsigned char*>(p.bias) + sizeof(BT) * (b * p.b_sb + n * p.b_sn + k0);
  const long long xs_g = sizeof(BT) * p.b_sl;

  stage_rows<true, CL_THREADS>(ks, static_cast<const unsigned char*>(p.k) +
                                       2 * (b * p.k_sb + n * p.k_sn + (long long)k0 * p.k_sl),
                               2 * p.k_sl, BK, kn, 2 * p.D, ROW_BYTES, ROW_BYTES, w.wk, tid);
  stage_rows<true, CL_THREADS>(vs, static_cast<const unsigned char*>(p.v) +
                                       2 * (b * p.v_sb + n * p.v_sn + (long long)k0 * p.v_sl),
                               2 * p.v_sl, BK, kn, 2 * p.Dv, ROW_BYTES, ROW_BYTES, w.wv, tid);
  if (TABLE)
    stage_rows<true, CL_THREADS>(es, static_cast<const unsigned char*>(p.emb) +
                                         2 * (long long)k0 * p.e_sl,
                                 2 * p.e_sl, BK, kn, 2 * p.D, ROW_BYTES, ROW_BYTES, w.wx, tid);

  // query tile i's Q, G and bias tile into stage i % 2: one cp.async group
  // (an empty one past the last tile)
  auto load_tile = [&](int i) {
    if (i < nk) {
      const int x0 = i * BQ, xn = min(BQ, p.L - x0);
      unsigned char* st = ring + (i & 1) * Smem::STAGE;
      stage_rows<true, CL_THREADS>(st, q + 2LL * x0 * p.q_sl, 2 * p.q_sl, BQ, xn, 2 * p.D,
                                   ROW_BYTES, ROW_BYTES, w.wq, tid);
      stage_rows<true, CL_THREADS>(st + Smem::KV, gg + 2LL * x0 * p.g_sl, 2 * p.g_sl, BQ, xn,
                                   2 * p.Dv, ROW_BYTES, ROW_BYTES, w.wg, tid);
      if (!TABLE)
        stage_rows<false, CL_THREADS>(st + 2 * Smem::KV, xb + x0 * xs_g, xs_g, BQ, xn,
                                      (int)sizeof(BT) * kn, (int)sizeof(BT) * BK,
                                      BiasRow<BT>::BYTES, w.wx, tid);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  load_tile(0);  // with the resident tiles
  load_tile(1);

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[jj][e] = dv[jj][e] = 0.f;

  for (int i = 0; i < nk; ++i) {
    const int x0 = i * BQ, xn = min(BQ, p.L - x0);
    const unsigned char* st = ring + (i & 1) * Smem::STAGE;
    const uint32_t qs = smem_u32(st), gs = qs + Smem::KV;
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // tile i has landed
    __syncthreads();

    // ---- S and dP: rows r0 = 16 grp .., keys c0 = 32 half .. ------------------
    const int r0 = grp * 16, c0 = half * 32;
    float s[4][4], dp[4][4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jj][e] = dp[jj][e] = 0.f;
    const bool live = r0 < xn && c0 < kn;
    if (live) {
      abt<2, TABLE>(s, qs, r0, smem_u32(ks), smem_u32(es), c0, lane);
      abt<2, false>(dp, gs, r0, smem_u32(vs), 0, c0, lane);
      if (!TABLE) {
        const unsigned char* x0r = st + 2 * Smem::KV + (r0 + g) * BiasRow<BT>::BYTES;
        const unsigned char* x1r = x0r + 8 * BiasRow<BT>::BYTES;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float2 b0 = bias_pair(x0r, c0 + 8 * jj + 2 * t4, BT());
          const float2 b1 = bias_pair(x1r, c0 + 8 * jj + 2 * t4, BT());
          s[jj][0] += b0.x;
          s[jj][1] += b0.y;
          s[jj][2] += b1.x;
          s[jj][3] += b1.y;
        }
      }
    }
    // logits in log2 units (s log2 e, so exp2 is the exponential); keys past L: -inf
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[jj][e] = (!live || c0 + 8 * jj + 2 * t4 + (e & 1) >= kn) ? -INFINITY
                                                                   : s[jj][e] * kLog2e;

    // this warp's partial (m, l, u) of rows g and g + 8 over its 32 keys; s
    // becomes e = exp(s - m_warp), which p rescales below
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      mx0 = fmaxf(mx0, fmaxf(s[jj][0], s[jj][1]));
      mx1 = fmaxf(mx1, fmaxf(s[jj][2], s[jj][3]));
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    float l0 = 0.f, l1 = 0.f, u0 = 0.f, u1 = 0.f;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {  // no valid key: m = -inf, e = l = u = 0
      const float e0 = mx0 == -INFINITY ? 0.f : exp2f(s[jj][0] - mx0);
      const float e1 = mx0 == -INFINITY ? 0.f : exp2f(s[jj][1] - mx0);
      const float e2 = mx1 == -INFINITY ? 0.f : exp2f(s[jj][2] - mx1);
      const float e3 = mx1 == -INFINITY ? 0.f : exp2f(s[jj][3] - mx1);
      s[jj][0] = e0;
      s[jj][1] = e1;
      s[jj][2] = e2;
      s[jj][3] = e3;
      l0 += e0 + e1;
      l1 += e2 + e3;
      u0 += e0 * dp[jj][0] + e1 * dp[jj][1];
      u1 += e2 * dp[jj][2] + e3 * dp[jj][3];
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {  // a xor butterfly: the same bits in the quad
      l0 += __shfl_xor_sync(0xffffffffu, l0, o);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o);
      u0 += __shfl_xor_sync(0xffffffffu, u0, o);
      u1 += __shfl_xor_sync(0xffffffffu, u1, o);
    }
    if (t4 == 0) {
      float* xh = xch + half * 3 * BQ;
      xh[r0 + g] = mx0;
      xh[BQ + r0 + g] = l0;
      xh[2 * BQ + r0 + g] = u0;
      xh[r0 + g + 8] = mx1;
      xh[BQ + r0 + g + 8] = l1;
      xh[2 * BQ + r0 + g + 8] = u1;
    }
    cluster.sync();  // every CTA's partials are written

    // ---- the rows' statistics from the 2 nk partials, in key order ------------
    if (tid < BQ) {
      float m = INFINITY, l = 1.f, delta = 0.f;  // a query past L: p = ds = 0
      if (tid < xn) {
        float pm[8], pl[8], pu[8];
#pragma unroll
        for (int rk = 0; rk < 4; ++rk) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            pm[2 * rk + h] = -INFINITY;
            pl[2 * rk + h] = pu[2 * rk + h] = 0.f;
            if (rk < nk) {
              const float* rx = cluster.map_shared_rank(xch, (unsigned)rk) + h * 3 * BQ;
              pm[2 * rk + h] = rx[tid];
              pl[2 * rk + h] = rx[BQ + tid];
              pu[2 * rk + h] = rx[2 * BQ + tid];
            }
          }
        }
        m = -INFINITY;
#pragma unroll
        for (int e = 0; e < 8; ++e) m = fmaxf(m, pm[e]);
        float ls = 0.f, us = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float a = exp2f(pm[e] - m);  // a partial with no valid key: exp(-inf) = 0
          ls += pl[e] * a;
          us += pu[e] * a;
        }
        l = ls;
        delta = us / ls;
      }
      fin[tid] = m;
      fin[BQ + tid] = l;
      fin[2 * BQ + tid] = delta;
    }
    __syncthreads();

    // ---- p = e exp(m_warp - m) / l, ds; dbias; P and dS to shared memory as bf16
    {
      const int ra = r0 + g, rb = ra + 8;
      // a row past L has m = +inf: the scale, so p and ds, is 0
      const float ca = exp2f(mx0 - fin[ra]) / fin[BQ + ra], da = fin[2 * BQ + ra];
      const float cb = exp2f(mx1 - fin[rb]) / fin[BQ + rb], db = fin[2 * BQ + rb];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p0 = s[jj][0] * ca, p1 = s[jj][1] * ca;
        const float p2 = s[jj][2] * cb, p3 = s[jj][3] * cb;
        dp[jj][0] = p0 * (dp[jj][0] - da);  // ds
        dp[jj][1] = p1 * (dp[jj][1] - da);
        dp[jj][2] = p2 * (dp[jj][2] - db);
        dp[jj][3] = p3 * (dp[jj][3] - db);
        const int byte = 2 * (c0 + 8 * jj + 2 * t4);
        *reinterpret_cast<uint32_t*>(ps + ra * PS_ROW + swz(ra, byte)) = pack_bf16(p0, p1);
        *reinterpret_cast<uint32_t*>(ps + rb * PS_ROW + swz(rb, byte)) = pack_bf16(p2, p3);
        *reinterpret_cast<uint32_t*>(dss + ra * PS_ROW + swz(ra, byte)) =
            pack_bf16(dp[jj][0], dp[jj][1]);
        *reinterpret_cast<uint32_t*>(dss + rb * PS_ROW + swz(rb, byte)) =
            pack_bf16(dp[jj][2], dp[jj][3]);
      }
      if (!TABLE && live) {
        BT* dbr = static_cast<BT*>(p.dbias) + ((long long)bh * p.L + x0 + ra) * p.L + k0 + c0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (ra + 8 * h >= xn) continue;
          BT* row = dbr + 8 * h * (long long)p.L;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int c = 8 * jj + 2 * t4, key = c0 + c;  // even: an even L aligns the pair
            store_row_pair(row + c, dp[jj][2 * h], dp[jj][2 * h + 1], key < kn, key + 1 < kn,
                           (p.L & 1) == 0);
          }
        }
      }
    }
    __syncthreads();

    // ---- dV += P^T.G, dK += dS^T.Q: keys 16 grp .., columns 64 half .. ------------
    if (grp * 16 < kn) {
      const int nkq = (xn + 15) >> 4;  // query steps holding a valid row
      const int prow0 = (mi >> 1) * 8 + (lane & 7);
      const int pbyte = (2 * grp + (mi & 1)) * 16;
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        if (kq >= nkq) break;
        const int prow = kq * 16 + prow0;
        uint32_t pa[4], da[4];
        ldsm_x4_trans(pa, smem_u32(ps) + prow * PS_ROW + swz(prow, pbyte));
        ldsm_x4_trans(da, smem_u32(dss) + prow * PS_ROW + swz(prow, pbyte));
        ab<4>(dv, pa, gs, kq, half * 64, lane);
        ab<4>(dk, da, qs, kq, half * 64, lane);
      }
    }

    // ---- this CTA's dQ partial dS.K_j (+ dS.E_j): query rows 16 grp .., columns 64 half ..
    if (grp * 16 < xn) {
      float dq[8][4];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[jj][e] = 0.f;
      const int nks = (kn + 15) >> 4;  // key steps holding a valid key
      const int arow = grp * 16 + (lane & 15);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk >= nks) break;
        uint32_t a[4];
        ldsm_x4(a, smem_u32(dss) + arow * PS_ROW + swz(arow, (2 * kk + (lane >> 4)) * 16));
        ab<4>(dq, a, smem_u32(ks), kk, half * 64, lane);
        if (TABLE) ab<4>(dq, a, smem_u32(es), kk, half * 64, lane);
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = half * 64 + 8 * jj + 2 * t4;
        store_pair(dqp + (r0 + g) * DQ_STRIDE + c, dq[jj][0], dq[jj][1]);
        store_pair(dqp + (r0 + g + 8) * DQ_STRIDE + c, dq[jj][2], dq[jj][3]);
      }
    }
    cluster.sync();  // every CTA's dQ partial is written, and stage i % 2 is free
    load_tile(i + 2);

    // ---- dQ rows: 16-row chunks c = j, j + nk, ... of the tile, summed in key-tile order
    __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(p.dq) + ((long long)bh * p.L + x0) * p.D;
    for (int c = j; c < 4; c += nk) {
      if (c * 16 >= xn) break;
#pragma unroll
      for (int u0 = 0; u0 < 16 * (DMAX / 4); u0 += CL_THREADS) {
        const int u = u0 + tid;
        const int r = c * 16 + u / (DMAX / 4), col = 4 * (u % (DMAX / 4));
        if (r >= xn || col >= p.D) continue;
        float4 part[4];  // every remote load in flight at once
#pragma unroll
        for (int rk = 0; rk < 4; ++rk)
          if (rk < nk)
            part[rk] = *reinterpret_cast<const float4*>(
                cluster.map_shared_rank(dqp, (unsigned)rk) + r * DQ_STRIDE + col);
        float4 acc = part[0];
#pragma unroll
        for (int rk = 1; rk < 4; ++rk) {
          if (rk >= nk) break;
          acc.x += part[rk].x;
          acc.y += part[rk].y;
          acc.z += part[rk].z;
          acc.w += part[rk].w;
        }
        __nv_bfloat16* dst = dqg + (long long)r * p.D + col;
        if ((p.D & 3) == 0) {  // four bf16 on 8 bytes
          uint2 packed;
          packed.x = pack_bf16(acc.x, acc.y);
          packed.y = pack_bf16(acc.z, acc.w);
          *reinterpret_cast<uint2*>(dst) = packed;
        } else {
          const float vals[4] = {acc.x, acc.y, acc.z, acc.w};
          for (int e = 0; e < 4 && col + e < p.D; ++e) dst[e] = __float2bfloat16_rn(vals[e]);
        }
      }
    }
  }
  cluster.sync();  // no CTA leaves while another may still read its dQ partial

  if (grp * 16 >= kn) return;
  const long long row0 = (long long)bh * p.L + k0 + grp * 16;
  store_tile(static_cast<__nv_bfloat16*>(p.dk), dk, row0, kn - grp * 16, half * 64, p.D, lane);
  store_tile(static_cast<__nv_bfloat16*>(p.dv), dv, row0, kn - grp * 16, half * 64, p.Dv, lane);
  if (TABLE) store_tile(p.demb_part, dk, row0, kn - grp * 16, half * 64, p.D, lane);
}

// ---------------------------------------------------------------------------
// bf16 at L > 256: three launches (the blockwise route)
// ---------------------------------------------------------------------------
//
// Replaces, for bf16 at L > 256, the XLA recompute of the JAX custom_vjp of
// K4 (`_blk_bwd`, distribuuuu_tpu/ops/attention.py:400, which is `_bwd`,
// :241) and of K5 (`_abs_blk_bwd`, :418, which is `_abs_bwd`, :514):
// BoTNet-50's MHSA at a 512^2 crop (L 1024) in training.
//
// What bounds it (H100 SXM, 3.35 TB/s, 989 TFLOP/s bf16): at K4's shape
// (B*N 32, L 1024, D = Dv = 128, bf16 bias) the call must move 193 MB (58 us;
// the bias and dbias are 134 MB of it) and do 43 GFLOP of products (43 us):
// bytes; the 512^2 training step (B*N 128) 4x both. In table mode the L^2
// terms go: 59 MB against the same 43 GFLOP, operations.
// The design: three kernels, no float atomics, one fixed order for every sum.
//   stats  a block per (batch*head, 64-query tile), 4 warps of 16 rows, laid
//          out as the forward kernel: Q and G stay in registers as A
//          fragments; the key tiles (K, V and the bias or emb tile) come
//          through the forward's two-stage cp.async ring; S = Q.K^T (+ bias |
//          + Q.E^T) and dP = G.V^T on mma.sync; per row the max m, the sum l
//          and u = sum dp exp(s - m), online in log2 units; writes (m, l,
//          delta = u / l) of each row to the f32 stats. 203-221 registers,
//          two blocks an SM.
//   kv     a block per (batch*head, 64-key tile), 16 warps, one block an SM.
//          K, V (and emb) of the key tile stay in shared memory; the walk
//          over the query tiles brings Q and G through a two-stage cp.async
//          ring (tile i + 1 in flight while tile i computes). Each (query
//          tile, key tile) pair forms S and dP once (a warp: 16 query rows x
//          16 keys), p = exp2(s - m) / l and ds = p (dp - delta) from the
//          rows' statistics, writes dbias (bias mode) and the bf16 ds of the
//          dq pass from registers, and puts P and dS in shared memory as
//          bf16 for dV += P^T.G and dK += dS^T.Q (a warp: 16 keys x 32
//          columns, summed in registers over the walk, in query order). The
//          bias and the statistics go from device memory straight to
//          registers, loaded before the tile's products hide their latency.
//          125-128 registers, no spills, 112 KB (128 KB in table mode).
//   dq     a block per (batch*head, 64-query tile), 4 warps of 16 rows: dq =
//          sum over the key tiles, in key order, of dS.K (+ dS.E), with dS
//          read back as bf16 (dbias itself under a bf16 bias, otherwise the
//          scratch the kv pass wrote) and K through a two-stage ring; four
//          blocks an SM (two in table mode).
// S and dP are formed twice a tile pair (stats, kv; the first tensor-core
// version formed them three times), so the products are 7 of L^2 D a head
// where 5 are the least; dS makes one more round trip through device memory
// in bf16 (67 MB at K4's shape, which is dbias itself under a bf16 bias). p
// and ds are rounded to bf16 as MMA operands (2^-9 relative), dbias and the
// statistics stay f32 until their final rounding. Ragged L, D and Dv as in
// the other routes: zero-fill past L, D or Dv in shared memory; a query row
// past L takes m = +inf (p = ds = 0), a key past L s = -inf.
// On the card (H100 SXM, 700 W; chip_smoke.py [attention-bwd]) the kv pass
// takes ~65 % of the call and runs at ~130 TFLOP/s, neither at its
// shared-memory (ldmatrix) bound nor at the tensor cores': each query tile's
// S phase and products sit between two block barriers, so the warps drain
// at each. Three other shapes of the kv pass were built and timed against
// this one: 8 warps at two blocks an SM (capped at 128 registers, it
// spilled, and was slower), 8 warps at one block an SM (about as fast, at
// 229 registers), and the bias tile through the cp.async ring instead of
// registers (slower).

// One key tile of the statistics sweep for this warp's 16 rows: the stage at
// `st` holds K, V and the bias or emb tile (the forward's MmaSmem ring); kn
// keys are valid (all of them when FULL). m0/m1 (log2 units), l0/l1 and
// u0/u1 of rows g and g + 8 are this thread's running shares.
template <typename BT, bool TABLE, bool FULL>
__device__ __forceinline__ void stats_step(const unsigned char* st, const uint32_t (&qf)[8][4],
                                           const uint32_t (&gf)[8][4], float& m0, float& m1,
                                           float& l0, float& l1, float& u0, float& u1, int kn,
                                           int warp, int lane) {
  using Smem = MmaSmem<BT, TABLE>;
  constexpr int NB = MBK / 8;
  const int g = lane >> 2, t4 = lane & 3;
  const int nsb = FULL ? NB : (kn + 7) >> 3;
  const uint32_t sk = smem_u32(st);
  float s[NB][4], dp[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
  qk_pass<FULL>(s, qf, sk, nsb, lane);
  if (TABLE) qk_pass<FULL>(s, qf, sk + 2 * Smem::KV, nsb, lane);
  qk_pass<FULL>(dp, gf, sk + Smem::KV, nsb, lane);
  if (!TABLE) {
    const unsigned char* r0 = st + 2 * Smem::KV + (warp * 16 + g) * BiasRow<BT>::BYTES;
    const unsigned char* r1 = r0 + 8 * BiasRow<BT>::BYTES;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float2 b0 = bias_pair(r0, 8 * j + 2 * t4, BT());
      const float2 b1 = bias_pair(r1, 8 * j + 2 * t4, BT());
      s[j][0] += b0.x;
      s[j][1] += b0.y;
      s[j][2] += b1.x;
      s[j][3] += b1.y;
    }
  }
  // logits in log2 units; keys past L: -inf
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[j][e] = (!FULL && 8 * j + 2 * t4 + (e & 1) >= kn) ? -INFINITY : s[j][e] * kLog2e;
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {  // the quad that shares rows g and g + 8
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);  // first tile: exp2(-inf) = 0
  float ls0 = 0.f, ls1 = 0.f, us0 = 0.f, us1 = 0.f;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const float e0 = exp2f(s[j][0] - mn0), e1 = exp2f(s[j][1] - mn0);
    const float e2 = exp2f(s[j][2] - mn1), e3 = exp2f(s[j][3] - mn1);
    ls0 += e0 + e1;
    ls1 += e2 + e3;
    us0 += e0 * dp[j][0] + e1 * dp[j][1];
    us1 += e2 * dp[j][2] + e3 * dp[j][3];
  }
  l0 = l0 * a0 + ls0;
  l1 = l1 * a1 + ls1;
  u0 = u0 * a0 + us0;
  u1 = u1 * a1 + us1;
  m0 = mn0;
  m1 = mn1;
}

template <typename BT, bool TABLE>
__global__ void __launch_bounds__(MMA_THREADS, 2)
    attention_bwd_stats_kernel(const BwdParams p, const BwdWidths w) {
  using Smem = MmaSmem<BT, TABLE>;
  extern __shared__ __align__(128) unsigned char smem[];

  const int nq = (p.L + BQ - 1) / BQ;
  const int bh = blockIdx.x / nq, qt = blockIdx.x - bh * nq;
  const int b = bh / p.heads, n = bh - b * p.heads;
  const int q0 = qt * BQ, qn = min(BQ, p.L - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bool active = warp * 16 < qn;
  const int nt = (p.L + MBK - 1) / MBK;
  const unsigned char* q = static_cast<const unsigned char*>(p.q) +
                           2 * (b * p.q_sb + n * p.q_sn + (long long)q0 * p.q_sl);
  const unsigned char* gg = static_cast<const unsigned char*>(p.g) +
                            2 * (b * p.g_sb + n * p.g_sn + (long long)q0 * p.g_sl);
  const unsigned char* k = static_cast<const unsigned char*>(p.k) + 2 * (b * p.k_sb + n * p.k_sn);
  const unsigned char* v = static_cast<const unsigned char*>(p.v) + 2 * (b * p.v_sb + n * p.v_sn);
  // the bias rows of this query tile, or the table; their row stride in bytes
  const unsigned char* x =
      TABLE ? static_cast<const unsigned char*>(p.emb)
            : static_cast<const unsigned char*>(p.bias) +
                  sizeof(BT) * (b * p.b_sb + n * p.b_sn + (long long)q0 * p.b_sl);
  const long long xs = TABLE ? 2 * p.e_sl : sizeof(BT) * p.b_sl;

  // key tile t's K, V and bias or emb tile into stage t % STAGES: one
  // cp.async group (an empty one past the last tile)
  auto load_tile = [&](int t) {
    if (t < nt) {
      const int k0 = t * MBK, kn = min(MBK, p.L - k0);
      unsigned char* st = smem + (t % STAGES) * Smem::STAGE;
      stage_rows<true>(st, k + 2 * k0 * p.k_sl, 2 * p.k_sl, MBK, kn, 2 * p.D, ROW_BYTES,
                       ROW_BYTES, w.wk, tid);
      stage_rows<true>(st + Smem::KV, v + 2 * k0 * p.v_sl, 2 * p.v_sl, MBK, kn, 2 * p.Dv,
                       ROW_BYTES, ROW_BYTES, w.wv, tid);
      if (TABLE)
        stage_rows<true>(st + 2 * Smem::KV, x + k0 * xs, xs, MBK, kn, 2 * p.D, ROW_BYTES,
                         ROW_BYTES, w.wx, tid);
      else
        stage_rows<false>(st + 2 * Smem::KV, x + sizeof(BT) * k0, xs, BQ, qn,
                          (int)sizeof(BT) * kn, (int)sizeof(BT) * MBK, BiasRow<BT>::BYTES, w.wx,
                          tid);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // Q and G go to the last stage's K and V slots; they are read into
  // registers before a tile is loaded there
  unsigned char* sq = smem + (STAGES - 1) * Smem::STAGE;
  stage_rows<true>(sq, q, 2 * p.q_sl, BQ, qn, 2 * p.D, ROW_BYTES, ROW_BYTES, w.wq, tid);
  stage_rows<true>(sq + Smem::KV, gg, 2 * p.g_sl, BQ, qn, 2 * p.Dv, ROW_BYTES, ROW_BYTES, w.wg,
                   tid);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) load_tile(t);

  uint32_t qf[8][4], gf[8][4];  // A fragments of this warp's 16 rows of Q and G
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, u0 = 0.f, u1 = 0.f;
  for (int t = 0; t < nt; ++t) {
    // tile t has landed and every warp is done with tile t - 1's stage
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    __syncthreads();
    if (t == 0) {
      if (active) {
        const int row = warp * 16 + (lane & 15);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const int byte = row * ROW_BYTES + swz(row, (2 * kk + (lane >> 4)) * 16);
          ldsm_x4(qf[kk], smem_u32(sq) + byte);
          ldsm_x4(gf[kk], smem_u32(sq + Smem::KV) + byte);
        }
      }
      if (nt >= STAGES) __syncthreads();  // Q and G are in registers: their slots may take a tile
    }
    load_tile(t + STAGES - 1);
    if (!active) continue;
    const int kn = min(MBK, p.L - t * MBK);
    const unsigned char* st = smem + (t % STAGES) * Smem::STAGE;
    if (kn == MBK)
      stats_step<BT, TABLE, true>(st, qf, gf, m0, m1, l0, l1, u0, u1, kn, warp, lane);
    else
      stats_step<BT, TABLE, false>(st, qf, gf, m0, m1, l0, l1, u0, u1, kn, warp, lane);
  }
  if (!active) return;
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {  // a xor butterfly: the same bits in the quad
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
    u0 += __shfl_xor_sync(0xffffffffu, u0, o);
    u1 += __shfl_xor_sync(0xffffffffu, u1, o);
  }
  const long long r0 = (long long)bh * p.L + q0 + warp * 16 + g;  // rows g and g + 8
  const int rows_left = qn - warp * 16;
  if (t4 == 0) {
    if (g < rows_left) {
      p.stats[r0] = m0;
      p.stats[p.rows + r0] = l0;
      p.stats[2 * p.rows + r0] = u0 / l0;
    }
    if (g + 8 < rows_left) {
      p.stats[r0 + 8] = m1;
      p.stats[p.rows + r0 + 8] = l1;
      p.stats[2 * p.rows + r0 + 8] = u1 / l1;
    }
  }
}

constexpr int KV_THREADS = 512;  // 16 warps
// a warp's S block: 16 query rows x KV_SK keys; its products: 16 keys x KV_PC columns
constexpr int KV_SK = 16, KV_PC = 32;

template <bool TABLE>
struct KvSmem {
  static constexpr int KV = BK * ROW_BYTES;         // a 64-row bf16 tile
  static constexpr int RES = (TABLE ? 3 : 2) * KV;  // K, V (and emb) of the key tile
  static constexpr int STAGE = 2 * KV;              // Q and G of a query tile
  static constexpr int PDS = 2 * BQ * PS_ROW;       // P, dS
  static constexpr int BYTES = RES + 2 * STAGE + PDS;
};

// Two adjacent bias values as loaded, converted to f32 where they are added.
template <typename BT>
struct BiasPair;
template <>
struct BiasPair<float> {
  using T = float2;
};
template <>
struct BiasPair<__nv_bfloat16> {
  using T = __nv_bfloat162;
};
__device__ __forceinline__ float2 pair_f32(float2 v) { return v; }
__device__ __forceinline__ float2 pair_f32(__nv_bfloat162 v) { return __bfloat1622float2(v); }

// src[0] and src[1] where v0 and v1 (0 elsewhere; v1 implies v0), one load
// where the pair is aligned.
template <typename BT>
__device__ __forceinline__ typename BiasPair<BT>::T load_bias_pair(const BT* src, bool aligned,
                                                                   bool v0, bool v1) {
  using P = typename BiasPair<BT>::T;
  if (aligned && v1) return __ldg(reinterpret_cast<const P*>(src));
  P r;
  r.x = v0 ? __ldg(src) : from_f32<BT>(0.f);
  r.y = v1 ? __ldg(src + 1) : from_f32<BT>(0.f);
  return r;
}

// dV += P^T.G and dK += dS^T.Q for keys 16 grp .. x columns 16 HP col ..,
// over the query steps of 16 that hold a valid row (all 4 when FULL).
template <bool FULL, int HP>
__device__ __forceinline__ void kv_products(float (&dv)[2 * HP][4], float (&dk)[2 * HP][4],
                                            uint32_t ps, uint32_t dss, uint32_t qs, uint32_t gs,
                                            int nkq, int grp, int col, int lane) {
  const int mi = lane >> 3;
  const int prow0 = (mi >> 1) * 8 + (lane & 7);
  const int pbyte = (2 * grp + (mi & 1)) * 16;
#pragma unroll
  for (int kq = 0; kq < 4; ++kq) {
    if (!FULL && kq >= nkq) break;
    const int prow = kq * 16 + prow0;
    uint32_t pa[4], da[4];
    ldsm_x4_trans(pa, ps + prow * PS_ROW + swz(prow, pbyte));
    ldsm_x4_trans(da, dss + prow * PS_ROW + swz(prow, pbyte));
    ab<HP>(dv, pa, gs, kq, col * 16 * HP, lane);
    ab<HP>(dk, da, qs, kq, col * 16 * HP, lane);
  }
}

template <typename BT, bool TABLE>
__global__ void __launch_bounds__(KV_THREADS, 1)
    attention_bwd_kv_kernel(const BwdParams p, const BwdWidths w) {
  using Smem = KvSmem<TABLE>;
  constexpr bool kOwnDs = TABLE || sizeof(BT) != 2;  // ds to its own scratch, not dbias
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ks = smem;
  unsigned char* vs = ks + Smem::KV;
  unsigned char* es = vs + Smem::KV;  // table mode
  unsigned char* ring = smem + Smem::RES;
  unsigned char* ps = ring + 2 * Smem::STAGE;
  unsigned char* dss = ps + BQ * PS_ROW;

  const int nk = (p.L + BK - 1) / BK, nq = (p.L + BQ - 1) / BQ;
  const int bh = blockIdx.x / nk, kt = blockIdx.x - bh * nk;
  const int b = bh / p.heads, n = bh - b * p.heads;
  const int k0 = kt * BK, kn = min(BK, p.L - k0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // S phase: query rows r0 = 16 grp .. x keys c0 = KV_SK part ..; products:
  // keys 16 grp .. x columns KV_PC part ..
  constexpr int JP = KV_SK / 16, HP = KV_PC / 16;
  const int grp = warp & 3, part = warp >> 2;
  const int r0 = grp * 16, c0 = part * KV_SK, ra = r0 + g, rb = ra + 8;

  const unsigned char* q = static_cast<const unsigned char*>(p.q) + 2 * (b * p.q_sb + n * p.q_sn);
  const unsigned char* gg = static_cast<const unsigned char*>(p.g) + 2 * (b * p.g_sb + n * p.g_sn);
  // this thread's bias pairs: keys k0 + c0 + 8 jj + 2 t4, +1 of a row
  const BT* bias = TABLE ? nullptr
                         : static_cast<const BT*>(p.bias) + b * p.b_sb + n * p.b_sn + k0 + c0 +
                               2 * t4;
  const bool bias_aligned = w.wx >= 2 * (int)sizeof(BT);
  const bool even = (p.L & 1) == 0;  // a pair of dbias / ds at an even index is aligned
  const float* stats = p.stats + (long long)bh * p.L;

  stage_rows<true, KV_THREADS>(ks, static_cast<const unsigned char*>(p.k) +
                                       2 * (b * p.k_sb + n * p.k_sn + (long long)k0 * p.k_sl),
                               2 * p.k_sl, BK, kn, 2 * p.D, ROW_BYTES, ROW_BYTES, w.wk, tid);
  stage_rows<true, KV_THREADS>(vs, static_cast<const unsigned char*>(p.v) +
                                       2 * (b * p.v_sb + n * p.v_sn + (long long)k0 * p.v_sl),
                               2 * p.v_sl, BK, kn, 2 * p.Dv, ROW_BYTES, ROW_BYTES, w.wv, tid);
  if (TABLE)
    stage_rows<true, KV_THREADS>(es, static_cast<const unsigned char*>(p.emb) +
                                         2 * (long long)k0 * p.e_sl,
                                 2 * p.e_sl, BK, kn, 2 * p.D, ROW_BYTES, ROW_BYTES, w.wx, tid);

  // query tile i's Q and G into stage i % 2: one cp.async group (an empty
  // one past the last tile)
  auto load_tile = [&](int i) {
    if (i < nq) {
      const int x0 = i * BQ, xn = min(BQ, p.L - x0);
      unsigned char* st = ring + (i & 1) * Smem::STAGE;
      stage_rows<true, KV_THREADS>(st, q + 2LL * x0 * p.q_sl, 2 * p.q_sl, BQ, xn, 2 * p.D,
                                   ROW_BYTES, ROW_BYTES, w.wq, tid);
      stage_rows<true, KV_THREADS>(st + Smem::KV, gg + 2LL * x0 * p.g_sl, 2 * p.g_sl, BQ, xn,
                                   2 * p.Dv, ROW_BYTES, ROW_BYTES, w.wg, tid);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  load_tile(0);  // with the resident tiles

  float dk[2 * HP][4], dv[2 * HP][4];
#pragma unroll
  for (int jj = 0; jj < 2 * HP; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[jj][e] = dv[jj][e] = 0.f;

  for (int i = 0; i < nq; ++i) {
    const int x0 = i * BQ, xn = min(BQ, p.L - x0);
    const bool live = r0 < xn && c0 < kn;  // the warp's S block holds a valid row and key
    const bool oka = ra < xn, okb = rb < xn;
    // the rows' statistics (a query past L: m = +inf, so p = ds = 0) and the
    // bias, loaded now so that their latency hides behind the products
    const float ma = oka ? __ldg(stats + x0 + ra) : INFINITY;
    const float la = oka ? __ldg(stats + p.rows + x0 + ra) : 1.f;
    const float da = oka ? __ldg(stats + 2 * p.rows + x0 + ra) : 0.f;
    const float mb = okb ? __ldg(stats + x0 + rb) : INFINITY;
    const float lb = okb ? __ldg(stats + p.rows + x0 + rb) : 1.f;
    const float db = okb ? __ldg(stats + 2 * p.rows + x0 + rb) : 0.f;
    typename BiasPair<BT>::T bp[2][2 * JP];
    if (!TABLE) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool ok = live && (h ? okb : oka);
        const BT* row = bias + (long long)(x0 + (h ? rb : ra)) * p.b_sl;
#pragma unroll
        for (int jj = 0; jj < 2 * JP; ++jj) {
          const int key = c0 + 8 * jj + 2 * t4;
          bp[h][jj] = load_bias_pair<BT>(row + 8 * jj, bias_aligned, ok && key < kn,
                                         ok && key + 1 < kn);
        }
      }
    }
    // tile i has landed, and every warp is done with tile i - 1 (its stage,
    // P and dS)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    load_tile(i + 1);
    const unsigned char* st = ring + (i & 1) * Smem::STAGE;
    const uint32_t qs = smem_u32(st), gs = qs + Smem::KV;

    // ---- S and dP: rows r0 .., keys c0 .. ------------------------------------
    float s[2 * JP][4], dp[2 * JP][4];
#pragma unroll
    for (int jj = 0; jj < 2 * JP; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jj][e] = dp[jj][e] = 0.f;
    if (live) {
      abt<JP, TABLE>(s, qs, r0, smem_u32(ks), smem_u32(es), c0, lane);
      abt<JP, false>(dp, gs, r0, smem_u32(vs), 0, c0, lane);
    }

    // ---- p = exp2(s - m) / l and ds = p (dp - delta); P and dS to shared memory
    const float ia = 1.f / la, ib = 1.f / lb;
#pragma unroll
    for (int jj = 0; jj < 2 * JP; ++jj) {
      float2 b0 = make_float2(0.f, 0.f), b1 = b0;
      if (!TABLE) {
        b0 = pair_f32(bp[0][jj]);
        b1 = pair_f32(bp[1][jj]);
      }
      const float bv[4] = {b0.x, b0.y, b1.x, b1.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool top = e < 2;  // row ra (else rb)
        const int key = c0 + 8 * jj + 2 * t4 + (e & 1);
        const float xl = (live && key < kn) ? (s[jj][e] + bv[e]) * kLog2e : -INFINITY;
        const float pr = exp2f(xl - (top ? ma : mb)) * (top ? ia : ib);
        dp[jj][e] = pr * (dp[jj][e] - (top ? da : db));
        s[jj][e] = pr;
      }
      const int byte = 2 * (c0 + 8 * jj + 2 * t4);
      *reinterpret_cast<uint32_t*>(ps + ra * PS_ROW + swz(ra, byte)) =
          pack_bf16(s[jj][0], s[jj][1]);
      *reinterpret_cast<uint32_t*>(ps + rb * PS_ROW + swz(rb, byte)) =
          pack_bf16(s[jj][2], s[jj][3]);
      *reinterpret_cast<uint32_t*>(dss + ra * PS_ROW + swz(ra, byte)) =
          pack_bf16(dp[jj][0], dp[jj][1]);
      *reinterpret_cast<uint32_t*>(dss + rb * PS_ROW + swz(rb, byte)) =
          pack_bf16(dp[jj][2], dp[jj][3]);
    }

    // ---- dbias (bias mode) and the bf16 ds of the dq pass, from registers ---------
    if (live) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!(h ? okb : oka)) continue;
        const long long off = ((long long)bh * p.L + x0 + (h ? rb : ra)) * p.L + k0 + c0;
#pragma unroll
        for (int jj = 0; jj < 2 * JP; ++jj) {
          const int c = 8 * jj + 2 * t4;
          const bool ok0 = c0 + c < kn, ok1 = c0 + c + 1 < kn;
          const float a = dp[jj][2 * h], bb = dp[jj][2 * h + 1];
          if (!TABLE)
            store_row_pair(static_cast<BT*>(p.dbias) + off + c, a, bb, ok0, ok1, even);
          if (kOwnDs)
            store_row_pair(static_cast<__nv_bfloat16*>(p.ds) + off + c, a, bb, ok0, ok1, even);
        }
      }
    }
    __syncthreads();

    // ---- dV += P^T.G, dK += dS^T.Q -------------------------------------------------
    if (grp * 16 < kn) {
      if (xn == BQ)
        kv_products<true, HP>(dv, dk, smem_u32(ps), smem_u32(dss), qs, gs, 4, grp, part, lane);
      else
        kv_products<false, HP>(dv, dk, smem_u32(ps), smem_u32(dss), qs, gs, (xn + 15) >> 4, grp,
                               part, lane);
    }
  }

  if (grp * 16 >= kn) return;
  const long long row0 = (long long)bh * p.L + k0 + grp * 16;
  const int col0 = part * KV_PC;
  store_tile(static_cast<__nv_bfloat16*>(p.dk), dk, row0, kn - grp * 16, col0, p.D, lane);
  store_tile(static_cast<__nv_bfloat16*>(p.dv), dv, row0, kn - grp * 16, col0, p.Dv, lane);
  if (TABLE) store_tile(p.demb_part, dk, row0, kn - grp * 16, col0, p.D, lane);
}

template <bool TABLE>
struct DqSmem {
  static constexpr int DS = BQ * PS_ROW;                   // 64 query rows x 64 keys of ds
  static constexpr int KV = BK * ROW_BYTES;                // a 64-row bf16 tile
  static constexpr int STAGE = DS + (TABLE ? 2 : 1) * KV;  // ds, K (and emb) of a key tile
  static constexpr int BYTES = STAGES * STAGE;
};

template <bool TABLE>
__global__ void __launch_bounds__(MMA_THREADS, TABLE ? 2 : 4)
    attention_bwd_dq_kernel(const BwdParams p, const BwdWidths w) {
  using Smem = DqSmem<TABLE>;
  extern __shared__ __align__(128) unsigned char smem[];

  const int nq = (p.L + BQ - 1) / BQ;
  const int bh = blockIdx.x / nq, qt = blockIdx.x - bh * nq;
  const int b = bh / p.heads, n = bh - b * p.heads;
  const int q0 = qt * BQ, qn = min(BQ, p.L - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool active = warp * 16 < qn;
  const int nt = (p.L + BK - 1) / BK;
  const unsigned char* ds =
      static_cast<const unsigned char*>(p.ds) + 2 * ((long long)bh * p.L + q0) * p.L;
  const unsigned char* k = static_cast<const unsigned char*>(p.k) + 2 * (b * p.k_sb + n * p.k_sn);
  const unsigned char* emb = static_cast<const unsigned char*>(p.emb);

  // key tile t's ds columns, K rows (and emb rows) into stage t % STAGES:
  // one cp.async group (an empty one past the last tile)
  auto load_tile = [&](int t) {
    if (t < nt) {
      const int k0 = t * BK, kn = min(BK, p.L - k0);
      unsigned char* st = smem + (t % STAGES) * Smem::STAGE;
      stage_rows<true>(st, ds + 2 * k0, 2LL * p.L, BQ, qn, 2 * kn, PS_ROW, PS_ROW, w.wds, tid);
      stage_rows<true>(st + Smem::DS, k + 2LL * k0 * p.k_sl, 2 * p.k_sl, BK, kn, 2 * p.D,
                       ROW_BYTES, ROW_BYTES, w.wk, tid);
      if (TABLE)
        stage_rows<true>(st + Smem::DS + Smem::KV, emb + 2LL * k0 * p.e_sl, 2 * p.e_sl, BK, kn,
                         2 * p.D, ROW_BYTES, ROW_BYTES, w.wx, tid);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  load_tile(0);

  float acc[16][4];  // dq rows g, g + 8 of the warp; columns 8 j + 2 t4, +1
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int arow = warp * 16 + (lane & 15);
  for (int t = 0; t < nt; ++t) {
    // tile t has landed and every warp is done with tile t - 1's stage
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    load_tile(t + 1);
    if (!active) continue;
    const int kn = min(BK, p.L - t * BK);
    const unsigned char* st = smem + (t % STAGES) * Smem::STAGE;
    uint32_t pa[4][4];  // dS as A fragments, key step kk (zero past L)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldsm_x4(pa[kk], smem_u32(st) + arow * PS_ROW + swz(arow, (2 * kk + (lane >> 4)) * 16));
    const uint32_t kt = smem_u32(st + Smem::DS);
    if (kn == BK) {
      pv_pass<true>(acc, pa, kt, 4, lane);
      if (TABLE) pv_pass<true>(acc, pa, kt + Smem::KV, 4, lane);
    } else {
      pv_pass<false>(acc, pa, kt, (kn + 15) >> 4, lane);
      if (TABLE) pv_pass<false>(acc, pa, kt + Smem::KV, (kn + 15) >> 4, lane);
    }
  }
  if (!active) return;
  store_tile(static_cast<__nv_bfloat16*>(p.dq), acc, (long long)bh * p.L + q0 + warp * 16,
             qn - warp * 16, 0, p.D, lane);
}

// ---------------------------------------------------------------------------
// demb = sum over B*N of the f32 dk partials (table mode)
// ---------------------------------------------------------------------------
//
// Two launches, no float atomics, a fixed order: the first sums the heads of
// each chunk of DEMB_CHUNK in order into an f32 [chunks, L*D] scratch (a
// thread an element, a block row of chunks along grid.y); the second sums
// the chunks in order and rounds once to emb's dtype. Bound by the bytes of
// the partial (B*N*L*D f32, read once).

constexpr int DEMB_THREADS = 256;
constexpr int DEMB_CHUNK = 8;  // heads a thread of the first pass sums

__global__ void __launch_bounds__(DEMB_THREADS)
    attention_bwd_demb_partial_kernel(const float* part, float* sums, long long heads,
                                      long long n) {
  const long long e = (long long)blockIdx.x * DEMB_THREADS + threadIdx.x;
  if (e >= n) return;
  const long long h0 = (long long)blockIdx.y * DEMB_CHUNK;
  const long long h1 = h0 + DEMB_CHUNK < heads ? h0 + DEMB_CHUNK : heads;
  float acc = 0.f;
  for (long long h = h0; h < h1; ++h) acc += part[h * n + e];
  sums[(long long)blockIdx.y * n + e] = acc;
}

template <typename T>
__global__ void __launch_bounds__(DEMB_THREADS)
    attention_bwd_demb_kernel(const float* sums, T* demb, int chunks, long long n) {
  const long long e = (long long)blockIdx.x * DEMB_THREADS + threadIdx.x;
  if (e >= n) return;
  float acc = 0.f;
  for (int c = 0; c < chunks; ++c) acc += sums[c * n + e];
  demb[e] = from_f32<T>(acc);
}

cudaError_t launch_demb(const BwdParams& p, float* sums, int dt, cudaStream_t stream) {
  const long long n = (long long)p.L * p.D, heads = p.rows / p.L;
  const long long chunks = (heads + DEMB_CHUNK - 1) / DEMB_CHUNK;
  const long long blocks = (n + DEMB_THREADS - 1) / DEMB_THREADS;
  if (chunks > 65535 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  attention_bwd_demb_partial_kernel<<<dim3((unsigned)blocks, (unsigned)chunks), DEMB_THREADS, 0,
                                      stream>>>(p.demb_part, sums, heads, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (dt == kBF16)
    attention_bwd_demb_kernel<__nv_bfloat16><<<(unsigned)blocks, DEMB_THREADS, 0, stream>>>(
        sums, static_cast<__nv_bfloat16*>(p.dbias), (int)chunks, n);
  else
    attention_bwd_demb_kernel<float><<<(unsigned)blocks, DEMB_THREADS, 0, stream>>>(
        sums, static_cast<float*>(p.dbias), (int)chunks, n);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

enum BwdRoute : int { kScalarRoute = 0, kBlockwise = 1, kCluster = 2 };

// The route of a dtype and L: the cluster kernel for bf16 at L <= CL_MAX_L,
// the three blockwise kernels for bf16 above it, the scalar ones for f32.
int bwd_route(int dt, int L) {
  if (dt == kF32) return kScalarRoute;
  return L <= CL_MAX_L ? kCluster : kBlockwise;
}

BwdWidths bwd_widths(const BwdParams& p, int bias_dt) {
  BwdWidths w;
  w.wq = copy_width(p.q, {2 * p.q_sb, 2 * p.q_sn, 2 * p.q_sl, 2LL * p.D});
  w.wk = copy_width(p.k, {2 * p.k_sb, 2 * p.k_sn, 2 * p.k_sl, 2LL * p.D});
  w.wv = copy_width(p.v, {2 * p.v_sb, 2 * p.v_sn, 2 * p.v_sl, 2LL * p.Dv});
  w.wg = copy_width(p.g, {2 * p.g_sb, 2 * p.g_sn, 2 * p.g_sl, 2LL * p.Dv});
  const long long e = bias_dt == kF32 ? 4 : 2;
  w.wx = bias_dt == kTable ? copy_width(p.emb, {2 * p.e_sl, 2LL * p.D})
                           : copy_width(p.bias, {e * p.b_sb, e * p.b_sn, e * p.b_sl, e * p.L});
  w.wds = p.ds ? copy_width(p.ds, {2LL * p.L}) : 2;
  return w;
}

// The blockwise route: the statistics, key-column and dq kernels, one grid
// of B*N * ceil(L / 64) blocks each, after the opt-in to their shared memory.
template <typename BT, bool TABLE>
cudaError_t launch_bwd_blockwise(const BwdParams& p, const BwdWidths& w, cudaStream_t stream) {
  constexpr int stats_bytes = MmaSmem<BT, TABLE>::BYTES;
  constexpr int kv_bytes = KvSmem<TABLE>::BYTES;
  constexpr int dq_bytes = DqSmem<TABLE>::BYTES;
  const long long tiles = (p.rows / p.L) * ((p.L + BQ - 1) / BQ);
  if (tiles > 0x7fffffffLL || p.ds == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_stats_kernel<BT, TABLE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, stats_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attention_bwd_kv_kernel<BT, TABLE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kv_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attention_bwd_dq_kernel<TABLE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return err;
  attention_bwd_stats_kernel<BT, TABLE>
      <<<(unsigned)tiles, MMA_THREADS, stats_bytes, stream>>>(p, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_kv_kernel<BT, TABLE><<<(unsigned)tiles, KV_THREADS, kv_bytes, stream>>>(p, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dq_kernel<TABLE><<<(unsigned)tiles, MMA_THREADS, dq_bytes, stream>>>(p, w);
  return cudaGetLastError();
}

template <typename BT, bool TABLE>
cudaError_t launch_bwd(const BwdParams& p, cudaStream_t stream) {
  const long long blocks = (p.rows + BWD_WARPS - 1) / BWD_WARPS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  attention_bwd_rows_kernel<BT, TABLE><<<(unsigned)blocks, BWD_WARPS * 32, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_cols_kernel<BT, TABLE><<<(unsigned)blocks, BWD_WARPS * 32, 0, stream>>>(p);
  return cudaGetLastError();
}

// The cluster kernel's launch configuration for B*N heads at this L: a
// cluster of ceil(L / 64) CTAs a head, after the opt-in to its shared memory.
template <typename BT, bool TABLE>
cudaError_t cluster_config(long long heads, int L, cudaStream_t stream, cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute& attr) {
  constexpr int bytes = ClusterSmem<BT, TABLE>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_cluster_kernel<BT, TABLE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int nk = (L + BK - 1) / BK;
  if (heads * nk > 0x7fffffffLL) return cudaErrorInvalidValue;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((unsigned)(heads * nk));
  cfg.blockDim = dim3(CL_THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)nk;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <typename BT, bool TABLE>
cudaError_t launch_bwd_cluster(const BwdParams& p, const BwdWidths& w, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<BT, TABLE>(p.rows / p.L, p.L, stream, cfg, attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, attention_bwd_cluster_kernel<BT, TABLE>, p, w);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename BT, bool TABLE>
cudaError_t cluster_occupancy(int L, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<BT, TABLE>(1, L, nullptr, cfg, attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(clusters, attention_bwd_cluster_kernel<BT, TABLE>, &cfg);
}

template <typename BT, bool TABLE>
cudaError_t launch_route(const BwdParams& p, const BwdWidths& w, int route, cudaStream_t s) {
  switch (route) {
    case kCluster:
      return launch_bwd_cluster<BT, TABLE>(p, w, s);
    case kBlockwise:
      return launch_bwd_blockwise<BT, TABLE>(p, w, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// bf16 q/k/v/g take the cluster or the blockwise route, f32 the scalar one;
// either with an f32 or a bf16 bias, or the table (then the demb kernels).
cudaError_t dispatch_bwd(const BwdParams& p, int dt, int bias_dt, int route, float* demb_sums,
                         cudaStream_t s) {
  if (route != bwd_route(dt, p.L)) return cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  if (dt == kBF16) {
    const BwdWidths w = bwd_widths(p, bias_dt);
    if (bias_dt == kF32) err = launch_route<float, false>(p, w, route, s);
    if (bias_dt == kBF16) err = launch_route<__nv_bfloat16, false>(p, w, route, s);
    if (bias_dt == kTable) err = launch_route<__nv_bfloat16, true>(p, w, route, s);
  } else if (dt == kF32) {
    if (bias_dt == kF32) err = launch_bwd<float, false>(p, s);
    if (bias_dt == kBF16) err = launch_bwd<__nv_bfloat16, false>(p, s);
    if (bias_dt == kTable) err = launch_bwd<float, true>(p, s);
  }
  if (err != cudaSuccess || bias_dt != kTable) return err;
  return launch_demb(p, demb_sums, dt, s);
}

}  // namespace

// Plain C entry point for ctypes. q/k/v/bias are [B, N, L, *] with the last
// axis contiguous and the given element strides of B, N and L; emb is [L, D]
// with row stride e_sl. dt: 0 = float32, 1 = bfloat16 for q, k, v, emb and
// out; bias_dt: the same codes, or -1 for table mode (bias = q . emb^T).
// bf16 takes the tensor-core kernel, f32 the scalar one.
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
  const Params p{q,    q_sb, q_sn, q_sl, k,   k_sb, k_sn, k_sl, v,     v_sb, v_sn, v_sl, bias, b_sb,
                 b_sn, b_sl, emb,  e_sl, out, heads, L,   D,    Dv,    0,    0,    0,    0,    0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dt) {
    case kF32:
      return (int)dispatch_vec<float>(p, bias_dt, batch * heads, s);
    case kBF16:
      return (int)dispatch_mma(p, bias_dt, batch * heads, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Plain C entry point of the backward for ctypes: q, k, v, the bias (or emb)
// and g as dtpu_attention_launch takes them (g is [B, N, L, Dv] like the
// output); dq, dk, dv and dlast contiguous, in the dtype of q (dt) and of the
// bias (bias_dt; -1: table mode, dlast is demb [L, D] in q's dtype). stats:
// an f32 scratch of 3 * B * N * L (blockwise and scalar routes); ds: the
// blockwise route's bf16 [B * N, L, L] ds (dlast itself for a bf16 bias, a
// scratch otherwise; null on the other routes); demb_part and demb_sums: f32
// scratch of B * N * L * D and ceil(B * N / 8) * L * D (table mode). route:
// 0 scalar, 1 blockwise, 2 cluster; it must be the route of dt and L
// (bwd_route). Launches on `stream`: one (cluster), three (blockwise:
// statistics, key columns, dq) or two (scalar: rows pass, then columns pass),
// then in table mode the two demb kernels. Returns cudaGetLastError() (0 =
// ok).
extern "C" int dtpu_attention_backward_launch(
    const void* q, long long q_sb, long long q_sn, long long q_sl,
    const void* k, long long k_sb, long long k_sn, long long k_sl,
    const void* v, long long v_sb, long long v_sn, long long v_sl,
    const void* bias, long long b_sb, long long b_sn, long long b_sl, int bias_dt,
    const void* emb, long long e_sl,
    const void* g, long long g_sb, long long g_sn, long long g_sl,
    void* dq, void* dk, void* dv, void* dlast, void* stats, void* ds, void* demb_part,
    void* demb_sums, int route, int dt, int batch, int heads, int L, int D, int Dv,
    void* stream) {
  if (batch <= 0 || heads <= 0 || L <= 0 || D <= 0 || D > DMAX || Dv <= 0 || Dv > DMAX)
    return (int)cudaErrorInvalidValue;
  const BwdParams p{q,    q_sb, q_sn, q_sl, k,    k_sb, k_sn, k_sl, v,     v_sb,
                    v_sn, v_sl, bias, b_sb, b_sn, b_sl, emb,  e_sl, g,     g_sb,
                    g_sn, g_sl, dq,   dk,   dv,   dlast, static_cast<float*>(demb_part),
                    static_cast<float*>(stats), ds, (long long)batch * heads * L, heads, L, D,
                    Dv};
  return (int)dispatch_bwd(p, dt, bias_dt, route, static_cast<float*>(demb_sums),
                           static_cast<cudaStream_t>(stream));
}

// How many clusters of the backward's cluster route can be resident at once
// at this L (bias_dt as above; q/k/v bf16), into *clusters: 0 means the card
// cannot run the route. Returns the CUDA error (0 = ok).
extern "C" int dtpu_attention_backward_cluster_occupancy(int bias_dt, int L, int* clusters) {
  if (L <= 0 || L > CL_MAX_L) return (int)cudaErrorInvalidValue;
  switch (bias_dt) {
    case kF32:
      return (int)cluster_occupancy<float, false>(L, clusters);
    case kBF16:
      return (int)cluster_occupancy<__nv_bfloat16, false>(L, clusters);
    case kTable:
      return (int)cluster_occupancy<__nv_bfloat16, true>(L, clusters);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
