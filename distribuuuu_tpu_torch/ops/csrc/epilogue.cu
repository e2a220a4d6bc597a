// Fused conv epilogue for Hopper (sm_90a): BN-apply -> cast -> (+residual) -> ReLU,
// written in the BN dtype, in the next conv's dtype, or in both from one pass.
//
// Replaces distribuuuu_tpu/ops/epilogue.py::_epilogue_kernel (the Pallas TPU
// kernel behind fused_conv_epilogue). Per element of a channels-last [R, C]
// conv output:
//
//     y = ((x - mean[c]) * mul[c]) + bias[c]     in f32, mul = rsqrt(var+eps)*scale
//     y = round_to(bn_dtype, y)
//     y = y + residual                           in f32
//     y = max(y, 0)                              when relu
//     out  = round_to(out_dtype, y)              the BN boundary (a residual, the head)
//     cast = round_to(cast_dtype, out)           the next conv's input
//
// x may also be an int32 accumulator (the int8 path's quantized conv): it is
// converted to f32 with round-to-nearest (__int2float_rn, as the plain
// version's promotion), and with mean 0, mul the dequant scale and bias the
// folded BN's shift the first line is the dequant acc * scale + bias.
//
// Either output may be left out. In eager PyTorch the next conv's bf16 input
// would otherwise be a separate cast pass over the f32 boundary (XLA folds
// that convert into the conv; here only this pass can absorb it).
//
// What bounds it on this card: HBM bytes. About five flops per element
// against 2-12 bytes, far below the H100's ~20 f32 flops per byte, so the
// least time is (bytes of x + residual + outputs) / 3.35 TB/s.
//
// Design. Vector route: each thread owns one group of 8 contiguous channels
// for its whole life and keeps that group's mean/mul/bias in 24 registers;
// no per-element channel index, no modulo. Thread t of the grid handles
// group t % G (G = C / 8) of rows t / G, t / G + S, ... with S = (threads in
// the grid) / G, so one pass of the grid covers one contiguous chunk of
// memory and every access is a 16-byte load or store, neighbouring threads
// on neighbouring addresses. A thread issues the loads of kUnroll rows
// before it uses the first (memory-level parallelism). The host sizes the
// grid from the rows, capped at one wave of resident blocks (SM count x
// occupancy), in a multiple of G / gcd(G, kThreads) blocks so that every
// thread's group stays fixed. Block size 256, fixed: a sweep of 128, 256
// and 512 threads on the H100 while the kernel was designed timed them
// alike at the widest, a middle and the narrowest ResNet-50 site; 2 or 8
// rows in flight, streaming loads and stores, or a launch bound of 4
// blocks an SM timed no better. Scalar route, same file: one element per
// thread in a grid-stride loop, for C % 8 != 0 or a pointer not aligned to
// 16 bytes; the wrapper picks the route and counts it.
//
// Backward (K1-bwd), same file: it stands in for the XLA recompute in the
// Pallas kernel's custom_vjp (distribuuuu_tpu/ops/epilogue.py:222, :254).
// From the saved x, affine and residual it recomputes the pre-ReLU value
// (never saving the output), and in one pass over [R, C] writes d_x (x's
// dtype) and d_identity (the residual's dtype), and sums per channel
// d_mean = -sum(g * mul), d_mul = sum(g * (x - mean)), d_bias = sum(g), each
// term rounded as autograd through the plain version rounds it. The sums
// are deterministic, without float atomics: a block of 256 threads covers
// up to 32 8-channel groups (a thread keeps its group for life, as the
// forward's vector route) times 256 / groups row lanes; each thread sums its
// rows in order, the block adds its lanes in lane order through shared
// memory and writes one partial per channel, and a second small kernel adds
// the blocks' partials in a fixed order. Bound: HBM bytes (g, x, the
// residual read once; d_x, d_identity written once; about ten f32 operations
// per element), so what counts is the bytes in flight: the block's
// mean/mul/bias sit in shared memory, two blocks an SM, and the training
// case (everything bf16, one gradient) has a route of its own that keeps
// its loads packed, four rows of x, g and the residual in flight a thread.
// A scalar route of the general kernel (masked element loads) takes
// C % 8 != 0 or pointers off 16 bytes.
//
// Bitwise equality with the plain PyTorch version: nvcc would contract
// (x - mean) * mul + bias into an FMA, which rounds once where the plain
// version (separate eager ops) rounds twice. The arithmetic therefore uses
// the explicitly rounded intrinsics __fsub_rn / __fmul_rn / __fadd_rn, which
// are never contracted, and bf16 rounding is __float2bfloat16_rn.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType : int { kF32 = 0, kBF16 = 1, kI32 = 2, kNone = -1 };  // kI32: x alone
using bf16 = __nv_bfloat16;

constexpr int kUnroll = 4;       // rows in flight per thread (vector route)
constexpr int kThreads = 256;   // block size of both routes

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int32_t v) { return __int2float_rn(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

// One element, up to the out dtype's rounding, returned as f32 (exact in
// either output type that is at least as wide).
template <typename BT, typename OT, bool HAS_RES>
__device__ __forceinline__ float epilogue_value(float x, float m, float k, float b, float r,
                                                int relu) {
  float y = __fadd_rn(__fmul_rn(__fsub_rn(x, m), k), b);
  y = to_f32(from_f32<BT>(y));
  if constexpr (HAS_RES) y = __fadd_rn(y, r);
  if (relu && y < 0.f) y = 0.f;  // NaN passes through, as torch.relu
  return to_f32(from_f32<OT>(y));
}

// 8 consecutive values at a 16-byte-aligned p, as f32
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float v[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // little-endian: element 2i is the low half of word i
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8(const int32_t* p, float v[8]) {
  const int4 a = __ldg(reinterpret_cast<const int4*>(p));
  const int4 b = __ldg(reinterpret_cast<const int4*>(p) + 1);
  const int w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __int2float_rn(w[i]);
}

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(bf16* p, const float v[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i])) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1])) << 16);
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// RT is ignored when HAS_RES is false; out or cast may be null (not both).
template <typename XT, typename BT, typename RT, typename OT, typename CT, bool HAS_RES>
__global__ void __launch_bounds__(kThreads)
    epilogue_vec_kernel(const XT* __restrict__ x, const float* __restrict__ mean,
                        const float* __restrict__ mul, const float* __restrict__ bias,
                        const RT* __restrict__ res, OT* __restrict__ out, CT* __restrict__ cast,
                        int64_t rows, int groups, int relu) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t step = (int64_t)gridDim.x * blockDim.x / groups;  // exact: see launch()
  const int g = (int)(tid % groups);
  const int64_t c = 8LL * groups;
  float m[8], k[8], b[8];
  load8(mean + 8 * g, m);
  load8(mul + 8 * g, k);
  load8(bias + 8 * g, b);
  for (int64_t row = tid / groups; row < rows; row += kUnroll * step) {
    float v[kUnroll][8], r[kUnroll][8];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t ru = row + u * step;
      if (ru < rows) {
        load8(x + ru * c + 8 * g, v[u]);
        if constexpr (HAS_RES) load8(res + ru * c + 8 * g, r[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t ru = row + u * step;
      if (ru >= rows) break;
      float o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        o[e] = epilogue_value<BT, OT, HAS_RES>(v[u][e], m[e], k[e], b[e],
                                               HAS_RES ? r[u][e] : 0.f, relu);
      if (out) store8(out + ru * c + 8 * g, o);
      if (cast) store8(cast + ru * c + 8 * g, o);
    }
  }
}

template <typename XT, typename BT, typename RT, typename OT, typename CT, bool HAS_RES>
__global__ void __launch_bounds__(kThreads)
    epilogue_scalar_kernel(const XT* __restrict__ x, const float* __restrict__ mean,
                           const float* __restrict__ mul, const float* __restrict__ bias,
                           const RT* __restrict__ res, OT* __restrict__ out,
                           CT* __restrict__ cast, int64_t n, int c, int relu) {
  const int64_t start = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int cstep = (int)(stride % c);
  int ch = (int)(start % c);  // carried incrementally, no modulo per element
  for (int64_t i = start; i < n; i += stride) {
    float r = 0.f;
    if constexpr (HAS_RES) r = to_f32(res[i]);
    const float o = epilogue_value<BT, OT, HAS_RES>(to_f32(x[i]), __ldg(mean + ch),
                                                    __ldg(mul + ch), __ldg(bias + ch), r, relu);
    if (out) out[i] = from_f32<OT>(o);
    if (cast) cast[i] = from_f32<CT>(o);
    ch += cstep;
    if (ch >= c) ch -= c;
  }
}

int64_t gcd64(int64_t a, int64_t b) {
  while (b) {
    const int64_t t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// Blocks the card holds at once: SMs x blocks per SM. `per_sm` caches the
// occupancy query (it costs more than a launch); each kernel instantiation
// passes its own cache.
template <typename Kernel>
int64_t resident_blocks(Kernel kernel, int* per_sm) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (*per_sm <= 0 &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, 0) != cudaSuccess)
    *per_sm = 0;
  return (int64_t)sms * (*per_sm > 0 ? *per_sm : 1);
}

struct Args {
  const void *x, *mean, *mul, *bias, *res;
  void *out, *cast;
  int64_t rows;
  int c, relu, vec;
  cudaStream_t stream;
};

template <typename XT, typename BT, typename RT, typename OT, typename CT, bool HAS_RES>
cudaError_t launch(const Args& a) {
  const XT* x = static_cast<const XT*>(a.x);
  const float* mean = static_cast<const float*>(a.mean);
  const float* mul = static_cast<const float*>(a.mul);
  const float* bias = static_cast<const float*>(a.bias);
  const RT* res = static_cast<const RT*>(a.res);
  OT* out = static_cast<OT*>(a.out);
  CT* cast = static_cast<CT*>(a.cast);
  static int vec_per_sm = 0, scalar_per_sm = 0;
  if (a.vec) {
    auto kernel = epilogue_vec_kernel<XT, BT, RT, OT, CT, HAS_RES>;
    const int groups = a.c / 8;
    const int64_t units = a.rows * groups;  // 8-channel vectors
    int64_t blocks = (units + kThreads * kUnroll - 1) / (kThreads * kUnroll);
    const int64_t cap = resident_blocks(kernel, &vec_per_sm);  // one wave
    if (blocks > cap) blocks = cap;
    // the grid's thread count a multiple of groups: each thread keeps one group
    const int64_t m = groups / gcd64(groups, kThreads);
    blocks = (blocks + m - 1) / m * m;
    kernel<<<(unsigned)blocks, kThreads, 0, a.stream>>>(x, mean, mul, bias, res, out, cast,
                                                        a.rows, groups, a.relu);
  } else {
    auto kernel = epilogue_scalar_kernel<XT, BT, RT, OT, CT, HAS_RES>;
    const int64_t n = a.rows * a.c;
    int64_t blocks = (n + kThreads - 1) / kThreads;
    const int64_t cap = resident_blocks(kernel, &scalar_per_sm);
    if (blocks > cap) blocks = cap;
    kernel<<<(unsigned)blocks, kThreads, 0, a.stream>>>(x, mean, mul, bias, res, out, cast, n,
                                                        a.c, a.relu);
  }
  return cudaGetLastError();
}

template <typename XT, typename BT, typename RT, typename OT, bool HAS_RES>
cudaError_t dispatch_cast(const Args& a, int cast_dt) {
  switch (cast_dt) {
    case kF32:
      return launch<XT, BT, RT, OT, float, HAS_RES>(a);
    case kBF16:
      return launch<XT, BT, RT, OT, bf16, HAS_RES>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename XT, typename BT>
cudaError_t dispatch_res(const Args& a, int res_dt, int cast_dt) {
  // out dtype = result_type(bn_dtype, residual dtype): f32 unless both are bf16
  constexpr bool kBnF32 = sizeof(BT) == 4;
  constexpr int kBnDt = kBnF32 ? kF32 : kBF16;
  switch (res_dt) {
    case kNone:  // no cast output: its type is the out type, unused
      return dispatch_cast<XT, BT, BT, BT, false>(a, cast_dt == kNone ? kBnDt : cast_dt);
    case kF32:
      return dispatch_cast<XT, BT, float, float, true>(a, cast_dt == kNone ? kF32 : cast_dt);
    case kBF16:
      if (kBnF32)
        return dispatch_cast<XT, BT, bf16, float, true>(a, cast_dt == kNone ? kF32 : cast_dt);
      return dispatch_cast<XT, BT, bf16, bf16, true>(a, cast_dt == kNone ? kBF16 : cast_dt);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename XT>
cudaError_t dispatch_bn(const Args& a, int bn_dt, int res_dt, int cast_dt) {
  switch (bn_dt) {
    case kF32:
      return dispatch_res<XT, float>(a, res_dt, cast_dt);
    case kBF16:
      return dispatch_res<XT, bf16>(a, res_dt, cast_dt);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---- backward -------------------------------------------------------------

__device__ __forceinline__ float round_dt(int dt, float v) {
  return dt == kBF16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// 8 values of a dtype-coded array from element `off`: one or two 16-byte
// loads on the vector route, `valid` (<= 8) masked element loads otherwise
template <bool VEC>
__device__ __forceinline__ void load8_dt(const void* base, int dt, int64_t off, int valid,
                                         float v[8]) {
  if constexpr (VEC) {
    if (dt == kF32)
      load8(static_cast<const float*>(base) + off, v);
    else
      load8(static_cast<const bf16*>(base) + off, v);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = e >= valid ? 0.f
             : dt == kF32 ? static_cast<const float*>(base)[off + e]
                          : __bfloat162float(static_cast<const bf16*>(base)[off + e]);
  }
}

template <bool VEC>
__device__ __forceinline__ void store8_dt(void* base, int dt, int64_t off, int valid,
                                          const float v[8]) {
  if constexpr (VEC) {
    if (dt == kF32)
      store8(static_cast<float*>(base) + off, v);
    else
      store8(static_cast<bf16*>(base) + off, v);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (e >= valid) break;
      if (dt == kF32)
        static_cast<float*>(base)[off + e] = v[e];
      else
        static_cast<bf16*>(base)[off + e] = __float2bfloat16_rn(v[e]);
    }
  }
}

constexpr int kBwdUnroll = 2;  // rows in flight per thread

struct BwdArgs {
  const void* x;
  const float *mean, *mul, *bias;
  const void *res, *g_out, *g_cast;  // res: only when relu (the mask); either g may be null
  void *d_x, *d_res;                  // d_res null: no residual gradient wanted
  float* partials;                    // [blocks_x, 3, c]
  int64_t rows;
  int c, groups;                      // groups = ceil(c / 8)
  int x_dt, res_dt, out_dt, cast_dt, bn_dt, has_res, relu;
};

// Block (bx, by) takes groups by * gpb + (tid % gpb) and rows bx * lanes +
// tid / gpb + k * gridDim.x * lanes. Per element, from the gradient g at the
// boundary (the cast output's gradient rounded to the boundary dtype and
// added, as autograd sums two uses): the ReLU mask from the recomputed
// boundary value (g kept unless it is <= 0, as threshold_backward), d_identity
// = g in the residual's dtype, g1 = g in the BN dtype, then g1 * mul and
// g1 * (x - mean) with the forward's explicitly rounded arithmetic.
template <bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
    epilogue_bwd_kernel(const BwdArgs a, int gpb, int lanes) {
  __shared__ float red[24][kThreads];
  // the block's mean/mul/bias, [vector][element][group]: a warp reads them
  // without bank conflicts, and they cost no registers
  __shared__ float vecs[3][8 * 32];
  const int gi = threadIdx.x % gpb, lane = threadIdx.x / gpb;
  const int g = blockIdx.y * gpb + gi;
  for (int i = threadIdx.x; i < 8 * gpb; i += kThreads) {
    const int e = i / gpb, ch = 8 * (blockIdx.y * gpb + i % gpb) + e;
    vecs[0][i] = ch < a.c ? a.mean[ch] : 0.f;
    vecs[1][i] = ch < a.c ? a.mul[ch] : 0.f;
    vecs[2][i] = ch < a.c ? a.bias[ch] : 0.f;
  }
  __syncthreads();
  const float* m = vecs[0] + gi;  // element e of the thread's group at [e * gpb]
  const float* k = vecs[1] + gi;
  const float* b = vecs[2] + gi;
  float s[24];  // d_mean[8], d_mul[8], d_bias[8]
#pragma unroll
  for (int v = 0; v < 24; ++v) s[v] = 0.f;
  if (lane < lanes && g < a.groups) {
    const int c0 = 8 * g, valid = min(8, a.c - c0);
    const int64_t step = (int64_t)gridDim.x * lanes;
    const bool need_res = a.has_res && a.relu;
    for (int64_t row = (int64_t)blockIdx.x * lanes + lane; row < a.rows;
         row += kBwdUnroll * step) {
      float xv[kBwdUnroll][8], go[kBwdUnroll][8], gc[kBwdUnroll][8], rv[kBwdUnroll][8];
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u) {
        const int64_t ru = row + u * step;
        if (ru < a.rows) {
          const int64_t off = ru * a.c + c0;
          load8_dt<VEC>(a.x, a.x_dt, off, valid, xv[u]);
          if (a.g_out) load8_dt<VEC>(a.g_out, a.out_dt, off, valid, go[u]);
          if (a.g_cast) load8_dt<VEC>(a.g_cast, a.cast_dt, off, valid, gc[u]);
          if (need_res) load8_dt<VEC>(a.res, a.res_dt, off, valid, rv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u) {
        const int64_t ru = row + u * step;
        if (ru >= a.rows) break;
        const int64_t off = ru * a.c + c0;
        float dx[8], dr[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float gv = a.g_out ? go[u][e] : 0.f;
          if (a.g_cast) {
            const float gcv = round_dt(a.out_dt, gc[u][e]);
            gv = a.g_out ? round_dt(a.out_dt, __fadd_rn(gv, gcv)) : gcv;
          }
          const float ke = k[e * gpb];
          const float d = __fsub_rn(xv[u][e], m[e * gpb]);
          if (a.relu) {
            float y = round_dt(a.bn_dt, __fadd_rn(__fmul_rn(d, ke), b[e * gpb]));
            if (a.has_res) y = round_dt(a.out_dt, __fadd_rn(y, rv[u][e]));
            if (y <= 0.f) gv = 0.f;  // NaN keeps its gradient, as threshold_backward
          }
          dr[e] = gv;
          const float g1 = round_dt(a.bn_dt, gv);
          const float ga = __fmul_rn(g1, ke);
          dx[e] = ga;
          s[e] = __fsub_rn(s[e], ga);
          s[8 + e] = __fadd_rn(s[8 + e], __fmul_rn(g1, d));
          s[16 + e] = __fadd_rn(s[16 + e], g1);
        }
        store8_dt<VEC>(a.d_x, a.x_dt, off, valid, dx);
        if (a.d_res) store8_dt<VEC>(a.d_res, a.res_dt, off, valid, dr);
      }
    }
  }
  // the block's lanes, added in lane order: one partial per channel
#pragma unroll
  for (int v = 0; v < 24; ++v) red[v][threadIdx.x] = s[v];
  __syncthreads();
  for (int item = threadIdx.x; item < 24 * gpb; item += kThreads) {
    const int v = item / gpb, gj = item % gpb;
    const int ch = 8 * (blockIdx.y * gpb + gj) + v % 8;
    if (ch >= a.c) continue;
    float t = 0.f;
    for (int l = 0; l < lanes; ++l) t = __fadd_rn(t, red[v][l * gpb + gj]);
    a.partials[((int64_t)blockIdx.x * 3 + v / 8) * a.c + ch] = t;
  }
}

__device__ __forceinline__ void unpack8(const uint4 u, float v[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack8(const float v[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i])) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1])) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

constexpr int kBwdRows = 4;  // rows in flight per thread (training route)

// The training case of the kernel above, the same arithmetic: x, g, the
// residual and the BN boundary all bf16, one gradient, the vector route.
// The loads stay packed (four registers a row and array) until used, so a
// thread keeps four rows of x, g and the residual in flight at two blocks
// an SM: twice the bytes in flight of the general route.
__global__ void __launch_bounds__(kThreads, 2)
    epilogue_bwd_bf16_kernel(const BwdArgs a, int gpb, int lanes) {
  __shared__ float red[24][kThreads];
  __shared__ float vecs[3][8 * 32];
  const int gi = threadIdx.x % gpb, lane = threadIdx.x / gpb;
  const int g = blockIdx.y * gpb + gi;
  for (int i = threadIdx.x; i < 8 * gpb; i += kThreads) {
    const int e = i / gpb, ch = 8 * (blockIdx.y * gpb + i % gpb) + e;
    vecs[0][i] = ch < a.c ? a.mean[ch] : 0.f;
    vecs[1][i] = ch < a.c ? a.mul[ch] : 0.f;
    vecs[2][i] = ch < a.c ? a.bias[ch] : 0.f;
  }
  __syncthreads();
  const float* m = vecs[0] + gi;
  const float* k = vecs[1] + gi;
  const float* b = vecs[2] + gi;
  float s[24];
#pragma unroll
  for (int v = 0; v < 24; ++v) s[v] = 0.f;
  if (lane < lanes && g < a.groups) {
    const bf16* x = static_cast<const bf16*>(a.x) + 8 * g;
    const bf16* gp = static_cast<const bf16*>(a.g_out) + 8 * g;
    const bf16* res = static_cast<const bf16*>(a.res) + 8 * g;
    bf16* d_x = static_cast<bf16*>(a.d_x) + 8 * g;
    bf16* d_res = static_cast<bf16*>(a.d_res) + 8 * g;
    const int64_t step = (int64_t)gridDim.x * lanes;
    const bool need_res = a.has_res && a.relu;
    for (int64_t row = (int64_t)blockIdx.x * lanes + lane; row < a.rows;
         row += kBwdRows * step) {
      uint4 xr[kBwdRows], gr[kBwdRows], rr[kBwdRows];
#pragma unroll
      for (int u = 0; u < kBwdRows; ++u) {
        const int64_t ru = row + u * step;
        if (ru < a.rows) {
          xr[u] = __ldg(reinterpret_cast<const uint4*>(x + ru * a.c));
          gr[u] = __ldg(reinterpret_cast<const uint4*>(gp + ru * a.c));
          if (need_res) rr[u] = __ldg(reinterpret_cast<const uint4*>(res + ru * a.c));
        }
      }
#pragma unroll
      for (int u = 0; u < kBwdRows; ++u) {
        const int64_t ru = row + u * step;
        if (ru >= a.rows) break;
        float xv[8], gv[8], rv[8], dx[8];
        unpack8(xr[u], xv);
        unpack8(gr[u], gv);
        if (need_res) unpack8(rr[u], rv);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float ke = k[e * gpb];
          const float d = __fsub_rn(xv[e], m[e * gpb]);
          if (a.relu) {
            float y = round_bf16(__fadd_rn(__fmul_rn(d, ke), b[e * gpb]));
            if (a.has_res) y = round_bf16(__fadd_rn(y, rv[e]));
            if (y <= 0.f) gv[e] = 0.f;  // NaN keeps its gradient, as threshold_backward
          }
          const float ga = __fmul_rn(gv[e], ke);
          dx[e] = ga;
          s[e] = __fsub_rn(s[e], ga);
          s[8 + e] = __fadd_rn(s[8 + e], __fmul_rn(gv[e], d));
          s[16 + e] = __fadd_rn(s[16 + e], gv[e]);
        }
        *reinterpret_cast<uint4*>(d_x + ru * a.c) = pack8(dx);
        if (a.d_res) *reinterpret_cast<uint4*>(d_res + ru * a.c) = pack8(gv);
      }
    }
  }
#pragma unroll
  for (int v = 0; v < 24; ++v) red[v][threadIdx.x] = s[v];
  __syncthreads();
  for (int item = threadIdx.x; item < 24 * gpb; item += kThreads) {
    const int v = item / gpb, gj = item % gpb;
    const int ch = 8 * (blockIdx.y * gpb + gj) + v % 8;
    if (ch >= a.c) continue;
    float t = 0.f;
    for (int l = 0; l < lanes; ++l) t = __fadd_rn(t, red[v][l * gpb + gj]);
    a.partials[((int64_t)blockIdx.x * 3 + v / 8) * a.c + ch] = t;
  }
}

// d_stats[i] = sum over the blocks' partials[b][i], b in a fixed order: a
// block covers 32 of the 3c columns with 8 lanes, lane l adding blocks l,
// l + 8, ... and the lanes added in order.
__global__ void __launch_bounds__(kThreads)
    epilogue_bwd_finalize(const float* __restrict__ partials, float* __restrict__ d_stats,
                          int blocks, int n3c) {
  __shared__ float sh[8][32];
  const int col = blockIdx.x * 32 + threadIdx.x % 32, lane = threadIdx.x / 32;
  float t = 0.f;
  if (col < n3c)
    for (int b = lane; b < blocks; b += 8) t = __fadd_rn(t, partials[(int64_t)b * n3c + col]);
  sh[lane][threadIdx.x % 32] = t;
  __syncthreads();
  if (lane == 0 && col < n3c) {
    float u = sh[0][threadIdx.x];
    for (int l = 1; l < 8; ++l) u = __fadd_rn(u, sh[l][threadIdx.x]);
    d_stats[col] = u;
  }
}

}  // namespace

// Plain C entry point for ctypes. dtype codes: 0 = float32, 1 = bfloat16,
// 2 = int32 (x only: a quantized conv's accumulator), -1 = none (no residual /
// no cast output). `out` (the out dtype) or `cast`
// (cast_dt) may be null, not both. vec = 1 takes the vector route (the
// caller guarantees c % 8 == 0 and 16-byte-aligned pointers), 0 the scalar
// one. Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int dtpu_epilogue_launch(const void* x, int x_dt, const void* mean, const void* mul,
                                    const void* bias, const void* res, int res_dt, void* out,
                                    void* cast, int cast_dt, int bn_dt, long long rows, int c,
                                    int relu, int vec, void* stream) {
  if (rows <= 0 || c <= 0 || (out == nullptr && cast == nullptr) ||
      (cast != nullptr) != (cast_dt != kNone) || (res != nullptr) != (res_dt != kNone) ||
      (vec && c % 8 != 0))
    return (int)cudaErrorInvalidValue;
  const Args a{x, mean, mul, bias, res, out, cast, rows, c, relu, vec,
               static_cast<cudaStream_t>(stream)};
  switch (x_dt) {
    case kF32:
      return (int)dispatch_bn<float>(a, bn_dt, res_dt, cast_dt);
    case kBF16:
      return (int)dispatch_bn<bf16>(a, bn_dt, res_dt, cast_dt);
    case kI32:
      return (int)dispatch_bn<int32_t>(a, bn_dt, res_dt, cast_dt);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K1's backward (the two kernels above, on one stream). Dtype codes as
// above; g_out (out_dt), g_cast (cast_dt), res (needed when relu and
// has_res) and d_res may be null. partials: blocks_x * 3 * c floats;
// d_stats: 3 * c floats (d_mean, d_mul, d_bias). The caller picks the grid:
// gpb 8-channel groups per block (<= 32), lanes = 256 / gpb, blocks_x row
// blocks; vec = 1 needs c % 8 == 0 and 16-byte-aligned pointers.
extern "C" int dtpu_epilogue_bwd_launch(const void* x, int x_dt, const void* mean,
                                        const void* mul, const void* bias, const void* res,
                                        int res_dt, int has_res, const void* g_out, int out_dt,
                                        const void* g_cast, int cast_dt, int bn_dt, int relu,
                                        void* d_x, void* d_res, float* partials, float* d_stats,
                                        long long rows, int c, int gpb, int blocks_x, int vec,
                                        void* stream) {
  const int groups = (c + 7) / 8;
  if (rows <= 0 || c <= 0 || gpb <= 0 || gpb > 32 || blocks_x <= 0 || d_x == nullptr ||
      (x_dt != kF32 && x_dt != kBF16) ||
      (g_out == nullptr && g_cast == nullptr) || (relu && has_res && res == nullptr) ||
      (vec && c % 8 != 0))
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{x, static_cast<const float*>(mean), static_cast<const float*>(mul),
                  static_cast<const float*>(bias), res, g_out, g_cast, d_x, d_res, partials,
                  rows, c, groups, x_dt, res_dt, out_dt, cast_dt, bn_dt, has_res, relu};
  const dim3 grid((unsigned)blocks_x, (unsigned)((groups + gpb - 1) / gpb));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int lanes = kThreads / gpb;
  const bool train_route = vec && x_dt == kBF16 && bn_dt == kBF16 && out_dt == kBF16 &&
                           g_out != nullptr && g_cast == nullptr && (!has_res || res_dt == kBF16);
  if (train_route)
    epilogue_bwd_bf16_kernel<<<grid, kThreads, 0, s>>>(a, gpb, lanes);
  else if (vec)
    epilogue_bwd_kernel<true><<<grid, kThreads, 0, s>>>(a, gpb, lanes);
  else
    epilogue_bwd_kernel<false><<<grid, kThreads, 0, s>>>(a, gpb, lanes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n3c = 3 * c;
  epilogue_bwd_finalize<<<(n3c + 31) / 32, kThreads, 0, s>>>(partials, d_stats, blocks_x, n3c);
  return (int)cudaGetLastError();
}
