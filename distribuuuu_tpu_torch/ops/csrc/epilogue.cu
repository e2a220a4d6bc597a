// Fused conv epilogue for Hopper (sm_90a): BN-apply -> cast -> (+residual) -> ReLU.
//
// Replaces distribuuuu_tpu/ops/epilogue.py::_epilogue_kernel (the Pallas TPU
// kernel behind fused_conv_epilogue). Per element of a channels-last [R, C]
// conv output:
//
//     y = ((x - mean[c]) * mul[c]) + bias[c]     in f32, mul = rsqrt(var+eps)*scale
//     y = round_to(bn_dtype, y)
//     y = y + residual                           in f32, rounded once to the out dtype
//     y = max(y, 0)                              when relu
//
// What bounds it on this card: HBM bytes. The op is elementwise with about
// five flops per element, far below the H100's ~20 flops per byte at f32,
// so its least time is (bytes of x + residual + out) / HBM bandwidth.
//
// Design (simple first): one element per thread in a grid-stride loop over
// the flattened [R, C] view; the channel index is carried incrementally
// instead of a 64-bit modulo per element. The three per-channel vectors are
// a few KB and stay in L1 / the read-only cache, so no shared memory is
// used. Templated on x dtype, BN dtype and residual dtype; relu is a flag.
// 16-byte vector loads, a tuned block size, and fusion into the conv are
// left for later work.
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

enum DType : int { kF32 = 0, kBF16 = 1, kNone = -1 };

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

// RT is ignored when HAS_RES is false.
template <typename XT, typename BT, typename RT, typename OT, bool HAS_RES>
__global__ void epilogue_kernel(const XT* __restrict__ x, const float* __restrict__ mean,
                                const float* __restrict__ mul, const float* __restrict__ bias,
                                const RT* __restrict__ res, OT* __restrict__ out, int64_t n,
                                int c, int relu) {
  const int64_t start = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int cstep = (int)(stride % c);
  int ch = (int)(start % c);
  for (int64_t i = start; i < n; i += stride) {
    float y = __fsub_rn(to_f32(x[i]), __ldg(mean + ch));
    y = __fmul_rn(y, __ldg(mul + ch));
    y = __fadd_rn(y, __ldg(bias + ch));
    float v = to_f32(from_f32<BT>(y));
    if (HAS_RES) v = __fadd_rn(v, to_f32(res[i]));
    if (relu && v < 0.f) v = 0.f;  // NaN passes through, as torch.relu
    out[i] = from_f32<OT>(v);
    ch += cstep;
    if (ch >= c) ch -= c;
  }
}

template <typename XT, typename BT, typename RT, typename OT, bool HAS_RES>
cudaError_t launch(const void* x, const void* mean, const void* mul, const void* bias,
                   const void* res, void* out, int64_t n, int c, int relu,
                   cudaStream_t stream) {
  const int threads = 256;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int64_t blocks = (n + threads - 1) / threads;
  const int64_t cap = (int64_t)sms * 8;  // 8 x 256 threads fill an SM
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  epilogue_kernel<XT, BT, RT, OT, HAS_RES><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const float*>(mean),
      static_cast<const float*>(mul), static_cast<const float*>(bias),
      static_cast<const RT*>(res), static_cast<OT*>(out), n, c, relu);
  return cudaGetLastError();
}

template <typename XT, typename BT>
cudaError_t dispatch_res(const void* x, const void* mean, const void* mul, const void* bias,
                         const void* res, int res_dt, void* out, int64_t n, int c, int relu,
                         cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  // out dtype = result_type(bn_dtype, residual dtype): f32 unless both are bf16
  constexpr bool kBnF32 = sizeof(BT) == 4;
  switch (res_dt) {
    case kNone:
      return launch<XT, BT, BT, BT, false>(x, mean, mul, bias, nullptr, out, n, c, relu, s);
    case kF32:
      return launch<XT, BT, float, float, true>(x, mean, mul, bias, res, out, n, c, relu, s);
    case kBF16:
      if (kBnF32)
        return launch<XT, BT, bf16, float, true>(x, mean, mul, bias, res, out, n, c, relu, s);
      return launch<XT, BT, bf16, bf16, true>(x, mean, mul, bias, res, out, n, c, relu, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename XT>
cudaError_t dispatch_bn(const void* x, const void* mean, const void* mul, const void* bias,
                        const void* res, int res_dt, void* out, int bn_dt, int64_t n, int c,
                        int relu, cudaStream_t s) {
  switch (bn_dt) {
    case kF32:
      return dispatch_res<XT, float>(x, mean, mul, bias, res, res_dt, out, n, c, relu, s);
    case kBF16:
      return dispatch_res<XT, __nv_bfloat16>(x, mean, mul, bias, res, res_dt, out, n, c, relu,
                                             s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point for ctypes. dtype codes: 0 = float32, 1 = bfloat16,
// -1 = no residual. Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int dtpu_epilogue_launch(const void* x, int x_dt, const void* mean, const void* mul,
                                    const void* bias, const void* res, int res_dt, void* out,
                                    int bn_dt, long long n, int c, int relu, void* stream) {
  if (n <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dt) {
    case kF32:
      return (int)dispatch_bn<float>(x, mean, mul, bias, res, res_dt, out, bn_dt, n, c, relu, s);
    case kBF16:
      return (int)dispatch_bn<__nv_bfloat16>(x, mean, mul, bias, res, res_dt, out, bn_dt, n, c,
                                             relu, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
