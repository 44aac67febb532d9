// Per-row layer norm and symmetric int8 quantization for Hopper (sm_90a).
//
// The activation side of every int8 contraction of the TPU kernels
// funasr_tpu/ops/sanm_layer_pallas.py `_sanm_layer_kernel` (`_ln` :54,
// `_rowquant` = quant.py `rowquant_kernel`), decoder_layer_pallas.py
// `_dec_layer_kernel` and ffn_pallas.py `_ffn_kernel_int8`, and of the XLA
// int8 dot (quant.py `quantize_rows`).  For one row x of width W:
//
//   y = x                                        (no norm), or
//   y = ((x - mean) * (1 / sqrt(var + eps))) * w + b   (float32, eps 1e-12)
//   scale = max(max|y|, 1e-8) * f32(1/127)       (form 0, rowquant_kernel)
//   scale = max(max|y|, 1e-8) / 127              (form 1, quantize_rows)
//   q = clip(rint(y / scale), -127, 127)         (half to even)
//
// and writes q (int8), scale (float32) and, when asked, y (float32).  The
// mean and variance are summed in float64 and rounded once to float32, so
// they do not depend on the order of the sum: the plain twin
// (ops/rowquant.py) computes them the same way and gets the same bits.  All
// float32 steps use _rn intrinsics (no FMA contraction) and IEEE division.
//
// Design.  One block of 128 threads per row; the row is staged in shared
// memory as float32 (W <= 12288), reduced with warp shuffles.  Bound: bytes
// (each element is read once and written once as int8), 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;
constexpr int MAX_W = 12288;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ double block_sum(double v, double* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
#pragma unroll
  for (int i = 0; i < NT / 32; ++i) s += red[i];
  __syncthreads();
  return s;
}

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NT / 32; ++i) s = fmaxf(s, red[i]);
  __syncthreads();
  return s;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(NT)
rowquant_kernel(const T* __restrict__ x, int W, const float* __restrict__ ln_w,
                const float* __restrict__ ln_b, float eps, int form, int8_t* __restrict__ q,
                float* __restrict__ scale, float* __restrict__ y) {
  extern __shared__ float row[];
  __shared__ double dred[NT / 32];
  __shared__ float fred[NT / 32];
  const int64_t r = blockIdx.x;
  const T* xr = x + r * W;

  double s = 0.0;
  for (int i = threadIdx.x; i < W; i += NT) {
    const float v = to_f(xr[i]);
    row[i] = v;
    s += (double)v;
  }
  if (ln_w) {
    const double mean = block_sum(s, dred) / W;
    double ss = 0.0;
    for (int i = threadIdx.x; i < W; i += NT) {
      const double d = (double)row[i] - mean;
      ss += d * d;
    }
    const double var = block_sum(ss, dred) / W;
    const float mean_f = (float)mean;
    const float inv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn((float)var, eps)));
    for (int i = threadIdx.x; i < W; i += NT)
      row[i] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(row[i], mean_f), inv), ln_w[i]), ln_b[i]);
  }
  if (y) {
    for (int i = threadIdx.x; i < W; i += NT) y[r * W + i] = row[i];
  }
  if (!q) return;
  float amax = 0.f;
  for (int i = threadIdx.x; i < W; i += NT) amax = fmaxf(amax, fabsf(row[i]));
  amax = fmaxf(block_max(amax, fred), 1e-8f);
  const float sc = form == 0 ? __fmul_rn(amax, (float)(1.0 / 127.0)) : __fdiv_rn(amax, 127.f);
  for (int i = threadIdx.x; i < W; i += NT) {
    const float v = fminf(fmaxf(rintf(__fdiv_rn(row[i], sc)), -127.f), 127.f);
    q[r * W + i] = (int8_t)v;
  }
  if (threadIdx.x == 0) scale[r] = sc;
}

}  // namespace

// Plain C entry point, called through ctypes.  x is (M, W) contiguous,
// float32 (dtype 0) or bfloat16 (dtype 1).  ln_w/ln_b null: no norm.  q and
// scale null: norm only (y must then be given).  Returns cudaGetLastError();
// cudaErrorInvalidValue (1) for a width above 12288 or another dtype.
extern "C" int rowquant_forward(const void* x, int dtype, int M, int W, const float* ln_w,
                                const float* ln_b, float eps, int form, void* q, float* scale,
                                float* y, void* stream) {
  if (M <= 0) return (int)cudaSuccess;
  if (W <= 0 || W > MAX_W) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * W;
  cudaStream_t st = (cudaStream_t)stream;
  int8_t* qp = static_cast<int8_t*>(q);
  if (dtype == 0) {
    auto kern = rowquant_kernel<float>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<M, NT, smem, st>>>(static_cast<const float*>(x), W, ln_w, ln_b, eps, form, qp,
                              scale, y);
  } else if (dtype == 1) {
    auto kern = rowquant_kernel<__nv_bfloat16>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<M, NT, smem, st>>>(static_cast<const __nv_bfloat16*>(x), W, ln_w, ln_b, eps, form,
                              qp, scale, y);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
