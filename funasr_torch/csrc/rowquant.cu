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
// Design.  Rows of up to 2048 values whose width keeps them 16-byte
// aligned (the served 512, 560 and 2048) take one warp each, eight warps a
// block, in a persistent grid of as many blocks as fit at once: a warp
// walks rows with a stride, holding each row in registers (16-byte loads;
// short rows load the next row while this one is reduced).  The quotient
// y / scale is taken as y * (1 / scale) except where a warp's vote finds a
// value near a half-integer (quantize_vec), since an IEEE division per
// value is the costliest step.  A block per row, with block barriers, is
// bound by block start-up and one memory round trip a row, whatever its
// arithmetic: in the int8 batch the warp kernel took 63.6 us a launch at
// the 2048-wide rows against 79.5 us for a block a row (H100, PERF.md),
// although alone, on rows it re-reads, it reads 2 us slower.  Other widths
// (up to 12288) take a block of 128 threads per row, the row staged in
// shared memory.  Bound: bytes (each element is read
// once and written once as int8), 3.35 TB/s.

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

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float (&v)[4]) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ uint32_t pack4(const int* q) {
  return (uint32_t)(q[0] & 0xff) | ((uint32_t)(q[1] & 0xff) << 8) |
         ((uint32_t)(q[2] & 0xff) << 16) | ((uint32_t)(q[3] & 0xff) << 24);
}

// q[i] = clip(rint(y[i] / sc), -127, 127) with the IEEE quotient's
// rounding, all lanes of a warp together: y * (1 / sc) decides unless a
// lane's value lies within 3.1e-5 of a half-integer, where the warp takes
// the division (see csrc/int8_wgmma.cuh `quantize_vec`, the same function)
template <int V>
__device__ __forceinline__ void quantize_vec(const float (&y)[V], float sc, float rsc,
                                             int (&q)[V]) {
  float qa[V];
  bool near = false;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    qa[i] = __fmul_rn(y[i], rsc);
    near |= fabsf(__fsub_rn(__fsub_rn(qa[i], floorf(qa[i])), 0.5f)) < 3.0517578125e-05f;
  }
  if (__any_sync(0xffffffffu, near)) {
#pragma unroll
    for (int i = 0; i < V; ++i) qa[i] = __fdiv_rn(y[i], sc);
  }
#pragma unroll
  for (int i = 0; i < V; ++i) q[i] = (int)fminf(fmaxf(rintf(qa[i]), -127.f), 127.f);
}

constexpr int WARP_ROWS = 8;  // warps a block of the warp kernel

// NV 16-byte vectors of row r (zeros past W) into v
template <typename T, int NV>
__device__ __forceinline__ void load_row(const T* __restrict__ x, int64_t r, int W, int lane,
                                         float (&v)[NV][Vec<T>::N]) {
  constexpr int V = Vec<T>::N;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = (k * 32 + lane) * V;
    if (c < W) {
      Vec<T>::load(x + r * W + c, v[k]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[k][i] = 0.f;
    }
  }
}

// One warp per row at a time, the warps of a persistent grid walking the
// rows with a stride (for short rows the next row's loads in flight while
// this one is reduced and quantized): NV 16-byte vectors a lane (W <= 32 NV
// V, W * sizeof(T) a multiple of 16); the same steps as rowquant_kernel.
template <typename T, int NV>
__global__ void __launch_bounds__(32 * WARP_ROWS)
rowquant_warp_kernel(const T* __restrict__ x, int M, int W, const float* __restrict__ ln_w,
                     const float* __restrict__ ln_b, float eps, int form,
                     int8_t* __restrict__ q, float* __restrict__ scale, float* __restrict__ y) {
  constexpr int V = Vec<T>::N;
  // short rows: the next row's loads in flight and each value widened to
  // float64 once (registers allow); long rows (2048) hold 8 KB a warp in
  // flight already
  constexpr bool SHORT = NV * V <= 24;
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * WARP_ROWS;
  int64_t r = (int64_t)blockIdx.x * WARP_ROWS + (threadIdx.x >> 5);
  float v[NV][V], nxt[SHORT ? NV : 1][V];
  if (SHORT && r < M) load_row<T, SHORT ? NV : 1>(x, r, W, lane, nxt);
  for (; r < M; r += stride) {
    if constexpr (SHORT) {
#pragma unroll
      for (int k = 0; k < NV; ++k)
#pragma unroll
        for (int i = 0; i < V; ++i) v[k][i] = nxt[k][i];
      if (r + stride < M) load_row<T, NV>(x, r + stride, W, lane, nxt);
    } else {
      load_row<T, NV>(x, r, W, lane, v);
    }
    if (ln_w) {
      // the sums in float64 over four accumulators (float64 sums of
      // float32 values do not depend on their order here: see the note at
      // the top), so the adds do not wait on each other
      double s[4] = {0.0, 0.0, 0.0, 0.0};
      double dv[SHORT ? NV : 1][V];
#pragma unroll
      for (int k = 0; k < NV; ++k)
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const double d = (double)v[k][i];
          if constexpr (SHORT) dv[k][i] = d;
          s[i & 3] += d;
        }
      const double mean = warp_sum((s[0] + s[1]) + (s[2] + s[3])) / W;
      double ss[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        if ((k * 32 + lane) * V >= W) break;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const double d = (SHORT ? dv[SHORT ? k : 0][i] : (double)v[k][i]) - mean;
          ss[i & 3] = __dadd_rn(ss[i & 3], __dmul_rn(d, d));
        }
      }
      const double var = warp_sum((ss[0] + ss[1]) + (ss[2] + ss[3])) / W;
      const float mean_f = (float)mean;
      const float inv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn((float)var, eps)));
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int c = (k * 32 + lane) * V;
        if (c >= W) break;
#pragma unroll
        for (int i = 0; i < V; i += 4) {  // the parameters 16 bytes at a time
          const float4 w = __ldg(reinterpret_cast<const float4*>(ln_w + c + i));
          const float4 b = __ldg(reinterpret_cast<const float4*>(ln_b + c + i));
          const float wv[4] = {w.x, w.y, w.z, w.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[k][i + e] = __fadd_rn(
                __fmul_rn(__fmul_rn(__fsub_rn(v[k][i + e], mean_f), inv), wv[e]), bv[e]);
        }
      }
    }
    if (y) {
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int c = (k * 32 + lane) * V;
        if (c >= W) break;
#pragma unroll
        for (int i = 0; i < V; i += 4)
          *reinterpret_cast<float4*>(y + r * W + c + i) =
              make_float4(v[k][i], v[k][i + 1], v[k][i + 2], v[k][i + 3]);
      }
    }
    if (!q) continue;
    float amax = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int i = 0; i < V; ++i) amax = fmaxf(amax, fabsf(v[k][i]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    amax = fmaxf(amax, 1e-8f);
    const float sc =
        form == 0 ? __fmul_rn(amax, (float)(1.0 / 127.0)) : __fdiv_rn(amax, 127.f);
    const float rsc = __frcp_rn(sc);
#pragma unroll
    for (int k = 0; k < NV; ++k) {  // every lane: quantize_vec votes across the warp
      const int c = (k * 32 + lane) * V;
      int qi[V];
      quantize_vec<V>(v[k], sc, rsc, qi);
      if (c >= W) continue;
      if constexpr (V == 8)
        *reinterpret_cast<uint2*>(q + r * W + c) = make_uint2(pack4(qi), pack4(qi + 4));
      else
        *reinterpret_cast<uint32_t*>(q + r * W + c) = pack4(qi);
    }
    if (lane == 0) scale[r] = sc;
  }
}

// The persistent grid: as many blocks as fit on the card at once (by the
// kernel's registers), never more than the rows need, so the rows are
// shared out in one wave.
template <typename T, int NV>
int launch_warp(const void* x, int M, int W, const float* ln_w, const float* ln_b, float eps,
                int form, void* q, float* scale, float* y, cudaStream_t st) {
  static int resident = 0;
  auto kernel = rowquant_warp_kernel<T, NV>;
  if (!resident) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * WARP_ROWS, 0);
    resident = max(1, sms * per_sm);
  }
  const int grid = min((M + WARP_ROWS - 1) / WARP_ROWS, resident);
  kernel<<<grid, 32 * WARP_ROWS, 0, st>>>(static_cast<const T*>(x), M, W, ln_w, ln_b, eps, form,
                                           static_cast<int8_t*>(q), scale, y);
  return (int)cudaGetLastError();
}

// the warp kernel's instance for W, or -1 where W takes the block kernel
template <typename T>
int dispatch_warp(const void* x, int M, int W, const float* ln_w, const float* ln_b, float eps,
                  int form, void* q, float* scale, float* y, cudaStream_t st) {
  constexpr int V = Vec<T>::N;
  if (W % V) return -1;
  if (W <= 512)  // the served 512: 4 float32 or 2 bf16 vectors a lane
    return launch_warp<T, 512 / (32 * V)>(x, M, W, ln_w, ln_b, eps, form, q, scale, y, st);
  constexpr int NV_MID = V == 4 ? 5 : 3;  // W = 560 (encoders0)
  if (W <= 32 * NV_MID * V)
    return launch_warp<T, NV_MID>(x, M, W, ln_w, ln_b, eps, form, q, scale, y, st);
  if (W <= 2048)
    return launch_warp<T, 2048 / (32 * V)>(x, M, W, ln_w, ln_b, eps, form, q, scale, y, st);
  return -1;
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
  // 16-byte loads of the rows and of the norm's parameters
  const bool aligned = (uintptr_t)x % 16 == 0 && (uintptr_t)ln_w % 16 == 0 &&
                       (uintptr_t)ln_b % 16 == 0;
  if (aligned && (dtype == 0 || dtype == 1)) {
    const int status =
        dtype == 0 ? dispatch_warp<float>(x, M, W, ln_w, ln_b, eps, form, q, scale, y, st)
                   : dispatch_warp<__nv_bfloat16>(x, M, W, ln_w, ln_b, eps, form, q, scale, y, st);
    if (status >= 0) return status;
  }
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
