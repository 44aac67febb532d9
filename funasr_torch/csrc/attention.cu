// Masked-softmax attention for Hopper (sm_90a), bf16 or float32 inputs.
//
// Replaces the TPU kernel funasr_tpu/ops/attention_pallas.py `_attn_kernel`
// (pallas_call at :84).  Same function, per (batch b, head h):
//
//   s   = q_h k_h^T + key_bias[b]     float32 (q pre-scaled by d^-0.5)
//   p   = softmax(s) in float32, normalised, THEN cast to v's dtype
//   out = p v_h                       float32 accumulation, cast to q's dtype
//
// with q (B, U, H*d), k/v (B, T, H*d) in their natural layout (a row stride
// per tensor, so k and v may be column slices of one fused projection) and
// key_bias (B, T) float32, 0 for valid keys and -1e30 for padding.  A row
// whose keys are all masked gets uniform weights, as the TPU kernel does
// (the serving path never builds one).
//
// Design.  One block per (64-query tile, head, batch), 256 threads.  The
// query tile stays in shared memory (float32, rows padded to d + 4); keys
// and values stream through one shared buffer in 64-key tiles.  To apply
// the normalised, rounded p of the contract exactly, the kernel makes two
// passes over the keys: pass 1 keeps the running row max and the rescaled
// row sum (online softmax, float32); pass 2 recomputes each score tile,
// forms p = exp(s - m) / l, rounds it to v's dtype, stages it in shared
// memory and accumulates p v.  Each thread holds a 4 x 4 score tile and a
// 4-row x (4 d/64)-column output tile; all arithmetic is float32 FMA on the
// CUDA cores.
//
// Bound on the H100 SXM, encoder self-attention (B=64, T=256, H=4, d=128,
// bf16, every key valid): q, k, v and out are 4 x 16.8 MB = 67 MB -> 20 us
// at 3.35 TB/s; the two products are 8.6 GFLOP -> 8.7 us at 989 TFLOP/s
// bf16, so it is bound by bytes.  Decoder cross-attention (U=128): 50 MB ->
// 15 us.  Keys past a row's length need neither bytes nor products, so at
// ragged lengths the bound falls with the valid keys.  This
// kernel runs the products on the CUDA cores (67 TFLOP/s float32) and
// computes q k^T twice, so it sits far above that bound; tensor-core
// (mma/wgmma) tiles are later work.
//
// Second kernel, `attention_forward_f32ctx`: the attention inside the int8
// layers (sanm_layer_pallas.py:118-127, decoder_layer_pallas.py:97-106).
// q, k, v arrive in float32 (column slices of an int8 projection's output)
// and are rounded to bf16 as they are loaded: q after the d^-0.5 scale (in
// float32), v after zeroing its rows past vlen[b] (the masked v of the SANM
// layer; no vlen for the decoder's memory).  p is normalised, rounded to
// bf16, and the context is written in float32 (the layer row-quantizes it
// without a bf16 round first).
//
// Its sums do not depend on their order, so the plain twin gets the same
// bits: every score q.k, the softmax sum and every p.v are summed in float64
// (a product of two bf16 values is exact, so those sums are exact in
// practice) and rounded once to float32; exp is taken in float64 and
// rounded once; the rest are IEEE float32 operations.  The int8 layers need
// this: one ulp of the context can move an int8 rounding tie in the next
// row-quantize, and such a tie spreads through every later layer.  Three
// passes over the keys: (1) the scores, on the float64 units (half the
// float32 rate), into a float32 scratch (B, H, U, T) that the wrapper
// allocates, and the row max; (2) exp(s - m) in place and the row sum;
// (3) p, rounded, and p v.  A thread reads back only the scratch entries
// it wrote.  Tensor-core tiles that keep the exact sums are later work.
//
// Third kernel, `attention_forward_i8qk`: the SANM layer's attention with
// int8 scores, the `int8_attn` branch of sanm_layer_pallas.py
// `_sanm_layer_kernel` (:112-117; FUNASR_TPU_INT8_ATTN=1 in the JAX
// package, `int8_attn=True` in the port).  Per head, in the kernel's
// prologue and per key tile, as the TPU body quantizes in VMEM:
//
//   q8, qs = rowquant(q * d^-0.5)      k8, ks = rowquant(k)   (k unmasked)
//   s      = (float(q8 k8^T) * qs) * ks^T + key_bias
//
// (quant.py `rowquant_kernel`, the "mul" form), the q.k sum exact in int32
// on __dp4a; then passes 2 and 3 of the float32-context kernel: exp in
// float64, the softmax sum and p v in float64, p rounded to bf16, v rounded
// to bf16 and zero past vlen[b].  The plain twin (ops/attention.py
// `attention_i8qk_ref`) gets the same bits.  Bound on the H100 SXM at the
// SANM shape (B=64, T=256, H=4, d=128, lengths 250/200): 4 float32 (B, T,
// 512) tensors of valid rows = 118 MB -> 35 us, above the 3.4 GOP of int8
// and 3.4 GFLOP of bf16 products (5 us): bytes.  The float64 sums on the CUDA cores
// keep it far above that, as for the float32-context kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // queries per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per block
constexpr int LP = BK + 4;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// rows [r0, r0 + 64) of a (rows, D) head slice with row stride `rs` into a
// float32 tile with row stride D + 4; rows past `nrows` are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int64_t rs,
                                          int r0, int nrows) {
  constexpr int LD = D + 4;
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, c = i % D;
    const int row = r0 + r;
    dst[r * LD + c] = (row < nrows) ? to_f(src[(int64_t)row * rs + c]) : 0.f;
  }
}

// s[i][j] = q[4 ty + i] . k[tx + 16 j] over the d columns
template <int D>
__device__ __forceinline__ void scores(const float* sQ, const float* sK, int tx,
                                       int ty, float s[4][4]) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; c += 4) {
    float4 qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qv[i] = *reinterpret_cast<const float4*>(&sQ[(4 * ty + i) * LD + c]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      kv[j] = *reinterpret_cast<const float4*>(&sK[(tx + 16 * j) * LD + c]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float a = s[i][j];
        a = fmaf(qv[i].x, kv[j].x, a);
        a = fmaf(qv[i].y, kv[j].y, a);
        a = fmaf(qv[i].z, kv[j].z, a);
        a = fmaf(qv[i].w, kv[j].w, a);
        s[i][j] = a;
      }
  }
}

// reductions over the 16 lanes (tx) that share a query row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off, 16));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off, 16);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, 2)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ out, int U, int Tk, int64_t q_bs, int64_t q_rs,
                 int64_t k_bs, int64_t k_rs, int64_t v_bs, int64_t v_rs,
                 int64_t o_bs, int64_t o_rs) {
  constexpr int LD = D + 4;
  constexpr int NG = D / 64;  // output column groups of 64
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;            // BQ x LD
  float* sKV = sQ + BQ * LD;   // BK x LD (keys, then values)
  float* sP = sKV + BK * LD;   // BQ x LP
  float* sB = sP + BQ * LP;    // BK key biases

  const int u0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* qh = q + b * q_bs + (int64_t)h * D;
  const T* kh = k + b * k_bs + (int64_t)h * D;
  const T* vh = v + b * v_bs + (int64_t)h * D;
  const float* bb = bias + (int64_t)b * Tk;

  load_tile<T, D>(sQ, qh, q_rs, u0, U);

  // ---- pass 1: row max m and row sum l of exp(s - m)
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
  }
  float s[4][4];
  for (int k0 = 0; k0 < Tk; k0 += BK) {
    __syncthreads();
    load_tile<T, D>(sKV, kh, k_rs, k0, Tk);
    if (tid < BK) sB[tid] = (k0 + tid < Tk) ? bb[k0 + tid] : -INFINITY;
    __syncthreads();
    scores<D>(sQ, sKV, tx, ty, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += sB[tx + 16 * j];
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_i[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += expf(s[i][j] - m_new);
      l_i[i] = l_i[i] * expf(m_i[i] - m_new) + row_sum(sum);
      m_i[i] = m_new;
    }
  }

  // ---- pass 2: p = exp(s - m) / l rounded to v's dtype, out = p v
  float o[4][4 * NG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) o[i][c] = 0.f;
  for (int k0 = 0; k0 < Tk; k0 += BK) {
    __syncthreads();
    load_tile<T, D>(sKV, kh, k_rs, k0, Tk);
    if (tid < BK) sB[tid] = (k0 + tid < Tk) ? bb[k0 + tid] : -INFINITY;
    __syncthreads();
    scores<D>(sQ, sKV, tx, ty, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] + sB[tx + 16 * j] - m_i[i]) / l_i[i];
        sP[(4 * ty + i) * LP + tx + 16 * j] = to_f(from_f<T>(p));
      }
    __syncthreads();
    load_tile<T, D>(sKV, vh, v_rs, k0, Tk);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(4 * ty + i) * LP + kk];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 vv = *reinterpret_cast<const float4*>(&sKV[kk * LD + 64 * g + 4 * tx]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[i][4 * g + 0] = fmaf(p[i], vv.x, o[i][4 * g + 0]);
          o[i][4 * g + 1] = fmaf(p[i], vv.y, o[i][4 * g + 1]);
          o[i][4 * g + 2] = fmaf(p[i], vv.z, o[i][4 * g + 2]);
          o[i][4 * g + 3] = fmaf(p[i], vv.w, o[i][4 * g + 3]);
        }
      }
    }
  }

  T* oh = out + b * o_bs + (int64_t)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = u0 + 4 * ty + i;
    if (u >= U) continue;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        oh[(int64_t)u * o_rs + 64 * g + 4 * tx + e] = from_f<T>(o[i][4 * g + e]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const float* bias, void* out,
           int B, int U, int Tk, int H, const long long* strides, cudaStream_t stream) {
  constexpr int LD = D + 4;
  const size_t smem = sizeof(float) * (BQ * LD + BK * LD + BQ * LP + BK);
  auto kern = attention_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((U + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<T*>(out), U, Tk, strides[0], strides[1], strides[2], strides[3],
      strides[4], strides[5], strides[6], strides[7]);
  return (int)cudaGetLastError();
}

// ---- the int8 layers' attention: float32 in, bf16-rounded, exact sums

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// rows [r0, r0 + 64) of a float32 head slice, each value times `scale` and
// rounded to bf16; rows past `nrows` are zero
template <int D>
__device__ __forceinline__ void load_rounded(float* dst, const float* src, int64_t rs,
                                             int r0, int nrows, float scale) {
  constexpr int LD = D + 4;
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, c = i % D;
    const int row = r0 + r;
    dst[r * LD + c] =
        (row < nrows) ? bf16_round(__fmul_rn(src[(int64_t)row * rs + c], scale)) : 0.f;
  }
}

// s[i][j] = q[4 ty + i] . k[tx + 16 j] summed in float64, rounded once, plus
// the key bias (a float32 add)
template <int D>
__device__ __forceinline__ void scores_exact(const float* sQ, const float* sK,
                                             const float* sB, int tx, int ty,
                                             float s[4][4]) {
  constexpr int LD = D + 4;
  double a[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = 0.0;
#pragma unroll 2
  for (int c = 0; c < D; c += 4) {
    float4 qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qv[i] = *reinterpret_cast<const float4*>(&sQ[(4 * ty + i) * LD + c]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      kv[j] = *reinterpret_cast<const float4*>(&sK[(tx + 16 * j) * LD + c]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        double t = a[i][j];
        t = fma((double)qv[i].x, (double)kv[j].x, t);
        t = fma((double)qv[i].y, (double)kv[j].y, t);
        t = fma((double)qv[i].z, (double)kv[j].z, t);
        t = fma((double)qv[i].w, (double)kv[j].w, t);
        a[i][j] = t;
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = __fadd_rn(__double2float_rn(a[i][j]), sB[tx + 16 * j]);
}

__device__ __forceinline__ double row_sum64(double x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off, 16);
  return x;
}

__device__ __forceinline__ float exp_exact(float x) {  // float64 exp, rounded once
  return __double2float_rn(exp((double)x));
}

// Passes 2 and 3 of the exact-sum attention, shared by both int8-layer
// kernels: `sc` holds this block's (64, Tk) float32 scores (rows past U are
// never touched) and m_i each thread's row maxima.  e = exp(s - m) in
// place and l = sum e in float64; then p = bf16(e / l) and out = p v summed
// in float64, v rounded to bf16 at load and zero past v_rows.
template <int D>
__device__ __forceinline__ void exact_softmax_pv(float* sc, const float m_i[4],
                                                 const bool row_ok[4], const float* vh,
                                                 int64_t v_rs, int v_rows, int Tk, float* sKV,
                                                 float* sP, float* oh, int64_t o_rs, int u0,
                                                 int U) {
  constexpr int LD = D + 4;
  constexpr int NG = D / 64;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  // ---- pass 2: e = exp(s - m) in place, l = sum e in float64
  double l64[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!row_ok[i]) continue;
    float* row = sc + (int64_t)(4 * ty + i) * Tk;
    for (int key = tx; key < Tk; key += 16) {
      const float e = exp_exact(__fsub_rn(row[key], m_i[i]));
      row[key] = e;
      l64[i] += (double)e;
    }
  }
  float l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) l_i[i] = __double2float_rn(row_sum64(l64[i]));

  // ---- pass 3: p = bf16(e / l), out = p v summed in float64
  double o[4][4 * NG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) o[i][c] = 0.0;
  for (int k0 = 0; k0 < Tk; k0 += BK) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const float e = (row_ok[i] && key < Tk) ? sc[(int64_t)(4 * ty + i) * Tk + key] : 0.f;
        sP[(4 * ty + i) * LP + tx + 16 * j] = bf16_round(__fdiv_rn(e, l_i[i]));
      }
    load_rounded<D>(sKV, vh, v_rs, k0, v_rows, 1.f);
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      double p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = (double)sP[(4 * ty + i) * LP + kk];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 vv = *reinterpret_cast<const float4*>(&sKV[kk * LD + 64 * g + 4 * tx]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[i][4 * g + 0] = fma(p[i], (double)vv.x, o[i][4 * g + 0]);
          o[i][4 * g + 1] = fma(p[i], (double)vv.y, o[i][4 * g + 1]);
          o[i][4 * g + 2] = fma(p[i], (double)vv.z, o[i][4 * g + 2]);
          o[i][4 * g + 3] = fma(p[i], (double)vv.w, o[i][4 * g + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = u0 + 4 * ty + i;
    if (u >= U) continue;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        oh[(int64_t)u * o_rs + 64 * g + 4 * tx + e] = __double2float_rn(o[i][4 * g + e]);
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
attention_f32ctx_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ bias,
                        const int* __restrict__ vlen, float* __restrict__ scratch,
                        float* __restrict__ out, int U, int Tk, float q_scale, int64_t q_bs,
                        int64_t q_rs, int64_t k_bs, int64_t k_rs, int64_t v_bs, int64_t v_rs,
                        int64_t o_bs, int64_t o_rs) {
  constexpr int LD = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sKV = sQ + BQ * LD;
  float* sP = sKV + BK * LD;
  float* sB = sP + BQ * LP;

  const int u0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* qh = q + b * q_bs + (int64_t)h * D;
  const float* kh = k + b * k_bs + (int64_t)h * D;
  const float* vh = v + b * v_bs + (int64_t)h * D;
  const float* bb = bias + (int64_t)b * Tk;
  const int v_rows = vlen ? min(Tk, vlen[b]) : Tk;
  // this block's (64, Tk) rows of the scratch; rows past U are never touched
  float* sc = scratch + (((int64_t)b * gridDim.y + h) * U + u0) * Tk;
  bool row_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) row_ok[i] = u0 + 4 * ty + i < U;

  load_rounded<D>(sQ, qh, q_rs, u0, U, q_scale);
  float s[4][4];

  // ---- pass 1: the scores into the scratch, and the row max m (exact
  // whatever the order)
  float m_i[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int k0 = 0; k0 < Tk; k0 += BK) {
    __syncthreads();
    load_rounded<D>(sKV, kh, k_rs, k0, Tk, 1.f);
    if (tid < BK) sB[tid] = (k0 + tid < Tk) ? bb[k0 + tid] : -INFINITY;
    __syncthreads();
    scores_exact<D>(sQ, sKV, sB, tx, ty, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        if (row_ok[i] && key < Tk) sc[(int64_t)(4 * ty + i) * Tk + key] = s[i][j];
        m_i[i] = fmaxf(m_i[i], s[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) m_i[i] = row_max(m_i[i]);

  exact_softmax_pv<D>(sc, m_i, row_ok, vh, v_rs, v_rows, Tk, sKV, sP,
                      out + b * o_bs + (int64_t)h * D, o_rs, u0, U);
}

// ---- the SANM layer's attention with int8 scores (int8_attn)

constexpr int LQ8 = 128 + 4;  // row stride of an int8 tile, bytes (33 words)

__device__ __forceinline__ uint32_t pack4(const int q[4]) {
  return (uint32_t)(q[0] & 0xff) | ((uint32_t)(q[1] & 0xff) << 8) |
         ((uint32_t)(q[2] & 0xff) << 16) | ((uint32_t)(q[3] & 0xff) << 24);
}

// rows [r0, r0 + 64) of a float32 head slice (d = 128), each value times
// `mult`, quantized per row as quant.py `rowquant_kernel` does (scale =
// max(absmax, 1e-8) * f32(1/127), q = clip(rint(y / scale))) into int8 rows
// of LQ8 bytes and their scales; rows past `nrows` are zero, scale 0.  One
// warp per row, four values per lane.
__device__ __forceinline__ void quantize_rows(int8_t* dst, float* scale, const float* src,
                                              int64_t rs, int r0, int nrows, float mult) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < 64; r += NT / 32) {
    const int row = r0 + r;
    uint32_t word = 0;
    float sc = 0.f;
    if (row < nrows) {
      const float* p = src + (int64_t)row * rs + 4 * lane;
      float y[4];
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        y[i] = __fmul_rn(p[i], mult);
        amax = fmaxf(amax, fabsf(y[i]));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      sc = __fmul_rn(fmaxf(amax, 1e-8f), (float)(1.0 / 127.0));
      int q[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        q[i] = (int)fminf(fmaxf(rintf(__fdiv_rn(y[i], sc)), -127.f), 127.f);
      word = pack4(q);
    }
    reinterpret_cast<uint32_t*>(dst + r * LQ8)[lane] = word;
    if (lane == 0) scale[r] = sc;
  }
}

// s[i][j] = (float(q8[4 ty + i] . k8[tx + 16 j]) * qs) * ks + key bias: the
// int8 dot exact in int32 (__dp4a), then the float32 steps in the twin's
// order
__device__ __forceinline__ void scores_i8(const int8_t* sQ8, const float* sQs,
                                          const int8_t* sK8, const float* sKs,
                                          const float* sB, int tx, int ty, float s[4][4]) {
  int a[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = 0;
#pragma unroll 4
  for (int c = 0; c < 128 / 4; ++c) {
    int qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = reinterpret_cast<const int*>(sQ8 + (4 * ty + i) * LQ8)[c];
#pragma unroll
    for (int j = 0; j < 4; ++j) kv[j] = reinterpret_cast<const int*>(sK8 + (tx + 16 * j) * LQ8)[c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[i][j] = __dp4a(qv[i], kv[j], a[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      s[i][j] = __fadd_rn(
          __fmul_rn(__fmul_rn(__int2float_rn(a[i][j]), sQs[4 * ty + i]), sKs[tx + 16 * j]),
          sB[tx + 16 * j]);
}

__global__ void __launch_bounds__(NT, 1)
attention_i8qk_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ bias,
                      const int* __restrict__ vlen, float* __restrict__ scratch,
                      float* __restrict__ out, int U, int Tk, float q_scale, int64_t q_bs,
                      int64_t q_rs, int64_t k_bs, int64_t k_rs, int64_t v_bs, int64_t v_rs,
                      int64_t o_bs, int64_t o_rs) {
  constexpr int D = 128, LD = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* sKV = smem;             // BK x LD: v, rounded to bf16
  float* sP = sKV + BK * LD;     // BQ x LP
  float* sB = sP + BQ * LP;      // BK key biases
  float* sQs = sB + BK;          // BQ query scales
  float* sKs = sQs + BQ;         // BK key scales
  int8_t* sQ8 = reinterpret_cast<int8_t*>(sKs + BK);  // BQ x LQ8
  int8_t* sK8 = sQ8 + BQ * LQ8;                       // BK x LQ8

  const int u0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* qh = q + b * q_bs + (int64_t)h * D;
  const float* kh = k + b * k_bs + (int64_t)h * D;
  const float* vh = v + b * v_bs + (int64_t)h * D;
  const float* bb = bias + (int64_t)b * Tk;
  const int v_rows = vlen ? min(Tk, vlen[b]) : Tk;
  float* sc = scratch + (((int64_t)b * gridDim.y + h) * U + u0) * Tk;
  bool row_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) row_ok[i] = u0 + 4 * ty + i < U;

  quantize_rows(sQ8, sQs, qh, q_rs, u0, U, q_scale);  // q * d^-0.5, then int8
  float s[4][4];

  // ---- pass 1: each key tile quantized in shared memory (k is not
  // masked), the int8 scores into the scratch, and the row max m
  float m_i[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int k0 = 0; k0 < Tk; k0 += BK) {
    __syncthreads();
    quantize_rows(sK8, sKs, kh, k_rs, k0, Tk, 1.f);
    if (tid < BK) sB[tid] = (k0 + tid < Tk) ? bb[k0 + tid] : -INFINITY;
    __syncthreads();
    scores_i8(sQ8, sQs, sK8, sKs, sB, tx, ty, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        if (row_ok[i] && key < Tk) sc[(int64_t)(4 * ty + i) * Tk + key] = s[i][j];
        m_i[i] = fmaxf(m_i[i], s[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) m_i[i] = row_max(m_i[i]);

  exact_softmax_pv<D>(sc, m_i, row_ok, vh, v_rs, v_rows, Tk, sKV, sP,
                      out + b * o_bs + (int64_t)h * D, o_rs, u0, U);
}

}  // namespace

// Plain C entry point, called through ctypes.  `strides` holds the batch and
// row strides (in elements) of q, k, v and out, in that order.  dtype: 0 =
// float32, 1 = bfloat16; the head size d must be 128.  Returns
// cudaGetLastError() (0 on success); 1 (cudaErrorInvalidValue) for another
// head size or dtype.
extern "C" int attention_forward(const void* q, const void* k, const void* v,
                                 const float* bias, void* out, int B, int U, int Tk,
                                 int H, int d, int dtype, const long long* strides,
                                 void* stream) {
  if (B <= 0 || U <= 0 || H <= 0) return (int)cudaSuccess;
  if (Tk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (d != 128) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float, 128>(q, k, v, bias, out, B, U, Tk, H, strides, st);
  if (dtype == 1) return launch<__nv_bfloat16, 128>(q, k, v, bias, out, B, U, Tk, H, strides, st);
  return (int)cudaErrorInvalidValue;
}

// The int8 layers' attention (second kernel above): float32 q, k, v rounded
// to bf16 at load (q times q_scale first; v zero past vlen[b] when vlen is
// not null), float32 output; `scratch` is float32 (B, H, U, Tk).  Same
// strides, head size and return codes as attention_forward.
extern "C" int attention_forward_f32ctx(const float* q, const float* k, const float* v,
                                        const float* bias, const int* vlen, float* scratch,
                                        float* out, int B, int U, int Tk, int H, int d,
                                        float q_scale, const long long* strides,
                                        void* stream) {
  if (B <= 0 || U <= 0 || H <= 0) return (int)cudaSuccess;
  if (Tk <= 0 || d != 128) return (int)cudaErrorInvalidValue;
  constexpr int D = 128, LD = D + 4;
  const size_t smem = sizeof(float) * (BQ * LD + BK * LD + BQ * LP + BK);
  auto kern = attention_f32ctx_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((U + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, (cudaStream_t)stream>>>(
      q, k, v, bias, vlen, scratch, out, U, Tk, q_scale, strides[0], strides[1], strides[2],
      strides[3], strides[4], strides[5], strides[6], strides[7]);
  return (int)cudaGetLastError();
}

// The SANM layer's attention with int8 scores (third kernel above): float32
// q, k, v; q times q_scale and k row-quantized in the kernel, v rounded to
// bf16 and zero past vlen[b] (when not null), float32 output; `scratch` is
// float32 (B, H, U, Tk).  Same strides, head size and return codes as
// attention_forward.
extern "C" int attention_forward_i8qk(const float* q, const float* k, const float* v,
                                      const float* bias, const int* vlen, float* scratch,
                                      float* out, int B, int U, int Tk, int H, int d,
                                      float q_scale, const long long* strides,
                                      void* stream) {
  if (B <= 0 || U <= 0 || H <= 0) return (int)cudaSuccess;
  if (Tk <= 0 || d != 128) return (int)cudaErrorInvalidValue;
  constexpr int LD = 128 + 4;
  const size_t smem = sizeof(float) * (BK * LD + BQ * LP + BK + BQ + BK) + 2 * 64 * LQ8;
  auto kern = attention_i8qk_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((U + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, (cudaStream_t)stream>>>(
      q, k, v, bias, vlen, scratch, out, U, Tk, q_scale, strides[0], strides[1], strides[2],
      strides[3], strides[4], strides[5], strides[6], strides[7]);
  return (int)cudaGetLastError();
}
