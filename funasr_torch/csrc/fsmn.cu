// Depthwise FSMN memory for Hopper (sm_90a), float32.
//
// The memory branch of the TPU kernels funasr_tpu/ops/sanm_layer_pallas.py
// `_sanm_layer_kernel` (:93-101) and decoder_layer_pallas.py
// `_dec_layer_kernel` (:76-88).  Per batch row b, frame t and channel c,
// with valid[t] = (t < len[b]) and vm = v * valid:
//
//   mem[t] = (vm[t] + sum_j tap[j] * vm[t + j - left]) * valid[t]
//   out[t] = res[t] + mem[t]      (res optional, float32 or bf16)
//
// vm is zero outside [0, T).  The sum runs over j = 0..K-1 in order, each
// step a separate _rn multiply and add, as the twin (ops/fsmn.py) does, so
// the two agree bit for bit.  v may be a column slice of a wider tensor
// (the v third of the fused QKV projection): it has its own row stride.
//
// Design.  One thread per (b, t, c); a block covers 128 channels of one
// frame, so each of the K taps is a coalesced row read that the
// neighbouring frames' blocks find in L2.  Bound: bytes, v read once and
// out written once (plus res), 3.35 TB/s.  The served layers do not launch
// it: the SANM layer computes its memory in the wout GEMM's epilogue
// (csrc/int8_gemm.cu) and the decoder layer takes fsmn_ln below.
//
// fsmn_ln_forward: the decoder layer's LN2, FSMN and residual in one
// launch (decoder_layer_pallas.py:76-88), in place of a layer-norm-only
// rowquant launch whose float32 output only the FSMN read.  For h (B, T,
// D):
//
//   y   = ((h - mean) * (1 / sqrt(var + eps))) * w + b   (csrc/rowquant.cu)
//   out = res + FSMN(y)                                    (as above)
//
// the mean and variance summed in float64 (_rn sums and products) and
// rounded once to float32, as rowquant.cu and its twin do.  A block takes
// FRAMES frames of one utterance: it copies their rows and the halo (K - 1
// rows) at full width D into shared memory with cp.async, 16 bytes a copy,
// all in flight at once, while each thread loads the residuals of its
// outputs into registers; each warp then norms whole rows in place and
// multiplies them by the length mask (the twin's vm), and each thread
// finishes its channels of the FRAMES frames, taps outer so each tap is
// loaded once for all frames, with FRAMES independent sums in flight.
// Every h element is read once from device memory (the halo again, from
// L2), every output written once.  Bound: bytes, h and res read and out
// written once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;
constexpr int LN_NT = 256;  // fsmn_ln: 8 warps
constexpr int FRAMES = 16;  // fsmn_ln: frames a block finishes
constexpr int MAX_SMEM = 232448;

__global__ void __launch_bounds__(NT)
fsmn_kernel(const float* __restrict__ v, long long v_bs, long long v_rs,
            const int* __restrict__ lengths, const float* __restrict__ taps, int T, int D,
            int K, int left, const void* __restrict__ res, int res_bf16,
            float* __restrict__ out) {
  const int c = blockIdx.x * NT + threadIdx.x;
  const int t = blockIdx.y, b = blockIdx.z;
  if (c >= D) return;
  const int L = lengths[b];
  const float* vb = v + b * v_bs + c;
  const float valid = t < L ? 1.f : 0.f;
  float acc = __fmul_rn(vb[(int64_t)t * v_rs], valid);
  for (int j = 0; j < K; ++j) {
    const int s = t + j - left;
    const float vm = (s >= 0 && s < T) ? __fmul_rn(vb[(int64_t)s * v_rs], s < L ? 1.f : 0.f)
                                       : 0.f;
    acc = __fadd_rn(acc, __fmul_rn(taps[j * D + c], vm));
  }
  acc = __fmul_rn(acc, valid);
  const int64_t o = ((int64_t)b * T + t) * D + c;
  if (res) {
    const float r = res_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(res)[o])
                             : static_cast<const float*>(res)[o];
    acc = __fadd_rn(r, acc);
  }
  out[o] = acc;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// CPT channels a thread (D <= CPT * LN_NT); a warp's row is 2 CPT float4
// a lane
template <int CPT>
__global__ void __launch_bounds__(LN_NT)
fsmn_ln_kernel(const float* __restrict__ h, const float* __restrict__ ln_w,
               const float* __restrict__ ln_b, float eps, const int* __restrict__ lengths,
               const float* __restrict__ taps, int T, int D, int K, int left,
               const void* __restrict__ res, int res_bf16, float* __restrict__ out) {
  constexpr int NV = 2 * CPT;
  extern __shared__ float rows[];  // (FRAMES + K - 1) x D: frames t0 - left ..
  const int b = blockIdx.y, t0 = blockIdx.x * FRAMES;
  const int n_rows = FRAMES + K - 1, chunks = D / 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* hb = h + (int64_t)b * T * D;
  for (int i = threadIdx.x; i < n_rows * chunks; i += LN_NT) {
    const int r = i / chunks, c = 4 * (i - r * chunks), s = t0 - left + r;
    if (s >= 0 && s < T) cp_async16(rows + r * D + c, hb + (int64_t)s * D + c);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  float rv[CPT][FRAMES];  // this thread's residuals, loading while the rows norm
#pragma unroll
  for (int ch = 0; ch < CPT; ++ch) {
    const int c = threadIdx.x + ch * LN_NT;
#pragma unroll
    for (int i = 0; i < FRAMES; ++i) {
      const int64_t o = ((int64_t)b * T + t0 + i) * D + c;
      rv[ch][i] = !res || c >= D || t0 + i >= T ? 0.f
                  : res_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(res)[o])
                             : static_cast<const float*>(res)[o];
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const int L = lengths[b];
  for (int r = warp; r < n_rows; r += LN_NT / 32) {
    const int s = t0 - left + r;
    float* y = rows + (size_t)r * D;
    if (s < 0 || s >= T) {  // outside the utterance: the twin's zero padding
      for (int c = 4 * lane; c < D; c += 128) *reinterpret_cast<float4*>(y + c) = float4{};
      continue;
    }
    float v[NV][4];
    double sum[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = 4 * (lane + 32 * k);
      const float4 u = c < D ? *reinterpret_cast<const float4*>(y + c) : float4{};
      v[k][0] = u.x, v[k][1] = u.y, v[k][2] = u.z, v[k][3] = u.w;
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[e] = __dadd_rn(sum[e], (double)v[k][e]);
    }
    const double mean =
        __ddiv_rn(warp_sum(__dadd_rn(__dadd_rn(sum[0], sum[1]), __dadd_rn(sum[2], sum[3]))),
                  (double)D);
    double ss[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (4 * (lane + 32 * k) >= D) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const double d = __dsub_rn((double)v[k][e], mean);
        ss[e] = __dadd_rn(ss[e], __dmul_rn(d, d));
      }
    }
    const double var =
        __ddiv_rn(warp_sum(__dadd_rn(__dadd_rn(ss[0], ss[1]), __dadd_rn(ss[2], ss[3]))),
                  (double)D);
    const float mean_f = (float)mean;
    const float inv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn((float)var, eps)));
    const float keep = s < L ? 1.f : 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = 4 * (lane + 32 * k);
      if (c >= D) break;
      const float4 w = __ldg(reinterpret_cast<const float4*>(ln_w + c));
      const float4 bb = __ldg(reinterpret_cast<const float4*>(ln_b + c));
      const float wv[4] = {w.x, w.y, w.z, w.w}, bv[4] = {bb.x, bb.y, bb.z, bb.w};
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[e] = __fmul_rn(
            __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[k][e], mean_f), inv), wv[e]), bv[e]),
            keep);
      *reinterpret_cast<float4*>(y + c) = make_float4(o[0], o[1], o[2], o[3]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int ch = 0; ch < CPT; ++ch) {
    const int c = threadIdx.x + ch * LN_NT;
    if (c >= D) break;
    float acc[FRAMES];
#pragma unroll
    for (int i = 0; i < FRAMES; ++i) acc[i] = rows[(size_t)(i + left) * D + c];
    for (int j = 0; j < K; ++j) {
      const float tp = __ldg(taps + (int64_t)j * D + c);
#pragma unroll
      for (int i = 0; i < FRAMES; ++i)
        acc[i] = __fadd_rn(acc[i], __fmul_rn(tp, rows[(size_t)(i + j) * D + c]));
    }
#pragma unroll
    for (int i = 0; i < FRAMES; ++i) {
      const int t = t0 + i;
      if (t >= T) break;
      float a = __fmul_rn(acc[i], t < L ? 1.f : 0.f);
      if (res) a = __fadd_rn(rv[ch][i], a);
      out[((int64_t)b * T + t) * D + c] = a;
    }
  }
}

template <int CPT>
int launch_ln(const float* h, const float* ln_w, const float* ln_b, float eps,
              const int* lengths, const float* taps, int B, int T, int D, int K, int left,
              const void* res, int res_bf16, float* out, size_t smem, cudaStream_t st) {
  static int allowed = 48 * 1024;
  auto kernel = fsmn_ln_kernel<CPT>;
  if ((int)smem > allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = (int)smem;
  }
  dim3 grid((T + FRAMES - 1) / FRAMES, B);
  kernel<<<grid, LN_NT, smem, st>>>(h, ln_w, ln_b, eps, lengths, taps, T, D, K, left, res,
                                    res_bf16, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, called through ctypes.  v: float32 with batch and row
// strides in elements (unit column stride); lengths: int32 (B,); taps:
// float32 (K, D); res: null or (B, T, D) contiguous float32 (res_bf16 0) or
// bfloat16 (1); out: (B, T, D) float32 contiguous.  Returns
// cudaGetLastError().
extern "C" int fsmn_forward(const float* v, long long v_bs, long long v_rs, const int* lengths,
                            const float* taps, int B, int T, int D, int K, int left,
                            const void* res, int res_bf16, float* out, void* stream) {
  if (B <= 0 || T <= 0 || D <= 0) return (int)cudaSuccess;
  if (T > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((D + NT - 1) / NT, T, B);
  fsmn_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(v, v_bs, v_rs, lengths, taps, T, D, K,
                                                     left, res, res_bf16, out);
  return (int)cudaGetLastError();
}

// Plain C entry point of the fused layer norm + FSMN, called through
// ctypes.  h: (B, T, D) float32 contiguous, 16-byte aligned; ln_w, ln_b:
// (D,) float32, 16-byte aligned; lengths: int32 (B,); taps: float32 (K,
// D); res: null or (B, T, D) contiguous float32 (res_bf16 0) or bfloat16
// (1); out: (B, T, D) float32.  Returns cudaGetLastError();
// cudaErrorInvalidValue (1) when D is not a multiple of 4 or above 1024,
// K or left is out of range, the rows and the halo do not fit in shared
// memory, or B is above 65535.
extern "C" int fsmn_ln_forward(const float* h, const float* ln_w, const float* ln_b, float eps,
                               const int* lengths, const float* taps, int B, int T, int D,
                               int K, int left, const void* res, int res_bf16, float* out,
                               void* stream) {
  if (B <= 0 || T <= 0 || D <= 0) return (int)cudaSuccess;
  const size_t smem = sizeof(float) * (size_t)(FRAMES + K - 1) * D;
  if (D % 4 || D > 4 * LN_NT || K < 1 || left < 0 || left >= K || B > 65535 ||
      smem > (size_t)MAX_SMEM || ((uintptr_t)h | (uintptr_t)ln_w | (uintptr_t)ln_b) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return D <= 2 * LN_NT ? launch_ln<2>(h, ln_w, ln_b, eps, lengths, taps, B, T, D, K, left, res,
                                       res_bf16, out, smem, st)
                        : launch_ln<4>(h, ln_w, ln_b, eps, lengths, taps, B, T, D, K, left, res,
                                       res_bf16, out, smem, st);
}
