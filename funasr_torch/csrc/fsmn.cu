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
// out written once (plus res), 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;

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
