// int8 x int8 -> int32 GEMM with a dequantize / bias / relu / residual
// epilogue, for Hopper (sm_90a).  The building block of the port's int8
// layers: it carries every contraction of the TPU kernels
// funasr_tpu/ops/sanm_layer_pallas.py `_sanm_layer_kernel`,
// decoder_layer_pallas.py `_dec_layer_kernel` and ffn_pallas.py
// `_ffn_kernel_int8`, and the XLA int8 dot of funasr_tpu/ops/quant.py
// `int8_dot_general` (QDense).
//
//   acc[m, n] = sum_k A[m, k] * B[n, k]          int32, exact
//   v = (float(acc) * sa[m]) * sb[n]             float32
//   v = res[m, n] + v          (res: optional, float32 or bf16)
//   v = bf16(v)                (optional: QDense rounds before its bias)
//   v = v + bias[n]            (optional)
//   v = max(v, 0)              (optional)
//   v = v + add[m, n]          (optional, float32: the FSMN memory)
//   out[m, n] = v              float32 or bf16 (round to nearest even)
//
// A is int8 (M, K) row-major with one float32 scale per row, B is int8
// (N, K) row-major (the nn.Linear (out, in) layout) with one float32 scale
// per output column.  The epilogue uses __fmul_rn / __fadd_rn so nvcc cannot
// contract it into FMAs: given the same int8 inputs, the result is bit-equal
// to the plain PyTorch twin (ops/int8_gemm.py), which computes acc exactly
// in float64 and applies the same float32 operations in the same order.
//
// Design.  One block per 128 x 128 output tile, 256 threads (8 warps, 2 x 4,
// each 64 x 32).  K streams through shared memory in 64-byte chunks,
// double-buffered with cp.async (16-byte copies, zero-filled past M, N and
// K, so ragged tails such as K = 560 and N = 8404 need no padding); rows are
// padded to 80 bytes so the 32-bit fragment loads are free of bank
// conflicts.  Each warp issues mma.sync.m16n8k32 s8 (int32 accumulate) on
// a 4 x 4 grid of 16 x 8 tiles.  K must be a multiple of 16 and A, B
// 16-byte aligned; the wrapper checks both.
//
// Bound on the H100 SXM: the layer GEMMs are 2 M N K int8 operations at
// 1,979 TOP/s dense; at M = 16384 the (M, 512) x (512, 1536) QKV projection
// is 25.8 GOP = 13 us against 33 MB of bytes (10 us), so operations bound
// it.  mma.sync reaches only part of Hopper's int8 rate (wgmma and TMA,
// a producer warp and a persistent grid are the later work that closes it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int NT = 256;
constexpr int LDS = BK + 16;  // padded row stride of a shared tile, bytes
constexpr int STAGE = (BM + BN) * LDS;

struct Epilogue {
  const float* sa;
  const float* sb;
  const float* bias;
  const void* res;
  long long res_ld;
  int res_bf16;
  const float* add;
  long long add_ld;
  int relu;
  int round_bf16;
  void* out;
  long long out_ld;
  int out_bf16;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0 bytes read: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// rows [r0, r0 + 128) x bytes [k0, k0 + 64) of a (rows, K) int8 matrix
__device__ __forceinline__ void load_stage(int8_t* dst, const int8_t* src, int rows, int K,
                                           int r0, int k0) {
#pragma unroll
  for (int i = 0; i < (128 * BK / 16) / NT; ++i) {
    const int c = threadIdx.x + i * NT;
    const int r = c / (BK / 16), col = (c % (BK / 16)) * 16;
    const bool ok = (r0 + r < rows) && (k0 + col < K);
    const int8_t* g = ok ? src + (int64_t)(r0 + r) * K + k0 + col : src;
    cp_async16(dst + r * LDS + col, g, ok);
  }
}

__device__ __forceinline__ float epilogue_value(const Epilogue& e, int acc, int m, int n) {
  float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), e.sa[m]), e.sb[n]);
  if (e.res) {
    const int64_t i = (int64_t)m * e.res_ld + n;
    const float r = e.res_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(e.res)[i])
                               : static_cast<const float*>(e.res)[i];
    v = __fadd_rn(r, v);
  }
  if (e.round_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
  if (e.bias) v = __fadd_rn(v, e.bias[n]);
  if (e.relu) v = fmaxf(v, 0.f);
  if (e.add) v = __fadd_rn(v, e.add[(int64_t)m * e.add_ld + n]);
  return v;
}

__device__ __forceinline__ void store(const Epilogue& e, int m, int n, float v) {
  const int64_t i = (int64_t)m * e.out_ld + n;
  if (e.out_bf16)
    static_cast<__nv_bfloat16*>(e.out)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(e.out)[i] = v;
}

__global__ void __launch_bounds__(NT)
int8_gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B, int M, int N,
                 int K, Epilogue e) {
  __shared__ __align__(16) int8_t smem[2 * STAGE];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int g = lane >> 2, t = lane & 3;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  const int nk = (K + BK - 1) / BK;
  load_stage(smem, A, M, K, m0, 0);
  load_stage(smem + BM * LDS, B, N, K, n0, 0);
  asm volatile("cp.async.commit_group;\n" ::);

  for (int kt = 0; kt < nk; ++kt) {
    int8_t* cur = smem + (kt & 1) * STAGE;
    if (kt + 1 < nk) {
      int8_t* nxt = smem + ((kt + 1) & 1) * STAGE;
      load_stage(nxt, A, M, K, m0, (kt + 1) * BK);
      load_stage(nxt + BM * LDS, B, N, K, n0, (kt + 1) * BK);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();

    const int8_t* sA = cur;
    const int8_t* sB = cur + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = sA + (wm + 16 * i + g) * LDS + kk + 4 * t;
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = sB + (wn + 8 * j + g) * LDS + kk + 4 * t;
        b[j][0] = *reinterpret_cast<const uint32_t*>(p);
        b[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + 16 * i + g + 8 * h;
        if (m >= M) continue;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = n0 + wn + 8 * j + 2 * t + c;
          if (n < N) store(e, m, n, epilogue_value(e, acc[i][j][2 * h + c], m, n));
        }
      }
}

}  // namespace

// Plain C entry point, called through ctypes.  Pointers may be null where
// the step is optional (bias, res, add).  Returns cudaGetLastError() (0 on
// success); cudaErrorInvalidValue (1) when K is not a multiple of 16.
extern "C" int int8_gemm_forward(const void* A, const void* B, int M, int N, int K,
                                 const float* sa, const float* sb, const float* bias,
                                 const void* res, long long res_ld, int res_bf16,
                                 const float* add, long long add_ld, int relu,
                                 int round_bf16, void* out, long long out_ld, int out_bf16,
                                 void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (K <= 0 || K % 16) return (int)cudaErrorInvalidValue;
  Epilogue e{sa, sb, bias, res, res_ld, res_bf16, add, add_ld, relu, round_bf16,
             out, out_ld, out_bf16};
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_gemm_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(A), static_cast<const int8_t*>(B), M, N, K, e);
  return (int)cudaGetLastError();
}
