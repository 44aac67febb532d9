// Fused dynamic-int8 matmul for Hopper (sm_90a): row quantize in the
// prologue, int8 x int8 -> int32 on mma.sync, the scales at the write.
//
// Replaces the TPU kernel funasr_tpu/ops/quant_pallas.py `_qmm_kernel`
// (pallas_call at :84), the opt-in QDense route of quant.py:118-122.  For x
// (M, K) bf16 or float32, w (N, K) int8 (the nn.Linear layout, quantized per
// output channel) with float32 scales sw (N,):
//
//   s_x[m] = max(max_k |x[m, k]|, 1e-8) * f32(1/127)     ("mul" form,
//   q[m, k] = clip(rint(x[m, k] / s_x[m]), -127, 127)     quant.py:150-157)
//   acc[m, n] = sum_k q[m, k] * w[n, k]                   int32, exact
//   v = (float(acc) * s_x[m]) * sw[n]                     float32
//   v = bf16(v)                      (bf16 x: the cast to x's dtype)
//   out[m, n] = v + bias[n]          (optional; flax adds it after the cast)
//
// written in x's dtype.  Every float32 step is an _rn intrinsic in this
// order and the quotient an IEEE division, so the plain twin
// (ops/qmm.py `quant_matmul_ref`: rowquant_ref "mul" + int8_gemm_ref) gets
// the same bits.
//
// Design.  One block per 64-row tile of x (and one share of the N tiles, so
// that a short M still fills the card): the block reads its rows of x once,
// finds each row's absmax with warp shuffles, and keeps the quantized rows
// in shared memory as an int8 (64, K) tile (K = 560: 37 KB) for all its N
// tiles, as the TPU kernel keeps them in VMEM scratch across its N grid
// steps.  The weights stream through two cp.async stages of 128 rows x 64
// bytes, zero-filled past N and K, so N = 8404 and K = 560 need no padding.
// 8 warps (2 x 4, each 32 x 32) issue mma.sync.m16n8k32 s8.  K must be a
// multiple of 16 and at most MAX_K; x and w 16-byte aligned (the wrapper
// checks).
//
// Bound on the H100 SXM: 2 M N K int8 operations at 1,979 TOP/s against x
// read once, w read once and out written once at 3.35 TB/s.  The output
// layer (8192, 512) x (512, 8404) is 70.5 GOP = 36 us against 146 MB of
// bytes = 44 us (bytes); encoders0's QKV (16384, 560) x (560, 1536) 28.2
// GOP = 14 us against 69 MB = 21 us.  mma.sync reaches only part of the
// int8 rate; wgmma with TMA is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 128, BK = 64;
constexpr int NT = 256;
constexpr int LDB = BK + 16;  // padded row stride of a weight stage, bytes
constexpr int BSTAGE = BN * LDB;
constexpr int MAX_K = 3072;
constexpr int TARGET_BLOCKS = 264;  // two blocks per SM of the H100's 132

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

// weight rows [n0, n0 + 128) x bytes [k0, k0 + 64) of the (N, K) int8 matrix
__device__ __forceinline__ void load_w(int8_t* dst, const int8_t* w, int N, int K, int n0,
                                       int k0) {
#pragma unroll
  for (int i = 0; i < (BN * BK / 16) / NT; ++i) {
    const int c = threadIdx.x + i * NT;
    const int r = c / (BK / 16), col = (c % (BK / 16)) * 16;
    const bool ok = (n0 + r < N) && (k0 + col < K);
    const int8_t* g = ok ? w + (int64_t)(n0 + r) * K + k0 + col : w;
    cp_async16(dst + r * LDB + col, g, ok);
  }
}

// 16 bytes of x as float32 values: 8 bf16 or 4 float32
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float v[4]) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float v[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  }
};

template <typename T>
__device__ __forceinline__ void store_pair(T* out, int64_t i, float v0, float v1, bool two,
                                           bool paired);
template <>
__device__ __forceinline__ void store_pair<float>(float* out, int64_t i, float v0, float v1,
                                                  bool two, bool paired) {
  if (two && paired) {
    *reinterpret_cast<float2*>(out + i) = make_float2(v0, v1);
  } else {
    out[i] = v0;
    if (two) out[i + 1] = v1;
  }
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* out, int64_t i,
                                                          float v0, float v1, bool two,
                                                          bool paired) {
  if (two && paired) {
    *reinterpret_cast<__nv_bfloat162*>(out + i) =
        __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
  } else {
    out[i] = __float2bfloat16_rn(v0);
    if (two) out[i + 1] = __float2bfloat16_rn(v1);
  }
}

// (acc * s_x) * sw, rounded to bf16 for a bf16 output, + bias: the twin's order
__device__ __forceinline__ float epilogue(int acc, float sx, float sw, const float* bias, int n,
                                          bool round_bf16) {
  float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw);
  if (round_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
  if (bias) v = __fadd_rn(v, bias[n]);
  return v;
}

// four int8 values packed little-endian into one 32-bit word
__device__ __forceinline__ uint32_t pack4(const int q[4]) {
  return (uint32_t)(q[0] & 0xff) | ((uint32_t)(q[1] & 0xff) << 8) |
         ((uint32_t)(q[2] & 0xff) << 16) | ((uint32_t)(q[3] & 0xff) << 24);
}

template <typename T>
__global__ void __launch_bounds__(NT)
qmm_kernel(const T* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ sw,
           const float* __restrict__ bias, T* __restrict__ out, int M, int N, int K, int Kp,
           int lda, int tiles_per_block) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* sA = smem;                    // BM x lda: the quantized rows
  int8_t* sW = smem + BM * lda;         // two weight stages
  float* sScale = reinterpret_cast<float*>(sW + 2 * BSTAGE);  // BM row scales

  const int m0 = blockIdx.x * BM;
  const int n_tiles = (N + BN - 1) / BN;
  const int t0 = blockIdx.y * tiles_per_block;
  const int t1 = min(t0 + tiles_per_block, n_tiles);
  if (t0 >= t1) return;
  const int nk = Kp / BK;
  const int steps = (t1 - t0) * nk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the first weight stage flies while the rows are quantized
  load_w(sW, w, N, K, t0 * BN, 0);
  asm volatile("cp.async.commit_group;\n" ::);

  // ---- prologue: each warp quantizes 8 rows into shared memory
  constexpr int V = Vec<T>::N;
  constexpr bool kBf16 = V == 8;
  for (int r = warp * (BM / 8); r < (warp + 1) * (BM / 8); ++r) {
    int8_t* dst = sA + r * lda;
    const int m = m0 + r;
    if (m < M) {
      const T* xr = x + (int64_t)m * K;
      float amax = 0.f;
      for (int c = lane * V; c < K; c += 32 * V) {
        float v[V];
        Vec<T>::load(xr + c, v);
#pragma unroll
        for (int i = 0; i < V; ++i) amax = fmaxf(amax, fabsf(v[i]));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      const float sc = __fmul_rn(fmaxf(amax, 1e-8f), (float)(1.0 / 127.0));
      for (int c = lane * V; c < K; c += 32 * V) {
        float v[V];
        Vec<T>::load(xr + c, v);
        int q[V];
#pragma unroll
        for (int i = 0; i < V; ++i)
          q[i] = (int)fminf(fmaxf(rintf(__fdiv_rn(v[i], sc)), -127.f), 127.f);
        if (V == 8)
          *reinterpret_cast<uint2*>(dst + c) = make_uint2(pack4(q), pack4(q + 4));
        else
          *reinterpret_cast<uint32_t*>(dst + c) = pack4(q);
      }
      if (lane == 0) sScale[r] = sc;
    } else {
      for (int c = lane * 16; c < K; c += 32 * 16)
        *reinterpret_cast<uint4*>(dst + c) = make_uint4(0, 0, 0, 0);
      if (lane == 0) sScale[r] = 0.f;
    }
    for (int c = K + lane * 16; c < Kp; c += 32 * 16)  // zero columns past K
      *reinterpret_cast<uint4*>(dst + c) = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  // ---- the N tiles: 8 warps of 32 x 32, mma.sync m16n8k32 s8
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;
  const int g = lane >> 2, t = lane & 3;
  const bool paired = (N & 1) == 0;  // bf16x2 / float2 stores stay aligned
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  for (int s = 0; s < steps; ++s) {
    const int kt = s % nk;
    const int8_t* cur = sW + (s & 1) * BSTAGE;
    if (s + 1 < steps) {
      const int s1 = s + 1;
      load_w(sW + (s1 & 1) * BSTAGE, w, N, K, (t0 + s1 / nk) * BN, (s1 % nk) * BK);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* p = sA + (wm + 16 * i + g) * lda + kt * BK + kk + 4 * t;
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * lda);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * lda + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = cur + (wn + 8 * j + g) * LDB + kk + 4 * t;
        b[j][0] = *reinterpret_cast<const uint32_t*>(p);
        b[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();  // the next step's copies overwrite this stage

    if (kt == nk - 1) {  // the tile is summed: scales, cast, bias, store
      const int n0 = (t0 + s / nk) * BN;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm + 16 * i + g + 8 * h;
          const int m = m0 + r;
          if (m >= M) continue;
          const float sx = sScale[r];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = n0 + wn + 8 * j + 2 * t;
            if (n >= N) continue;
            const bool two = n + 1 < N;
            const float v0 = epilogue(acc[i][j][2 * h], sx, sw[n], bias, n, kBf16);
            const float v1 =
                two ? epilogue(acc[i][j][2 * h + 1], sx, sw[n + 1], bias, n + 1, kBf16) : 0.f;
            store_pair<T>(out, (int64_t)m * N + n, v0, v1, two, paired);
          }
        }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const float* sw, const float* bias, void* out, int M,
           int N, int K, cudaStream_t stream) {
  const int Kp = (K + BK - 1) / BK * BK;
  const int lda = Kp + 16;  // 16 or 80 mod 128: conflict-free fragment loads
  const size_t smem = (size_t)BM * lda + 2 * BSTAGE + BM * sizeof(float);
  auto kern = qmm_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int m_blocks = (M + BM - 1) / BM;
  const int n_tiles = (N + BN - 1) / BN;
  // split the N tiles over blocks only as far as needed to fill the card;
  // each block of a split quantizes its rows again (the same bits)
  int splits = (TARGET_BLOCKS + m_blocks - 1) / m_blocks;
  splits = splits < 1 ? 1 : (splits > n_tiles ? n_tiles : splits);
  const int per_block = (n_tiles + splits - 1) / splits;
  splits = (n_tiles + per_block - 1) / per_block;
  dim3 grid(m_blocks, splits);
  kern<<<grid, NT, smem, stream>>>(static_cast<const T*>(x), static_cast<const int8_t*>(w), sw,
                                   bias, static_cast<T*>(out), M, N, K, Kp, lda, per_block);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, called through ctypes.  x (M, K) and out (M, N)
// contiguous in dtype 0 = float32 or 1 = bfloat16; w (N, K) int8
// contiguous; sw (N,) float32; bias (N,) float32 or null.  Returns
// cudaGetLastError() (0 on success); cudaErrorInvalidValue (1) when K is
// not a multiple of 16, K > 3072 or the dtype is another.
extern "C" int qmm_forward(const void* x, int dtype, const void* w, const float* sw,
                           const float* bias, void* out, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (K <= 0 || K % 16 || K > MAX_K) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, w, sw, bias, out, M, N, K, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, sw, bias, out, M, N, K, st);
  return (int)cudaErrorInvalidValue;
}
