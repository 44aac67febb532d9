// Position-wise FFN out = relu(x W1^T + b1) W2^T + b2 for Hopper (sm_90a),
// bf16 or float32, the hidden tile kept in shared memory.
//
// Replaces the TPU kernel funasr_tpu/ops/ffn_pallas.py `_ffn_kernel` (:39,
// pallas_call at :86).  Same function (ffn_pallas.py:39-45), for x (M, K),
// w1 (H, K) and w2 (N, H) in one dtype T (the nn.Linear layout), float32
// biases:
//
//   h   = T(relu(x w1^T + b1))        float32 accumulation, then cast
//   out = T(h w2^T + b2)              float32 accumulation, then cast
//
// Design.  One block of 256 threads per 32 rows (bf16) or 16 rows
// (float32) of x.  The block stages its rows of x in shared memory, then
// computes its whole (rows, H) hidden tile into shared memory (32 x 2048
// bf16 = 128 KB, as the TPU kernel keeps it in VMEM), then the output rows
// from it: the hidden activations never touch device memory.  The weights
// stream through two cp.async stages of 128 rows x 64 bytes.  bf16 runs on
// the tensor cores, mma.sync.m16n8k16 with float32 accumulation (8 warps,
// each 32 rows x 16 columns of a 128-column tile); float32 runs as FMA on
// the CUDA cores, one sum per output in k order.  The sums run in another
// order than the plain twin's, so kernel and twin agree to a stated
// tolerance, not bit for bit (ops/ffn.py).  K and H must be multiples of 32
// and the operands 16-byte aligned (the wrapper checks); N and M are free.
//
// Bound on the H100 SXM at (16384, 512) -> 2048 -> 512 bf16: 68.7 GFLOP =
// 69 us at 989 TFLOP/s against 37.7 MB of bytes = 11 us: operations.  The
// mma.sync loop with a barrier per 64-byte step reaches only part of that;
// wgmma tiles are later work.  No caller routes this kernel, in the JAX
// package or in the port: it is ported for completeness.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int BN = 128;             // output columns per tile
constexpr int CHUNK = 64;           // bytes of K per weight stage row
constexpr int LDW = CHUNK + 16;     // padded row stride of a weight stage
constexpr int WSTAGE = BN * LDW;
constexpr int SMEM_MAX = 232448;    // an H100 block's shared memory

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

// weight rows [n0, n0 + 128) x bytes [b0, b0 + 64) of an (N, kbytes) matrix
__device__ __forceinline__ void load_w(char* dst, const char* w, int N, int kbytes, int n0,
                                       int b0) {
#pragma unroll
  for (int i = 0; i < (BN * CHUNK / 16) / NT; ++i) {
    const int c = threadIdx.x + i * NT;
    const int r = c / (CHUNK / 16), col = (c % (CHUNK / 16)) * 16;
    const bool ok = n0 + r < N;
    const char* g = ok ? w + (int64_t)(n0 + r) * kbytes + b0 + col : w;
    cp_async16(dst + r * LDW + col, g, ok);
  }
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Per-dtype tile arithmetic over one 64-byte weight stage.  Both keep the
// accumulator of a (BM, 128) output tile in registers and visit their
// outputs through `each(row, col, acc)`.
template <typename T>
struct Tile;

template <>
struct Tile<__nv_bfloat16> {  // 32 rows; warp w owns columns [16 w, 16 w + 16)
  static constexpr int BM = 32;
  float acc[2][2][4];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
  }
  // sA: the block's rows (row stride lda bytes) at this stage's k bytes
  __device__ void step(const char* sA, int lda, const char* sW) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3, wn = warp * 16;
#pragma unroll
    for (int kk = 0; kk < CHUNK; kk += 32) {  // two k16 steps of 32 bytes
      uint32_t a[2][4], b[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const char* p = sA + (16 * i + g) * lda + kk + 4 * t;
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * lda);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * lda + 16);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const char* p = sW + (wn + 8 * j + g) * LDW + kk + 4 * t;
        b[j][0] = *reinterpret_cast<const uint32_t*>(p);
        b[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
  }
  template <typename F>
  __device__ void each(F f) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3, wn = warp * 16;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          f(16 * i + g + 8 * (c >> 1), wn + 8 * j + 2 * t + (c & 1), acc[i][j][c]);
  }
};

template <>
struct Tile<float> {  // 16 rows; thread (r, c0) owns row r, columns c0 + 16 j
  static constexpr int BM = 16;
  float acc[8];
  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  }
  __device__ void step(const char* sA, int lda, const char* sW) {
    const int r = threadIdx.x >> 4, c0 = threadIdx.x & 15;
    const float* a = reinterpret_cast<const float*>(sA + r * lda);
#pragma unroll
    for (int k = 0; k < CHUNK / 4; ++k) {
      const float av = a[k];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[j] = fmaf(av, reinterpret_cast<const float*>(sW + (c0 + 16 * j) * LDW)[k], acc[j]);
    }
  }
  template <typename F>
  __device__ void each(F f) {
    const int r = threadIdx.x >> 4, c0 = threadIdx.x & 15;
#pragma unroll
    for (int j = 0; j < 8; ++j) f(r, c0 + 16 * j, acc[j]);
  }
};

// dst[row, n] = put(relu?(sA w^T + bias)) for n < N, the (BM, kbytes) rows
// in shared memory, w (N, kbytes) in device memory; `store(row, n, v)`
template <typename T, typename Store>
__device__ void gemm_rows(const char* sA, int lda, const T* w, int N, int kbytes,
                          const float* bias, bool relu, char* sW, Store store) {
  const int nk = kbytes / CHUNK;
  const int steps = ((N + BN - 1) / BN) * nk;
  const char* wb = reinterpret_cast<const char*>(w);
  Tile<T> tile;
  tile.zero();
  load_w(sW, wb, N, kbytes, 0, 0);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int s = 0; s < steps; ++s) {
    const int kt = s % nk, n0 = (s / nk) * BN;
    if (s + 1 < steps)
      load_w(sW + ((s + 1) & 1) * WSTAGE, wb, N, kbytes, ((s + 1) / nk) * BN,
             ((s + 1) % nk) * CHUNK);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    tile.step(sA + kt * CHUNK, lda, sW + (s & 1) * WSTAGE);
    __syncthreads();  // the next step's copies overwrite this stage
    if (kt == nk - 1) {
      tile.each([&](int row, int col, float v) {
        const int n = n0 + col;
        if (n >= N) return;
        v = __fadd_rn(v, bias[n]);
        if (relu) v = fmaxf(v, 0.f);
        store(row, n, v);
      });
      tile.zero();
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
ffn_kernel(const T* __restrict__ x, const T* __restrict__ w1, const float* __restrict__ b1,
           const T* __restrict__ w2, const float* __restrict__ b2, T* __restrict__ out, int M,
           int K, int H, int N) {
  constexpr int BM = Tile<T>::BM;
  extern __shared__ __align__(16) char smem[];
  const int ldx = K * (int)sizeof(T) + 16, ldh = H * (int)sizeof(T) + 16;
  char* sX = smem;               // BM x ldx: the block's rows of x
  char* sH = sX + BM * ldx;      // BM x ldh: the hidden tile
  char* sW = sH + BM * ldh;      // two weight stages
  const int m0 = blockIdx.x * BM;

  const int xrow = K * (int)sizeof(T) / 16;  // 16-byte pieces per row
  for (int i = threadIdx.x; i < BM * xrow; i += NT) {
    const int r = i / xrow, c = (i % xrow) * 16;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (m0 + r < M)
      v = *reinterpret_cast<const uint4*>(reinterpret_cast<const char*>(x) +
                                          (int64_t)(m0 + r) * K * sizeof(T) + c);
    *reinterpret_cast<uint4*>(sX + r * ldx + c) = v;
  }
  __syncthreads();

  gemm_rows<T>(sX, ldx, w1, H, K * (int)sizeof(T), b1, true, sW,
               [&](int row, int n, float v) {
                 put(reinterpret_cast<T*>(sH + row * ldh) + n, v);
               });
  __syncthreads();
  gemm_rows<T>(sH, ldh, w2, N, H * (int)sizeof(T), b2, false, sW,
               [&](int row, int n, float v) {
                 if (m0 + row < M) put(out + (int64_t)(m0 + row) * N + n, v);
               });
}

template <typename T>
int launch(const void* x, const void* w1, const float* b1, const void* w2, const float* b2,
           void* out, int M, int K, int H, int N, cudaStream_t stream) {
  constexpr int BM = Tile<T>::BM;
  const size_t smem = (size_t)BM * (K * sizeof(T) + 16) + (size_t)BM * (H * sizeof(T) + 16) +
                      2 * WSTAGE;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kern = ffn_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(M + BM - 1) / BM, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), b1, static_cast<const T*>(w2), b2,
      static_cast<T*>(out), M, K, H, N);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, called through ctypes.  x (M, K), w1 (H, K), w2
// (N, H) and out (M, N) contiguous in dtype 0 = float32 or 1 = bfloat16;
// b1 (H,) and b2 (N,) float32.  Returns cudaGetLastError() (0 on success);
// cudaErrorInvalidValue (1) when K or H is not a multiple of 32, the rows
// of x and the hidden tile do not fit the block's shared memory, or the
// dtype is another.
extern "C" int ffn_forward(const void* x, int dtype, const void* w1, const float* b1,
                           const void* w2, const float* b2, void* out, int M, int K, int H,
                           int N, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (K <= 0 || H <= 0 || K % 32 || H % 32) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, w1, b1, w2, b2, out, M, K, H, N, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w1, b1, w2, b2, out, M, K, H, N, st);
  return (int)cudaErrorInvalidValue;
}
