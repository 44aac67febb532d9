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
// The int32 sums are exact in any order (|acc| <= 127^2 K < 2^31).
//
// Design: the mainloop of int8_wgmma.cuh.  A persistent grid of one block
// per SM walks 128 x BN output tiles (BN = 128 or 256), N fastest inside a
// band of 128 rows, so a band of A is read from device memory once and
// served from L2 to the N tiles beside it.  One producer thread streams
// 128-byte K stages of A and B by TMA into a ring; two consumer warpgroups
// (64 rows each) run wgmma m64nBNk32 s8 and then the epilogue straight
// from their accumulator registers, while the producer already loads the
// next tile.  The epilogue drains the accumulators 32 columns at a time
// through a small per-warp shared buffer, so each lane then finishes 4
// consecutive columns: res and add are read and out written in 16-byte
// accesses that cover whole lines, with the column scales and bias staged
// in shared memory while the tile's product runs.  The
// plan (BN, stages, grid, shared bytes) comes from ops/int8_gemm.py
// `gemm_plan`; the entry point refuses a plan it cannot run.  K must be a
// multiple of 16 and A, B 16-byte aligned (TMA's rules; the wrapper checks).
//
// Bound on the H100 SXM: bytes.  The served layer GEMMs write a float32
// (M, N) output, which outweighs the int8 operands: (16384, 512) x (1536,
// 512) moves 109 MB (33 us at 3.35 TB/s) against 25.8 GOP (13 us at 1,979
// TOP/s).  So the epilogue's write path sets the time as much as the
// mainloop, and the design keeps the stores in flight while the next
// tile's operands load.

#include <cuda_bf16.h>

#include "int8_wgmma.cuh"

namespace {

using i8w::BK;
constexpr int BM = 128;
constexpr int NC = 2;                // consumer warpgroups, 64 rows each
constexpr int NT = 128 * (NC + 1);   // + the producer warpgroup

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
  int vec;  // every (M, N) operand takes 4-element accesses at n % 4 == 0
};

// The twin's float32 steps, in its order, for one element
__device__ __forceinline__ float finish(const Epilogue& e, int acc, float sa, float sb,
                                        float res, float bias, float add) {
  float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), sa), sb);
  if (e.res) v = __fadd_rn(res, v);
  if (e.round_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
  if (e.bias) v = __fadd_rn(v, bias);
  if (e.relu) v = fmaxf(v, 0.f);
  if (e.add) v = __fadd_rn(v, add);
  return v;
}

// This warp's 16 rows (from m0) x BN columns of the tile at n0, from the
// accumulator registers through the warp's staging buffer (drain_tile):
// each lane finishes 4 consecutive columns of 4 rows per 32-column chunk,
// with the tile's column scales and bias from shared memory (s_sb, s_bias)
// and 16-byte loads of res and add, all issued before the chunk's stores.
template <int BN>
__device__ __forceinline__ void store_tile(const Epilogue& e, const int (&acc)[BN / 2],
                                           const float* s_sb, const float* s_bias, int* stage,
                                           int m0, int n0, int M, int N) {
  const int lane = threadIdx.x & 31, row = lane >> 3, col = 4 * (lane & 7);
  const bool vec = e.vec;
  float sa[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * i + row;
    sa[i] = m < M ? __ldg(e.sa + m) : 0.f;
  }
  i8w::drain_tile<BN>(acc, stage, [&](int c0, const int4 (&q)[4]) {
    const int c = c0 + col, n = n0 + c;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 r[4], ad[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + 4 * i + row;
      const bool in = m < M && n < N;
      r[i] = zero;
      if (e.res && in)
        r[i] = e.res_bf16
                   ? i8w::load4(static_cast<const __nv_bfloat16*>(e.res),
                                (int64_t)m * e.res_ld + n, n, N, vec)
                   : i8w::load4(static_cast<const float*>(e.res), (int64_t)m * e.res_ld + n, n,
                                N, vec);
      ad[i] = e.add && in ? i8w::load4(e.add, (int64_t)m * e.add_ld + n, n, N, vec) : zero;
    }
    const float4 sb = *reinterpret_cast<const float4*>(s_sb + c);
    const float4 b = e.bias ? *reinterpret_cast<const float4*>(s_bias + c) : zero;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + 4 * i + row;
      if (m >= M || n >= N) continue;
      const float v[4] = {finish(e, q[i].x, sa[i], sb.x, r[i].x, b.x, ad[i].x),
                          finish(e, q[i].y, sa[i], sb.y, r[i].y, b.y, ad[i].y),
                          finish(e, q[i].z, sa[i], sb.z, r[i].z, b.z, ad[i].z),
                          finish(e, q[i].w, sa[i], sb.w, r[i].w, b.w, ad[i].w)};
      const int64_t o = (int64_t)m * e.out_ld + n;
      if (e.out_bf16)
        i8w::store4(static_cast<__nv_bfloat16*>(e.out), o, n, N, v, vec);
      else
        i8w::store4(static_cast<float*>(e.out), o, n, N, v, vec);
    }
  });
}

// While a tile's product runs, bring the rows of res and add that this
// warpgroup's epilogue will read (64 rows from m0, BN columns from n0)
// into L2: one bulk prefetch a row, threads 0-63 for res and 64-127 for
// add, so the epilogue's loads wait on L2 rather than on device memory.
template <int BN>
__device__ __forceinline__ void prefetch_rows(const Epilogue& e, int m0, int n0, int M, int N) {
  const int t = threadIdx.x & 127, m = m0 + (t & 63);
  const bool is_res = t < 64;
  const void* base = is_res ? e.res : e.add;
  if (!base || m >= M) return;
  const int bytes_per = is_res && e.res_bf16 ? 2 : 4;
  const char* p = static_cast<const char*>(base) +
                  ((int64_t)m * (is_res ? e.res_ld : e.add_ld) + n0) * bytes_per;
  const uint32_t bytes = (uint32_t)(min(BN, N - n0) * bytes_per) & ~15u;
  if (bytes && ((uintptr_t)p & 15) == 0) i8w::prefetch_l2(p, bytes);
}

template <int BN>
__global__ void __launch_bounds__(NT, 1)
int8_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b, int M, int N, int K, int stages,
                 Epilogue e) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sA = i8w::align_smem(smem_raw);        // stages x BM x 128 bytes
  uint8_t* sB = sA + (size_t)stages * BM * BK;    // stages x BN x 128 bytes
  uint64_t* full = reinterpret_cast<uint64_t*>(sB + (size_t)stages * BN * BK);
  uint64_t* empty = full + stages;
  float* cols = reinterpret_cast<float*>(empty + stages);  // NC x (sb, bias) x BN
  int* stages_out = reinterpret_cast<int*>(cols + NC * 2 * BN);  // a buffer per consumer warp

  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * tiles_n;
  const int nk = (K + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      i8w::mbar_init(&full[s], 1);
      i8w::mbar_init(&empty[s], 4 * NC);  // one arrival per consumer warp
    }
    i8w::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  i8w::Ring ring{full, empty, stages};
  if (wg == NC) {  // ---- producer
    i8w::reg_dealloc<40>();
    if (threadIdx.x != NC * 128) return;
    i8w::tma_prefetch(&map_a);
    i8w::tma_prefetch(&map_b);
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
      for (int kb = 0; kb < nk; ++kb) {
        const int s = ring.stage;
        i8w::mbar_wait(&empty[s], ring.phase ^ 1);
        i8w::mbar_expect_tx(&full[s], (BM + BN) * BK);
        i8w::tma_load_2d(sA + (size_t)s * BM * BK, &map_a, &full[s], kb * BK, m0);
        i8w::tma_load_2d(sB + (size_t)s * BN * BK, &map_b, &full[s], kb * BK, n0);
        ring.advance();
      }
    }
  } else {  // ---- consumers: 64 rows of each tile per warpgroup
    i8w::reg_alloc<232>();
    int acc[1][BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[0][i] = 0;
    const uint8_t* a_rows = sA + wg * 64 * BK;
    float* s_sb = cols + wg * 2 * BN;
    float* s_bias = s_sb + BN;
    const int warp = threadIdx.x >> 5;  // 0 .. 4 NC - 1: rows 16 warp .. of the tile
    int* stage = stages_out + warp * (i8w::STAGE_WARP_BYTES / 4);
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
      i8w::named_barrier(1 + wg, 128);  // the last tile's epilogue is done with them
      i8w::stage_cols<BN>(s_sb, e.sb, n0, N);
      if (e.bias) i8w::stage_cols<BN>(s_bias, e.bias, n0, N);
      prefetch_rows<BN>(e, m0 + wg * 64, n0, M, N);
      i8w::mma_tile<BN, 1>(
          acc, nk, ring, [&](int s, int) { return a_rows + (size_t)s * BM * BK; }, sB);
      i8w::named_barrier(1 + wg, 128);  // the columns are staged
      store_tile<BN>(e, acc[0], s_sb, s_bias, stage, m0 + 16 * warp, n0, M, N);
    }
  }
}

// the ring, its barriers, each consumer warpgroup's staged columns and
// each consumer warp's staging buffer
int smem_bytes(int bn, int stages) {
  return i8w::SMEM_ALIGN + stages * ((BM + bn) * BK + 16) + NC * 2 * bn * 4 +
         4 * NC * i8w::STAGE_WARP_BYTES;
}

template <int BN>
int launch(const void* A, const void* B, int M, int N, int K, int stages, int grid, int smem,
           const Epilogue& e, cudaStream_t stream) {
  static int allowed = 0;
  auto kernel = int8_gemm_kernel<BN>;
  CUtensorMap map_a, map_b;
  if (!i8w::kmajor_map(&map_a, A, M, K, BM) || !i8w::kmajor_map(&map_b, B, N, K, BN))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = i8w::allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NT, smem, stream>>>(map_a, map_b, M, N, K, stages, e);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, called through ctypes.  Pointers may be null where
// the step is optional (bias, res, add).  The plan (bn, stages, grid,
// smem) is ops/int8_gemm.py `gemm_plan`'s.  Returns cudaGetLastError() (0
// on success); cudaErrorInvalidValue (1) when K is not a multiple of 16,
// the plan is not one this kernel runs (bn 128 or 256, 2-8 stages, shared
// bytes as smem_bytes within the limit, a grid of at most one block per
// SM) or a tensor map cannot be encoded.
extern "C" int int8_gemm_forward(const void* A, const void* B, int M, int N, int K,
                                 const float* sa, const float* sb, const float* bias,
                                 const void* res, long long res_ld, int res_bf16,
                                 const float* add, long long add_ld, int relu,
                                 int round_bf16, void* out, long long out_ld, int out_bf16,
                                 int bn, int stages, int grid, int smem, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (K <= 0 || K % 16) return (int)cudaErrorInvalidValue;
  if ((bn != 128 && bn != 256) || stages < 2 || stages > 8 || grid < 1 ||
      grid > i8w::sm_count() || smem != smem_bytes(bn, stages) || smem > i8w::MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  // 4-element accesses at n % 4 == 0 stay aligned when every row stride is
  // a multiple of 4 and every base is aligned to 4 elements
  auto aligned4 = [](const void* p, long long ld, int bf16) {
    return !p || (ld % 4 == 0 && (uintptr_t)p % (bf16 ? 8 : 16) == 0);
  };
  const int vec = aligned4(out, out_ld, out_bf16) && aligned4(res, res_ld, res_bf16) &&
                  aligned4(add, add_ld, 0);
  Epilogue e{sa, sb, bias, res, res_ld, res_bf16, add, add_ld, relu, round_bf16,
             out, out_ld, out_bf16, vec};
  cudaStream_t st = (cudaStream_t)stream;
  return bn == 256 ? launch<256>(A, B, M, N, K, stages, grid, smem, e, st)
                   : launch<128>(A, B, M, N, K, stages, grid, smem, e, st);
}
