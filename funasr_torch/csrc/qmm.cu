// Fused dynamic-int8 matmul for Hopper (sm_90a): row quantize in the
// prologue, int8 x int8 -> int32 on wgmma, the scales at the write.
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
// Design: the mainloop of int8_wgmma.cuh with another producer of A.  A
// block owns a band of BM rows (64 per consumer warpgroup) and a run of N
// tiles; a persistent grid of one block per SM walks these units.  Each
// consumer warpgroup quantizes its 64 rows with the band producer of
// int8_wgmma.cuh (`quantize_rows`, shared with the int8 GEMM's
// row-quantizing entry: rows held in registers, absmax by warp shuffles)
// and writes them into shared memory in the 128B-swizzled
// K-major layout that TMA gives the int8 GEMM (K padded to a multiple of
// 128 with zeros), then fences them into the async proxy; the band then
// serves every N tile of the unit, as the TPU kernel keeps its rows in VMEM
// scratch across its N grid steps.  Meanwhile the producer thread streams the weights by TMA
// through the ring, zero-filled past N and K, so N = 8404 and K = 560 need
// no padding.  The epilogue drains the accumulators through a per-warp
// shared buffer (drain_tile) and writes 4 consecutive columns a lane, with
// the tile's weight scales and bias staged in shared memory while the
// tile's product runs.  Where the bands alone do not fill the card (a
// short M), the N tiles are split over several units, each of which
// quantizes its band again (the same bits).
//
// What runs at which K (ops/qmm.py `qmm_plan`; 227 KB of shared memory):
// the band takes BM x Kp bytes, Kp = K rounded up to 128.  K <= 1280 runs
// 128-row bands (K = 512: 64 KB band and 4 stages of 256-row weight
// tiles; K = 560: 80 KB and 3; K = 1280: 160 KB and 2 stages of 128
// rows), larger K 64-row bands with one consumer warpgroup (K = 2048:
// 128 KB and 2 stages of 256 rows; K = 2816: 176 KB and 2 of 128 rows;
// K = 3072: 192 KB and 2 of 64 rows).
// K must be a multiple of 16 and at most MAX_K; x and w 16-byte aligned
// (the wrapper checks).
//
// Bound on the H100 SXM: bytes.  x is read once in its dtype, w once, out
// written once: encoders0's QKV (16384, 560) x (560, 1536) moves 70 MB (21
// us at 3.35 TB/s) against 28.2 GOP (14 us at 1,979 TOP/s); the output
// layer (8192, 512) x (512, 8404) 151 MB (45 us) against 70.5 GOP (36 us).

#include <cuda_bf16.h>

#include "int8_wgmma.cuh"

namespace {

using i8w::BK;
constexpr int MAX_K = 3072;

// (acc * s_x) * sw, rounded to bf16 for a bf16 output, + bias: the twin's order
__device__ __forceinline__ float epilogue(int acc, float sx, float sw, bool has_bias, float bias,
                                          bool round_bf16) {
  float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw);
  if (round_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
  if (has_bias) v = __fadd_rn(v, bias);
  return v;
}

template <typename T, int BN, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
qmm_kernel(const __grid_constant__ CUtensorMap map_w, const T* __restrict__ x,
           const float* __restrict__ sw, const float* __restrict__ bias, T* __restrict__ out,
           int M, int N, int K, int stages, int splits, int per_split) {
  constexpr int BM = 64 * NC;
  const int nk = (K + BK - 1) / BK, Kp = nk * BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* band = i8w::align_smem(smem_raw);       // nk k-blocks of BM x 128 bytes
  uint8_t* sB = band + (size_t)Kp * BM;             // stages x BN x 128 bytes
  uint64_t* full = reinterpret_cast<uint64_t*>(sB + (size_t)stages * BN * BK);
  uint64_t* empty = full + stages;
  float* scale = reinterpret_cast<float*>(empty + stages);  // BM row scales
  float* cols = scale + BM;  // NC x (sw, bias) x BN
  int* stages_out = reinterpret_cast<int*>(cols + NC * 2 * BN);  // a buffer per consumer warp

  const int n_tiles = (N + BN - 1) / BN;
  const int units = (M + BM - 1) / BM * splits;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      i8w::mbar_init(&full[s], 1);
      i8w::mbar_init(&empty[s], 4 * NC);
    }
    i8w::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  i8w::Ring ring{full, empty, stages};
  if (wg == NC) {  // ---- producer: the weight tiles of every unit, in order
    if constexpr (NC > 1) i8w::reg_dealloc<40>();
    if (threadIdx.x != NC * 128) return;
    i8w::tma_prefetch(&map_w);
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int t0 = u % splits * per_split, t1 = min(t0 + per_split, n_tiles);
      for (int t = t0; t < t1; ++t)
        for (int kb = 0; kb < nk; ++kb) {
          const int s = ring.stage;
          i8w::mbar_wait(&empty[s], ring.phase ^ 1);
          i8w::mbar_expect_tx(&full[s], BN * BK);
          i8w::tma_load_2d(sB + (size_t)s * BN * BK, &map_w, &full[s], kb * BK, t * BN);
          ring.advance();
        }
    }
  } else {  // ---- consumers: quantize 64 rows, then every N tile of the unit
    if constexpr (NC > 1) i8w::reg_alloc<232>();
    constexpr bool kBf16 = i8w::Vec<T>::N == 8;
    const bool vec = (N & 3) == 0;  // 4-element stores stay aligned
    const int r0 = wg * 64;
    float* s_sw = cols + wg * 2 * BN;
    float* s_bias = s_sw + BN;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, row = lane >> 3;
    const int wr = 16 * warp + row;  // the band row of this lane's first staged row
    int* stage = stages_out + warp * (i8w::STAGE_WARP_BYTES / 4);
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int m0 = u / splits * BM;
      const int t0 = u % splits * per_split, t1 = min(t0 + per_split, n_tiles);
      // the last unit's wgmma and epilogue are done with the band and scales
      i8w::named_barrier(1 + wg, 128);
      i8w::quantize_rows<T, BM>(x, K, band, scale, m0, r0, M, K, Kp);
      i8w::fence_proxy_async();
      for (int t = t0; t < t1; ++t) {
        const int n0 = t * BN;
        // the band is written; the last tile's epilogue is done with the columns
        i8w::named_barrier(1 + wg, 128);
        i8w::stage_cols<BN>(s_sw, sw, n0, N);
        if (bias) i8w::stage_cols<BN>(s_bias, bias, n0, N);
        // declared per tile: dead while the band quantizes
        int acc[1][BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[0][i] = 0;
        i8w::mma_tile<BN, 1>(
            acc, nk, ring,
            [&](int, int kb) { return band + (size_t)kb * BM * BK + r0 * BK; }, sB);
        i8w::named_barrier(1 + wg, 128);  // the columns are staged
        float sx[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) sx[i] = scale[wr + 4 * i];
        i8w::drain_tile<BN>(acc[0], stage, [&](int c0, const int4 (&q)[4]) {
          const int c = c0 + 4 * (lane & 7), n = n0 + c;
          const float4 w4 = *reinterpret_cast<const float4*>(s_sw + c);
          const float4 b4 =
              bias ? *reinterpret_cast<const float4*>(s_bias + c) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int m = m0 + wr + 4 * i;
            if (m >= M || n >= N) continue;
            const float v[4] = {epilogue(q[i].x, sx[i], w4.x, bias, b4.x, kBf16),
                                epilogue(q[i].y, sx[i], w4.y, bias, b4.y, kBf16),
                                epilogue(q[i].z, sx[i], w4.z, bias, b4.z, kBf16),
                                epilogue(q[i].w, sx[i], w4.w, bias, b4.w, kBf16)};
            i8w::store4(out, (int64_t)m * N + n, n, N, v, vec);
          }
        });
      }
    }
  }
}

// the band, the weight ring and its barriers, the row scales, each
// consumer warpgroup's staged column scales and bias and each consumer
// warp's staging buffer
int smem_bytes(int bm, int bn, int stages, int K) {
  const int Kp = (K + BK - 1) / BK * BK;
  return i8w::SMEM_ALIGN + bm * Kp + stages * (bn * BK + 16) + bm * 4 +
         bm / 64 * (2 * bn * 4 + 4 * i8w::STAGE_WARP_BYTES);
}

template <typename T, int BN, int NC>
int launch(const void* x, const CUtensorMap& map_w, const float* sw, const float* bias,
           void* out, int M, int N, int K, int stages, int splits, int per_split, int grid,
           int smem, cudaStream_t stream) {
  static int allowed = 0;
  auto kern = qmm_kernel<T, BN, NC>;
  cudaError_t err = i8w::allow_smem(kern, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, 128 * (NC + 1), smem, stream>>>(map_w, static_cast<const T*>(x), sw, bias,
                                               static_cast<T*>(out), M, N, K, stages, splits,
                                               per_split);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const CUtensorMap& map_w, const float* sw, const float* bias,
             void* out, int M, int N, int K, int bm, int bn, int stages, int splits,
             int per_split, int grid, int smem, cudaStream_t st) {
  if (bm == 128 && bn == 256)
    return launch<T, 256, 2>(x, map_w, sw, bias, out, M, N, K, stages, splits, per_split, grid,
                             smem, st);
  if (bm == 128)
    return launch<T, 128, 2>(x, map_w, sw, bias, out, M, N, K, stages, splits, per_split, grid,
                             smem, st);
  if (bn == 256)
    return launch<T, 256, 1>(x, map_w, sw, bias, out, M, N, K, stages, splits, per_split, grid,
                             smem, st);
  if (bn == 128)
    return launch<T, 128, 1>(x, map_w, sw, bias, out, M, N, K, stages, splits, per_split, grid,
                             smem, st);
  return launch<T, 64, 1>(x, map_w, sw, bias, out, M, N, K, stages, splits, per_split, grid,
                          smem, st);
}

}  // namespace

// Plain C entry point, called through ctypes.  x (M, K) and out (M, N)
// contiguous in dtype 0 = float32 or 1 = bfloat16; w (N, K) int8
// contiguous; sw (N,) float32; bias (N,) float32 or null.  The plan (bm,
// bn, stages, splits, per_split, grid, smem) is ops/qmm.py `qmm_plan`'s.
// Returns cudaGetLastError() (0 on success); cudaErrorInvalidValue (1)
// when K is not a multiple of 16, K > 3072, the dtype is another, the
// plan is not one this kernel runs (bm 64 or 128, bn 128 or 256, or 64
// with bm 64, 2-8 stages, shared bytes as smem_bytes within the limit, splits x
// per_split covering the N tiles, at most one block per SM) or the weights'
// tensor map cannot be encoded.
extern "C" int qmm_forward(const void* x, int dtype, const void* w, const float* sw,
                           const float* bias, void* out, int M, int N, int K, int bm, int bn,
                           int stages, int splits, int per_split, int grid, int smem,
                           void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (K <= 0 || K % 16 || K > MAX_K || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (N + bn - 1) / bn;
  if ((bm != 64 && bm != 128) || (bn != 64 * (bm / 64) && bn != 128 && bn != 256) ||
      stages < 2 || stages > 8 ||
      splits < 1 || per_split < 1 || (long long)splits * per_split < n_tiles || grid < 1 ||
      grid > i8w::sm_count() || smem != smem_bytes(bm, bn, stages, K) || smem > i8w::MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_w;
  if (!i8w::kmajor_map(&map_w, w, N, K, bn)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(x, map_w, sw, bias, out, M, N, K, bm, bn, stages, splits, per_split,
                           grid, smem, st);
  return dispatch<__nv_bfloat16>(x, map_w, sw, bias, out, M, N, K, bm, bn, stages, splits,
                                 per_split, grid, smem, st);
}
