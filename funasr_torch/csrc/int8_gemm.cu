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
//   v = v + add[m, n]          (optional, float32), or
//   v = v + mem[m, n]          (optional: the SANM layer's FSMN memory,
//                               computed here from v, see below)
//   out[m, n] = v              float32 or bf16 (round to nearest even)
//
// Two entries.  int8_gemm_forward takes A as int8 with its row scales.
// int8_gemm_rq_forward is the SANM layer's ctx -> wout contraction in one
// launch: it takes the float32 rows of ctx (a row stride) and
// row-quantizes them itself with the A producer of int8_wgmma.cuh
// (`quantize_rows`, shared with csrc/qmm.cu), which computes what
// csrc/rowquant.cu computes in form "mul", and it computes the layer's
// FSMN memory in its epilogue; its twin is ops/rowquant.py rowquant_ref,
// ops/fsmn.py fsmn_ref, then the GEMM's twin.  It folds a rowquant launch
// and an FSMN launch into the GEMM (the TPU kernel keeps those int8 rows
// and the memory in VMEM; separate launches write them to device memory
// for the GEMM to read back).
//
// The FSMN memory (csrc/fsmn.cu, ops/fsmn.py fsmn_ref): with m = b T + t,
// valid[t] = t < len[b] and vm = v * valid,
//
//   mem[t, n] = (vm[t] + sum_j tap[j, n] * vm[t + j - left]) * valid[t]
//
// the sum over j = 0 .. K-1 in order, vm zero outside the utterance.  Each
// consumer warpgroup copies its tile's v rows and their halo (64 + K - 1
// rows of the tile's columns) into shared memory with cp.async while the
// tile's product runs, and the epilogue computes the memory from there, so
// every v element is read about (64 + K - 1) / 64 times instead of K + 1
// and the memory never goes through device memory.
//
// The other int8 contractions of the layers keep the rowquant + int8_gemm
// pair: there the band's quantize, which runs before the unit's tiles on
// each SM and is not overlapped, measured slower than a rowquant launch
// (PERF.md section 6).
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
// The row-quantizing entry is qmm's design (csrc/qmm.cu) with this
// epilogue: a block owns a band of 128 rows, quantized by its two consumer
// warpgroups into shared memory (K padded to 128 with zeros), and a run of
// 128-wide N tiles whose weights stream by TMA through the ring; its plan
// is ops/int8_gemm.py `rq_plan` (the band, the ring and the staged v must
// fit in shared memory: K at most 640).
//
// Bound on the H100 SXM: bytes.  The served layer GEMMs write a float32
// (M, N) output, which outweighs the int8 operands: (16384, 512) x (1536,
// 512) moves 109 MB (33 us at 3.35 TB/s) against 25.8 GOP (13 us at 1,979
// TOP/s).  So the epilogue's write path sets the time as much as the
// mainloop, and the design keeps the stores in flight while the next
// tile's operands load.  The row-quantizing entry reads the float rows once
// instead of an int8 copy written and read back, and v once (plus its
// halo) instead of the memory: at the SANM wout, (16384, 512) float32 x
// (512, 512), it moves 118 MB (35 us).

#include <cuda_bf16.h>

#include "int8_wgmma.cuh"

namespace {

using i8w::BK;
constexpr int BM = 128;
constexpr int NC = 2;                // consumer warpgroups, 64 rows each
constexpr int NT = 128 * (NC + 1);   // + the producer warpgroup
constexpr int MAX_TAPS = 17;         // FSMN taps: the halo rows staged beside a tile
// The SANM layer's FSMN memory, computed in the row-quantizing entry's
// epilogue
struct Fsmn {
  const float* v;       // v[m, n] at v + m * v_ld + n: the v third of the QKV output
  long long v_ld;
  const int* lengths;   // (M / T,) valid frames of each utterance
  const float* taps;    // (K, N) float32
  int T, K, left;
};

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

// The twin's float32 steps, in its order, for one element (FSMN: add is
// the FSMN memory)
template <bool FSMN = false>
__device__ __forceinline__ float finish(const Epilogue& e, int acc, float sa, float sb,
                                        float res, float bias, float add) {
  float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), sa), sb);
  if (e.res) v = __fadd_rn(res, v);
  if (e.round_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
  if (e.bias) v = __fadd_rn(v, bias);
  if (e.relu) v = fmaxf(v, 0.f);
  if (FSMN || e.add) v = __fadd_rn(v, add);
  return v;
}

// Bring this warpgroup's v rows and their halo, global rows m0 - left ..
// m0 + 63 + K - 1 - left of the tile's BN columns, into vst (row stride
// BN; zeros past M or N), with cp.async: the copies run while the tile's
// product does, and fsmn_wait completes them before the epilogue.
template <int BN>
__device__ __forceinline__ void fsmn_stage(const Fsmn& f, float* vst, int m0, int n0, int M,
                                           int N) {
  constexpr int CH = BN / 4;  // 16-byte chunks a row
  const int rows = 64 + f.K - 1;
  for (int i = threadIdx.x & 127; i < rows * CH; i += 128) {
    const int rr = i / CH, c = 4 * (i % CH), m = m0 - f.left + rr, n = n0 + c;
    const bool in = m >= 0 && m < M && n < N;
    const float* src = in ? f.v + (int64_t)m * f.v_ld + n : f.v;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(i8w::smem_u32(vst + rr * BN + c)),
                 "l"(src), "r"(in ? 16 : 0)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void fsmn_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The FSMN memory at this lane's 4 rows (warpgroup-local rows ml[i], frames
// t[i], lengths L[i]) and 4 columns (tile column c, global n) from the
// staged v tile: the multiplies and adds of csrc/fsmn.cu in its order,
// taps outer so each tap's 4 columns load once for the 4 rows.
__device__ __forceinline__ void fsmn_mem(const Fsmn& f, const float* vst, int ld,
                                         const int (&ml)[4], const int (&t)[4],
                                         const int (&L)[4], int c, int n, int N, bool vec,
                                         float4 (&mem)[4]) {
  float a[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float valid = t[i] < L[i] ? 1.f : 0.f;
    const float4 v = *reinterpret_cast<const float4*>(vst + (ml[i] + f.left) * ld + c);
    a[i][0] = __fmul_rn(v.x, valid), a[i][1] = __fmul_rn(v.y, valid);
    a[i][2] = __fmul_rn(v.z, valid), a[i][3] = __fmul_rn(v.w, valid);
  }
  for (int j = 0; j < f.K; ++j) {
    const float4 tp4 = i8w::load4(f.taps, (int64_t)j * N + n, n, N, vec);
    const float tp[4] = {tp4.x, tp4.y, tp4.z, tp4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = t[i] + j - f.left;
      const bool inside = s >= 0 && s < f.T;
      const float keep = s < L[i] ? 1.f : 0.f;
      const float4 v4 = *reinterpret_cast<const float4*>(vst + (ml[i] + j) * ld + c);
      const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float vm = inside ? __fmul_rn(v[e], keep) : 0.f;
        a[i][e] = __fadd_rn(a[i][e], __fmul_rn(tp[e], vm));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float valid = t[i] < L[i] ? 1.f : 0.f;
    mem[i] = make_float4(__fmul_rn(a[i][0], valid), __fmul_rn(a[i][1], valid),
                         __fmul_rn(a[i][2], valid), __fmul_rn(a[i][3], valid));
  }
}

// This warp's 16 rows (from m0) x BN columns of the tile at n0, from the
// accumulator registers through the warp's staging buffer (drain_tile):
// each lane finishes 4 consecutive columns of 4 rows per 32-column chunk,
// with the tile's column scales and bias from shared memory (s_sb, s_bias)
// and 16-byte loads of res and add, all issued before the chunk's stores.
// With FSMN (the row-quantizing entry) the row scales come from the band's
// shared scales (s_scale, row m at m - band_m0) and the memory computed
// from the warpgroup's staged v tile (vst, whose row 0 is global row mg -
// left) takes the place of add.
template <int BN, bool FSMN = false>
__device__ __forceinline__ void store_tile(const Epilogue& e, const int (&acc)[BN / 2],
                                           const float* s_sb, const float* s_bias, int* stage,
                                           int m0, int n0, int M, int N,
                                           const Fsmn* f = nullptr, const float* vst = nullptr,
                                           int mg = 0, const float* s_scale = nullptr,
                                           int band_m0 = 0) {
  const int lane = threadIdx.x & 31, row = lane >> 3, col = 4 * (lane & 7);
  const bool vec = e.vec;
  float sa[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * i + row;
    if constexpr (FSMN)
      sa[i] = s_scale[m - band_m0];
    else
      sa[i] = m < M ? __ldg(e.sa + m) : 0.f;
  }
  int ml[4], ft[4], fl[4];  // FSMN: each row's warpgroup row, frame, length
  if constexpr (FSMN) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + 4 * i + row, b = m / f->T;
      ml[i] = m - mg, ft[i] = m - b * f->T;
      fl[i] = m < M ? __ldg(f->lengths + b) : 0;
    }
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
      if constexpr (!FSMN)
        ad[i] = e.add && in ? i8w::load4(e.add, (int64_t)m * e.add_ld + n, n, N, vec) : zero;
    }
    if constexpr (FSMN) fsmn_mem(*f, vst, BN, ml, ft, fl, c, n, N, vec, ad);
    const float4 sb = *reinterpret_cast<const float4*>(s_sb + c);
    const float4 b = e.bias ? *reinterpret_cast<const float4*>(s_bias + c) : zero;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + 4 * i + row;
      if (m >= M || n >= N) continue;
      const float v[4] = {finish<FSMN>(e, q[i].x, sa[i], sb.x, r[i].x, b.x, ad[i].x),
                          finish<FSMN>(e, q[i].y, sa[i], sb.y, r[i].y, b.y, ad[i].y),
                          finish<FSMN>(e, q[i].z, sa[i], sb.z, r[i].z, b.z, ad[i].z),
                          finish<FSMN>(e, q[i].w, sa[i], sb.w, r[i].w, b.w, ad[i].w)};
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

// The row-quantizing entry: qmm_kernel's band and schedule (csrc/qmm.cu)
// with this file's epilogue and the FSMN memory.  A unit is a band of RQ_BM
// float32 rows and the N tiles t0 .. t1 - 1; the consumers quantize the
// band, then run each tile's product and epilogue.
constexpr int RQ_BM = 128, RQ_BN = 128;
constexpr int VST_ROWS = 64 + MAX_TAPS - 1;  // a warpgroup's staged v rows, with the halo

__global__ void __launch_bounds__(NT, 1)
int8_gemm_rq_kernel(const __grid_constant__ CUtensorMap map_b, const float* __restrict__ x,
                    long long ldx, int M, int N, int K, int stages, int splits, int per_split,
                    Epilogue e, Fsmn f) {
  const int nk = (K + BK - 1) / BK, Kp = nk * BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* band = i8w::align_smem(smem_raw);       // nk k-blocks of RQ_BM x 128 bytes
  uint8_t* sB = band + (size_t)Kp * RQ_BM;         // stages x RQ_BN x 128 bytes
  uint64_t* full = reinterpret_cast<uint64_t*>(sB + (size_t)stages * RQ_BN * BK);
  uint64_t* empty = full + stages;
  float* scale = reinterpret_cast<float*>(empty + stages);  // RQ_BM row scales
  float* cols = scale + RQ_BM;  // NC x (sb, bias) x RQ_BN
  int* stages_out = reinterpret_cast<int*>(cols + NC * 2 * RQ_BN);  // a buffer per consumer warp
  // each consumer warpgroup's VST_ROWS x RQ_BN tile of v
  float* vsts = reinterpret_cast<float*>(stages_out + 4 * NC * (i8w::STAGE_WARP_BYTES / 4));

  const int n_tiles = (N + RQ_BN - 1) / RQ_BN;
  const int units = (M + RQ_BM - 1) / RQ_BM * splits;
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
    i8w::reg_dealloc<40>();
    if (threadIdx.x != NC * 128) return;
    i8w::tma_prefetch(&map_b);
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int t0 = u % splits * per_split, nt = min(t0 + per_split, n_tiles) - t0;
      for (int i = 0; i < nt; ++i)
        for (int kb = 0, t = t0 + (i + u) % nt; kb < nk; ++kb) {
          const int s = ring.stage;
          i8w::mbar_wait(&empty[s], ring.phase ^ 1);
          i8w::mbar_expect_tx(&full[s], RQ_BN * BK);
          i8w::tma_load_2d(sB + (size_t)s * RQ_BN * BK, &map_b, &full[s], kb * BK, t * RQ_BN);
          ring.advance();
        }
    }
  } else {  // ---- consumers: quantize 64 rows, then every N tile of the unit
    i8w::reg_alloc<232>();
    const int r0 = wg * 64;
    float* s_sb = cols + wg * 2 * RQ_BN;
    float* s_bias = s_sb + RQ_BN;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int* stage = stages_out + warp * (i8w::STAGE_WARP_BYTES / 4);
    float* vst = vsts + (size_t)wg * VST_ROWS * RQ_BN;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int m0 = u / splits * RQ_BM;
      const int t0 = u % splits * per_split, nt = min(t0 + per_split, n_tiles) - t0;
      {  // the unit's v rows and halo into L2, while the band quantizes
        const int t = threadIdx.x & 127, m = m0 + r0 - f.left + t;
        const uint32_t bytes = (uint32_t)(N * 4) & ~15u;
        if (e.vec && t < 64 + f.K - 1 && m >= 0 && m < M)
          i8w::prefetch_l2(f.v + (int64_t)m * f.v_ld, bytes);
      }
      // the last unit's wgmma and epilogue are done with the band and scales
      i8w::named_barrier(1 + wg, 128);
      i8w::quantize_rows<float, RQ_BM>(x, ldx, band, scale, m0, r0, M, K, Kp);
      i8w::fence_proxy_async();
      // each unit starts at its own N tile, so the SMs' epilogues do not all
      // write the same columns at once
      for (int i = 0; i < nt; ++i) {
        const int t = t0 + (i + u) % nt, n0 = t * RQ_BN;
        // the band is written; the last tile's epilogue is done with the columns
        i8w::named_barrier(1 + wg, 128);
        i8w::stage_cols<RQ_BN>(s_sb, e.sb, n0, N);
        if (e.bias) i8w::stage_cols<RQ_BN>(s_bias, e.bias, n0, N);
        prefetch_rows<RQ_BN>(e, m0 + r0, n0, M, N);
        fsmn_stage<RQ_BN>(f, vst, m0 + r0, n0, M, N);
        // declared per tile: dead while the band quantizes and the FSMN runs
        int acc[1][RQ_BN / 2];
#pragma unroll
        for (int i = 0; i < RQ_BN / 2; ++i) acc[0][i] = 0;
        i8w::mma_tile<RQ_BN, 1>(
            acc, nk, ring,
            [&](int, int kb) { return band + (size_t)kb * RQ_BM * BK + r0 * BK; }, sB);
        fsmn_wait();
        i8w::named_barrier(1 + wg, 128);  // the columns and v are staged
        store_tile<RQ_BN, true>(e, acc[0], s_sb, s_bias, stage, m0 + 16 * warp, n0, M, N, &f,
                                vst, m0 + r0, scale, m0);
      }
    }
  }
}

// the ring, its barriers, each consumer warpgroup's staged columns and
// each consumer warp's staging buffer
int smem_bytes(int bn, int stages) {
  return i8w::SMEM_ALIGN + stages * ((BM + bn) * BK + 16) + NC * 2 * bn * 4 +
         4 * NC * i8w::STAGE_WARP_BYTES;
}

// the band, the weight ring and its barriers, the row scales, each
// consumer warpgroup's staged columns, its warps' staging buffers and its
// tile of v with the halo
int rq_smem_bytes(int stages, int K) {
  const int Kp = (K + BK - 1) / BK * BK;
  return i8w::SMEM_ALIGN + RQ_BM * Kp + stages * (RQ_BN * BK + 16) + RQ_BM * 4 +
         NC * (2 * RQ_BN * 4 + 4 * i8w::STAGE_WARP_BYTES + VST_ROWS * RQ_BN * 4);
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

// 4-element accesses at n % 4 == 0 stay aligned when every row stride is
// a multiple of 4 and every base is aligned to 4 elements
bool aligned4(const void* p, long long ld, int bf16) {
  return !p || (ld % 4 == 0 && (uintptr_t)p % (bf16 ? 8 : 16) == 0);
}

}  // namespace

// The GEMM's launch.  Pointers may be null where the step is optional
// (bias, res, add).  The plan (bn, stages, grid, smem) is
// ops/int8_gemm.py `gemm_plan`'s.  Returns cudaGetLastError() (0 on
// success); cudaErrorInvalidValue (1) when K is not a multiple of 16, the
// plan is not one this kernel runs (bn 128 or 256, 2-8 stages, shared
// bytes as smem_bytes within the limit, a grid of at most one block per
// SM) or a tensor map cannot be encoded.
static int gemm_forward(const void* A, const void* B, int M, int N, int K, const float* sa,
                        const float* sb, const float* bias, const void* res, long long res_ld,
                        int res_bf16, const float* add, long long add_ld, int relu,
                        int round_bf16, void* out, long long out_ld, int out_bf16, int bn,
                        int stages, int grid, int smem, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (K <= 0 || K % 16) return (int)cudaErrorInvalidValue;
  if ((bn != 128 && bn != 256) || stages < 2 || stages > 8 || grid < 1 ||
      grid > i8w::sm_count() || smem != smem_bytes(bn, stages) || smem > i8w::MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const int vec = aligned4(out, out_ld, out_bf16) && aligned4(res, res_ld, res_bf16) &&
                  aligned4(add, add_ld, 0);
  Epilogue e{sa, sb, bias, res, res_ld, res_bf16, add, add_ld, relu, round_bf16,
             out, out_ld, out_bf16, vec};
  cudaStream_t st = (cudaStream_t)stream;
  return bn == 256 ? launch<256>(A, B, M, N, K, stages, grid, smem, e, st)
                   : launch<128>(A, B, M, N, K, stages, grid, smem, e, st);
}

// Plain C entry point, called through ctypes with gemm_forward's 23
// arguments packed as int64 in its order (ops/int8_gemm.py `_PACK`, null
// pointers as 0): ctypes then converts one argument instead of 23.  At
// the decoder's small GEMMs the wrapper's host time, not the kernel, sets
// the pace of calls made back to back.
extern "C" int int8_gemm_forward(const long long* p) {
  auto ptr = [p](int i) { return reinterpret_cast<void*>(static_cast<uintptr_t>(p[i])); };
  return gemm_forward(ptr(0), ptr(1), (int)p[2], (int)p[3], (int)p[4],
                      static_cast<const float*>(ptr(5)), static_cast<const float*>(ptr(6)),
                      static_cast<const float*>(ptr(7)), ptr(8), p[9], (int)p[10],
                      static_cast<const float*>(ptr(11)), p[12], (int)p[13], (int)p[14],
                      ptr(15), p[16], (int)p[17], (int)p[18], (int)p[19], (int)p[20],
                      (int)p[21], ptr(22));
}

// The row-quantizing entry, called through ctypes: the SANM layer's
// ctx -> wout with its FSMN memory.  x: (M, K) float32, row stride ldx
// elements, 16-byte aligned rows; B: (N, K) int8 contiguous; sb, bias,
// res and out as int8_gemm_forward's (no sa: the kernel's own row scales;
// out float32); fsmn_v: the memory's v (row stride v_ld), with its (M / T,)
// int32 lengths and (taps_k, N) float32 taps.  The plan (stages, splits,
// per_split, grid, smem) is ops/int8_gemm.py `rq_plan`'s.  Returns
// cudaGetLastError() (0 on success); cudaErrorInvalidValue (1) when K is
// not a multiple of 16, the plan is not one this kernel runs (shared bytes
// as rq_smem_bytes), the FSMN takes more than 17 taps, v is not 16-byte
// aligned in whole rows, or the weights' tensor map cannot be encoded.
extern "C" int int8_gemm_rq_forward(const float* x, long long ldx, const void* B, int M, int N,
                                    int K, const float* sb, const float* bias, const void* res,
                                    long long res_ld, int res_bf16, const float* fsmn_v,
                                    long long v_ld, const int* lengths, const float* taps,
                                    int T, int taps_k, int left, float* out, long long out_ld,
                                    int stages, int splits, int per_split, int grid, int smem,
                                    void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  const int n_tiles = (N + RQ_BN - 1) / RQ_BN;
  if (K <= 0 || K % 16 || stages < 2 || stages > 8 || splits < 1 || per_split < 1 ||
      (long long)splits * per_split < n_tiles || grid < 1 || grid > i8w::sm_count() ||
      smem != rq_smem_bytes(stages, K) || smem > i8w::MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  if (!fsmn_v || !lengths || !taps || T < 1 || taps_k < 1 || taps_k > MAX_TAPS || left < 0 ||
      left >= taps_k || N % 4 || v_ld % 4 || (uintptr_t)fsmn_v % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_b;
  if (!i8w::kmajor_map(&map_b, B, N, K, RQ_BN)) return (int)cudaErrorInvalidValue;
  static int allowed = 0;
  const cudaError_t err = i8w::allow_smem(int8_gemm_rq_kernel, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  const int vec = aligned4(out, out_ld, 0) && aligned4(res, res_ld, res_bf16) &&
                  aligned4(taps, N, 0);
  const Epilogue e{nullptr, sb, bias, res, res_ld, res_bf16, nullptr, 0, 0, 0,
                   out,     out_ld, 0,    vec};
  const Fsmn f{fsmn_v, v_ld, lengths, taps, T, taps_k, left};
  int8_gemm_rq_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(map_b, x, ldx, M, N, K, stages,
                                                                 splits, per_split, e, f);
  return (int)cudaGetLastError();
}
