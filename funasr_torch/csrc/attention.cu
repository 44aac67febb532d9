// Masked-softmax attention for Hopper (sm_90a): three kernels, one source.
//
// 1. `attention_forward`, bf16 or float32 q, k, v.  Replaces the TPU kernel
//    funasr_tpu/ops/attention_pallas.py `_attn_kernel` (:37, pallas_call at
//    :84).  Per (batch b, head h):
//
//      s   = q_h k_h^T + key_bias[b]     float32 (q pre-scaled by d^-0.5)
//      p   = softmax(s) in float32, normalised, THEN cast to v's dtype
//      out = p v_h                       float32 accumulation, cast to q's dtype
//
//    q (B, U, H*d), k/v (B, T, H*d) in their natural layout (a row stride per
//    tensor, so k and v may be column slices of one fused projection),
//    key_bias (B, T) float32, 0 for valid keys and -1e30 for padding.  A row
//    whose keys are all masked gets uniform weights, as the TPU kernel does.
//    The head size d is a template parameter, instantiated at 128 (the
//    Paraformer-large family), 64 (the 256-wide models with 4 heads: the
//    aishell SANM and Conformer encoders, the SAN decoder) and 32
//    (CT-Transformer punctuation: D = 256, H = 8); the TPU kernel takes any
//    d, and the JAX package sends d = 32 and 64 to XLA only for its TPU
//    alignment gate.
//
//    Bound on the H100 SXM, encoder self-attention (B=64, T=256, H=4, d=128,
//    bf16, keys 250/200): q, out and the valid rows of k, v are 63 MB ->
//    19 us at 3.35 TB/s, above the 7.4 GFLOP of the two products (7.5 us at
//    989 TFLOP/s): bytes.  Decoder cross-attention (U=128): 14 us.
//
//    bf16 design: both products on the tensor cores, mma.sync m16n8k16 bf16
//    with float32 accumulation.  A block of 4 warps owns 64 queries, 16 per
//    warp; the warp's q rows stay in registers as ldmatrix fragments.  K and
//    V arrive in 64-key tiles (rows padded to 272 bytes, so ldmatrix is free
//    of bank conflicts) through a two-stage cp.async ring.  To apply the
//    normalised, rounded p of the contract exactly, the keys are visited
//    twice: pass 1 keeps the row max m and the rescaled row sum l (online
//    softmax, float32); pass 2 recomputes S = q k^T on the tensor cores, forms
//    p = exp(s - m) / l in registers, rounds it to bf16 and multiplies it by
//    V (ldmatrix.trans) without a trip through shared memory: the m16n8k16
//    accumulator layout is the A-operand layout.  O is rounded to bf16 once
//    and leaves through shared memory in 16-byte rows.  At d = 32 the same
//    loops run 2 k-steps of m16n8k16 for S (8 at d = 128) and 4 n-tiles of
//    O, the tile rows are 80 bytes (still free of ldmatrix bank conflicts)
//    and a 64-key stage of K and V is 10 KB; d = 64 runs 4 k-steps and 8
//    n-tiles over rows of 144 bytes.
//
//    float32 design (`attention_kernel_f32`): both products on the tensor
//    cores with float32 accuracy, mma.sync m16n8k8 tf32 on split operands: x =
//    hi + lo with hi = tf32(x), lo = tf32(x - hi) (rounded as cvt.rna.tf32.f32
//    does, by two integer operations), and a b = hi hi + hi lo + lo hi
//    accumulated in float32 (lo lo, under 2^-22 of the product, is dropped);
//    one tf32 product alone keeps about 3 digits and misses the 1e-4 float32
//    bar.  An mma rounds its sum toward zero, so a long chain of them into one
//    accumulator drifts with the number of keys: each tile's p v goes to a
//    fresh accumulator, folded into O by a float32 FMA.  Each value is split
//    where a warp loads it into fragments: q once, into registers at d <= 64
//    (64 registers a thread at d = 64 for hi and lo); at d = 128 q stays in
//    shared memory and is split as each tile reloads it, so nothing spills.  A
//    block of 4 warps owns 64 queries, 16 per warp; K and V arrive in 64-key
//    tiles (32 at d = 128, where a block's 105 KB still lets two blocks share
//    an SM) through a two-stage cp.async ring, 16-byte rows (k and v column
//    slices must be 16-byte aligned).  One pass over the keys: the online
//    softmax keeps the row max m and the rescaled sum l in float32, rescales O
//    when m grows and divides by l once at the end (the float32 contract
//    rounds p to no narrower type).  p never leaves registers: within each
//    8-key step the keys are relabelled so that S's accumulator layout is p's
//    A-operand layout, and V's rows are read in that order; the row strides
//    keep every float4 fragment load free of bank conflicts.  Trailing keys
//    whose bias is -1e30 or below add exact zeros and are skipped (a block
//    scans its bias row first); a row with no other key gets uniform weights
//    over all Tk.  Warps whose 16 rows are all past U only stage tiles.
//    Bound: 3 tf32 products for each of the two, 6 x 2 U T d operations at 495
//    TFLOP/s, 2.5x under the 2 x 2 U T d at 67 TFLOP/s of one float32 product
//    on the CUDA cores; mma.sync reaches part of that peak, and the split's 5
//    operations a value, once per warp, share the issue slots with it.
//
//    `attention_forward_alibi` is the float32 body at d = 64 with
//    emotion2vec's symmetric ALiBi (funasr_tpu/models/emotion2vec/model.py:136
//    `AltAttention`, an XLA attention there, not a TPU kernel):
//
//      s = q_h k_h^T + key_bias[b] + (u >= extra && j >= extra ? -slope[h] |u - j| : 0)
//
//    slope (H,) float32 is the head's ALiBi slope times max(scale, 0), made
//    on the device by the caller; the first `extra` rows and columns (the
//    extra tokens) get no term.  The term is computed in the block from
//    (h, u, j), so no (B, H, T, T) bias reaches device memory; with all
//    slopes 0 it adds -0.0 and gives the plain kernel's bits.  Bound at
//    emotion2vec base (B = 8, T = 759, H = 12, d = 64, ragged keys): q, k, v
//    and out, 75 MB -> 22 us at 3.35 TB/s, below the 8.6 GFLOP of the two
//    products over the valid keys (0.128 ms at 67 TFLOP/s float32; 0.052 ms
//    for the split's 25.8 GFLOP of tf32 at 495 TFLOP/s): operations.
//
// 2. `attention_forward_f32ctx`: the attention inside the int8 layers
//    (sanm_layer_pallas.py:118-129, decoder_layer_pallas.py:101-115).  q, k,
//    v arrive in float32 (column slices of an int8 projection's output) and
//    are rounded to bf16 as they are loaded: q after the d^-0.5 scale (in
//    float32), v after zeroing its rows past vlen[b] (the masked v of the SANM
//    layer; no vlen for the decoder's memory).  p is normalised, rounded to
//    bf16, and the context is written in float32 (the layer row-quantizes it
//    without a bf16 round first).
//
//    Its sums do not depend on their order, so the plain twin gets the same
//    bits: every score q.k, the softmax sum and every p.v are summed in float64
//    (a product of two bf16 values is exact, so those sums are exact in
//    practice) and rounded once to float32; exp is taken in float64 and
//    rounded once; the rest are IEEE float32 operations in the twin's order.
//    The int8 layers need this: one ulp of the context can move an int8
//    rounding tie in the next row-quantize, and such a tie spreads through
//    every later layer.
//
//    Bound at the SANM shape (B=64, T=256, H=4, d=128, lengths 250/200): the
//    valid rows of q, k, v and out in float32, 118 MB -> 35 us; the sums, 6.7
//    GFLOP of products, need 0.10 ms on the float64 tensor cores (67 TFLOP/s)
//    if they must be float64, which the bit-equal contract asks.  Design: the
//    score and p.v sums run on mma.sync m16n8k8 .f64 (float64 tensor cores,
//    twice the CUDA cores' float64 rate).  A block of 4 warps owns 64 query
//    rows, 16 a warp.  Every q, k and v value is rounded and widened to
//    float64 once: q into the warp's A fragments in registers (64 doubles a
//    thread), k and v into 16-key float64 tiles in shared memory (rows of 132
//    doubles: conflict-free fragment loads).  Two tile buffers make a
//    pipeline with one barrier a tile: tile kt + 1 is staged from registers
//    (fetched a tile ahead) while tile kt is multiplied.  No conversion is
//    left in an inner loop but p's (f32 -> f64, once per element).  The
//    block's scores stay in shared memory (64 x T float32, 66 KB at T=256:
//    two blocks an SM, at up to 240 registers a thread) up to
//    EXACT_ONCHIP_MAX_T keys; past it they go to a float32 (B, H, U, ld)
//    scratch in device memory that the wrapper allocates (ops/attention.py
//    `exact_attention_plan` holds the rule).  The key bias row is staged in
//    shared memory.  Passes: (1) scores (two half sums over d a key: four
//    independent mma chains a warp), bias, row max; (2) a warp per eight
//    rows at a time: e = exp(s - m) in float64 in place and l = sum e in
//    float64, then p = bf16(e / l) in place; the eight values are loaded
//    before any is stored, since the compiler cannot tell the rows apart and
//    a store between would serialize the exp chains; (3) out += p v on the
//    float64 tensor cores, stopping at vlen (the keys past it meet zero rows
//    of v: exact zeros).  The head size is a template parameter, instantiated
//    at 128 and 64: the tile rows (HD + 4 doubles, conflict-free at both),
//    the region that holds q, the k tiles or the int8 tiles (33.8 KB at
//    128, 17.4 KB at 64) and the staging loops follow from it; the on-chip
//    key limit stays EXACT_ONCHIP_MAX_T at both.
//
// 3. `attention_forward_i8qk`: the SANM layer's attention with int8 scores,
//    the `int8_attn` branch of sanm_layer_pallas.py `_sanm_layer_kernel`
//    (:112-117; FUNASR_TPU_INT8_ATTN=1 in the JAX package, `int8_attn=True`
//    in the port).  Per head, in the prologue and per 64-key tile, as the TPU
//    body quantizes in VMEM:
//
//      q8, qs = rowquant(q * d^-0.5)      k8, ks = rowquant(k)   (k unmasked)
//      s      = (float(q8 k8^T) * qs) * ks^T + key_bias
//
//    (quant.py `rowquant_kernel`, the "mul" form), the q.k sum exact in int32
//    on mma.sync m16n8k32 .s8 with q8 in registers; k's 64-key tiles are
//    quantized into two int8 buffers (the sixteen rows' absmax reductions of
//    a warp interleaved), one barrier a tile; then passes 2 and 3 of the
//    float32-context kernel (float64 exp, sum and p.v on the float64 tensor
//    cores, bf16 p, v rounded to bf16 and zero past vlen[b]).  The plain twin
//    (ops/attention.py `attention_i8qk_ref`) gets the same bits.  Bound at
//    the SANM shape: the same 118 MB of float32 rows -> 35 us, above 3.4 GOP
//    of int8 and 3.4 GFLOP of products that the float64 p.v makes 0.05 ms on
//    the float64 tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int SMEM_MAX = 232448;  // an H100 block's shared memory

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0 bytes read: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// ======================================================================
// 1a. bf16 attention on the tensor cores
// ======================================================================

// Instantiated at head sizes D = 128, 64 and 32 (`attention_forward` picks one).
constexpr int MB_NT = 128;          // 4 warps, 16 queries each
constexpr int MB_BQ = 64;           // queries per block
constexpr int MB_BK = 64;           // keys per tile
template <int D>  // bf16 per shared row (272 bytes at d = 128, 144 at 64, 80 at 32)
__host__ __device__ constexpr int mb_ld() { return D + 8; }
template <int D>  // bf16 per tile
__host__ __device__ constexpr int mb_tile() { return MB_BK * mb_ld<D>(); }
template <int D>  // 2 stages x (K, V)
__host__ __device__ constexpr size_t mb_smem() { return 4 * mb_tile<D>() * sizeof(__nv_bfloat16); }
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [r0, r0 + 64) of a (rows, D) bf16 head slice with row stride `rs`
// into a shared tile; rows past `nrows` are zero-filled
template <int D>
__device__ __forceinline__ void mb_load(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                        int64_t rs, int r0, int nrows) {
  constexpr int CPR = D / 8;  // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < (MB_BK * CPR) / MB_NT; ++i) {
    const int c = threadIdx.x + i * MB_NT;
    const int r = c / CPR, col = (c % CPR) * 8;
    const bool ok = r0 + r < nrows;
    cp_async16(dst + r * mb_ld<D>() + col, ok ? src + (int64_t)(r0 + r) * rs + col : src, ok);
  }
}

// S (16 rows x 64 keys) = the warp's q fragments times a K tile, plus the
// key bias (-inf past Tk): s[j] is the accumulator of keys 8j .. 8j + 7
template <int D>
__device__ __forceinline__ void mb_scores(const uint32_t qa[D / 16][4], const __nv_bfloat16* sK,
                                          const float* bb, int k0, int Tk, float s[8][4]) {
  constexpr int LD = mb_ld<D>();
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t kb[4];  // keys 16 jj .. 16 jj + 15, d 16 ks .. 16 ks + 15
      ldmatrix_x4(kb, sK + (16 * jj + (mi >> 1) * 8 + r) * LD + 16 * ks + (mi & 1) * 8);
      mma_bf16(s[2 * jj], qa[ks], kb[0], kb[1]);
      mma_bf16(s[2 * jj + 1], qa[ks], kb[2], kb[3]);
    }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = k0 + 8 * j + 2 * t + e;
      const float bv = key < Tk ? bb[key] : -INFINITY;
      s[j][e] += bv;
      s[j][2 + e] += bv;
    }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(MB_NT, 2)
attention_kernel_bf16_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                          __nv_bfloat16* __restrict__ out, int U, int Tk, int64_t q_bs,
                          int64_t q_rs, int64_t k_bs, int64_t k_rs, int64_t v_bs, int64_t v_rs,
                          int64_t o_bs, int64_t o_rs) {
  constexpr int MB_LD = mb_ld<D>(), MB_TILE = mb_tile<D>();
  extern __shared__ __align__(16) __nv_bfloat16 sbuf[];  // stage s: K at 2 s TILE, V after it
  const int u0 = blockIdx.x * MB_BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* qh = q + b * q_bs + (int64_t)h * D;
  const __nv_bfloat16* kh = k + b * k_bs + (int64_t)h * D;
  const __nv_bfloat16* vh = v + b * v_bs + (int64_t)h * D;
  const float* bb = bias + (int64_t)b * Tk;
  const int nt = (Tk + MB_BK - 1) / MB_BK;

  // the q tile through stage 1's K slot, the first K tile into stage 0
  mb_load<D>(sbuf + 2 * MB_TILE, qh, q_rs, u0, U);
  cp_async_commit();
  mb_load<D>(sbuf, kh, k_rs, 0, Tk);
  cp_async_commit();
  cp_async_wait1();
  __syncthreads();
  uint32_t qa[D / 16][4];  // A fragments of the warp's 16 rows
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    ldmatrix_x4(qa[ks], sbuf + 2 * MB_TILE + (warp * 16 + (lane & 15)) * MB_LD + 16 * ks +
                            (lane >> 4) * 8);
  __syncthreads();

  // steps 0 .. nt-1: pass 1 over K tiles; steps nt .. 2 nt - 1: pass 2 over
  // (K, V) tiles.  Each step prefetches the next one into the other stage.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv_l[2];
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[j][c] = 0.f;
  for (int s = 0; s < 2 * nt; ++s) {
    if (s + 1 < 2 * nt) {
      __nv_bfloat16* nxt = sbuf + ((s + 1) & 1) * 2 * MB_TILE;
      const int tl = s + 1 < nt ? s + 1 : s + 1 - nt;
      mb_load<D>(nxt, kh, k_rs, tl * MB_BK, Tk);
      if (s + 1 >= nt) mb_load<D>(nxt + MB_TILE, vh, v_rs, tl * MB_BK, Tk);
    }
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const __nv_bfloat16* sK = sbuf + (s & 1) * 2 * MB_TILE;
    const int k0 = (s < nt ? s : s - nt) * MB_BK;
    float sc[8][4];
    mb_scores<D>(qa, sK, bb, k0, Tk, sc);
    if (s < nt) {  // ---- pass 1: online row max and sum
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(sc[j][2 * hf], sc[j][2 * hf + 1]));
        const float m_new = fmaxf(m[hf], quad_max(mx));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          sum += exp2f((sc[j][2 * hf] - m_new) * LOG2E) +
                 exp2f((sc[j][2 * hf + 1] - m_new) * LOG2E);
        l[hf] = l[hf] * exp2f((m[hf] - m_new) * LOG2E) + sum;
        m[hf] = m_new;
      }
      if (s == nt - 1) {
        inv_l[0] = 1.f / quad_sum(l[0]);
        inv_l[1] = 1.f / quad_sum(l[1]);
      }
    } else {  // ---- pass 2: p = bf16(exp(s - m) / l), O += p V
      const __nv_bfloat16* sV = sK + MB_TILE;
      const int mi = lane >> 3, r = lane & 7;
#pragma unroll
      for (int kk = 0; kk < MB_BK / 16; ++kk) {
        float p[2][4];
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            p[x][c] = exp2f((sc[2 * kk + x][c] - m[c >> 1]) * LOG2E) * inv_l[c >> 1];
        const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                                pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
#pragma unroll
        for (int dd = 0; dd < D / 16; ++dd) {
          uint32_t vb[4];  // keys 16 kk .. +15, d 16 dd .. +15, transposed
          ldmatrix_x4_trans(vb,
                            sV + (16 * kk + (mi & 1) * 8 + r) * MB_LD + 16 * dd + (mi >> 1) * 8);
          mma_bf16(o[2 * dd], pa, vb[0], vb[1]);
          mma_bf16(o[2 * dd + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // the next step's copies overwrite this stage
  }

  // O rounded to bf16 once, staged per warp, written as 16-byte rows
  __nv_bfloat16* sO = sbuf + warp * 16 * MB_LD;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(sO + g * MB_LD + 8 * j + 2 * t) = pack_bf16(o[j][0], o[j][1]);
    *reinterpret_cast<uint32_t*>(sO + (g + 8) * MB_LD + 8 * j + 2 * t) =
        pack_bf16(o[j][2], o[j][3]);
  }
  __syncwarp();
  __nv_bfloat16* oh = out + b * o_bs + (int64_t)h * D;
  constexpr int CPR = D / 8;  // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < 16 * CPR / 32; ++i) {
    const int c = lane + 32 * i, r = c / CPR, col = (c % CPR) * 8;
    const int u = u0 + warp * 16 + r;
    if (u < U)
      *reinterpret_cast<uint4*>(oh + (int64_t)u * o_rs + col) =
          *reinterpret_cast<const uint4*>(sO + r * MB_LD + col);
  }
}

// ======================================================================
// 1b. float32 attention on the tensor cores: split TF32, one pass
// ======================================================================

constexpr int FB_NT = 128;  // 4 warps, 16 queries each
constexpr int FB_BQ = 64;   // queries per block
// A key whose bias is at or below this is padding: past the last key above
// it, exp(s - m) underflows to an exact 0, so the loop stops there.
constexpr float DEAD_BIAS = -1e30f;

// The float32 body's shapes at head size D.  Row strides make the float4
// fragment loads free of bank conflicts: K rows (read at row sigma(g), column
// 4t) 4 words past a multiple of 32, V rows (row t, column 4g) 8 past, q
// rows (row g, column 4t) 16 past.
template <int D>
struct FB {
  static constexpr bool QREG = D <= 64;          // q's split fragments in registers
  static constexpr int BK = D == 128 ? 32 : 64;  // keys a tile
  static constexpr int LDK = D + 4, LDV = D + 8, LDQ = D + 16;
  static constexpr int KT = BK * LDK;            // floats: a K tile, then its V tile
  static constexpr int STAGE = KT + BK * LDV;
  static constexpr size_t SMEM = sizeof(float) * (2 * STAGE + (QREG ? 0 : FB_BQ * LDQ));
};

// rows [r0, r0 + R) of a (rows, D) float32 head slice with row stride `rs`
// into a shared tile of row stride LD; rows past `nrows` are zero-filled
template <int D, int R, int LD>
__device__ __forceinline__ void fb_load(float* dst, const float* src, int64_t rs, int r0,
                                        int nrows) {
  constexpr int CPR = D / 4;  // 16-byte chunks a row
  static_assert(R * CPR % FB_NT == 0, "whole passes of the block");
#pragma unroll
  for (int i = 0; i < R * CPR / FB_NT; ++i) {
    const int c = threadIdx.x + i * FB_NT;
    const int r = c / CPR, col = (c % CPR) * 4;
    const bool ok = r0 + r < nrows;
    cp_async16(dst + r * LD + col, ok ? src + (int64_t)(r0 + r) * rs + col : src, ok);
  }
}

// tf32(x) as cvt.rna.tf32.f32 rounds it (to nearest, ties away from zero; 10
// mantissa bits), by two integer operations: ptxas expands the cvt into a
// longer sequence on sm_90a.  The carry of the add may reach the exponent,
// as rounding up does.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo to within 2^-22 |x|: hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}
// D(16 x 8) += A(16 x 8) B(8 x 8), tf32 operands, float32 accumulator; the
// layout of mma_f64 below
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c += a b with float32 accuracy from split operands: the two small
// products, then hi hi (lo lo, under 2^-22 of the product, is dropped)
__device__ __forceinline__ void mma_split(float c[4], const uint32_t ah[4], const uint32_t al[4],
                                          const uint32_t bh[2], const uint32_t bl[2]) {
  mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, al, bh[0], bh[1]);
  mma_tf32(c, ah, bh[0], bh[1]);
}

// The symmetric ALiBi term of query u and key j (emotion2vec's AltAttention):
// -(slope * |u - j|), zero on the first `extra` rows and columns (the extra
// tokens).  u and j come as floats (exact below 2^24, so |u - j| is too);
// the product is rounded on its own, never contracted into the add.
__device__ __forceinline__ float alibi_term(float slope, float u, float j, bool extra_uj) {
  return extra_uj ? 0.f : -__fmul_rn(slope, fabsf(__fsub_rn(u, j)));
}

// ALIBI = false is the plain kernel (slopes and extra unused); ALIBI = true
// adds alibi_term(slopes[h], u, j, ...) to every score after the key bias.
//
// Keys are relabelled within each 8-key step so that S's accumulator is P's
// A operand: S's B column n is key (n >> 1) + 4 (n & 1), so a thread's
// accumulator columns 2t and 2t + 1 hold keys t and t + 4, which are A's
// columns t and t + 4 of p v, and V's B rows t and t + 4 are read as they
// lie.  The d columns are relabelled within each 16: k-steps 2c and 2c + 1
// take columns 16c + 4t + {0, 1} and {2, 3} as A's (and B's) t and t + 4,
// one float4 of q and of k a thread.  O's column n of tile 4m + i is d
// 32m + 4n + i, so V arrives as float4s and O leaves as them.
template <int D, bool ALIBI>
__global__ void __launch_bounds__(FB_NT, 2)
attention_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     const float* __restrict__ slopes, int extra, float* __restrict__ out, int U,
                     int Tk, int64_t q_bs, int64_t q_rs, int64_t k_bs, int64_t k_rs,
                     int64_t v_bs, int64_t v_rs, int64_t o_bs, int64_t o_rs) {
  using F = FB<D>;
  constexpr int BK = F::BK, NJ = BK / 8, NC = D / 16, NM = D / 32;
  extern __shared__ __align__(16) float fbuf[];  // stage s: K at s STAGE, V after it; q last
  __shared__ int s_last[FB_NT / 32];
  float* sQ = fbuf + 2 * F::STAGE;
  const int u0 = blockIdx.x * FB_BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16 + g;       // the thread's rows row0 and row0 + 8 of the block
  const int krow = (g >> 1) + 4 * (g & 1);  // the key of S's B column g
  const float* qh = q + b * q_bs + (int64_t)h * D;
  const float* kh = k + b * k_bs + (int64_t)h * D;
  const float* vh = v + b * v_bs + (int64_t)h * D;
  const float* bb = bias + (int64_t)b * Tk;

  // the first tile (and q at d = 128) in flight while the keys are scanned
  if constexpr (!F::QREG) fb_load<D, FB_BQ, F::LDQ>(sQ, qh, q_rs, u0, U);
  fb_load<D, BK, F::LDK>(fbuf, kh, k_rs, 0, Tk);
  fb_load<D, BK, F::LDV>(fbuf + F::KT, vh, v_rs, 0, Tk);
  cp_async_commit();
  int last = -1;  // the last key whose bias is above DEAD_BIAS
  for (int i = threadIdx.x; i < Tk; i += FB_NT)
    if (bb[i] > DEAD_BIAS) last = i;
  last = __reduce_max_sync(0xffffffffu, last);
  if (lane == 0) s_last[warp] = last;

  // q's split A fragments (d <= 64): rows row0 and row0 + 8, 4 columns a
  // 16-column block, split once
  uint32_t qah[F::QREG ? 2 * NC : 1][4], qal[F::QREG ? 2 * NC : 1][4];
  if constexpr (F::QREG) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float4 x[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int u = u0 + row0 + 8 * hf;
        x[hf] = u < U ? *reinterpret_cast<const float4*>(qh + (int64_t)u * q_rs + 16 * c + 4 * t)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      split_tf32(x[0].x, qah[2 * c][0], qal[2 * c][0]);
      split_tf32(x[1].x, qah[2 * c][1], qal[2 * c][1]);
      split_tf32(x[0].y, qah[2 * c][2], qal[2 * c][2]);
      split_tf32(x[1].y, qah[2 * c][3], qal[2 * c][3]);
      split_tf32(x[0].z, qah[2 * c + 1][0], qal[2 * c + 1][0]);
      split_tf32(x[1].z, qah[2 * c + 1][1], qal[2 * c + 1][1]);
      split_tf32(x[0].w, qah[2 * c + 1][2], qal[2 * c + 1][2]);
      split_tf32(x[1].w, qah[2 * c + 1][3], qal[2 * c + 1][3]);
    }
  }
  __syncthreads();
  last = max(max(s_last[0], s_last[1]), max(s_last[2], s_last[3]));
  const int kend = last < 0 ? Tk : last + 1;  // no key above it: every key (uniform weights)
  const int nt = (kend + BK - 1) / BK;
  const bool active = u0 + warp * 16 < U;  // a warp whose rows are all past U only stages
  const float slope = ALIBI ? slopes[h] : 0.f;
  const float uf[2] = {(float)(u0 + row0), (float)(u0 + row0 + 8)};
  const bool ux[2] = {u0 + row0 < extra, u0 + row0 + 8 < extra};

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[j][c] = 0.f;
  for (int kt = 0; kt < nt; ++kt) {
    if (kt + 1 < nt) {
      float* nxt = fbuf + ((kt + 1) & 1) * F::STAGE;
      fb_load<D, BK, F::LDK>(nxt, kh, k_rs, (kt + 1) * BK, Tk);
      fb_load<D, BK, F::LDV>(nxt + F::KT, vh, v_rs, (kt + 1) * BK, Tk);
    }
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    if (active) {
      const float* sK = fbuf + (kt & 1) * F::STAGE;
      const float* sV = sK + F::KT;
      const int k0 = kt * BK;
      float bv[NJ][2];  // the key biases, loaded ahead of the products
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + t + 4 * e;
          bv[j][e] = key < Tk ? bb[key] : -INFINITY;
        }

      // ---- S = q k^T, three tf32 products a step
      float s[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        uint32_t ah[2][4], al[2][4];
        if constexpr (F::QREG) {
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            ah[0][x] = qah[2 * c][x], al[0][x] = qal[2 * c][x];
            ah[1][x] = qah[2 * c + 1][x], al[1][x] = qal[2 * c + 1][x];
          }
        } else {
          const float4 x0 = *reinterpret_cast<const float4*>(sQ + row0 * F::LDQ + 16 * c + 4 * t);
          const float4 x1 =
              *reinterpret_cast<const float4*>(sQ + (row0 + 8) * F::LDQ + 16 * c + 4 * t);
          split_tf32(x0.x, ah[0][0], al[0][0]);
          split_tf32(x1.x, ah[0][1], al[0][1]);
          split_tf32(x0.y, ah[0][2], al[0][2]);
          split_tf32(x1.y, ah[0][3], al[0][3]);
          split_tf32(x0.z, ah[1][0], al[1][0]);
          split_tf32(x1.z, ah[1][1], al[1][1]);
          split_tf32(x0.w, ah[1][2], al[1][2]);
          split_tf32(x1.w, ah[1][3], al[1][3]);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float4 kv =
              *reinterpret_cast<const float4*>(sK + (8 * j + krow) * F::LDK + 16 * c + 4 * t);
          uint32_t bh[2][2], bl[2][2];
          split_tf32(kv.x, bh[0][0], bl[0][0]);
          split_tf32(kv.y, bh[0][1], bl[0][1]);
          split_tf32(kv.z, bh[1][0], bl[1][0]);
          split_tf32(kv.w, bh[1][1], bl[1][1]);
          mma_split(s[j], ah[0], al[0], bh[0], bl[0]);
          mma_split(s[j], ah[1], al[1], bh[1], bl[1]);
        }
      }

      // ---- key bias (-inf past Tk), ALiBi, then the online softmax
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[j][e] = __fadd_rn(s[j][e], bv[j][e]);
          s[j][2 + e] = __fadd_rn(s[j][2 + e], bv[j][e]);
          if constexpr (ALIBI) {
            const int key = k0 + 8 * j + t + 4 * e;
            const float jf = (float)key;
            s[j][e] = __fadd_rn(s[j][e], alibi_term(slope, uf[0], jf, ux[0] || key < extra));
            s[j][2 + e] =
                __fadd_rn(s[j][2 + e], alibi_term(slope, uf[1], jf, ux[1] || key < extra));
          }
        }
      float alpha2[2];  // the rows' rescale of O
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NJ; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hf], s[j][2 * hf + 1]));
        const float mn = fmaxf(m[hf], quad_max(mx));
        const float alpha = m[hf] == -INFINITY ? 0.f : exp2f((m[hf] - mn) * LOG2E);
        const float mref = mn == -INFINITY ? 0.f : mn;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f((s[j][2 * hf + e] - mref) * LOG2E);
            s[j][2 * hf + e] = p;
            sum += p;
          }
        l[hf] = l[hf] * alpha + sum;
        m[hf] = mn;
        alpha2[hf] = alpha;
      }

      // ---- O = O alpha + p V, 32 columns of O at a time: the tile's products
      // go to a fresh accumulator (an mma rounds its sum toward zero, so a
      // chain of them into one accumulator drifts with the number of keys),
      // folded into O by one float32 FMA.  p is split from S's accumulator
      // in place (again for each 32 columns); V is read as it lies.
#pragma unroll
      for (int mq = 0; mq < NM; ++mq) {
        float pv[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) pv[i][c] = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          uint32_t ph[4], pl[4];  // A: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
          split_tf32(s[j][0], ph[0], pl[0]);
          split_tf32(s[j][2], ph[1], pl[1]);
          split_tf32(s[j][1], ph[2], pl[2]);
          split_tf32(s[j][3], ph[3], pl[3]);
          const float4 v0 =
              *reinterpret_cast<const float4*>(sV + (8 * j + t) * F::LDV + 32 * mq + 4 * g);
          const float4 v1 =
              *reinterpret_cast<const float4*>(sV + (8 * j + t + 4) * F::LDV + 32 * mq + 4 * g);
          const float a0[4] = {v0.x, v0.y, v0.z, v0.w}, a1[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            uint32_t bh[2], bl[2];
            split_tf32(a0[i], bh[0], bl[0]);
            split_tf32(a1[i], bh[1], bl[1]);
            mma_split(pv[i], ph, pl, bh, bl);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            o[4 * mq + i][c] = fmaf(o[4 * mq + i][c], alpha2[c >> 1], pv[i][c]);
      }
    }
    __syncthreads();  // the next step's copies overwrite this stage
  }

  // divide by l once; row r, columns 32m + 8t + (0..3 | 4..7) as float4s
  const float inv_l[2] = {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])};
  float* oh = out + b * o_bs + (int64_t)h * D;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int u = u0 + row0 + 8 * hf;
    if (!active || u >= U) continue;
    const float inv = inv_l[hf];
#pragma unroll
    for (int mq = 0; mq < NM; ++mq) {
      float* dst = oh + (int64_t)u * o_rs + 32 * mq + 8 * t;
      *reinterpret_cast<float4*>(dst) =
          make_float4(o[4 * mq][2 * hf] * inv, o[4 * mq + 1][2 * hf] * inv,
                      o[4 * mq + 2][2 * hf] * inv, o[4 * mq + 3][2 * hf] * inv);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(o[4 * mq][2 * hf + 1] * inv, o[4 * mq + 1][2 * hf + 1] * inv,
                      o[4 * mq + 2][2 * hf + 1] * inv, o[4 * mq + 3][2 * hf + 1] * inv);
    }
  }
}

// ======================================================================
// 2, 3. the int8 layers' attention: exact sums on the float64 tensor cores
// ======================================================================

constexpr int X_NT = 128;  // 4 warps, 16 query rows each
constexpr int X_BQ = 64;   // query rows per block
constexpr int X_KT = 16;   // keys per float64 tile (two tiles in flight)
constexpr int I8_KT = 64;  // keys per int8 score tile

// The exact kernels' shapes at head size HD (128 or 64)
template <int HD>
struct XS {
  static constexpr int LD = HD + 4;       // doubles (or q floats) per tile row
  static constexpr int TILE = X_KT * LD;  // doubles per float64 tile
  // q, the int8 tiles or the two float64 tiles: 33,792 bytes at 128, 17,408 at 64
  static constexpr size_t REGION = 2 * TILE * sizeof(double);
  static constexpr int LQ8 = HD + 16;  // bytes per int8 row (36 / 20 words: conflict-free)
  static constexpr int I8_TILE = I8_KT * LQ8 + I8_KT * 4;  // int8 rows, then their scales
  static constexpr int CPR = HD / 4;      // float4 chunks a row
  static constexpr int RPP = X_NT / CPR;  // rows a pass of the block (4 / 8)
  static_assert(2 * I8_TILE <= (int)REGION, "two int8 tiles fit the region");
  static_assert(X_BQ * LD * (int)sizeof(float) <= (int)REGION, "q fits the region");
};
// Scores of up to this many keys stay in shared memory: 64 rows x ld(T)
// float32, the bias row and the tile region fit the 227 KB of one block
// (T = 736 would just fit).  ops/attention.py EXACT_ONCHIP_MAX_T holds the
// same number.
constexpr int EXACT_ONCHIP_MAX_T = 704;

// row stride of the scores: keys padded to 32, plus 8 floats (float32 rows
// 8 banks apart; ops/attention.py `exact_scores_ld`)
__host__ __device__ __forceinline__ int scores_ld(int Tk) { return (Tk + 31) / 32 * 32 + 8; }

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float exp_exact(float x) {  // float64 exp, rounded once
  return __double2float_rn(exp((double)x));
}

// D(16 x 8) += A(16 x 8) B(8 x 8) in float64: a_i = A[g + 8 (i & 1)][t + 4 (i >> 1)],
// b_i = B[t + 4 i][g], c_i = D[g + 8 (i >> 1)][2 t + (i & 1)]
__device__ __forceinline__ void mma_f64(double c[4], const double a[4], double b0, double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A 16-row x HD float32 tile of a head slice, fetched into registers (HD /
// 32 float4 a thread: a warp per row at 128, half a warp at 64) a tile
// ahead of its use; rows past `nrows` are zero
template <int HD>
__device__ __forceinline__ void x_fetch(float4 f[HD / 32], const float* src, int64_t rs,
                                        int r0, int nrows) {
  using X = XS<HD>;
  const int r = threadIdx.x / X::CPR, col = (threadIdx.x % X::CPR) * 4;
#pragma unroll
  for (int i = 0; i < HD / 32; ++i) {
    const int row = r0 + r + X::RPP * i;
    f[i] = row < nrows ? *reinterpret_cast<const float4*>(src + (int64_t)row * rs + col)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}
// ... rounded to bf16 and widened to float64 into a shared tile
template <int HD>
__device__ __forceinline__ void x_stage(double* dst, const float4 f[HD / 32]) {
  using X = XS<HD>;
  const int r = threadIdx.x / X::CPR, col = (threadIdx.x % X::CPR) * 4;
#pragma unroll
  for (int i = 0; i < HD / 32; ++i) {
    double2* d = reinterpret_cast<double2*>(dst + (r + X::RPP * i) * X::LD + col);
    d[0] = make_double2(bf16_round(f[i].x), bf16_round(f[i].y));
    d[1] = make_double2(bf16_round(f[i].z), bf16_round(f[i].w));
  }
}

// Score epilogue of one accumulator pair: s = f32(acc) + bias, or the int8
// form; stored to the block's score rows, folded into the row maxima.
struct ScoreRows {
  float* sc;   // this block's row 0 of the scores
  int ld;      // row stride
  int row0;    // the thread's first row (g of its warp); the second is row0 + 8
  bool ok0, ok1;
  float m0, m1;
  __device__ __forceinline__ void put(int key, float s0, float s1) {
    if (ok0) sc[row0 * ld + key] = s0;
    if (ok1) sc[(row0 + 8) * ld + key] = s1;
    m0 = fmaxf(m0, s0);
    m1 = fmaxf(m1, s1);
  }
};

// Passes 2 and 3, shared by both kernels, after a block barrier that ends
// pass 1.  sc holds the warp's 16 score rows (keys < Tk); rs.m0 / rs.m1 the
// thread's partial row maxima.  e = exp(s - m) and l = sum e in float64, p =
// bf16(e / l) in place (a warp per eight rows at a time), then out = p v on
// the float64 tensor cores, v rounded to bf16 at staging and zero past
// v_rows.  `region` holds the two float64 tiles.
template <int HD>
__device__ __forceinline__ void exact_softmax_pv(ScoreRows& rs, double* region, const float* vh,
                                                 int64_t v_rs, int v_rows, int Tk, float* oh,
                                                 int64_t o_rs, int u0, int U) {
  using X = XS<HD>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float m0 = quad_max(rs.m0), m1 = quad_max(rs.m1);
  float4 f[HD / 32];
  x_fetch<HD>(f, vh, v_rs, 0, v_rows);  // v's first tile, in flight during pass 2
  __syncwarp();

  // ---- pass 2, eight of the warp's rows at a time, a lane per key (eight
  // independent exp chains a lane): e = exp(s - m) in place and l = sum e in
  // float64, then p = bf16(e / l) in place
  const int nrows = min(16, U - u0 - warp * 16);  // the warp's rows below U
  for (int r0 = 0; r0 < 16; r0 += 8) {
    float* s0 = rs.sc + (warp * 16 + r0) * rs.ld;
    float m[8];
    double l64[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      m[r] = __shfl_sync(0xffffffffu, r0 == 0 ? m0 : m1, 4 * r);
      l64[r] = 0.0;
    }
    // (the eight values are loaded before any is stored: the compiler cannot
    // tell the rows apart, and a store between would serialize the chains)
    for (int key = lane; key < Tk; key += 32) {
      float x[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) x[r] = r0 + r < nrows ? s0[r * rs.ld + key] : 0.f;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        x[r] = exp_exact(__fsub_rn(x[r], m[r]));
        l64[r] += (double)x[r];
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (r0 + r < nrows) s0[r * rs.ld + key] = x[r];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int r = 0; r < 8; ++r) l64[r] += __shfl_xor_sync(0xffffffffu, l64[r], off);
    float l[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) l[r] = __double2float_rn(l64[r]);
    for (int key = lane; key < Tk; key += 32) {
      float x[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) x[r] = r0 + r < nrows ? s0[r * rs.ld + key] : 0.f;
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (r0 + r < nrows) s0[r * rs.ld + key] = bf16_round(__fdiv_rn(x[r], l[r]));
    }
  }
  __syncwarp();

  // ---- pass 3: out = p v on the float64 tensor cores, 16-key v tiles
  // through two buffers (stage tile kt + 1 while tile kt is multiplied, one
  // barrier a tile); keys from v_rows on meet zero rows of v: their terms are
  // exact zeros, so the tiles stop there
  const float* p0 = rs.sc + rs.row0 * rs.ld;
  const float* p1 = p0 + 8 * rs.ld;
  double o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[j][c] = 0.0;
  const int nkt = (v_rows + X_KT - 1) / X_KT;
  x_stage<HD>(region, f);
  if (nkt > 1) x_fetch<HD>(f, vh, v_rs, X_KT, v_rows);
  __syncthreads();
  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) {
      x_stage<HD>(region + ((kt + 1) & 1) * X::TILE, f);
      if (kt + 2 < nkt) x_fetch<HD>(f, vh, v_rs, (kt + 2) * X_KT, v_rows);
    }
    const double* sV = region + (kt & 1) * X::TILE;
#pragma unroll
    for (int kk = 0; kk < X_KT / 8; ++kk) {
      const int ka = kt * X_KT + 8 * kk + t, kb = ka + 4;
      double a[4];
      a[0] = rs.ok0 && ka < Tk ? (double)p0[ka] : 0.0;
      a[1] = rs.ok1 && ka < Tk ? (double)p1[ka] : 0.0;
      a[2] = rs.ok0 && kb < Tk ? (double)p0[kb] : 0.0;
      a[3] = rs.ok1 && kb < Tk ? (double)p1[kb] : 0.0;
      const double* v0 = sV + (8 * kk + t) * X::LD + g;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) mma_f64(o[j], a, v0[8 * j], v0[4 * X::LD + 8 * j]);
    }
    __syncthreads();  // tile kt + 1 staged; this tile's buffer is free
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int u = u0 + rs.row0 + 8 * hf;
    if (u >= U) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(oh + (int64_t)u * o_rs + 8 * j + 2 * t) =
          make_float2(__double2float_rn(o[j][2 * hf]), __double2float_rn(o[j][2 * hf + 1]));
  }
}

// The block's score rows: shared memory after the tile region, or its rows
// of the device scratch (batch row blockIdx.z of this launch)
template <int HD, bool ONCHIP>
__device__ __forceinline__ float* score_base(char* smem, float* scratch, int U, int u0, int ld) {
  if (ONCHIP) return reinterpret_cast<float*>(smem + XS<HD>::REGION);
  return scratch + (((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * U + u0) * ld;
}

// The key bias row of batch row b, staged in shared memory after the region
// and the on-chip scores (visible after the caller's next barrier)
template <int HD, bool ONCHIP>
__device__ __forceinline__ const float* stage_bias(char* smem, const float* bias, int b, int Tk,
                                                   int ld) {
  float* sB = reinterpret_cast<float*>(smem + XS<HD>::REGION) + (ONCHIP ? X_BQ * ld : 0);
  for (int i = threadIdx.x; i < Tk; i += X_NT) sB[i] = bias[(int64_t)b * Tk + i];
  return sB;
}

template <int HD, bool ONCHIP>
__global__ void __launch_bounds__(X_NT, 2)
attention_f32ctx_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ bias,
                        const int* __restrict__ vlen, float* __restrict__ scratch,
                        float* __restrict__ out, int U, int Tk, float q_scale, int64_t q_bs,
                        int64_t q_rs, int64_t k_bs, int64_t k_rs, int64_t v_bs, int64_t v_rs,
                        int64_t o_bs, int64_t o_rs) {
  using X = XS<HD>;
  extern __shared__ __align__(16) char xbuf[];
  double* region = reinterpret_cast<double*>(xbuf);  // q floats, then the two k tiles
  const int u0 = blockIdx.x * X_BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* qh = q + b * q_bs + (int64_t)h * HD;
  const float* kh = k + b * k_bs + (int64_t)h * HD;
  const int ld = scores_ld(Tk);
  const float* bb = stage_bias<HD, ONCHIP>(xbuf, bias, b, Tk, ld);
  ScoreRows rs{score_base<HD, ONCHIP>(xbuf, scratch, U, u0, ld), ld, warp * 16 + g,
               u0 + warp * 16 + g < U, u0 + warp * 16 + g + 8 < U, -INFINITY, -INFINITY};

  // q * q_scale rounded to bf16 (float32, rows of X::LD) in the region, then
  // widened once into the warp's float64 A fragments
  float* sQ = reinterpret_cast<float*>(xbuf);
  for (int i = threadIdx.x; i < X_BQ * HD / 4; i += X_NT) {
    const int r = i / X::CPR, c = (i % X::CPR) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (u0 + r < U) x = *reinterpret_cast<const float4*>(qh + (int64_t)(u0 + r) * q_rs + c);
    *reinterpret_cast<float4*>(sQ + r * X::LD + c) =
        make_float4(bf16_round(__fmul_rn(x.x, q_scale)), bf16_round(__fmul_rn(x.y, q_scale)),
                    bf16_round(__fmul_rn(x.z, q_scale)), bf16_round(__fmul_rn(x.w, q_scale)));
  }
  float4 f[HD / 32];
  x_fetch<HD>(f, kh, k_rs, 0, Tk);
  __syncthreads();
  double qa[HD / 8][4];
  {
    const float* q0 = sQ + rs.row0 * X::LD + t;
#pragma unroll
    for (int ks = 0; ks < HD / 8; ++ks) {
      qa[ks][0] = q0[8 * ks];
      qa[ks][1] = q0[8 * X::LD + 8 * ks];
      qa[ks][2] = q0[8 * ks + 4];
      qa[ks][3] = q0[8 * X::LD + 8 * ks + 4];
    }
  }
  __syncthreads();

  // ---- pass 1: scores on the float64 tensor cores, 16-key k tiles through
  // the two buffers (one barrier a tile), two half sums of d a key pair (four
  // independent chains a warp; their float64 sum is exact), the bias, the
  // row max
  const int nkt = (Tk + X_KT - 1) / X_KT;
  x_stage<HD>(region, f);
  if (nkt > 1) x_fetch<HD>(f, kh, k_rs, X_KT, Tk);
  __syncthreads();
  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) {
      x_stage<HD>(region + ((kt + 1) & 1) * X::TILE, f);
      if (kt + 2 < nkt) x_fetch<HD>(f, kh, k_rs, (kt + 2) * X_KT, Tk);
    }
    const double* sK = region + (kt & 1) * X::TILE;
    double acc[X_KT / 8][2][4];
#pragma unroll
    for (int j = 0; j < X_KT / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][0][c] = acc[j][1][c] = 0.0;
#pragma unroll
    for (int ks = 0; ks < HD / 8; ++ks)
#pragma unroll
      for (int j = 0; j < X_KT / 8; ++j) {
        const double* kr = sK + (8 * j + g) * X::LD + 8 * ks + t;
        mma_f64(acc[j][ks & 1], qa[ks], kr[0], kr[4]);
      }
    float bv[X_KT / 8][2];  // loaded before the score stores
#pragma unroll
    for (int j = 0; j < X_KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = kt * X_KT + 8 * j + 2 * t + e;
        bv[j][e] = key < Tk ? bb[key] : 0.f;
      }
#pragma unroll
    for (int j = 0; j < X_KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (kt * X_KT + 8 * j + 2 * t + e < Tk)
          rs.put(kt * X_KT + 8 * j + 2 * t + e,
                 __fadd_rn(__double2float_rn(acc[j][0][e] + acc[j][1][e]), bv[j][e]),
                 __fadd_rn(__double2float_rn(acc[j][0][2 + e] + acc[j][1][2 + e]), bv[j][e]));
    __syncthreads();  // tile kt + 1 staged; this tile's buffer is free
  }

  const int v_rows = vlen ? min(Tk, vlen[b]) : Tk;
  exact_softmax_pv<HD>(rs, region, v + b * v_bs + (int64_t)h * HD, v_rs, v_rows, Tk,
                       out + b * o_bs + (int64_t)h * HD, o_rs, u0, U);
}

// ---- the SANM layer's attention with int8 scores (int8_attn)

__device__ __forceinline__ uint32_t pack4(const int q[4]) {
  return (uint32_t)(q[0] & 0xff) | ((uint32_t)(q[1] & 0xff) << 8) |
         ((uint32_t)(q[2] & 0xff) << 16) | ((uint32_t)(q[3] & 0xff) << 24);
}

// The warp's 16 rows (r0 + warp + 4 j, j < 16) of a 64-row float32 tile of
// a head slice, four values a lane, fetched into registers a tile ahead of
// their use; rows past `nrows` are 0.  A row is LPR = HD / 4 lanes (the
// warp at 128; at 64 each half-warp takes every other row: j = 2 i + half)
template <int HD>
struct Q8 {
  static constexpr int LPR = HD / 4;     // lanes a row
  static constexpr int RPW = 32 / LPR;   // rows a warp-wide load
  static constexpr int NX = 16 / RPW;    // float4 a lane
  static __device__ __forceinline__ int row(int i) {  // the tile row of x[i]
    return (threadIdx.x >> 5) + 4 * (RPW * i + (threadIdx.x & 31) / LPR);
  }
};

template <int HD>
__device__ __forceinline__ void q8_fetch(float4 x[Q8<HD>::NX], const float* src, int64_t rs,
                                         int r0, int nrows) {
  const int col = 4 * ((threadIdx.x & 31) % Q8<HD>::LPR);
#pragma unroll
  for (int i = 0; i < Q8<HD>::NX; ++i) {
    const int row = r0 + Q8<HD>::row(i);
    x[i] = row < nrows ? *reinterpret_cast<const float4*>(src + (int64_t)row * rs + col)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// ... each value times `mult`, quantized per row as quant.py
// `rowquant_kernel` does (scale = max(absmax, 1e-8) * f32(1/127), q =
// clip(rint(y / scale))) into an int8 tile: 64 rows of LQ8 bytes, then
// their 64 scales; rows past `nrows` are zero, scale 0.  The row's lanes
// (a warp at 128, a half-warp at 64) reduce its absmax.
template <int HD>
__device__ __forceinline__ void quantize_rows(int8_t* dst, const float4 x[Q8<HD>::NX], int r0,
                                              int nrows, float mult) {
  using Q = Q8<HD>;
  const int lane = threadIdx.x & 31, rl = lane % Q::LPR;
  float* scale = reinterpret_cast<float*>(dst + I8_KT * XS<HD>::LQ8);
  float amax[Q::NX];  // the rows' reductions interleaved
#pragma unroll
  for (int i = 0; i < Q::NX; ++i)
    amax[i] = fmaxf(fmaxf(fabsf(__fmul_rn(x[i].x, mult)), fabsf(__fmul_rn(x[i].y, mult))),
                    fmaxf(fabsf(__fmul_rn(x[i].z, mult)), fabsf(__fmul_rn(x[i].w, mult))));
#pragma unroll
  for (int off = Q::LPR / 2; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < Q::NX; ++i)
      amax[i] = fmaxf(amax[i], __shfl_xor_sync(0xffffffffu, amax[i], off));
#pragma unroll
  for (int i = 0; i < Q::NX; ++i) {
    const int r = Q::row(i);
    uint32_t word = 0;
    float sc = 0.f;
    if (r0 + r < nrows) {
      const float y[4] = {__fmul_rn(x[i].x, mult), __fmul_rn(x[i].y, mult),
                          __fmul_rn(x[i].z, mult), __fmul_rn(x[i].w, mult)};
      sc = __fmul_rn(fmaxf(amax[i], 1e-8f), (float)(1.0 / 127.0));
      int qv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        qv[c] = (int)fminf(fmaxf(rintf(__fdiv_rn(y[c], sc)), -127.f), 127.f);
      word = pack4(qv);
    }
    reinterpret_cast<uint32_t*>(dst + r * XS<HD>::LQ8)[rl] = word;
    if (rl == 0) scale[r] = sc;
  }
}

template <int HD, bool ONCHIP>
__global__ void __launch_bounds__(X_NT, 2)
attention_i8qk_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ bias,
                      const int* __restrict__ vlen, float* __restrict__ scratch,
                      float* __restrict__ out, int U, int Tk, float q_scale, int64_t q_bs,
                      int64_t q_rs, int64_t k_bs, int64_t k_rs, int64_t v_bs, int64_t v_rs,
                      int64_t o_bs, int64_t o_rs) {
  extern __shared__ __align__(16) char xbuf[];
  // two int8 tiles in pass 1 (q8 in the second at first), the float64 v
  // tiles in pass 3
  using X = XS<HD>;
  int8_t* s8 = reinterpret_cast<int8_t*>(xbuf);
  const int u0 = blockIdx.x * X_BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* kh = k + b * k_bs + (int64_t)h * HD;
  const int ld = scores_ld(Tk);
  const float* bb = stage_bias<HD, ONCHIP>(xbuf, bias, b, Tk, ld);
  ScoreRows rs{score_base<HD, ONCHIP>(xbuf, scratch, U, u0, ld), ld, warp * 16 + g,
               u0 + warp * 16 + g < U, u0 + warp * 16 + g + 8 < U, -INFINITY, -INFINITY};

  // q * d^-0.5 row-quantized into the second int8 tile, then the warp's
  // int8 A fragments and row scales into registers
  float4 x[Q8<HD>::NX];
  q8_fetch<HD>(x, q + b * q_bs + (int64_t)h * HD, q_rs, u0, U);
  quantize_rows<HD>(s8 + X::I8_TILE, x, u0, U, q_scale);
  q8_fetch<HD>(x, kh, k_rs, 0, Tk);
  __syncthreads();
  uint32_t qa[HD / 32][4];
  const float* qscale = reinterpret_cast<const float*>(s8 + X::I8_TILE + I8_KT * X::LQ8);
  const float qs0 = qscale[rs.row0], qs1 = qscale[rs.row0 + 8];
#pragma unroll
  for (int kk = 0; kk < HD / 32; ++kk) {
    const int8_t* p = s8 + X::I8_TILE + rs.row0 * X::LQ8 + 32 * kk + 4 * t;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(p);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * X::LQ8);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(p + 16);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(p + 8 * X::LQ8 + 16);
  }

  // ---- pass 1: 64-key tiles of k (not masked) quantized into the two int8
  // buffers (tile kt + 1 while tile kt is multiplied, one barrier a tile),
  // the int8 scores exact in int32, the float32 steps, the row max
  const int nkt = (Tk + I8_KT - 1) / I8_KT;
  quantize_rows<HD>(s8, x, 0, Tk, 1.f);
  if (nkt > 1) q8_fetch<HD>(x, kh, k_rs, I8_KT, Tk);
  __syncthreads();  // tile 0 quantized; every warp holds its q fragments
  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) {
      quantize_rows<HD>(s8 + ((kt + 1) & 1) * X::I8_TILE, x, (kt + 1) * I8_KT, Tk, 1.f);
      if (kt + 2 < nkt) q8_fetch<HD>(x, kh, k_rs, (kt + 2) * I8_KT, Tk);
    }
    const int8_t* sK = s8 + (kt & 1) * X::I8_TILE;
    const float* kscale = reinterpret_cast<const float*>(sK + I8_KT * X::LQ8);
    int acc[I8_KT / 8][4];
#pragma unroll
    for (int j = 0; j < I8_KT / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = 0;
#pragma unroll
    for (int kk = 0; kk < HD / 32; ++kk)
#pragma unroll
      for (int j = 0; j < I8_KT / 8; ++j) {
        const int8_t* p = sK + (8 * j + g) * X::LQ8 + 32 * kk + 4 * t;
        mma_s8(acc[j], qa[kk], *reinterpret_cast<const uint32_t*>(p),
               *reinterpret_cast<const uint32_t*>(p + 16));
      }
    float ks[I8_KT / 8][2], bv[I8_KT / 8][2];  // loaded before the score stores
#pragma unroll
    for (int j = 0; j < I8_KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kl = 8 * j + 2 * t + e;
        ks[j][e] = kscale[kl];
        bv[j][e] = kt * I8_KT + kl < Tk ? bb[kt * I8_KT + kl] : 0.f;
      }
#pragma unroll
    for (int j = 0; j < I8_KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = kt * I8_KT + 8 * j + 2 * t + e;
        if (key < Tk)
          rs.put(key,
                 __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[j][e]), qs0), ks[j][e]),
                           bv[j][e]),
                 __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[j][2 + e]), qs1), ks[j][e]),
                           bv[j][e]));
      }
    __syncthreads();  // tile kt + 1 quantized; this tile's buffer is free
  }

  const int v_rows = vlen ? min(Tk, vlen[b]) : Tk;
  exact_softmax_pv<HD>(rs, reinterpret_cast<double*>(xbuf), v + b * v_bs + (int64_t)h * HD,
                       v_rs, v_rows, Tk, out + b * o_bs + (int64_t)h * HD, o_rs, u0, U);
}

using ExactKernel = void (*)(const float*, const float*, const float*, const float*, const int*,
                             float*, float*, int, int, float, int64_t, int64_t, int64_t, int64_t,
                             int64_t, int64_t, int64_t, int64_t);

template <int HD>
int launch_exact(ExactKernel onchip, ExactKernel spill, const float* q,
                 const float* k, const float* v, const float* bias, const int* vlen,
                 float* scratch, float* out, int B, int U, int Tk, int H, float q_scale,
                 const long long* st, cudaStream_t stream) {
  if (!scratch && Tk > EXACT_ONCHIP_MAX_T) return (int)cudaErrorInvalidValue;
  const int ld = scores_ld(Tk);  // the scores (on chip) and the bias row
  const size_t smem = XS<HD>::REGION + (scratch ? 1 : X_BQ + 1) * (size_t)ld * sizeof(float);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const void* kern = scratch ? (const void*)spill : (const void*)onchip;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((U + X_BQ - 1) / X_BQ, H, B);
  if (scratch)
    spill<<<grid, X_NT, smem, stream>>>(q, k, v, bias, vlen, scratch, out, U, Tk, q_scale, st[0],
                                        st[1], st[2], st[3], st[4], st[5], st[6], st[7]);
  else
    onchip<<<grid, X_NT, smem, stream>>>(q, k, v, bias, vlen, nullptr, out, U, Tk, q_scale,
                                         st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7]);
  return (int)cudaGetLastError();
}

template <int D, bool ALIBI>
int launch_forward_f32(const float* q, const float* k, const float* v, const float* bias,
                       const float* slopes, int extra, float* out, int B, int U, int Tk, int H,
                       const long long* st, cudaStream_t s) {
  auto kern = attention_kernel_f32<D, ALIBI>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)FB<D>::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((U + FB_BQ - 1) / FB_BQ, H, B);
  kern<<<grid, FB_NT, FB<D>::SMEM, s>>>(q, k, v, bias, slopes, extra, out, U, Tk, st[0], st[1],
                                        st[2], st[3], st[4], st[5], st[6], st[7]);
  return (int)cudaGetLastError();
}

template <int D>
int launch_forward(const void* q, const void* k, const void* v, const float* bias, void* out,
                   int B, int U, int Tk, int H, int dtype, const long long* st,
                   cudaStream_t s) {
  if (dtype == 1) {
    auto kern = attention_kernel_bf16_mma<D>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)mb_smem<D>());
    if (err != cudaSuccess) return (int)err;
    dim3 grid((U + MB_BQ - 1) / MB_BQ, H, B);
    kern<<<grid, MB_NT, mb_smem<D>(), s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), bias, static_cast<__nv_bfloat16*>(out), U, Tk,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7]);
    return (int)cudaGetLastError();
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return launch_forward_f32<D, false>(static_cast<const float*>(q), static_cast<const float*>(k),
                                      static_cast<const float*>(v), bias, nullptr, 0,
                                      static_cast<float*>(out), B, U, Tk, H, st, s);
}

}  // namespace

// Plain C entry point, called through ctypes.  `strides` holds the batch and
// row strides (in elements) of q, k, v and out, in that order.  dtype: 0 =
// float32, 1 = bfloat16; the head size d is 128, 64 or 32 (one instance each),
// and q, k, v 16-byte aligned with strides that are multiples of 8 (bf16) or
// 4 (float32) elements (the wrapper checks).  Returns cudaGetLastError() (0 on success); 1
// (cudaErrorInvalidValue) for another head size or dtype.
extern "C" int attention_forward(const void* q, const void* k, const void* v,
                                 const float* bias, void* out, int B, int U, int Tk,
                                 int H, int d, int dtype, const long long* st,
                                 void* stream) {
  if (B <= 0 || U <= 0 || H <= 0) return (int)cudaSuccess;
  if (Tk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 128) return launch_forward<128>(q, k, v, bias, out, B, U, Tk, H, dtype, st, s);
  if (d == 64) return launch_forward<64>(q, k, v, bias, out, B, U, Tk, H, dtype, st, s);
  if (d == 32) return launch_forward<32>(q, k, v, bias, out, B, U, Tk, H, dtype, st, s);
  return (int)cudaErrorInvalidValue;
}

// The float32 kernel with emotion2vec's symmetric ALiBi (its d = 64 instance
// only): `attention_forward`'s arguments at dtype 0, plus slopes (H,) float32
// (slope x max(scale, 0) a head) and `extra`, the leading rows and columns
// that get no ALiBi term.  Returns cudaGetLastError(); 1
// (cudaErrorInvalidValue) for another head size or a negative `extra`.
extern "C" int attention_forward_alibi(const float* q, const float* k, const float* v,
                                       const float* bias, const float* slopes, int extra,
                                       float* out, int B, int U, int Tk, int H, int d,
                                       const long long* st, void* stream) {
  if (B <= 0 || U <= 0 || H <= 0) return (int)cudaSuccess;
  if (Tk <= 0 || d != 64 || extra < 0) return (int)cudaErrorInvalidValue;
  return launch_forward_f32<64, true>(q, k, v, bias, slopes, extra, out, B, U, Tk, H, st,
                                      (cudaStream_t)stream);
}

// The int8 layers' attention (second kernel above): float32 q, k, v rounded
// to bf16 at load (q times q_scale first; v zero past vlen[b] when vlen is
// not null), float32 output.  `scratch` is null when the scores stay in
// shared memory (Tk <= EXACT_ONCHIP_MAX_T), else float32 (B, H, U,
// scores_ld(Tk)).  q, k, v 16-byte aligned with strides that are multiples
// of 4 (the wrapper checks).  The head size d is 128 or 64; same strides
// and return codes as attention_forward.
extern "C" int attention_forward_f32ctx(const float* q, const float* k, const float* v,
                                        const float* bias, const int* vlen, float* scratch,
                                        float* out, int B, int U, int Tk, int H, int d,
                                        float q_scale, const long long* strides,
                                        void* stream) {
  if (B <= 0 || U <= 0 || H <= 0) return (int)cudaSuccess;
  if (Tk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 128)
    return launch_exact<128>(attention_f32ctx_kernel<128, true>,
                             attention_f32ctx_kernel<128, false>, q, k, v, bias, vlen, scratch,
                             out, B, U, Tk, H, q_scale, strides, s);
  if (d == 64)
    return launch_exact<64>(attention_f32ctx_kernel<64, true>, attention_f32ctx_kernel<64, false>,
                            q, k, v, bias, vlen, scratch, out, B, U, Tk, H, q_scale, strides, s);
  return (int)cudaErrorInvalidValue;
}

// The SANM layer's attention with int8 scores (third kernel above): float32
// q, k, v; q times q_scale and k row-quantized in the kernel, v rounded to
// bf16 and zero past vlen[b] (when not null), float32 output.  Same scratch
// rule, alignment, strides, head size and return codes as
// attention_forward_f32ctx.
extern "C" int attention_forward_i8qk(const float* q, const float* k, const float* v,
                                      const float* bias, const int* vlen, float* scratch,
                                      float* out, int B, int U, int Tk, int H, int d,
                                      float q_scale, const long long* strides,
                                      void* stream) {
  if (B <= 0 || U <= 0 || H <= 0) return (int)cudaSuccess;
  if (Tk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 128)
    return launch_exact<128>(attention_i8qk_kernel<128, true>, attention_i8qk_kernel<128, false>,
                             q, k, v, bias, vlen, scratch, out, B, U, Tk, H, q_scale, strides, s);
  if (d == 64)
    return launch_exact<64>(attention_i8qk_kernel<64, true>, attention_i8qk_kernel<64, false>, q,
                            k, v, bias, vlen, scratch, out, B, U, Tk, H, q_scale, strides, s);
  return (int)cudaErrorInvalidValue;
}
