// Position-wise FFN out = relu(x W1^T + b1) W2^T + b2 for Hopper (sm_90a),
// bf16 on wgmma + TMA, float32 on the CUDA cores, the hidden activations
// kept on chip in chunks.
//
// Replaces the TPU kernel funasr_tpu/ops/ffn_pallas.py `_ffn_kernel` (:39,
// pallas_call at :86).  Same function (ffn_pallas.py:39-45), for x (M, K),
// w1 (H, K) and w2 (N, H) in one dtype T (the nn.Linear layout), float32
// biases:
//
//   h   = T(relu(x w1^T + b1))        float32 accumulation, then cast
//   out = T(h w2^T + b2)              float32 accumulation, then cast
//
// bf16 design (ffn_wgmma_kernel).  The mainloop parts of int8_wgmma.cuh
// (mbarrier ring with watchdog waits, TMA 2-D loads into 128B-swizzled
// K-major stages, the swizzle-128B wgmma descriptor, setmaxnreg) with
// wgmma.mma_async ... .f32.bf16.bf16: a bf16 stage row of 64 elements is
// the same 128 bytes as an int8 one, and a k16 step advances 32 bytes.
// A persistent grid walks units of one band of BM = 64 rows of x and up to
// NG = 512 output columns.  Per block: one producer thread (TMA) and two
// consumer warpgroups that split the unit's columns, each holding its
// 64 x 256 slice of out in float32 registers (128 a thread) across the
// whole hidden dimension: the register file allows no larger band.  The
// band of x stays in shared memory (64 KB at K = 512, loaded once by TMA).
// For each chunk of BH = 128 hidden columns:
//
//   1. each warpgroup computes its 64 columns of x w1[chunk]^T (m64n64k16,
//      one ring slot of 128 w1 rows x 128 bytes of K per k-block);
//   2. adds b1 (the chunk's 128 biases ride on its first w1 slot by a bulk
//      copy into shared memory), applies relu, rounds to bf16 and writes
//      its half into an h buffer in the 128B-swizzled layout TMA would
//      give (swizzle_offset), fenced into the async proxy, and arrives on a
//      named barrier;
//   3. waits on the other warpgroup's barrier for its half, then
//      accumulates h[chunk] w2[its 256 rows, chunk]^T into its out slice
//      (m64n128k16 over two ring slots per 64 hidden columns).
//
// The hidden activations never reach device memory and H has no cap.  A
// warpgroup issues chunk c + 1's first product before chunk c's second,
// and writes h[c + 1] once the first group of the second has retired the
// first product: the relu and the stores run while the tensor cores work.
// Three h buffers make the arrive/wait pair of step 3 the only sync a
// chunk (a buffer is written again only after both warpgroups passed the
// barrier that follows their last read of it).  A slot is released one
// group late (after the next group is issued and the group reading it has
// retired); the producer itself releases each w2 slot for the warpgroup
// that does not read it, which passes it by without waiting.  Ring order =
// consumption order: the band, then per chunk c the w1 k-blocks of c + 1
// and the w2 slots of c.
//
// TMA multicast of each weight slot to a cluster of two blocks (two bands
// on one weight stream) measured slower than one block on an H100
// (PERF.md section 6) and is not kept: the weight stream is not what bounds
// this kernel.
//
// Epilogue: out = bf16(acc + b2), the four lanes of a quad swapping their
// column pairs so that each lane stores 16 contiguous bytes (whole
// sectors; the accumulator layout alone gives 4-byte stores a lane that
// fill half sectors of 8 rows), masked past M and N.  Ragged H
// and K: TMA zero-fills past the tensors, a zero-filled w2 column adds
// nothing whatever relu(b1) gives for a padded hidden column (b1 is read
// as 0 there).  N > 512 runs one unit per 512 columns (each computes h
// again).  The plan (stages, grid, shared bytes) is ops/ffn.py
// `ffn_plan`'s; the entry refuses another.
//
// float32 design (ffn_f32_kernel, the CUDA cores: no tensor-core float32
// mode meets the 2e-5 bar without a split scheme).  One block of 256
// threads per 16 rows of x and up to 512 output columns; the rows of x in
// shared memory; for each chunk of 256 hidden columns the (16, 256) hidden
// tile is computed into shared memory, then added into a (16, 512) float32
// out tile in shared memory.  Weights stream through two cp.async stages of
// 128 rows x 64 bytes; one FMA sum per output and chunk in k order.
//
// Both sum in another order than the plain twin (ops/ffn.py `ffn_ref`),
// which can move a bf16 rounding of h: kernel and twin agree to a stated
// tolerance, not bit for bit.  K and H must be multiples of 32 and x, w1,
// w2 and b1 16-byte aligned (the wrapper sees to it: b1 rides on a bulk
// copy); N and M are free; K is at
// most 896 (bf16: the band of x in shared memory beside a ring of 4) or
// 2528 (float32).
//
// Bound on the H100 SXM at (16384, 512) -> 2048 -> 512 bf16: 68.7 GFLOP =
// 69 us at 989 TFLOP/s against 37.7 MB of bytes = 11 us: operations.  Each
// weight byte serves one 64-row band: 256 bands x 4 MB = 1 GB through L2
// and into the SMs' shared memory; the m64n64 products of step 1 read as
// many operand bytes from shared memory as they do arithmetic.  float32:
// 68.7 GFLOP at 67 TFLOP/s = 1.03 ms.

#include <cuda_bf16.h>

#include "int8_wgmma.cuh"

namespace {

using i8w::BK;

// ---------------------------------------------------------------- bf16

constexpr int BM = 64;                 // rows of x a band
constexpr int BH = 128;                // hidden columns a chunk
constexpr int NG = 512;                // output columns a unit: 256 per consumer warpgroup
constexpr int NC = 2;                  // consumer warpgroups
constexpr int NT = 128 * (NC + 1);     // + the producer warpgroup
constexpr int SLOT_ROWS = 128;         // weight rows of a ring slot
constexpr int SLOT = SLOT_ROWS * BK;   // 16 KB
constexpr int XBLK = BM * BK;          // one 64-column k-block of the band: 8 KB
constexpr int HBUFS = 3;               // h buffers
constexpr int HBUF = 2 * XBLK;         // one h chunk: two 64-column k-blocks
constexpr int MIN_STAGES = 4;  // a warpgroup holds a slot while it waits 3 slots on
constexpr int MAX_STAGES = 12;

// `count` arrivals on a barrier of this block
__device__ __forceinline__ void mbar_arrive_count(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(i8w::smem_u32(bar)),
               "r"(count)
               : "memory");
}

// `bytes` (a multiple of 16) from global src into shared dst, counted on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(i8w::smem_u32(dst)), "l"(src), "r"(bytes), "r"(i8w::smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The named barrier on which warpgroup w announces hidden chunk g (a
// running count): ids 1-4, alternating with g so that a warpgroup one chunk
// ahead never arrives on the barrier the other still waits on.
__device__ __forceinline__ int h_barrier(int w, int g) { return 1 + 2 * w + (g & 1); }

#define FFN_F8(i)                                                                    \
  "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]),            \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define FFN_F32(i) FFN_F8(i), FFN_F8((i) + 8), FFN_F8((i) + 16), FFN_F8((i) + 24)

// d (+)= A (64 x 16 bf16, desc a) . B (64 x 16 bf16, desc b)^T, float32;
// scale_d = 0 starts the sum
__device__ __forceinline__ void mma_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : FFN_F32(0)
      : "l"(a), "l"(b), "r"(scale_d));
}

// the same with B 128 x 16
__device__ __forceinline__ void mma_n128(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : FFN_F32(0), FFN_F32(32)
      : "l"(a), "l"(b), "r"(scale_d));
}

#undef FFN_F32
#undef FFN_F8

// keep the compiler from moving accumulator reads or writes across a wgmma
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The consumer side of the ring, for one warpgroup.  `held` is the slot
// whose wgmma group may still be in flight (-1: none).  Each of the
// warpgroup's warps arrives once on a slot's empty barrier.
struct Consumer {
  i8w::Ring ring;
  int held = -1;

  __device__ __forceinline__ void release(int s) {
    if (s >= 0 && (threadIdx.x & 31) == 0) i8w::mbar_arrive(&ring.empty[s]);
  }
  // the next slot, once it has landed
  __device__ __forceinline__ int next() {
    const int s = ring.stage;
    i8w::mbar_wait(&ring.full[s], ring.phase);
    ring.advance();
    return s;
  }
  // after a group reading slot s was committed: retire the group before it
  // and release that one's slot
  __device__ __forceinline__ void issued(int s) {
    i8w::wgmma_wait<1>();
    release(held);
    held = s;
  }
  __device__ __forceinline__ void drain() {
    i8w::wgmma_wait<0>();
    release(held);
    held = -1;
  }
};

// h = bf16(relu(a1 + b1)) into this warpgroup's 64-column k-block `hk` of
// an h buffer (64 rows x 128 bytes, 128B-swizzled), for hidden columns h0
// .. h0 + 63 (b1: their biases in shared memory, read as 0 past H): the
// accumulator register 4 j + 2 hh + c of lane (g, t) in warp w is row
// 16 w + g + 8 hh, column 8 j + 2 t + c.  A warp's 4-byte stores of one
// (j, hh) cover 8 rows x 16 bytes in 8 distinct swizzled chunks: no bank
// conflict.
__device__ __forceinline__ void store_h(const float (&a1)[32], const float* b1, int h0, int H,
                                        uint8_t* hk) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = h0 + 8 * j + 2 * t;
    const float c0 = n < H ? b1[n - h0] : 0.f;
    const float c1 = n + 1 < H ? b1[n + 1 - h0] : 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = 16 * warp + g + 8 * hh;
      const float v0 = fmaxf(__fadd_rn(a1[4 * j + 2 * hh], c0), 0.f);
      const float v1 = fmaxf(__fadd_rn(a1[4 * j + 2 * hh + 1], c1), 0.f);
      *reinterpret_cast<__nv_bfloat162*>(hk + i8w::swizzle_offset(row, (8 * j + 2 * t) * 2)) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

// out = bf16(acc + b2) for this warp's 16 rows (from m) and a 128-column
// half (from n): acc is an m64n128 accumulator, register 4 j + 2 hh + c of
// lane (g, t) row g + 8 hh, column 8 j + 2 t + c.  For each 32 columns the
// four lanes of a quad swap their bf16 pairs (a 4 x 4 transpose by
// shuffles), so that lane t then holds the 8 columns 8 (4 q + t) .. + 7 of
// its row: one 16-byte store each, whole sectors, where the row stride
// allows it (vec), and element by element past N or otherwise.
__device__ __forceinline__ void store_out(__nv_bfloat16* __restrict__ out,
                                          const float (&acc)[64], const float* __restrict__ b2,
                                          int m, int n, int M, int N, bool vec) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float2 bias[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = n + 8 * (4 * q + jj) + 2 * t;
      bias[jj] = make_float2(c < N ? __ldg(b2 + c) : 0.f, c + 1 < N ? __ldg(b2 + c + 1) : 0.f);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      uint32_t v[4], w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int r = 4 * (4 * q + jj) + 2 * hh;
        const __nv_bfloat162 p = __floats2bfloat162_rn(__fadd_rn(acc[r], bias[jj].x),
                                                       __fadd_rn(acc[r + 1], bias[jj].y));
        v[jj] = *reinterpret_cast<const uint32_t*>(&p);
      }
      // lane t sends its pair of column block t ^ k to lane t ^ k and
      // receives that lane's pair of block t: w[i] = lane i's pair of block t
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = t ^ k;
        const uint32_t send = i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
        const uint32_t got = __shfl_xor_sync(0xffffffffu, send, k);
#pragma unroll
        for (int e = 0; e < 4; ++e) w[e] = e == i ? got : w[e];
      }
      const int row = m + g + 8 * hh, c0 = n + 8 * (4 * q + t);
      if (row >= M) continue;
      __nv_bfloat16* o = out + (int64_t)row * N + c0;
      if (vec && c0 + 7 < N) {
        *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
        continue;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&w[e]);
        if (c0 + 2 * e < N) o[2 * e] = p.x;
        if (c0 + 2 * e + 1 < N) o[2 * e + 1] = p.y;
      }
    }
  }
}

__global__ void __launch_bounds__(NT, 1)
ffn_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_w1,
                 const __grid_constant__ CUtensorMap map_w2, const float* __restrict__ b1,
                 const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, int M, int K,
                 int H, int N, int stages) {
  const int nk = (2 * K + BK - 1) / BK;  // 64-column k-blocks of the band
  const int nh = (H + BH - 1) / BH;      // hidden chunks
  const int groups = (N + NG - 1) / NG;
  const int units = (M + BM - 1) / BM * groups;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* xs = i8w::align_smem(smem_raw);  // nk x (64 rows x 128 bytes)
  uint8_t* hs = xs + (size_t)nk * XBLK;     // HBUFS x (2 x 64 rows x 128 bytes)
  uint8_t* ws = hs + HBUFS * HBUF;          // stages x (128 rows x 128 bytes)
  uint64_t* full = reinterpret_cast<uint64_t*>(ws + (size_t)stages * SLOT);
  uint64_t* empty = full + stages;
  uint64_t* xfull = empty + stages;
  uint64_t* xempty = xfull + 1;
  float* b1s = reinterpret_cast<float*>(xempty + 1);  // HBUFS x BH: each h buffer's b1

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      i8w::mbar_init(&full[s], 1);
      i8w::mbar_init(&empty[s], 4 * NC);  // every consumer warp
    }
    i8w::mbar_init(xfull, 1);
    i8w::mbar_init(xempty, 4 * NC);
    i8w::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NC) {  // ---- producer: one thread
    i8w::reg_dealloc<24>();  // one thread issues every load
    if (threadIdx.x == NC * 128) {
      i8w::tma_prefetch(&map_x);
      i8w::tma_prefetch(&map_w1);
      i8w::tma_prefetch(&map_w2);
      i8w::Ring ring{full, empty, stages};
      // the next ring slot: 128 rows from row0 at byte xb (and, with b1_src
      // != nullptr, b1_bytes of b1 into b1_dst on the same barrier)
      auto put = [&](const CUtensorMap* map, int xb, int row0, const float* b1_src = nullptr,
                     float* b1_dst = nullptr, uint32_t b1_bytes = 0) {
        const int s = ring.stage;
        i8w::mbar_wait(&empty[s], ring.phase ^ 1);
        i8w::mbar_expect_tx(&full[s], SLOT + b1_bytes);
        if (b1_src) bulk_load(b1_dst, b1_src, b1_bytes, &full[s]);
        i8w::tma_load_2d(ws + (size_t)s * SLOT, map, &full[s], xb, row0);
        ring.advance();
        return s;
      };
      uint32_t xph = 0;
      int hc = 0;  // chunks streamed so far: the consumers' h buffer count
      for (int u = blockIdx.x; u < units; u += gridDim.x, hc += nh) {
        const int m0 = (u / groups) * BM, n0 = (u % groups) * NG;
        i8w::mbar_wait(xempty, xph ^ 1);  // the last band's products are done with x
        i8w::mbar_expect_tx(xfull, nk * XBLK);
        for (int kb = 0; kb < nk; ++kb)
          i8w::tma_load_2d(xs + (size_t)kb * XBLK, &map_x, xfull, kb * BK, m0);
        xph ^= 1;
        for (int c = -1; c < nh; ++c) {
          if (c + 1 < nh) {
            const int h0 = (c + 1) * BH;
            put(&map_w1, 0, h0, b1 + h0, b1s + (hc + c + 1) % HBUFS * BH,
                4 * min(BH, H - h0));
            for (int kb = 1; kb < nk; ++kb) put(&map_w1, kb * BK, h0);
          }
          if (c >= 0)
            for (int j = 0; j < 2; ++j)
              for (int p = 0; p < NG / SLOT_ROWS; ++p) {
                // one consumer warpgroup reads a w2 slot: this thread
                // releases it for the other's warps, which never wait on it
                const int s = put(&map_w2, (c * BH + 64 * j) * 2, n0 + SLOT_ROWS * p);
                mbar_arrive_count(&empty[s], 4);
              }
        }
      }
    }
    __syncwarp();
  } else {  // ---- consumers: warpgroup wg owns out columns 256 wg .. 256 wg + 255
    i8w::reg_alloc<240>();  // 2 x 128 x 240 + 128 x 24: 64,512 of 65,536
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    Consumer cons{i8w::Ring{full, empty, stages}};
    float acc[2][64];  // out: two 128-column halves
    float a1[32];      // this warpgroup's 64 columns of a hidden chunk
#pragma unroll
    for (int i = 0; i < 32; ++i) a1[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.f;
    uint32_t xph = 0;
    int hc = 0;  // chunks computed so far: chunk c of this unit is in h buffer (hc + c) % HBUFS
    auto hbuf = [&](int c) { return hs + (size_t)((hc + c) % HBUFS) * HBUF; };

    // a1 = x band . w1[chunk]^T: one slot a k-block, this warpgroup's 64 of its 128 rows
    auto gemm1 = [&]() {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = cons.next();
        const uint64_t da = i8w::desc_sw128(xs + (size_t)kb * XBLK);
        const uint64_t db = i8w::desc_sw128(ws + (size_t)s * SLOT + wg * 64 * BK);
        i8w::wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 32; ++k) mma_n64(a1, da + 2 * k, db + 2 * k, (kb | k) != 0);
        i8w::wgmma_commit();
        cons.issued(s);
      }
    };
    // the h chunk into this warpgroup's k-block of its buffer, visible to
    // the other warpgroup and to wgmma after the barrier
    auto finish_h = [&](int c) {
      store_h(a1, b1s + (hc + c) % HBUFS * BH + 64 * wg, c * BH + 64 * wg, H,
              hbuf(c) + wg * XBLK);
      i8w::fence_proxy_async();
      named_arrive(h_barrier(wg, hc + c), 128 * NC);
    };

    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int m0 = (u / groups) * BM, n0 = (u % groups) * NG;
      i8w::mbar_wait(xfull, xph);
      xph ^= 1;
      gemm1();
      cons.drain();
      fence_acc(a1);
      if (nh == 1 && lane == 0) i8w::mbar_arrive(xempty);
      finish_h(0);
      for (int c = 0; c < nh; ++c) {
        const bool next = c + 1 < nh;
        if (next) gemm1();
        // acc += h[c] . w2[n0 .., chunk c]^T: per 64 hidden columns j, the
        // unit's 512 rows in four slots; slots 2 wg and 2 wg + 1 are this
        // warpgroup's (acc[0] and acc[1]), the other two it passes by
        i8w::named_barrier(h_barrier(1 - wg, hc + c), 128 * NC);  // the other half of h[c]
        for (int j = 0; j < 2; ++j) {
          const uint64_t da = i8w::desc_sw128(hbuf(c) + j * XBLK);
          for (int pair = 0; pair < NC; ++pair) {
            if (pair != wg) {  // the producer released these for this warpgroup
              cons.ring.advance();
              cons.ring.advance();
              continue;
            }
            int s = cons.next();
            uint64_t db = i8w::desc_sw128(ws + (size_t)s * SLOT);
            i8w::wgmma_fence();
#pragma unroll
            for (int k = 0; k < BK / 32; ++k)
              mma_n128(acc[0], da + 2 * k, db + 2 * k, (c | j | k) != 0);
            i8w::wgmma_commit();
            cons.issued(s);
            if (j == 0 && next) {  // chunk c + 1's first product has retired
              fence_acc(a1);
              if (c + 1 == nh - 1 && lane == 0) i8w::mbar_arrive(xempty);
              finish_h(c + 1);
            }
            s = cons.next();
            db = i8w::desc_sw128(ws + (size_t)s * SLOT);
            i8w::wgmma_fence();
#pragma unroll
            for (int k = 0; k < BK / 32; ++k)
              mma_n128(acc[1], da + 2 * k, db + 2 * k, (c | j | k) != 0);
            i8w::wgmma_commit();
            cons.issued(s);
          }
        }
      }
      cons.drain();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      hc += nh;

      // out = bf16(acc + b2), masked past M and N
      const bool vec = N % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
      store_out(out, acc[0], b2, m0 + 16 * warp, n0 + 256 * wg, M, N, vec);
      store_out(out, acc[1], b2, m0 + 16 * warp, n0 + 256 * wg + 128, M, N, vec);
    }
  }
}

// the band, the h buffers, the ring and its barriers, the band's two
// barriers, the h buffers' b1
int bf16_smem_bytes(int K, int stages) {
  const int nk = (2 * K + BK - 1) / BK;
  return i8w::SMEM_ALIGN + nk * XBLK + HBUFS * HBUF + stages * (SLOT + 16) + 16 +
         HBUFS * BH * 4;
}

int launch_bf16(const void* x, const void* w1, const float* b1, const void* w2,
                const float* b2, void* out, int M, int K, int H, int N, int stages, int grid,
                int smem, cudaStream_t stream) {
  static int allowed = 0;
  CUtensorMap mx, mw1, mw2;  // bf16 rows as bytes: 128-byte boxes of K (of H for w2)
  if (!i8w::kmajor_map(&mx, x, M, 2 * K, BM) || !i8w::kmajor_map(&mw1, w1, H, 2 * K, SLOT_ROWS) ||
      !i8w::kmajor_map(&mw2, w2, N, 2 * H, SLOT_ROWS))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = i8w::allow_smem(ffn_wgmma_kernel, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  ffn_wgmma_kernel<<<grid, NT, smem, stream>>>(mx, mw1, mw2, b1, b2,
                                               static_cast<__nv_bfloat16*>(out), M, K, H, N,
                                               stages);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- float32

constexpr int F_NT = 256;
constexpr int F_BM = 16;              // rows of x a block
constexpr int F_BH = 256;             // hidden columns a chunk
constexpr int F_NG = 512;             // output columns a block
constexpr int F_BN = 128;             // output columns a tile
constexpr int F_CHUNK = 64;           // bytes of K per weight stage row
constexpr int F_LDW = F_CHUNK + 16;   // padded row stride of a weight stage
constexpr int F_WSTAGE = F_BN * F_LDW;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

// weight rows [n0, n0 + 128) x bytes [b0, b0 + 64) of an (N, ld bytes) matrix
__device__ __forceinline__ void load_w(char* dst, const char* w, int N, int ld, int n0,
                                       int b0) {
#pragma unroll
  for (int i = 0; i < (F_BN * F_CHUNK / 16) / F_NT; ++i) {
    const int c = threadIdx.x + i * F_NT;
    const int r = c / (F_CHUNK / 16), col = (c % (F_CHUNK / 16)) * 16;
    const bool ok = n0 + r < N;
    const char* g = ok ? w + (int64_t)(n0 + r) * ld + b0 + col : w;
    cp_async16(dst + r * F_LDW + col, g, ok);
  }
}

// 16 rows x 128 columns of float32 sums; thread (r, c0) owns row r,
// columns c0 + 16 j
struct Tile {
  float acc[8];
  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  }
  // sA: the block's rows (row stride lda bytes) at this stage's k bytes
  __device__ void step(const char* sA, int lda, const char* sW) {
    const int r = threadIdx.x >> 4, c0 = threadIdx.x & 15;
    const float* a = reinterpret_cast<const float*>(sA + r * lda);
#pragma unroll
    for (int k = 0; k < F_CHUNK / 4; ++k) {
      const float av = a[k];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[j] = fmaf(av, reinterpret_cast<const float*>(sW + (c0 + 16 * j) * F_LDW)[k], acc[j]);
    }
  }
  template <typename F>
  __device__ void each(F f) {
    const int r = threadIdx.x >> 4, c0 = threadIdx.x & 15;
#pragma unroll
    for (int j = 0; j < 8; ++j) f(r, c0 + 16 * j, acc[j]);
  }
};

// store(row, n, relu?(sA w^T + bias)) for n < N: the (F_BM, kbytes) rows
// in shared memory, w (N rows of ld bytes, the first kbytes summed) in
// device memory, bias optional
template <typename Store>
__device__ void gemm_rows(const char* sA, int lda, const float* w, int N, int ld, int kbytes,
                          const float* bias, bool relu, char* sW, Store store) {
  const int nk = kbytes / F_CHUNK;
  const int steps = ((N + F_BN - 1) / F_BN) * nk;
  const char* wb = reinterpret_cast<const char*>(w);
  Tile tile;
  tile.zero();
  load_w(sW, wb, N, ld, 0, 0);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int s = 0; s < steps; ++s) {
    const int kt = s % nk, n0 = (s / nk) * F_BN;
    if (s + 1 < steps)
      load_w(sW + ((s + 1) & 1) * F_WSTAGE, wb, N, ld, ((s + 1) / nk) * F_BN,
             ((s + 1) % nk) * F_CHUNK);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    tile.step(sA + kt * F_CHUNK, lda, sW + (s & 1) * F_WSTAGE);
    __syncthreads();  // the next step's copies overwrite this stage
    if (kt == nk - 1) {
      tile.each([&](int row, int col, float v) {
        const int n = n0 + col;
        if (n >= N) return;
        if (bias) v = __fadd_rn(v, bias[n]);
        if (relu) v = fmaxf(v, 0.f);
        store(row, n, v);
      });
      tile.zero();
    }
  }
}

__global__ void __launch_bounds__(F_NT)
ffn_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, float* __restrict__ out, int M, int K, int H,
               int N) {
  extern __shared__ __align__(16) char smem[];
  const int ldx = K * 4 + 16, ldh = F_BH * 4 + 16;
  char* sX = smem;                                          // F_BM x ldx: rows of x
  char* sH = sX + F_BM * ldx;                               // F_BM x ldh: a hidden chunk
  float* sO = reinterpret_cast<float*>(sH + F_BM * ldh);    // F_BM x F_NG: out sums
  char* sW = reinterpret_cast<char*>(sO + F_BM * F_NG);     // two weight stages
  const int groups = (N + F_NG - 1) / F_NG;
  const int m0 = blockIdx.x / groups * F_BM, n0 = blockIdx.x % groups * F_NG;
  const int nn = min(F_NG, N - n0);

  const int xrow = K * 4 / 16;  // 16-byte pieces per row
  for (int i = threadIdx.x; i < F_BM * xrow; i += F_NT) {
    const int r = i / xrow, c = (i % xrow) * 16;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (m0 + r < M)
      v = *reinterpret_cast<const uint4*>(reinterpret_cast<const char*>(x) +
                                          (int64_t)(m0 + r) * K * 4 + c);
    *reinterpret_cast<uint4*>(sX + r * ldx + c) = v;
  }
  for (int i = threadIdx.x; i < F_BM * F_NG; i += F_NT) sO[i] = 0.f;
  __syncthreads();

  for (int h0 = 0; h0 < H; h0 += F_BH) {
    const int hn = min(F_BH, H - h0);
    gemm_rows(sX, ldx, w1 + (int64_t)h0 * K, hn, K * 4, K * 4, b1 + h0, true, sW,
              [&](int row, int n, float v) {
                reinterpret_cast<float*>(sH + row * ldh)[n] = v;
              });
    __syncthreads();
    gemm_rows(sH, ldh, w2 + (int64_t)n0 * H + h0, nn, H * 4, hn * 4, nullptr, false, sW,
              [&](int row, int n, float v) { sO[row * F_NG + n] += v; });
    __syncthreads();
  }
  for (int i = threadIdx.x; i < F_BM * nn; i += F_NT) {
    const int r = i / nn, n = i % nn;
    if (m0 + r < M) out[(int64_t)(m0 + r) * N + n0 + n] = __fadd_rn(sO[r * F_NG + n], b2[n0 + n]);
  }
}

int f32_smem_bytes(int K) {
  return F_BM * (K * 4 + 16) + F_BM * (F_BH * 4 + 16) + F_BM * F_NG * 4 + 2 * F_WSTAGE;
}

}  // namespace

// Plain C entry point, called through ctypes.  x (M, K), w1 (H, K), w2
// (N, H) and out (M, N) contiguous in dtype 0 = float32 or 1 = bfloat16;
// b1 (H,) and b2 (N,) float32; x, w1, w2 and b1 16-byte aligned.  The plan
// (stages, grid, smem) is ops/ffn.py `ffn_plan`'s.  Returns
// cudaGetLastError() (0 on success); cudaErrorInvalidValue (1) when K or H
// is not a multiple of 32, the dtype is another, an operand is misaligned,
// the plan is not one this kernel runs (bf16: 4-12 stages, shared bytes as
// bf16_smem_bytes within the limit; float32: 2 stages, one block per 16
// rows and 512 columns, shared bytes as f32_smem_bytes within the limit) or
// a tensor map cannot be encoded.
extern "C" int ffn_forward(const void* x, int dtype, const void* w1, const float* b1,
                           const void* w2, const float* b2, void* out, int M, int K, int H,
                           int N, int stages, int grid, int smem, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (K <= 0 || H <= 0 || K % 32 || H % 32 || grid < 1) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w1) |
       reinterpret_cast<uintptr_t>(w2) | reinterpret_cast<uintptr_t>(b1)) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    const int blocks = (M + F_BM - 1) / F_BM * ((N + F_NG - 1) / F_NG);
    if (stages != 2 || grid != blocks || smem != f32_smem_bytes(K) ||
        smem > i8w::MAX_SMEM)
      return (int)cudaErrorInvalidValue;
    static int allowed = 0;
    const cudaError_t err = i8w::allow_smem(ffn_f32_kernel, smem, allowed);
    if (err != cudaSuccess) return (int)err;
    ffn_f32_kernel<<<grid, F_NT, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1), b1,
        static_cast<const float*>(w2), b2, static_cast<float*>(out), M, K, H, N);
    return (int)cudaGetLastError();
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (stages < MIN_STAGES || stages > MAX_STAGES || smem != bf16_smem_bytes(K, stages) ||
      smem > i8w::MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  return launch_bf16(x, w1, b1, w2, b2, out, M, K, H, N, stages, grid, smem, st);
}
