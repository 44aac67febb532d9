// The int8 mainloop shared by csrc/int8_gemm.cu and csrc/qmm.cu, for Hopper
// (sm_90a): TMA loads into a ring of 128-byte-swizzled shared stages under
// mbarriers, one producer thread, consumer warpgroups issuing
// wgmma.mma_async ... .s32.s8.s8, and a persistent grid of one block per SM.
//
// Layout.  Both operands are K-major int8: A (rows, K) and B (N, K), the
// nn.Linear layout, which is the only layout wgmma takes for integer types.
// A stage holds BK = 128 bytes of K for a tile's rows: TMA writes each row
// as 128 bytes with CU_TENSOR_MAP_SWIZZLE_128B (16-byte chunk c of row r at
// chunk c ^ (r % 8)), every tile 1024-byte aligned, so the wgmma descriptor
// is the 128B-swizzle K-major one (8-row groups 1024 bytes apart) and the
// four k32 steps of a stage advance its start address by 32 bytes.  TMA
// zero-fills a box past the tensor's rows or K, and int8 zeros add nothing
// to the int32 sums: ragged M, N and K (37 rows, N = 8404, K = 560 or 16)
// need no padding.  qmm writes its quantized band in the same layout with
// generic stores (swizzle_offset) and fences it into the async proxy.
//
// Roles.  Warpgroups 0 .. NC-1 consume (the int32 accumulator in
// registers: m64nBNk32 is BN / 2 registers a thread per 64 rows),
// warpgroup NC produces: one thread issues every TMA load, the rest exit
// after giving up registers (setmaxnreg).  full[s] completes when the
// stage's bytes have landed, empty[s] when every consumer warp that reads
// the stage has finished with it.  A consumer keeps one wgmma group in
// flight and releases a stage one k-step late.  The producer runs ahead
// into the next tile while the consumers write the current one: that
// overlap is what a persistent grid buys over one block per tile.
//
// Every mbarrier wait carries a watchdog: a wait that lasts about 10 s (a
// plan the kernel cannot run, a lost load) traps, so a fault ends the
// launch with an error instead of hanging the card.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace i8w {

constexpr int BK = 128;                   // bytes of K per stage: one swizzle row
constexpr int MAX_SMEM = 232448;          // dynamic shared memory a block can have
constexpr int SMEM_ALIGN = 1024;          // a 128B-swizzle tile's alignment
constexpr long long WATCHDOG = 20000000000LL;  // clock64 cycles, about 10 s

// ---------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* align_smem(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + ((SMEM_ALIGN - (a & (SMEM_ALIGN - 1))) & (SMEM_ALIGN - 1));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.b32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > WATCHDOG) __trap();
}

// generic-proxy writes to shared memory made visible to wgmma and TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// box (BK bytes of K at x, rows from y) of a 2-D map into `dst`, counted on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y)
      : "memory");
}

// Ask L2 to fetch `bytes` (a multiple of 16) from the 16-byte aligned p,
// with no register or barrier of the caller's waiting on it.
__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p), "r"(bytes) : "memory");
}

template <int REGS>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// Byte offset of (row, byte c) in a tile of 128-byte rows under the 128B
// swizzle that TMA applies and the descriptor below reads.
__device__ __forceinline__ uint32_t swizzle_offset(int row, int c) {
  return row * BK + ((((c >> 4) ^ row) & 7) << 4) + (c & 15);
}

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows, 128B
// swizzle: start address >> 4 (bits 0-13), leading offset 1 (bits 16-29;
// unused by the swizzled layouts), stride offset 1024 bytes between 8-row
// groups (bits 32-45), base offset 0 (1024-aligned tiles), layout type 1 =
// SWIZZLE_128B (bits 62-63).
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across a wgmma
template <int H, int R>
__device__ __forceinline__ void fence_acc(int (&d)[H][R]) {
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[h][i])::"memory");
}

#define I8W_R8(i)                                                                     \
  "+r"(d[(i) + 0]), "+r"(d[(i) + 1]), "+r"(d[(i) + 2]), "+r"(d[(i) + 3]),             \
      "+r"(d[(i) + 4]), "+r"(d[(i) + 5]), "+r"(d[(i) + 6]), "+r"(d[(i) + 7])
#define I8W_R32(i) I8W_R8(i), I8W_R8((i) + 8), I8W_R8((i) + 16), I8W_R8((i) + 24)

// d (+)= A (64 x 32 int8, desc a) . B (BN x 32 int8, desc b)^T, int32;
// scale_d = 0 starts the sum
template <int BN>
struct Mma;

template <>
struct Mma<64> {
  __device__ __forceinline__ static void run(int (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p;\n}\n"
        : I8W_R32(0)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Mma<128> {
  __device__ __forceinline__ static void run(int (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
        "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63}, %64, %65, p;\n}\n"
        : I8W_R32(0), I8W_R32(32)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Mma<256> {
  __device__ __forceinline__ static void run(int (&d)[128], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
        "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "
        "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
        "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, "
        "%106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
        "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p;\n}\n"
        : I8W_R32(0), I8W_R32(32), I8W_R32(64), I8W_R32(96)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

#undef I8W_R32
#undef I8W_R8

// A ring of `stages` shared stages with a full and an empty barrier each,
// and one role's position in it.  Both roles walk the same sequence of
// stages; the producer waits on empty with the opposite parity, so its
// first pass over the ring does not wait.
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  int stages;
  int stage = 0;
  uint32_t phase = 0;

  __device__ __forceinline__ void advance() {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// Sum one output tile over nk stages: the consumer side of the ring.  The
// warpgroup owns H x 64 rows: a_tile(stage, kb) is its first 64 x 128-byte
// A tile for k-block kb (the next one 64 rows on), b_stages the ring's B
// tiles (BN x 128 bytes each); acc[h] sums rows 64 h .. 64 h + 63.  Each
// stage is released one k-step late, once the next stage's wgmma group is
// issued and the group reading it has retired; each warp arrives once.
template <int BN, int H, class ATile>
__device__ __forceinline__ void mma_tile(int (&acc)[H][BN / 2], int nk, Ring& ring,
                                         ATile a_tile, const uint8_t* b_stages) {
  const bool arrives = (threadIdx.x & 31) == 0;
  int held = -1;
  fence_acc(acc);
  for (int kb = 0; kb < nk; ++kb) {
    const int s = ring.stage;
    mbar_wait(&ring.full[s], ring.phase);
    const uint64_t da = desc_sw128(a_tile(s, kb));
    const uint64_t db = desc_sw128(b_stages + (size_t)s * BN * BK);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 32; ++k)  // 32 bytes of K = 2 in the descriptor's units
#pragma unroll
      for (int h = 0; h < H; ++h)  // 64 rows of 128 bytes = 512 units on
        Mma<BN>::run(acc[h], da + 512 * h + 2 * k, db + 2 * k, (kb | k) != 0);
    wgmma_commit();
    wgmma_wait<1>();
    if (held >= 0 && arrives) mbar_arrive(&ring.empty[held]);
    held = s;
    ring.advance();
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (held >= 0 && arrives) mbar_arrive(&ring.empty[held]);
}

// The tile's BN per-column values src[n0 ..] (0 past N) into shared
// memory, shared out over one consumer warpgroup: the epilogue then reads
// them from shared memory instead of waiting on device memory between its
// stores.
template <int BN>
__device__ __forceinline__ void stage_cols(float* dst, const float* __restrict__ src, int n0,
                                           int N) {
  for (int i = threadIdx.x & 127; i < BN; i += 128)
    dst[i] = n0 + i < N ? __ldg(src + n0 + i) : 0.f;
}

// The epilogue's staging: each consumer warp owns 16 rows of its
// warpgroup's 64 and drains them 32 columns at a time through a private
// 16 x 32 int32 buffer (rows padded to STAGE_LD words, so the 8-byte writes
// of the accumulator layout and the 16-byte reads are free of bank
// conflicts).  Read back, each lane holds 4 consecutive columns of a row
// and 8 lanes cover 128 bytes of it: every load of res / add and every
// store of out is a 16-byte access, and a warp's access covers whole
// 128-byte lines (float32) instead of 32-byte pieces of 8 rows.
constexpr int STAGE_LD = 40;                       // words per staged row
constexpr int STAGE_WARP_BYTES = 16 * STAGE_LD * 4;  // one warp's buffer

// Drain this warp's 16 x BN accumulator rows: for each chunk of 32 columns,
// emit(c0, q) gets q[i] = acc[row 4 i + lane / 8][columns c0 + 4 (lane % 8)
// .. + 3] (tile-local, row 0 = the warp's first).  The accumulator register
// 4 j + 2 h + c of lane (g = lane / 4, t = lane % 4) is row g + 8 h, column
// 8 j + 2 t + c: the mma.sync m16n8 layout tiled along N.
template <int BN, class Emit>
__device__ __forceinline__ void drain_tile(const int (&acc)[BN / 2], int* stage, Emit emit) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += 4) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<int2*>(stage + (g + 8 * h) * STAGE_LD + 8 * j + 2 * t) =
            make_int2(acc[4 * (j0 + j) + 2 * h], acc[4 * (j0 + j) + 2 * h + 1]);
    __syncwarp();
    int4 q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      q[i] = *reinterpret_cast<const int4*>(stage + (4 * i + (lane >> 3)) * STAGE_LD +
                                            4 * (lane & 7));
    __syncwarp();  // the next chunk overwrites the buffer
    emit(8 * j0, q);
  }
}

// x[i .. i + 3] as float32 (0 past N - n): one 16-byte (float32) or
// 8-byte (bf16) load where `vec` and all four are in range
__device__ __forceinline__ float4 load4(const float* x, int64_t i, int n, int N, bool vec) {
  if (vec && n + 3 < N) return *reinterpret_cast<const float4*>(x + i);
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = n + k < N ? x[i + k] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* x, int64_t i, int n, int N,
                                        bool vec) {
  if (vec && n + 3 < N) {
    const uint2 u = *reinterpret_cast<const uint2*>(x + i);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = n + k < N ? __bfloat162float(x[i + k]) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// out[i .. i + 3] = v (the first N - n of them), rounding to nearest even
// for bf16: one 16- or 8-byte store where `vec` and all four are in range
__device__ __forceinline__ void store4(float* out, int64_t i, int n, int N, const float (&v)[4],
                                       bool vec) {
  if (vec && n + 3 < N) {
    *reinterpret_cast<float4*>(out + i) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (n + k < N) out[i + k] = v[k];
}

__device__ __forceinline__ void store4(__nv_bfloat16* out, int64_t i, int n, int N,
                                       const float (&v)[4], bool vec) {
  if (vec && n + 3 < N) {
    const __nv_bfloat162 a =
        __halves2bfloat162(__float2bfloat16_rn(v[0]), __float2bfloat16_rn(v[1]));
    const __nv_bfloat162 b =
        __halves2bfloat162(__float2bfloat16_rn(v[2]), __float2bfloat16_rn(v[3]));
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&a);
    u.y = *reinterpret_cast<const uint32_t*>(&b);
    *reinterpret_cast<uint2*>(out + i) = u;
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (n + k < N) out[i + k] = __float2bfloat16_rn(v[k]);
}

// ---------------------------------------------------------- the A producer
//
// The band producer of qmm and of the int8 GEMM's row-quantizing entry: a
// consumer warpgroup turns its 64 rows of the float A (float32 or bf16,
// row stride ldx) into int8 in shared memory, in the 128B-swizzled K-major
// layout that TMA gives the mainloop.  For one row y of width K
// (csrc/rowquant.cu and its twin ops/rowquant.py, form "mul"):
//
//   scale = max(max|y|, 1e-8) * f32(1/127)
//   q     = clip(rint(y / scale), -127, 127)          (half to even)
//
// every float32 step an _rn intrinsic and the quotient rounded as the IEEE
// division rounds it (quantize_vec), so the bits are the twin's.

// 16 bytes of A as float32 values: 8 bf16 or 4 float32
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

__device__ __forceinline__ uint32_t pack4(const int q[4]) {
  return (uint32_t)(q[0] & 0xff) | ((uint32_t)(q[1] & 0xff) << 8) |
         ((uint32_t)(q[2] & 0xff) << 16) | ((uint32_t)(q[3] & 0xff) << 24);
}

// q[i] = clip(rint(y[i] / sc), -127, 127), the quotient rounded as IEEE
// division rounds it, for the V values of every lane of a warp (all lanes
// call it together): y * rsc (rsc = 1 / sc, correctly rounded) is within
// 2^-23 relative of y / sc, so within 1.9e-5 of the rounded quotient for
// |y / sc| <= 127 (|y| <= absmax), and the two round to the same integer
// unless one lies within 3.1e-5 of a half-integer.  Where any lane of the
// warp has such a value the warp takes the division for these V values (a
// warp-uniform branch, rarely taken); otherwise the product decides.
template <int V>
__device__ __forceinline__ void quantize_vec(const float (&y)[V], float sc, float rsc,
                                             int (&q)[V]) {
  float qa[V];
  bool near = false;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    qa[i] = __fmul_rn(y[i], rsc);
    near |= fabsf(__fsub_rn(__fsub_rn(qa[i], floorf(qa[i])), 0.5f)) < 3.0517578125e-05f;
  }
  if (__any_sync(0xffffffffu, near)) {
#pragma unroll
    for (int i = 0; i < V; ++i) qa[i] = __fdiv_rn(y[i], sc);
  }
#pragma unroll
  for (int i = 0; i < V; ++i) q[i] = (int)fminf(fmaxf(rintf(qa[i]), -127.f), 127.f);
}

// 16 bytes of A (a 16-byte aligned p) as raw bits, and as V float32 values
__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[Vec<T>::N]) {
  if constexpr (Vec<T>::N == 4) {
    v[0] = __uint_as_float(u.x), v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z), v[3] = __uint_as_float(u.w);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  }
}

// The rows held in registers as float32: NV 16-byte vectors a lane (K <=
// 32 NV V) and groups of two rows, the next group's loads in flight while
// this one is reduced and quantized, so every row is read from device
// memory once and a row's chain of latencies (load, warp reduction)
// overlaps the next group's loads.  The quantize is quantize_vec's: an IEEE division per value would
// take about half of this function's time.
template <typename T, int BM, int NV>
__device__ __forceinline__ void quantize_rows_held(const T* __restrict__ x, long long ldx,
                                                   uint8_t* band, float* scale, int m0, int r0,
                                                   int M, int K) {
  constexpr int V = Vec<T>::N;
  constexpr int R = 2;  // rows of a group
  const int warp = (threadIdx.x & 127) >> 5, lane = threadIdx.x & 31;
  const int rw = r0 + warp * 16;
  // the group of R rows from warp row g, as float32 (zeros past M or K)
  auto load = [&](float (&y)[R][NV][V], int g) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int m = m0 + rw + g + j;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int c = (k * 32 + lane) * V;
        uint4 u = make_uint4(0, 0, 0, 0);
        if (g + j < 16 && m < M && c < K) u = load16(x + (int64_t)m * ldx + c);
        unpack<T>(u, y[j][k]);
      }
    }
  };
  auto quantize = [&](float (&y)[R][NV][V], int g) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (g + j >= 16) break;
      const int r = rw + g + j, m = m0 + r;
      float amax = 0.f;
#pragma unroll
      for (int k = 0; k < NV; ++k)
#pragma unroll
        for (int i = 0; i < V; ++i) amax = fmaxf(amax, fabsf(y[j][k][i]));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      const float sc = __fmul_rn(fmaxf(amax, 1e-8f), (float)(1.0 / 127.0));
      const float rsc = __frcp_rn(sc);
      const bool live = m < M;
#pragma unroll
      for (int k = 0; k < NV; ++k) {  // every lane: quantize_vec votes across the warp
        const int c = (k * 32 + lane) * V;
        int q[V];
        quantize_vec<V>(y[j][k], sc, rsc, q);
        if (!live)
#pragma unroll
          for (int i = 0; i < V; ++i) q[i] = 0;
        if (c >= K) continue;
        uint8_t* p = band + (size_t)(c / BK) * BM * BK + swizzle_offset(r, c % BK);
        if constexpr (V == 8)
          *reinterpret_cast<uint2*>(p) = make_uint2(pack4(q), pack4(q + 4));
        else
          *reinterpret_cast<uint32_t*>(p) = pack4(q);
      }
      if (lane == 0) scale[r] = live ? sc : 0.f;
    }
  };
  float ya[R][NV][V], yb[R][NV][V];  // two groups in flight
  load(ya, 0);
  for (int g = 0; g < 16; g += 2 * R) {
    load(yb, g + R);
    quantize(ya, g);
    load(ya, g + 2 * R);
    quantize(yb, g + R);
  }
}

// Quantize this warpgroup's 64 rows of the band at global row m0 into the
// band's k-blocks (BM rows of 128 bytes each; tile row offset r0 = 64 wg),
// scales into scale[r0 ..]; each warp takes 16 rows.  Rows past M quantize
// to zeros with scale 0; columns K .. Kp - 1 are zeros.  x + m * ldx is
// row m; K a multiple of 16, x and ldx * sizeof(T) 16-byte aligned.  Rows
// of up to 512 values (768 bf16: qmm's 560 at encoders0) are held in
// registers (quantize_rows_held); longer ones are read once per pass.
template <typename T, int BM>
__device__ __forceinline__ void quantize_rows(const T* __restrict__ x, long long ldx,
                                              uint8_t* band, float* scale, int m0, int r0,
                                              int M, int K, int Kp) {
  constexpr int V = Vec<T>::N;
  const int warp = (threadIdx.x & 127) >> 5, lane = threadIdx.x & 31;
  bool held = true;
  if (K <= 512) {
    quantize_rows_held<T, BM, 512 / (32 * V)>(x, ldx, band, scale, m0, r0, M, K);
  } else if constexpr (V == 8) {  // bf16 rows of 560 (qmm at encoders0)
    if (K <= 768)
      quantize_rows_held<T, BM, 3>(x, ldx, band, scale, m0, r0, M, K);
    else
      held = false;
  } else {
    held = false;
  }
  for (int r = r0 + warp * 16; r < r0 + warp * 16 + 16; ++r) {
    const int m = m0 + r;
    // byte c of row r in k-block c / 128
    auto at = [&](int c) {
      return band + (size_t)(c / BK) * BM * BK + swizzle_offset(r, c % BK);
    };
    if (held) {
      // quantize_rows_held wrote the row and its scale
    } else if (m < M) {
      const T* xr = x + (int64_t)m * ldx;
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
        // V bytes at c (a multiple of V) stay inside one 16-byte chunk
        if (V == 8)
          *reinterpret_cast<uint2*>(at(c)) = make_uint2(pack4(q), pack4(q + 4));
        else
          *reinterpret_cast<uint32_t*>(at(c)) = pack4(q);
      }
      if (lane == 0) scale[r] = sc;
    } else {
      for (int c = lane * 16; c < K; c += 32 * 16)
        *reinterpret_cast<uint4*>(at(c)) = make_uint4(0, 0, 0, 0);
      if (lane == 0) scale[r] = 0.f;
    }
    for (int c = K + lane * 16; c < Kp; c += 32 * 16)  // zero columns past K
      *reinterpret_cast<uint4*>(at(c)) = make_uint4(0, 0, 0, 0);
  }
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point: the
// library then needs no link against libcuda.  Looked up once.
static EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Map of a (rows, K) int8 row-major matrix, boxes of 128 bytes of K by
// box_rows rows, 128B swizzle, zero fill out of bounds.  K % 16 == 0 and a
// 16-byte aligned base are TMA's rules (the wrappers check them).
static bool encode_kmajor(CUtensorMap* map, const void* base, int rows, int K, int box_rows) {
  const EncodeTiled fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// encode_kmajor through a small cache keyed by its arguments: a weight's
// map is the same at every call, and PyTorch's caching allocator hands the
// activations the same addresses again, so most launches skip the encode.
// A map depends only on its arguments, so a hit is always the right map.
static bool kmajor_map(CUtensorMap* map, const void* base, int rows, int K, int box_rows) {
  struct Entry {
    const void* base;
    int rows, K, box_rows;
    CUtensorMap map;
  };
  constexpr int SLOTS = 128;
  static Entry cache[SLOTS] = {};
  static std::mutex lock;
  const uintptr_t key = (uintptr_t)base;
  const int slot = (int)(((key >> 8) ^ (key >> 20) ^ (uintptr_t)rows * 131 ^
                          (uintptr_t)box_rows) % SLOTS);
  std::lock_guard<std::mutex> guard(lock);
  Entry& e = cache[slot];
  if (e.base != base || e.rows != rows || e.K != K || e.box_rows != box_rows) {
    if (!encode_kmajor(&e.map, base, rows, K, box_rows)) {
      e.base = nullptr;
      return false;
    }
    e.base = base, e.rows = rows, e.K = K, e.box_rows = box_rows;
  }
  *map = e.map;
  return true;
}

// The current device's SM count, read once per device.
static int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!cached[dev]) cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev];
}

// Raise a kernel's dynamic shared memory limit once per size.
template <class Kernel>
static cudaError_t allow_smem(Kernel kernel, int bytes, int& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

}  // namespace i8w
