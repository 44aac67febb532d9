// CTC prefix scoring for Hopper (sm_90a), float32: the beam's whole prefix
// step in one launch, and the frame recurrence alone.
//
// Replaces the TPU kernel funasr_tpu/ops/ctc_prefix_pallas.py `_kernel`
// (:47, called through `ctc_recurrence` :105) together with the XLA prologue
// that funasr_tpu/ops/beam_search.py `ctc_prefix_step` (:125) fuses around
// it.  For every row (b, k, w) of the (B, K, W) candidate slots and every
// frame t, with both carries starting at NEG_INF = -1e10 (finite):
//
//   r_nb[t] = xg[t] + lse(r_nb[t-1], phi[t])
//   r_b[t]  = xb[t] + lse(r_b[t-1],  r_nb[t-1])
//   lse(a, b) = m + log(exp(a - m) + exp(b - m)),  m = max(max(a, b), NEG_INF)
//
// Two entries share the kernel and differ only in what the producer stages:
//
// - `ctc_prefix_step_forward`, the beam's step.  xg[b,k,w,:] is the row
//   x_t[b, cand[b,k,w], :] of the time-minor (B, V, T) log-probs, xb the row
//   x_t[b, blank, :], and phi comes from the prefix state r_prev (B, K, T, 2):
//   phi[0] = prefix_empty ? 0 : NEG_INF, and for t >= 1
//   phi[t] = cand == last ? r_prev[b,k,t-1,1] : phi_all[b,k,t-1],
//   phi_all = lse(r_prev[..., 0], r_prev[..., 1]).  It writes r_new
//   (B, K, W, T, 2) and sigma = lse(r_nb[T-1], r_b[T-1]) (B, K, W).
// - `ctc_prefix_forward`, the Pallas kernel's own contract: xg and
//   phi_shift (R, T), xb (R / rows_per_b, T) -> (R, T, 2).
//
// Each step is a separate IEEE operation in the order above: accurate
// expf/logf, no fast math, `__fadd_rn`/`__fsub_rn` so that nothing is
// contracted into an FMA.  The plain twins (ops/ctc_prefix.py
// `ctc_prefix_step_ref`, `ctc_recurrence_ref`) run the same operations as
// PyTorch elementwise kernels, whose float32 exp/log are the same expf/logf,
// so kernel and twin agree bit for bit.  No parallel scan over T: it would
// change the rounding.
//
// Floors.  Bytes: the gathered rows, r_prev, xb, cand and last read once,
// r_new and sigma written once, about 25 MB at the beam's B=32 x 15 s step
// (K=10, W=16, T=383), 7.3 us at 3.35 TB/s.  Chain: every frame waits on
// the last (max, max, sub, expf, add, logf, add, add), so a row takes T
// times that latency however many SMs run; `ctc_chain_floor` times it alone,
// in one warp with its operands in registers.  The chain floor is the real
// one: the serial chain never reaches the byte bound.
//
// Design, so that the chain waits on nothing but its own arithmetic:
// - A block owns whole hypotheses: 32 rows, one chain warp, a lane a row
//   (W = 16: 2 hypotheses; W = 1: 32; W > 32: a 32-candidate slice of one),
//   so the beam's shape gives 160 blocks over the 132 SMs.
// - Roles.  The chain warp reads only shared memory, runs the lse chain and
//   writes its results to shared memory.  A producer warp stages the next
//   frame tile (TT frames) ahead of it: the gathered xg rows, the two r_prev
//   rows of each hypothesis and xb by 4-byte `cp.async` (T is rarely a
//   multiple of 4, so wider copies would not be aligned), then phi_all, once
//   per hypothesis and frame (not once per candidate), and r_b shifted by
//   one frame into per-hypothesis tiles; each lane picks its phi from those
//   by its `cand == last` flag.  A store warp drains finished (32, TT, 2)
//   output tiles to device memory, coalesced, while the chain runs the next
//   tile, and the chain writes sigma in its epilogue.  Two stages of each
//   ring; the roles meet on named barriers (`bar.sync`/`bar.arrive`), never
//   a block-wide `__syncthreads`.  No (B, K, W, T) intermediate reaches
//   device memory.
// - Row strides of TT+1 and 2*TT+1 words keep the lanes' column accesses
//   free of bank conflicts; a hypothesis tile is read as a broadcast.
// - The frame loop is unrolled 8 times, not over the whole tile: a frame is
//   about 130 instructions, and one warp running a 32-frame straight line
//   of them (66 KB of code) measured far slower than the same chain in a
//   short loop.  Frame j + 1's operands are read before frame j's results
//   are stored.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TT = 32;            // frames per staged tile
constexpr int ROWS = 32;          // rows per block: one chain warp
constexpr int PAD = TT + 1;       // row stride of an input tile, words
constexpr int OPAD = 2 * TT + 1;  // row stride of an output tile, words
constexpr int IN_TILE = ROWS * PAD;
constexpr int RAW_TILE = ROWS * 2 * TT;
// one stage: xg rows, phi_all, r_b and xb tiles, then the raw r_prev pairs
constexpr int STAGE = 4 * IN_TILE + RAW_TILE;
constexpr int OUT_TILE = ROWS * OPAD;
constexpr size_t SMEM_BYTES = sizeof(float) * (2 * STAGE + 2 * OUT_TILE);
constexpr float NEG_INF = -1e10f;
constexpr unsigned FULL_MASK = 0xffffffffu;
// named barriers: stage s of each ring; 0 is __syncthreads'
constexpr int BAR_FULL = 1, BAR_EMPTY = 3, BAR_OFULL = 5, BAR_OEMPTY = 7;

__device__ __forceinline__ float lse(float a, float b) {
  const float m = fmaxf(fmaxf(a, b), NEG_INF);
  return __fadd_rn(m, logf(__fadd_rn(expf(__fsub_rn(a, m)), expf(__fsub_rn(b, m)))));
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  __threadfence_block();
  asm volatile("bar.arrive %0, 64;" ::"r"(id) : "memory");
}

// 4-byte async copy; zero-fills (and reads nothing) when !ok
__device__ __forceinline__ void cp4(float* dst, const float* src, const float* safe, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(ok ? src : safe), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_all;" ::: "memory"); }

struct Params {
  // the step: x_t (B, V, T); r_prev (B, K, T, 2) with hypothesis strides
  // sB, sK (floats) and contiguous (t, 2) pairs; last (B, K) and cand
  // (B, K, W) with strides (lB, lK) and (cB, cK, cW) (elements)
  const float* x_t;
  const float* r_prev;
  const int64_t* last;
  const int64_t* cand;
  int64_t sB, sK, lB, lK, cB, cK, cW;
  int V, blank;
  float phi0;
  // the recurrence (W = 1, a "hypothesis" is a row): xg, phi (R, T), xb (R / K, T)
  const float* xg;
  const float* phi;
  const float* xb;
  int H, K, W, T;  // hypotheses, hypotheses per batch item, rows each, frames
  float* out;      // (H * W, T, 2)
  float* sigma;    // (H * W), the step only
};

// The block's rows: lanes [0, nrows) hold rows row0 + lane; lane i belongs
// to hypothesis hyp0 + i / Wb.
struct Block {
  int hyp0, nh, nrows, Wb;
  int64_t row0;
};

__device__ __forceinline__ Block block_rows(const Params& p) {
  Block bk;
  bk.Wb = p.W < ROWS ? p.W : ROWS;
  const int hpb = ROWS / bk.Wb, chunks = (p.W + ROWS - 1) / ROWS;
  const int w0 = (blockIdx.x % chunks) * ROWS;
  bk.hyp0 = (blockIdx.x / chunks) * hpb;
  bk.nh = min(hpb, p.H - bk.hyp0);
  bk.nrows = p.W <= ROWS ? bk.nh * p.W : min(ROWS, p.W - w0);
  bk.row0 = (int64_t)bk.hyp0 * p.W + w0;
  return bk;
}

// Start the copies of tile t0 into stage st (one warp, lane = frame).
// my_c, my_b: lane i's candidate and batch item (the step only).
template <bool kStep>
__device__ __forceinline__ void start_tile(const Params& p, const Block& bk, float* st, int t0,
                                           int lane, int my_c, int my_b) {
  const int t = t0 + lane;
  const bool in_t = t < p.T;
  float* sx = st;
  float* spa = st + IN_TILE;
  float* sxb = st + 3 * IN_TILE;
  float* sraw = st + 4 * IN_TILE;
  if constexpr (kStep) {
    for (int i = 0; i < bk.nrows; ++i) {
      const int c = __shfl_sync(FULL_MASK, my_c, i), b = __shfl_sync(FULL_MASK, my_b, i);
      cp4(sx + i * PAD + lane, p.x_t + ((int64_t)b * p.V + c) * p.T + t, p.x_t, in_t);
    }
    for (int h = 0; h < bk.nh; ++h) {
      const int hyp = bk.hyp0 + h, b = hyp / p.K, k = hyp % p.K;
      cp4(sxb + h * PAD + lane, p.x_t + ((int64_t)b * p.V + p.blank) * p.T + t, p.x_t, in_t);
      // frame t - 1 of the prefix state: phi at frame t
      const bool prev = in_t && t > 0;
      const float* r = p.r_prev + b * p.sB + k * p.sK + 2 * (int64_t)(t - 1);
      cp4(sraw + h * 2 * TT + 2 * lane, r, p.r_prev, prev);
      cp4(sraw + h * 2 * TT + 2 * lane + 1, r + 1, p.r_prev, prev);
    }
  } else {
    for (int i = 0; i < bk.nrows; ++i) {
      const int64_t row = bk.row0 + i;
      cp4(sx + i * PAD + lane, p.xg + row * p.T + t, p.xg, in_t);
      cp4(spa + i * PAD + lane, p.phi + row * p.T + t, p.phi, in_t);
      cp4(sxb + i * PAD + lane, p.xb + (row / p.K) * p.T + t, p.xb, in_t);
    }
  }
  cp_commit();
}

// After the copies of stage st landed: phi_all and r_b of each hypothesis
// (the step only).  Lane j reads the raw pair that its own copies wrote.
template <bool kStep>
__device__ __forceinline__ void finish(const Params& p, const Block& bk, float* st, int t0,
                                       int lane) {
  if constexpr (kStep) {
    float* spa = st + IN_TILE;
    float* srb = st + 2 * IN_TILE;
    const float* sraw = st + 4 * IN_TILE;
    for (int h = 0; h < bk.nh; ++h) {
      float pa = p.phi0, rb = p.phi0;
      if (t0 + lane > 0) {
        const float a = sraw[h * 2 * TT + 2 * lane], b = sraw[h * 2 * TT + 2 * lane + 1];
        pa = lse(a, b);
        rb = b;
      }
      spa[h * PAD + lane] = pa;
      srb[h * PAD + lane] = rb;
    }
  }
}

// Warp 0 runs the chain, warp 1 produces, warp 2 stores.
template <bool kStep>
__global__ void __launch_bounds__(96) ctc_prefix_kernel(const Params p) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Block bk = block_rows(p);
  const int ntiles = (p.T + TT - 1) / TT;
  float* s_out = smem + 2 * STAGE;
  const bool valid = lane < bk.nrows;
  const int64_t row = bk.row0 + lane;

  if (warp == 2) {
    // drain finished output tiles: a row's 2 nt floats are contiguous
    for (int n = 0; n < ntiles; ++n) {
      const int s = n & 1, t0 = n * TT, nt2 = 2 * min(TT, p.T - t0);
      bar_sync(BAR_OFULL + s);
      const float* so = s_out + s * OUT_TILE;
      for (int i = 0; i < bk.nrows; ++i) {
        float* dst = p.out + ((bk.row0 + i) * p.T + t0) * 2;
        for (int c = lane; c < nt2; c += 32) dst[c] = so[i * OPAD + c];
      }
      if (n + 2 < ntiles) bar_arrive(BAR_OEMPTY + s);
    }
    return;
  }

  // lane i's candidate, batch item, and whether it repeats the last token
  int my_c = 0, my_b = 0;
  bool same = false;
  if (kStep && valid) {
    const int hyp = (int)(row / p.W), w = (int)(row % p.W), k = hyp % p.K;
    my_b = hyp / p.K;
    const int64_t c = p.cand[my_b * p.cB + k * p.cK + w * p.cW];
    my_c = (int)c;
    same = c == p.last[my_b * p.lB + k * p.lK];
  }
  if (warp == 1) {  // producer
    for (int n = 0; n < ntiles; ++n) {
      const int s = n & 1;
      float* st = smem + s * STAGE;
      if (n >= 2) bar_sync(BAR_EMPTY + s);
      start_tile<kStep>(p, bk, st, n * TT, lane, my_c, my_b);
      cp_wait();
      finish<kStep>(p, bk, st, n * TT, lane);
      bar_arrive(BAR_FULL + s);
    }
    return;
  }

  // the chain warp: lane = row
  const int h = lane / bk.Wb;
  float nb = NEG_INF, bl = NEG_INF;
  for (int n = 0; n < ntiles; ++n) {
    const int s = n & 1, t0 = n * TT, nt = min(TT, p.T - t0);
    const float* st = smem + s * STAGE;
    bar_sync(BAR_FULL + s);
    if (n >= 2) bar_sync(BAR_OEMPTY + s);
    const float* px = st + lane * PAD;
    const float* pp = st + (same ? 2 : 1) * IN_TILE + h * PAD;
    const float* pb = st + 3 * IN_TILE + h * PAD;
    float* po = s_out + s * OUT_TILE + lane * OPAD;
    // frame j + 1's operands are read before frame j's results are stored,
    // so no shared load waits behind a store (column TT is the padding)
    float x = px[0], ph = pp[0], b = pb[0];
#pragma unroll 8
    for (int j = 0; j < nt; ++j) {
      const float x_next = px[j + 1], ph_next = pp[j + 1], b_next = pb[j + 1];
      const float new_nb = __fadd_rn(x, lse(nb, ph));
      bl = __fadd_rn(b, lse(bl, nb));
      nb = new_nb;
      po[2 * j] = nb;
      po[2 * j + 1] = bl;
      x = x_next;
      ph = ph_next;
      b = b_next;
    }
    bar_arrive(BAR_OFULL + s);
    if (n + 2 < ntiles) bar_arrive(BAR_EMPTY + s);
  }
  if (kStep && valid) p.sigma[row] = lse(nb, bl);
}

// One warp, the chain alone: T frames of the two dependent lse with their
// operands in registers (changed every frame off the chain, so nothing folds).
__global__ void ctc_chain_floor_kernel(int T, float* out) {
  const int lane = threadIdx.x;
  float nb = NEG_INF, bl = NEG_INF;
  float x = -1.0f - 0.01f * lane, phi = -2.0f + 0.01f * lane, xb = -0.5f;
  for (int t = 0; t < T; ++t) {
    const float new_nb = __fadd_rn(x, lse(nb, phi));
    bl = __fadd_rn(xb, lse(bl, nb));
    nb = new_nb;
    x = __fsub_rn(x, 1e-3f);
    phi = __fadd_rn(phi, 1e-3f);
  }
  out[2 * lane] = nb;
  out[2 * lane + 1] = bl;
}

template <bool kStep>
int launch(const Params& p, void* stream) {
  if (p.H <= 0 || p.W <= 0 || p.T <= 0) return (int)cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      ctc_prefix_kernel<kStep>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int wb = p.W < ROWS ? p.W : ROWS;
  const int hpb = ROWS / wb, chunks = (p.W + ROWS - 1) / ROWS;
  const int blocks = ((p.H + hpb - 1) / hpb) * chunks;
  ctc_prefix_kernel<kStep><<<blocks, 96, SMEM_BYTES, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, called through ctypes; each returns
// cudaGetLastError() (or cudaErrorInvalidValue for bad sizes).
//
// The beam's step.  x_t: float32 (B, V, T) contiguous; r_prev: float32
// (B, K, T, 2) with strides (sB, sK, 2, 1) in floats (sK = 0 for the step-0
// broadcast); last: int64 (B, K), strides (lB, lK); cand: int64 (B, K, W),
// strides (cB, cK, cW), each token in [0, V); r_new: float32
// (B, K, W, T, 2) and sigma: float32 (B, K, W), contiguous.
extern "C" int ctc_prefix_step_forward(const float* x_t, int B, int V, int T,
                                       const float* r_prev, int64_t sB, int64_t sK,
                                       const int64_t* last, int64_t lB, int64_t lK,
                                       const int64_t* cand, int64_t cB, int64_t cK, int64_t cW,
                                       int K, int W, int prefix_empty, int blank, float* r_new,
                                       float* sigma, void* stream) {
  if (B < 0 || K < 0 || blank < 0 || blank >= V) return (int)cudaErrorInvalidValue;
  Params p{};
  p.x_t = x_t;
  p.r_prev = r_prev;
  p.last = last;
  p.cand = cand;
  p.sB = sB;
  p.sK = sK;
  p.lB = lB;
  p.lK = lK;
  p.cB = cB;
  p.cK = cK;
  p.cW = cW;
  p.V = V;
  p.blank = blank;
  p.phi0 = prefix_empty ? 0.0f : NEG_INF;
  p.H = B * K;
  p.K = K;
  p.W = W;
  p.T = T;
  p.out = r_new;
  p.sigma = sigma;
  return launch<true>(p, stream);
}

// The recurrence.  xg, phi: float32 (R, T) contiguous; xb: float32
// (R / rows_per_b, T) contiguous; out: float32 (R, T, 2) contiguous.
extern "C" int ctc_prefix_forward(const float* xg, const float* phi, const float* xb, int R,
                                  int T, int rows_per_b, float* out, void* stream) {
  if (R <= 0 || T <= 0) return (int)cudaSuccess;
  if (rows_per_b <= 0) return (int)cudaErrorInvalidValue;
  Params p{};
  p.xg = xg;
  p.phi = phi;
  p.xb = xb;
  p.H = R;
  p.K = rows_per_b;
  p.W = 1;
  p.T = T;
  p.out = out;
  return launch<false>(p, stream);
}

// The chain floor: one warp, T frames, out float32 (32, 2).
extern "C" int ctc_chain_floor(int T, float* out, void* stream) {
  ctc_chain_floor_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(T, out);
  return (int)cudaGetLastError();
}
