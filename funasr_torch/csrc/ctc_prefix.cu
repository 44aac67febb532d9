// CTC prefix-score frame recurrence for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel funasr_tpu/ops/ctc_prefix_pallas.py `_kernel`
// (:47, called through `ctc_recurrence` :105).  For every row r of
// R = B*K*W candidate slots and every frame t, with both carries starting
// at NEG_INF = -1e10 (finite):
//
//   r_nb[t] = xg[t] + lse(r_nb[t-1], phi[t])
//   r_b[t]  = xb[t] + lse(r_b[t-1],  r_nb[t-1])
//   lse(a, b) = m + log(exp(a - m) + exp(b - m)),  m = max(max(a, b), NEG_INF)
//
// xg and phi are (R, T) row-major, xb is (B, T) with rows_per_b = K*W rows
// per batch item, and the output is (R, T, 2): [..., 0] = r_nb, [..., 1] =
// r_b, the layout that the beam's `ctc_prefix_step` keeps as its state, so
// no stack copy follows.  Each step is a separate IEEE operation in the
// order above: accurate expf/logf, no fast math, no multiply (so nothing
// for nvcc to contract into an FMA).  The plain twin
// (ops/ctc_prefix.py `ctc_recurrence_ref`) runs the same operations as
// PyTorch elementwise kernels, whose float32 exp/log are the same expf/logf,
// so the two agree bit for bit.
//
// Design.  The chain over T is sequential and the rows are independent, so
// one thread owns one row and keeps both carries in registers.  In the
// (R, T) layout consecutive rows are T*4 bytes apart: a warp reading "frame
// t of 32 rows" would touch 32 cache lines.  So the block (ROWS rows) walks
// T in tiles of TT frames, staged through shared memory: the tile load is
// coalesced (neighbouring threads read neighbouring frames of a row) and
// goes to registers one tile ahead, so its latency hides behind the current
// tile's TT serial steps, which each thread runs out of shared memory; the
// (ROWS, TT, 2) output tile goes back coalesced too.  Row strides of TT+1 and 2*TT+1
// words keep the per-thread column accesses free of bank conflicts.  xb is
// read straight from global memory: every row of a batch item reads the
// same address, which the warp broadcasts.  Bound: bytes, xg and phi read
// once and the output written once (4 * (4 R T + B T) bytes) over
// 3.35 TB/s; the arithmetic (two lse per row and frame) is far below it,
// but the serial chain leaves most of the card idle at R ~ 5,000 rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 64;  // rows (threads) per block
constexpr int TT = 32;    // frames per staged tile
constexpr int RSTEP = ROWS / TT;
static_assert(ROWS == 2 * TT, "one output column of the (ROWS, 2 TT) tile per thread");
constexpr float NEG_INF = -1e10f;

__device__ __forceinline__ float lse(float a, float b) {
  const float m = fmaxf(fmaxf(a, b), NEG_INF);
  return __fadd_rn(m, logf(__fadd_rn(expf(__fsub_rn(a, m)), expf(__fsub_rn(b, m)))));
}

// Tile (rows row0.., frames t0..) of xg and phi into registers: thread tid
// takes frame tid % TT of rows tid / TT + m * RSTEP, so each warp load is
// one row's TT contiguous frames.
__device__ __forceinline__ void load_tile(const float* __restrict__ xg,
                                          const float* __restrict__ phi, int64_t row0,
                                          int nrows, int T, int t0, float (&pxg)[TT],
                                          float (&pphi)[TT]) {
  const int lj = threadIdx.x % TT, li = threadIdx.x / TT;
  const bool in_t = t0 + lj < T;
#pragma unroll
  for (int m = 0; m < TT; ++m) {
    const int i = li + m * RSTEP;
    pxg[m] = 0.f;
    pphi[m] = 0.f;
    if (in_t && i < nrows) {
      const int64_t g = (row0 + i) * T + t0 + lj;
      pxg[m] = xg[g];
      pphi[m] = phi[g];
    }
  }
}

__global__ void __launch_bounds__(ROWS)
ctc_prefix_kernel(const float* __restrict__ xg, const float* __restrict__ phi,
                  const float* __restrict__ xb, int R, int T, int rows_per_b,
                  float* __restrict__ out) {
  __shared__ float s_xg[ROWS][TT + 1];
  __shared__ float s_phi[ROWS][TT + 1];
  __shared__ float s_out[ROWS][2 * TT + 1];
  const int tid = threadIdx.x;
  const int lj = tid % TT, li = tid / TT;
  const int64_t row0 = (int64_t)blockIdx.x * ROWS;
  const int nrows = (int)min((int64_t)ROWS, (int64_t)R - row0);
  const bool live = tid < nrows;
  const float* xbr = xb + (live ? (row0 + tid) / rows_per_b : 0) * (int64_t)T;
  float nb = NEG_INF, bl = NEG_INF;
  float pxg[TT], pphi[TT];
  load_tile(xg, phi, row0, nrows, T, 0, pxg, pphi);

  for (int t0 = 0; t0 < T; t0 += TT) {
    const int nt = min(TT, T - t0);
#pragma unroll
    for (int m = 0; m < TT; ++m) {
      s_xg[li + m * RSTEP][lj] = pxg[m];
      s_phi[li + m * RSTEP][lj] = pphi[m];
    }
    __syncthreads();
    // the next tile's loads are in flight while this one is computed
    if (t0 + TT < T) load_tile(xg, phi, row0, nrows, T, t0 + TT, pxg, pphi);
    if (live) {
#pragma unroll
      for (int j = 0; j < TT; ++j) {
        if (j < nt) {
          const float new_nb = __fadd_rn(s_xg[tid][j], lse(nb, s_phi[tid][j]));
          const float new_bl = __fadd_rn(xbr[t0 + j], lse(bl, nb));
          nb = new_nb;
          bl = new_bl;
          s_out[tid][2 * j] = nb;
          s_out[tid][2 * j + 1] = bl;
        }
      }
    }
    __syncthreads();
    // thread tid writes column tid of every row: 2 TT contiguous floats a row
    if (tid < 2 * nt) {
      for (int i = 0; i < nrows; ++i) out[((row0 + i) * T + t0) * 2 + tid] = s_out[i][tid];
    }
    // the next iteration writes s_xg/s_phi, which no thread reads any more,
    // and s_out only after its first barrier
  }
}

}  // namespace

// Plain C entry point, called through ctypes.  xg, phi: float32 (R, T)
// contiguous; xb: float32 (R / rows_per_b, T) contiguous; out: float32
// (R, T, 2) contiguous.  Returns cudaGetLastError().
extern "C" int ctc_prefix_forward(const float* xg, const float* phi, const float* xb, int R,
                                  int T, int rows_per_b, float* out, void* stream) {
  if (R <= 0 || T <= 0) return (int)cudaSuccess;
  if (rows_per_b <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (R + ROWS - 1) / ROWS;
  ctc_prefix_kernel<<<blocks, ROWS, 0, (cudaStream_t)stream>>>(xg, phi, xb, R, T, rows_per_b,
                                                               out);
  return (int)cudaGetLastError();
}
