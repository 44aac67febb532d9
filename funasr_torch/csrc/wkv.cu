// The RWKV-4 WKV recurrence for Hopper (sm_90a), float32.
//
// Replaces no TPU kernel: the JAX package runs the recurrence as a
// `lax.scan` (funasr_tpu/models/rwkv.py:32 `wkv_scan`), which XLA compiles
// into one loop.  The port's plain version (ops/wkv.py `wkv_ref`) is a Python
// loop of about fifteen elementwise launches a position, so an encoder pass
// of 1536 positions took ~23,000 launches a block; this kernel takes one.
//
// For every row b and channel c, with aa = bb = 0 and pp = -1e30 at the
// start and w = exp(time_decay) > 0, u = time_first:
//
//   ww = u + k[t];   p = max(pp, ww)
//   out[t] = (e^(pp-p) aa + e^(ww-p) v[t]) / (e^(pp-p) bb + e^(ww-p))
//   ww2 = pp - w;    p2 = max(ww2, k[t])
//   aa = e^(ww2-p2) aa + e^(k[t]-p2) v[t];  bb = e^(ww2-p2) bb + e^(k[t]-p2);  pp = p2
//
// Each step is a separate IEEE operation in that order: accurate expf, fmaxf,
// and `__fmul_rn` / `__fadd_rn` / `__fsub_rn` / `__fdiv_rn`, so that nvcc
// contracts nothing into an FMA.  The plain version runs the same operations
// as PyTorch elementwise kernels, whose float32 exp is the same expf, so
// kernel and twin agree bit for bit.
//
// Design: one thread a (row, channel), carrying aa, bb, pp in registers over
// T; a warp covers 32 adjacent channels of one row, so every load of k and v
// and every store of out is one coalesced 128-byte line.  The loads of the
// next 8 positions are issued before the current 8 are computed, so the
// chain waits on its own arithmetic and not on device memory.  No parallel
// scan over T: it would change the rounding.
//
// Floors.  Bytes: k and v read once and out written once, 12 B T C bytes
// (BAT's encoder at B = 8 x 15 s, T = 1536, C = 256: 37.7 MB, 11 us at 3.35
// TB/s).  Chain: a position waits on the last (two max, four sub, four expf,
// six mul, four add, one div), so a row takes T times that latency however
// many SMs run; `wkv_chain_floor` times the chain alone, in one warp with its
// operands in registers.  At these shapes (B C = 2048 threads, 16 SMs busy)
// the chain is the bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // threads a block
constexpr int U = 8;     // positions loaded ahead

struct State {
  float aa, bb, pp;
};

// one position of the recurrence; returns out[t]
__device__ __forceinline__ float wkv_step(State& s, float kt, float vt, float w, float u) {
  const float ww = __fadd_rn(u, kt);
  const float p = fmaxf(s.pp, ww);
  float e1 = expf(__fsub_rn(s.pp, p));
  float e2 = expf(__fsub_rn(ww, p));
  const float out = __fdiv_rn(__fadd_rn(__fmul_rn(e1, s.aa), __fmul_rn(e2, vt)),
                              __fadd_rn(__fmul_rn(e1, s.bb), e2));
  const float ww2 = __fsub_rn(s.pp, w);
  const float p2 = fmaxf(ww2, kt);
  e1 = expf(__fsub_rn(ww2, p2));
  e2 = expf(__fsub_rn(kt, p2));
  s.aa = __fadd_rn(__fmul_rn(e1, s.aa), __fmul_rn(e2, vt));
  s.bb = __fadd_rn(__fmul_rn(e1, s.bb), e2);
  s.pp = p2;
  return out;
}

__global__ void __launch_bounds__(NT)
wkv_kernel(const float* __restrict__ k, const float* __restrict__ v,
           const float* __restrict__ w, const float* __restrict__ u, float* __restrict__ out,
           int B, int T, int C) {
  const int64_t idx = (int64_t)blockIdx.x * NT + threadIdx.x;
  if (idx >= (int64_t)B * C) return;
  const int b = (int)(idx / C), c = (int)(idx % C);
  const int64_t base = (int64_t)b * T * C + c;
  const float* kp = k + base;
  const float* vp = v + base;
  float* op = out + base;
  const float wc = w[c], uc = u[c];
  State s{0.f, 0.f, -1e30f};

  float kb[U], vb[U];
#pragma unroll
  for (int i = 0; i < U; ++i) {
    kb[i] = i < T ? kp[(int64_t)i * C] : 0.f;
    vb[i] = i < T ? vp[(int64_t)i * C] : 0.f;
  }
  for (int t0 = 0; t0 < T; t0 += U) {
    float kn[U], vn[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int t = t0 + U + i;
      kn[i] = t < T ? kp[(int64_t)t * C] : 0.f;
      vn[i] = t < T ? vp[(int64_t)t * C] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (t0 + i < T) op[(int64_t)(t0 + i) * C] = wkv_step(s, kb[i], vb[i], wc, uc);
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      kb[i] = kn[i];
      vb[i] = vn[i];
    }
  }
}

// One warp, the chain alone: T positions with k and v in registers (changed
// every position off the chain, so nothing folds).
__global__ void wkv_chain_floor_kernel(int T, float* out) {
  const int lane = threadIdx.x;
  State s{0.f, 0.f, -1e30f};
  float kt = 0.1f * lane, vt = 1.0f - 0.01f * lane, acc = 0.f;
  for (int t = 0; t < T; ++t) {
    acc = __fadd_rn(acc, wkv_step(s, kt, vt, 0.5f, 0.3f));
    kt = __fsub_rn(kt, 1e-3f);
    vt = __fadd_rn(vt, 1e-3f);
  }
  out[lane] = acc;
}

}  // namespace

// Plain C entry points, called through ctypes; each returns
// cudaGetLastError() (0 on success).
//
// k, v, out: float32 (B, T, C) contiguous; w, u: float32 (C,).
extern "C" int wkv_forward(const float* k, const float* v, const float* w, const float* u,
                           float* out, int B, int T, int C, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0) return (int)cudaSuccess;
  const int64_t n = (int64_t)B * C;
  const unsigned blocks = (unsigned)((n + NT - 1) / NT);
  wkv_kernel<<<blocks, NT, 0, (cudaStream_t)stream>>>(k, v, w, u, out, B, T, C);
  return (int)cudaGetLastError();
}

// The chain floor: one warp, T positions, out float32 (32,).
extern "C" int wkv_chain_floor(int T, float* out, void* stream) {
  wkv_chain_floor_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(T, out);
  return (int)cudaGetLastError();
}
