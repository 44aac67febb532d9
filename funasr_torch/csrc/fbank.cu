// Fused kaldi log-mel fbank for Hopper (sm_90a): a float64 real FFT with a
// sparse mel bank.
//
// Replaces the TPU kernel funasr_tpu/ops/fbank_pallas.py `_fbank_pallas`
// (pallas_call at :209, body `_fbank_kernel` :97), which folds kaldi's
// per-frame steps into one dense (400, 512) DFT operator for the MXU.  Same
// function here, computed as the FFT it is.  Per 400-sample frame (16 kHz,
// hop 160, snip_edges, dither 0):
//
//   s     = 32768 * wav[160 t : 160 t + 400]
//   x[i]  = win[i] * (d[i] - 0.97 d[i-1]),  d = s - mean(s),  d[-1] = d[0]
//   X     = rfft(x zero-padded to 512)[:256]   (Nyquist dropped: mel weight 0)
//   feats = log(max(sum_{f in [lo_j, hi_j)} w_jf |X_f|^2, FLT_EPSILON))
//   db    = 10 * log(sum s^2 + 1e-6) / ln 10                  (with_energy)
//
// Why float64.  At a served input (voiced sines over low noise) DC removal
// and preemphasis leave about 1e-9 of a frame's power in the lowest mel
// bins (mel 1 sees only FFT bin 2, 62.5 Hz), so a rounding error relative
// to the whole frame becomes a 1e-3 error in the log.  Measured against
// the float64 exact value (numpy/torch, CPU): float32 preprocessing + FFT +
// mel 1.06e-3 (9.9e-4 from the float32 operator twin, whose bar is 1e-3);
// float64 preprocessing with a float32 FFT 1.48e-3; float64 throughout ~0.
// So every step up to the log is float64; the log is rounded once to
// float32.  The H100 runs float64 at half its float32 rate.
//
// Design.  A tile is F = 8 consecutive frames of one row, 16 threads a
// frame (two frames a warp, so every step inside a frame syncs by warp).
// The grid is persistent (the blocks resident on the card, each walking
// tiles), so each block copies the tables into shared memory once: the
// window, both twiddle tables and the packed mel weights (a bin feeds at
// most two mels: at most 512), with the int32 ranges.  Per tile:
//  1. The frames' span of samples, (F-1)*160 + 400 floats, is staged once
//     in shared memory by coalesced loads (16-byte ones where the row's
//     address allows: a row starts at b*N*4 bytes), zero past the row.
//  2. Preprocess in float64: lane n2 owns the sample pairs
//     (32 n1 + 2 n2, +1), which are z[16 n1 + n2] = x[2n] + i x[2n+1] of
//     the 256-point complex FFT whose split step gives the 512-point real
//     one.  The mean and the energy are 16-lane shuffle sums.
//  3. z's 256-point FFT as 16 x 16: each lane runs a 16-point radix-2 FFT
//     in registers over n1, multiplies by the twiddle W256^(n2 k1), and a
//     padded shared-memory transpose (row stride 17 doubles: conflict-free
//     both ways; re, then im, through one buffer) hands lane k1 the 16
//     values of its second 16-point FFT, over n2, which gives
//     Z[k1 + 16 k2].
//  4. Split: X[k] = E[k] + W512^k O[k], E = (Z[k] + conj Z[256-k]) / 2,
//     O = (Z[k] - conj Z[256-k]) / 2i.  Z[256-k] sits in lane 16 - k1's
//     registers and comes by shuffle; the power |X|^2 (float64) replaces
//     the frame's transpose buffer.
//  5. Mel: each output (frame, mel) sums only its contiguous range of bins
//     with float64 weights (501 nonzeros at 80 mels, not 20,480), the log
//     in float64.  A warp takes a few mels of all F frames, so its lanes
//     run the same number of terms and read few weights; the F x n_mels
//     tile goes through shared memory and out by coalesced stores.
// Frames past T are computed from zeros and not stored; a frame depends on
// its own 400 samples only.
//
// Bound on the H100 SXM: at B = 64 x 15 s (95,872 frames) the function
// reads 61 MB of waveform and writes 31 MB of features: 27.5 us at 3.35
// TB/s, bound by bytes.  Its least float32 work (a 512-point real FFT plus
// the mel bank's nonzeros, about 15.4 kFLOP a frame) is 22 us at 67
// TFLOP/s; done in float64 as here, about 1.5 GFLOP at 34 TFLOP/s is about
// 45 us, the floor of this kernel's own arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FRAME_LEN = 400;
constexpr int FRAME_SHIFT = 160;
constexpr int NBINS = 256;
constexpr int F = 8;              // frames per block
constexpr int TPF = 16;           // threads per frame
constexpr int NT = F * TPF;       // threads per block
constexpr int MAX_MELS = 256;
constexpr int SPAN = (F - 1) * FRAME_SHIFT + FRAME_LEN;  // a tile's samples
// the sample buffer then holds the F x n_mels output tile
constexpr int SWAV = SPAN > F * MAX_MELS ? SPAN : F * MAX_MELS;
constexpr int MAX_NNZ = 2 * NBINS;  // a bin feeds at most two mels
constexpr int LD = 17;            // padded row of the 16 x 16 transpose
constexpr int FSTR = 16 * LD + 1; // doubles a frame (odd: frames on other banks)
constexpr unsigned FULL = 0xffffffffu;
constexpr double SCALE = 32768.0;
constexpr double PREEMPH = 0.97;
// offsets into the float64 table (ops/fbank_kernel.py kernel_tables)
constexpr int TAB_WIN = 0;                   // window, 400
constexpr int TAB_TW = FRAME_LEN;            // W256^(n2 k1) at [k1*16+n2]: re 256, im 256
constexpr int TAB_SPLIT = TAB_TW + 2 * 256;  // W512^k: re 256, im 256
constexpr int TAB_MEL = TAB_SPLIT + 2 * 256; // mel weights, range by range

static_assert(SPAN % 4 == 0, "16-byte staging");
static_assert(NBINS <= FSTR, "the power spectrum reuses a frame's buffer");

// cos(2 pi m / 16) and sin(2 pi m / 16) for m in 0..7
__device__ __forceinline__ constexpr double cos16(int m) {
  return m == 0 ? 1.0
       : m == 1 ? 0.92387953251128675613
       : m == 2 ? 0.70710678118654752440
       : m == 3 ? 0.38268343236508977173
       : m == 4 ? 0.0
       : m == 5 ? -0.38268343236508977173
       : m == 6 ? -0.70710678118654752440
                : -0.92387953251128675613;
}
__device__ __forceinline__ constexpr double sin16(int m) {
  return cos16(m < 4 ? 4 - m : m - 4);
}
__device__ __forceinline__ constexpr int bitrev4(int r) {
  return ((r & 1) << 3) | ((r & 2) << 1) | ((r & 4) >> 1) | ((r & 8) >> 3);
}

// In-place 16-point forward DFT, radix-2 decimation in frequency: natural
// order in, register r holds bin bitrev4(r) out.  Every index and twiddle
// is a compile-time constant after unrolling; W^0 and W^4 = -i are exact.
__device__ __forceinline__ void fft16(double (&re)[16], double (&im)[16]) {
#pragma unroll
  for (int stage = 0; stage < 4; ++stage) {
#pragma unroll
    for (int bf = 0; bf < 8; ++bf) {  // butterfly bf of the stage
      const int span = 8 >> stage, j = bf % span;
      const int a = (bf / span) * 2 * span + j, b = a + span, m = j << stage;
      const double dr = re[a] - re[b], di = im[a] - im[b];
      re[a] += re[b];
      im[a] += im[b];
      if (m == 0) {
        re[b] = dr;
        im[b] = di;
      } else if (m == 4) {  // times -i
        re[b] = di;
        im[b] = -dr;
      } else {  // times cos - i sin
        const double c = cos16(m), s = sin16(m);
        re[b] = fma(dr, c, di * s);
        im[b] = fma(di, c, -dr * s);
      }
    }
  }
}

__global__ void __launch_bounds__(NT)
fbank_kernel(const float* __restrict__ wav, int64_t N, int T, int n_tiles,
             const double* __restrict__ tab,  // float64 tables, TAB_* offsets
             const int* __restrict__ mel_idx, // lo | len | off, n_mels each
             int n_mels,
             float* __restrict__ feats,       // (B, T, n_mels)
             float* __restrict__ db)          // (B, T) or nullptr
{
  __shared__ __align__(16) float s_wav[SWAV];   // samples, then the output tile
  __shared__ double s_buf[F * FSTR];            // transpose, then power
  __shared__ __align__(16) double s_win[FRAME_LEN];
  __shared__ double s_tw[2 * 256];
  __shared__ double s_split[2 * 256];
  __shared__ double s_melw[MAX_NNZ];
  __shared__ int s_mel[3 * MAX_MELS];

  const int tid = threadIdx.x;
  const int m = tid / TPF;   // frame of the tile
  const int ln = tid % TPF;  // lane in the frame: n2, then k1
  const int tiles_per_row = (T + F - 1) / F;

  // 0. the tables, once per block
  for (int i = tid; i < TAB_MEL; i += NT) {
    const double v = __ldg(tab + i);
    if (i < TAB_TW) s_win[i - TAB_WIN] = v;
    else if (i < TAB_SPLIT) s_tw[i - TAB_TW] = v;
    else s_split[i - TAB_SPLIT] = v;
  }
  for (int i = tid; i < 3 * n_mels; i += NT) s_mel[i] = __ldg(mel_idx + i);
  {
    const int nnz = __ldg(mel_idx + 3 * n_mels - 1) + __ldg(mel_idx + 2 * n_mels - 1);
    for (int i = tid; i < nnz; i += NT) s_melw[i] = __ldg(tab + TAB_MEL + i);
  }

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_row;
    const int t0 = (tile - b * tiles_per_row) * F;

    // 1. stage the tile's samples
    __syncthreads();  // the previous tile's output is stored
    {
      const float* src = wav + (int64_t)b * N + (int64_t)t0 * FRAME_SHIFT;
      const int64_t left = N - (int64_t)t0 * FRAME_SHIFT;
      const int cnt = left < SPAN ? (int)left : SPAN;
      int i = tid;
      if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        const int n4 = cnt / 4;
        for (; i < n4; i += NT)
          reinterpret_cast<float4*>(s_wav)[i] = __ldg(reinterpret_cast<const float4*>(src) + i);
        i = 4 * n4 + tid;
      }
      for (; i < SPAN; i += NT) s_wav[i] = i < cnt ? __ldg(src + i) : 0.f;
    }
    __syncthreads();

    // 2. preprocess: lane n2 holds z[16 r + n2] in register r
    const float* fr = s_wav + m * FRAME_SHIFT;
    double zr[16], zi[16];
    double sum = 0.0, energy = 0.0;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int i0 = 32 * r + 2 * ln;
      if (i0 < FRAME_LEN) {  // both samples of the pair are in the frame
        const float2 v = *reinterpret_cast<const float2*>(fr + i0);
        const double a = SCALE * v.x, c = SCALE * v.y;
        zr[r] = a;
        zi[r] = c;
        sum += a + c;
        energy = fma(a, a, fma(c, c, energy));
      } else {
        zr[r] = 0.0;
        zi[r] = 0.0;
      }
    }
#pragma unroll
    for (int off = TPF / 2; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(FULL, sum, off);
      energy += __shfl_xor_sync(FULL, energy, off);
    }
    const double mean = sum * (1.0 / FRAME_LEN);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int i0 = 32 * r + 2 * ln;
      if (i0 < FRAME_LEN) {
        const double prev = SCALE * fr[i0 > 0 ? i0 - 1 : 0] - mean;
        const double d0 = zr[r] - mean, d1 = zi[r] - mean;
        const double2 w = *reinterpret_cast<const double2*>(s_win + i0);
        zr[r] = w.x * (d0 - PREEMPH * prev);
        zi[r] = w.y * (d1 - PREEMPH * d0);
      }
    }
    if (db != nullptr && ln == 0 && t0 + m < T)
      db[(int64_t)b * T + t0 + m] =
          (float)(10.0 * log(energy + 1e-6) / 2.302585092994045684);

    // 3. first 16-point FFT (over n1) and twiddle; the transpose, re then
    // im through one buffer; second 16-point FFT (over n2): register r
    // then holds Z[ln + 16 bitrev4(r)]
    fft16(zr, zi);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int k1 = bitrev4(r);
      const double wr = s_tw[k1 * 16 + ln], wi = s_tw[256 + k1 * 16 + ln];
      const double yr = fma(zr[r], wr, -zi[r] * wi);
      zi[r] = fma(zr[r], wi, zi[r] * wr);
      zr[r] = yr;
    }
    double* fb = s_buf + m * FSTR;
#pragma unroll
    for (int r = 0; r < 16; ++r) fb[ln * LD + bitrev4(r)] = zr[r];
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) zr[r] = fb[r * LD + ln];
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) fb[ln * LD + bitrev4(r)] = zi[r];
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) zi[r] = fb[r * LD + ln];
    __syncwarp();  // the frame's buffer is free: the power goes there
    fft16(zr, zi);

    // 4. split step and power for bins k = ln + 16 k2.  Z[256 - k] is lane
    // (16 - ln)'s register 15 - r, exchanged by shuffle; lane 0's partner
    // is itself, at register bitrev4((16 - k2) & 15).  With E + W O
    // doubled, the power is a quarter of its square (exact).
    const int partner = (TPF - ln) & (TPF - 1);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int k2 = bitrev4(r), r0 = bitrev4((16 - k2) & 15);
      const int k = ln + 16 * k2;
      const double pr = __shfl_sync(FULL, zr[15 - r], partner, TPF);
      const double pi = __shfl_sync(FULL, zi[15 - r], partner, TPF);
      const double br = ln ? pr : zr[r0], bi = -(ln ? pi : zi[r0]);  // conj
      const double er = zr[r] + br, ei = zi[r] + bi;  // 2 E
      const double dr = zr[r] - br, di = zi[r] - bi;  // 2 D; O = D / i = (di, -dr)
      const double wr = s_split[k], wi = s_split[256 + k];
      const double xr = er + fma(wr, di, wi * dr);
      const double xi = ei + fma(wi, di, -wr * dr);
      fb[k] = 0.25 * fma(xr, xr, xi * xi);
    }
    __syncthreads();

    // 5. sparse mel and log.  Output o is frame o % F of mel o / F: a warp
    // takes 32 / F mels of all F frames, so its lanes loop alike and read
    // 32 / F weights (shared-memory broadcasts); the frames' buffers sit at
    // an odd stride (no bank conflict).  The tile goes through shared
    // memory to a coalesced store.
    float* s_out = s_wav;
    for (int o = tid; o < F * n_mels; o += NT) {
      const int fm = o % F, j = o / F;
      const int len = s_mel[n_mels + j];
      const double* p = s_buf + fm * FSTR + s_mel[j];
      const double* w = s_melw + s_mel[2 * n_mels + j];
      double s = 0.0;
      for (int i = 0; i < len; ++i) s = fma(w[i], p[i], s);
      s_out[fm * n_mels + j] = (float)log(fmax(s, 1.1920928955078125e-07));
    }
    __syncthreads();
    const int nf = T - t0 < F ? T - t0 : F;
    float* out = feats + ((int64_t)b * T + t0) * n_mels;
    for (int o = tid; o < nf * n_mels; o += NT) out[o] = s_out[o];
  }
}

}  // namespace

// Plain C entry point, called through ctypes.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int fbank_forward(const float* wav, long long B, long long N, int T,
                             const double* tab, const int* mel_idx, int n_mels,
                             float* feats, float* db, void* stream) {
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  if (n_mels < 1 || n_mels > MAX_MELS) return (int)cudaErrorInvalidValue;
  static int grid_cap = 0;  // resident blocks on the whole card
  if (grid_cap == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fbank_kernel, NT, 0);
    grid_cap = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long n_tiles = B * ((T + F - 1) / F);
  if (n_tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int grid = n_tiles < grid_cap ? (int)n_tiles : grid_cap;
  fbank_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(wav, N, T, (int)n_tiles, tab, mel_idx,
                                                      n_mels, feats, db);
  return (int)cudaGetLastError();
}
