// Fused kaldi log-mel fbank for Hopper (sm_90a), float32 throughout.
//
// Replaces the TPU kernel funasr_tpu/ops/fbank_pallas.py `_fbank_kernel`
// (pallas_call at :209).  Same function: every per-frame preprocessing step
// of kaldi fbank with dither 0 (DC removal, preemphasis with the first
// sample duplicated, the window) is linear, so the windowed DFT of a frame
// is one fixed operator A (400, 512) = [re 256 | im 256] built on the host
// in float64 for the frontend's window (ops/fbank_kernel.py `fused_dft`), the
// Nyquist bin dropped (its mel weight is 0).  Per frame:
//
//   ri    = (32768 * wav[160 t : 160 t + 400]) @ A          (512)
//   power = ri[:256]^2 + ri[256:]^2                          (256)
//   feats = log(max(power @ mel, FLT_EPSILON))               (n_mels)
//   db    = 10 * log(sum(frame^2) + 1e-6) / ln 10            (with_energy)
//
// Design.  One block computes TM = 32 consecutive frames of one row against
// all 512 operator columns, so re and im of every bin meet in the same
// thread and the power spectrum never leaves the SM; the mel product, the
// log and the energy column follow in the same block.  Frames are read
// straight from the waveform: the 32 frames of a block span 10,480
// contiguous samples, loaded chunk by chunk (KC = 16 samples per frame) into
// shared memory; no (B, T, 512) frame tensor exists.  The operator streams
// through shared memory in the same KC-row chunks (32 KB); that buffer is
// reused for the (32, 256) power tile.  Each of the 256 threads keeps a
// 4-frame x 8-bin (re and im) accumulator tile in registers (64 floats).
//
// Bound on the H100 SXM: at B = 64 x 15 s (95,872 frames) the function
// reads 61 MB of waveform and writes 31 MB of features: 27 us at 3.35 TB/s.
// Its least work is a 512-point real FFT plus the mel bank's nonzeros, about
// 15.4 kFLOP a frame = 1.5 GFLOP of float32, 22 us at 67 TFLOP/s, so it is
// bound by bytes.  This kernel does the dense operator product instead,
// 95,872 x (400 x 512 + 256 x 80) MACs = 43.2 GFLOP (0.65 ms on the CUDA
// cores), so it sits far above the bound; an FFT-shaped kernel is later
// work.  The operator (800 KB) is re-read from L2 by every block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FRAME_LEN = 400;
constexpr int FRAME_SHIFT = 160;
constexpr int NBINS = 256;
constexpr int NCOLS = 2 * NBINS;  // re | im
constexpr int TM = 32;            // frames per block
constexpr int KC = 16;            // samples per chunk (400 = 25 x 16)
constexpr int NT = 256;           // threads per block
constexpr float SCALE = 32768.0f;

static_assert(FRAME_LEN % KC == 0, "chunking must tile the frame");
static_assert(TM * NBINS == KC * NCOLS, "power tile reuses the operator buffer");

__global__ void __launch_bounds__(NT)
fbank_kernel(const float* __restrict__ wav, int64_t N, int T,
             const float* __restrict__ op,   // (400, 512) row-major
             const float* __restrict__ mel,  // (256, n_mels) row-major
             int n_mels,
             float* __restrict__ feats,      // (B, T, n_mels)
             float* __restrict__ db)         // (B, T) or nullptr
{
  __shared__ __align__(16) float s_op[KC * NCOLS];  // operator chunk, then power
  __shared__ __align__(16) float s_fr[KC * TM];     // frame chunk, [k][m]

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TM;
  const int tid = threadIdx.x;
  const int tx = tid & 31;  // bins tx + 32 j, j < 8
  const int ty = tid >> 5;  // frames 4 ty .. 4 ty + 3
  const float* w = wav + (int64_t)b * N;

  float acc_re[4][8], acc_im[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc_re[i][j] = 0.f;
      acc_im[i][j] = 0.f;
    }

  for (int k0 = 0; k0 < FRAME_LEN; k0 += KC) {
    const float4* src = reinterpret_cast<const float4*>(op + (int64_t)k0 * NCOLS);
    float4* dst = reinterpret_cast<float4*>(s_op);
#pragma unroll
    for (int i = tid; i < KC * NCOLS / 4; i += NT) dst[i] = __ldg(src + i);
#pragma unroll
    for (int i = tid; i < KC * TM; i += NT) {
      const int m = i / KC, k = i % KC;  // k fastest: coalesced waveform reads
      const int t = t0 + m;
      s_fr[k * TM + m] =
          (t < T) ? w[(int64_t)t * FRAME_SHIFT + k0 + k] * SCALE : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const float4 f4 = *reinterpret_cast<const float4*>(&s_fr[k * TM + 4 * ty]);
      const float f[4] = {f4.x, f4.y, f4.z, f4.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float re = s_op[k * NCOLS + tx + 32 * j];
        const float im = s_op[k * NCOLS + NBINS + tx + 32 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_re[i][j] = fmaf(f[i], re, acc_re[i][j]);
          acc_im[i][j] = fmaf(f[i], im, acc_im[i][j]);
        }
      }
    }
    __syncthreads();
  }

  // power tile [m][bin] into the operator buffer
  float* s_pow = s_op;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float re = acc_re[i][j], im = acc_im[i][j];
      s_pow[(4 * ty + i) * NBINS + tx + 32 * j] = re * re + im * im;
    }
  __syncthreads();

  for (int o = tid; o < TM * n_mels; o += NT) {
    const int m = o / n_mels, j = o % n_mels;
    const int t = t0 + m;
    if (t >= T) continue;
    const float* p = s_pow + m * NBINS;
    float s = 0.f;
    for (int f = 0; f < NBINS; ++f) s = fmaf(p[f], __ldg(mel + f * n_mels + j), s);
    feats[((int64_t)b * T + t) * n_mels + j] = logf(fmaxf(s, 1.1920928955078125e-07f));
  }

  if (db != nullptr) {
    // raw-sample frame energy (VAD compute_decibel): one warp per frame
    for (int m = ty; m < TM; m += NT / 32) {
      const int t = t0 + m;
      if (t >= T) break;  // warp-uniform
      const float* fr = w + (int64_t)t * FRAME_SHIFT;
      float e = 0.f;
      for (int n = tx; n < FRAME_LEN; n += 32) {
        const float x = fr[n] * SCALE;
        e = fmaf(x, x, e);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) e += __shfl_xor_sync(0xffffffffu, e, off);
      if (tx == 0) db[(int64_t)b * T + t] = 10.0f * (logf(e + 1e-6f) / 2.30258512f);
    }
  }
}

}  // namespace

// Plain C entry point, called through ctypes.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int fbank_forward(const float* wav, long long B, long long N, int T,
                             const float* op, const float* mel, int n_mels,
                             float* feats, float* db, void* stream) {
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  dim3 grid((T + TM - 1) / TM, (unsigned)B);
  fbank_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(wav, N, T, op, mel, n_mels,
                                                       feats, db);
  return (int)cudaGetLastError();
}
