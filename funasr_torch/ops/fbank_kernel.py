"""Fused kaldi fbank: the CUDA kernel's wrapper and its plain twin.

Replaces the TPU kernel funasr_tpu/ops/fbank_pallas.py ``_fbank_kernel``.
Every per-frame step of kaldi fbank with dither 0 (DC removal,
preemphasis with the first sample duplicated, the window) is linear, so
the windowed DFT is one fixed (400, 512) operator ``[re 256 | im 256]``
built in float64 (:func:`fused_dft`), one per window type; the Nyquist bin
is dropped because its mel weight is exactly 0.  Computation is full float32 (the JAX
kernel's ``precision="highest"``).

- :func:`fused_fbank` launches ``csrc/fbank.cu`` for a CUDA tensor and
  counts the launch in ``fused_fbank.launches``; for a CPU tensor it runs
  :func:`fbank_ref`.  There is no other path.
- :func:`fbank_ref` is the plain PyTorch version of the same arithmetic.

Frames are 400 samples at hop 160 (16 kHz, 25 ms / 10 ms, snip_edges).
The design and the bound on the card are in the kernel source.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from funasr_torch.ops import cuda_build
from funasr_torch.ops.fbank import (
    LOG_EPS,
    _dft_matrices,
    _window,
    kaldi_mel_banks,
    num_fbank_frames,
)

SAMPLE_RATE = 16000
FRAME_LEN = 400
FRAME_SHIFT = 160
PADDED = 512
_LN10 = float(np.log(10.0).astype(np.float32))


@functools.lru_cache(maxsize=8)
def fused_dft(window: str = "hamming", preemph: float = 0.97) -> np.ndarray:
    """(400, 512) float32 operator: preprocess + window + DFT, columns
    [re bins 0..255 | im bins 0..255], built in float64 as
    funasr_tpu/ops/fbank_pallas.py ``_fused_dft`` builds it (hamming
    there; any window of :func:`funasr_torch.ops.fbank._window` here)."""
    n = FRAME_LEN
    cos_m, sin_m = _dft_matrices(n, PADDED)  # (400, 257)
    P = np.eye(n) - np.ones((n, n)) / n  # DC removal
    L = np.eye(n)
    for i in range(1, n):
        L[i, i - 1] -= preemph
    L[0, 0] -= preemph  # first sample duplicated (kaldi semantics)
    W = np.diag(_window(window, n))
    M = W @ L @ P
    nb = PADDED // 2
    A = np.concatenate([(M.T @ cos_m)[:, :nb], (M.T @ sin_m)[:, :nb]], axis=1)
    return A.astype(np.float32)


_tables: Dict[Tuple[str, int, str], Tuple[torch.Tensor, torch.Tensor]] = {}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p]


def _device_tables(device: torch.device, num_mel_bins: int, window: str):
    """(operator (400, 512), mel (256, n_mels)) float32 on ``device``."""
    key = (str(device), num_mel_bins, window)
    if key not in _tables:
        mel = kaldi_mel_banks(num_mel_bins, PADDED, float(SAMPLE_RATE))[: PADDED // 2]
        _tables[key] = (
            torch.as_tensor(fused_dft(window), device=device),
            torch.as_tensor(mel.astype(np.float32), device=device).contiguous())
    return _tables[key]


def _frame_lengths(lengths: torch.Tensor) -> torch.Tensor:
    return num_fbank_frames(lengths.to(torch.int64), FRAME_LEN,
                            FRAME_SHIFT).to(torch.int32)


def fbank_ref(waveform: torch.Tensor, lengths: torch.Tensor,
              num_mel_bins: int = 80, with_energy: bool = False,
              window: str = "hamming"):
    """Plain PyTorch twin of the kernel: (B, N) waveform in [-1, 1] ->
    feats (B, T, n_mels) float32, feat_lengths (B,) int32 and, with
    ``with_energy``, the raw-frame decibel track (B, T)."""
    B, N = waveform.shape
    T = num_fbank_frames(N, FRAME_LEN, FRAME_SHIFT)
    op, mel = _device_tables(waveform.device, num_mel_bins, window)
    x = waveform.to(torch.float32) * float(1 << 15)
    frames = x.unfold(1, FRAME_LEN, FRAME_SHIFT)[:, :T]  # (B, T, 400)
    ri = frames @ op
    nb = PADDED // 2
    power = ri[..., :nb] * ri[..., :nb] + ri[..., nb:] * ri[..., nb:]
    feats = torch.log(torch.clamp_min(power @ mel, LOG_EPS))
    out = (feats, _frame_lengths(lengths))
    if with_energy:
        e = (frames * frames).sum(dim=-1)
        out = out + (10.0 * (torch.log(e + 1e-6) / _LN10),)
    return out


def fused_fbank(waveform: torch.Tensor, lengths: torch.Tensor,
                num_mel_bins: int = 80, with_energy: bool = False,
                window: str = "hamming"):
    """Fused kaldi fbank (16 kHz, dither 0, 25 ms / 10 ms, snip_edges):
    same contract as :func:`fbank_ref`.  CUDA tensor -> the kernel
    (float32 (B, N) waveform required); CPU tensor -> the twin."""
    if waveform.device.type == "cpu":
        return fbank_ref(waveform, lengths, num_mel_bins, with_energy, window)
    if waveform.device.type != "cuda":
        raise ValueError(f"fused_fbank: unsupported device {waveform.device}")
    if waveform.dtype != torch.float32 or waveform.dim() != 2:
        raise ValueError("fused_fbank: expects a (B, N) float32 waveform, got "
                         f"{tuple(waveform.shape)} {waveform.dtype}")
    wav = waveform.contiguous()
    B, N = wav.shape
    T = num_fbank_frames(N, FRAME_LEN, FRAME_SHIFT)
    feats = torch.empty((B, T, num_mel_bins), dtype=torch.float32,
                        device=wav.device)
    db = (torch.empty((B, T), dtype=torch.float32, device=wav.device)
          if with_energy else None)
    if T > 0 and B > 0:
        op, mel = _device_tables(wav.device, num_mel_bins, window)
        fn = cuda_build.function("fbank", "fbank_forward", _ARGTYPES)
        status = fn(wav.data_ptr(), B, N, T, op.data_ptr(), mel.data_ptr(),
                    num_mel_bins, feats.data_ptr(),
                    None if db is None else db.data_ptr(),
                    torch.cuda.current_stream(wav.device).cuda_stream)
        cuda_build.check(status, "fbank kernel launch")
        fused_fbank.launches += 1
    out = (feats, _frame_lengths(lengths))
    return out + (db,) if with_energy else out


fused_fbank.launches = 0
