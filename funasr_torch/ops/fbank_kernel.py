"""Fused kaldi fbank: the CUDA kernel's wrapper, its host tables and its
plain twin.

Replaces the TPU kernel funasr_tpu/ops/fbank_pallas.py ``_fbank_kernel``.

- :func:`fused_fbank` launches ``csrc/fbank.cu`` for a CUDA tensor and
  counts the launch in ``fused_fbank.launches``; for a CPU tensor it runs
  :func:`fbank_ref`.  There is no other path.  The kernel computes each
  frame's 512-point real FFT (a 256-point complex FFT as 16 x 16, then the
  split step) and a sparse mel bank, every step up to the log in float64:
  at a served input DC removal and preemphasis leave about 1e-9 of a
  frame's power in the lowest mel bins, where a float32 FFT's rounding,
  relative to the whole frame, becomes a 1e-3 error in the log.  Its
  float64 tables are built here on the host (:func:`kernel_tables`,
  :func:`twiddles`, :func:`mel_ranges`).
- :func:`fbank_ref` is the plain PyTorch twin: every per-frame step of
  kaldi fbank with dither 0 (DC removal, preemphasis with the first sample
  duplicated, the window) is linear, so the windowed DFT is one fixed
  (400, 512) operator ``[re 256 | im 256]`` built in float64
  (:func:`fused_dft`), one per window type, applied in float32 (the JAX
  kernel's ``precision="highest"``); the Nyquist bin is dropped because
  its mel weight is exactly 0.
- :func:`check_args` raises for what the kernel does not take; it runs on
  tensors of any device.

Frames are 400 samples at hop 160 (16 kHz, 25 ms / 10 ms, snip_edges).
The kernel's design and its bound on the card are in its source.
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
MAX_MELS = PADDED // 2  # the kernel's bins 0..255 (csrc/fbank.cu MAX_MELS)
_LN10 = float(np.log(10.0).astype(np.float32))


@functools.lru_cache(maxsize=8)
def fused_dft(window: str = "hamming", preemph: float = 0.97) -> np.ndarray:
    """(400, 512) float32 operator: preprocess + window + DFT, columns
    [re bins 0..255 | im bins 0..255], built in float64 as
    funasr_tpu/ops/fbank_pallas.py ``_fused_dft`` builds it (hamming
    there; any window of :func:`funasr_torch.ops.fbank._window` here)."""
    return fused_dft64(window, preemph).astype(np.float32)


@functools.lru_cache(maxsize=8)
def fused_dft64(window: str = "hamming", preemph: float = 0.97) -> np.ndarray:
    """:func:`fused_dft` before its rounding to float32."""
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
    return np.concatenate([(M.T @ cos_m)[:, :nb], (M.T @ sin_m)[:, :nb]], axis=1)


@functools.lru_cache(maxsize=1)
def twiddles() -> Tuple[np.ndarray, np.ndarray]:
    """The kernel's float64 twiddles, complex128: ``tw[k1 * 16 + n2] =
    W256^(n2 k1)`` between its two 16-point passes (lane n2 reads
    consecutive entries for each k1), and ``split[k] = W512^k`` of the
    real-FFT split step, ``W_n = exp(-2 pi i / n)``."""
    k1, n2 = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    tw = np.exp(-2j * np.pi * ((k1 * n2) % 256) / 256).ravel()
    split = np.exp(-2j * np.pi * np.arange(PADDED // 2) / PADDED)
    return tw, split


@functools.lru_cache(maxsize=8)
def mel_ranges(num_mel_bins: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                           np.ndarray]:
    """The kaldi mel bank (bins 0..255) as contiguous ranges: mel j sums
    bins ``lo[j] + i`` for ``i < n[j]`` with weights ``w[off[j] + i]``
    (float64); an empty triangle has ``n[j] == 0``.  -> (lo, n, off) int32
    and w float64, at most 512 weights (a bin feeds at most two mels)."""
    bank = kaldi_mel_banks(num_mel_bins, PADDED, float(SAMPLE_RATE))[: PADDED // 2]
    lo = np.zeros(num_mel_bins, np.int32)
    n = np.zeros(num_mel_bins, np.int32)
    for j in range(num_mel_bins):
        nz = np.flatnonzero(bank[:, j])
        if nz.size:
            lo[j], n[j] = nz[0], nz[-1] + 1 - nz[0]
    off = (np.cumsum(n) - n).astype(np.int32)
    w = np.concatenate([bank[lo[j]: lo[j] + n[j], j] for j in range(num_mel_bins)])
    return lo, n, off, w


def kernel_tables(num_mel_bins: int, window: str) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel's two tables: float64 ``[window 400 | tw re 256 | tw im
    256 | split re 256 | split im 256 | mel weights]`` (the ``TAB_*``
    offsets of ``csrc/fbank.cu``) and int32 ``[lo | n | off]``."""
    tw, split = twiddles()
    lo, n, off, w = mel_ranges(num_mel_bins)
    if w.size > 2 * MAX_MELS:  # the kernel's shared buffer (MAX_NNZ)
        raise ValueError(f"fbank kernel: {w.size} mel weights, at most {2 * MAX_MELS}")
    tab = np.concatenate([_window(window, FRAME_LEN), tw.real, tw.imag,
                          split.real, split.imag, w])
    return tab, np.concatenate([lo, n, off])


_tables: Dict[Tuple[str, int, str], Tuple[torch.Tensor, torch.Tensor]] = {}
_kernel_tables: Dict[Tuple[str, int, str], Tuple[torch.Tensor, torch.Tensor]] = {}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p]


def _device_tables(device: torch.device, num_mel_bins: int, window: str):
    """The twin's (operator (400, 512), mel (256, n_mels)) float32 on
    ``device``."""
    key = (str(device), num_mel_bins, window)
    if key not in _tables:
        mel = kaldi_mel_banks(num_mel_bins, PADDED, float(SAMPLE_RATE))[: PADDED // 2]
        _tables[key] = (
            torch.as_tensor(fused_dft(window), device=device),
            torch.as_tensor(mel.astype(np.float32), device=device).contiguous())
    return _tables[key]


def _kernel_device_tables(device: torch.device, num_mel_bins: int, window: str):
    """:func:`kernel_tables` on ``device``, built once per key."""
    key = (str(device), num_mel_bins, window)
    if key not in _kernel_tables:
        tab, idx = kernel_tables(num_mel_bins, window)
        _kernel_tables[key] = (torch.as_tensor(tab, device=device),
                               torch.as_tensor(idx, device=device))
    return _kernel_tables[key]


def prepare(device, num_mel_bins: int, window: str) -> None:
    """Put the kernel's and the twin's tables for ``(num_mel_bins, window)``
    on ``device`` now: an engine does it when it is built, so its first
    batch copies nothing from pageable host memory (a copy that would wait
    on the card's queued work)."""
    device = torch.device(device)
    if device.type == "cuda":
        _kernel_device_tables(device, num_mel_bins, window)
        _device_tables(device, num_mel_bins, window)


def check_args(waveform: torch.Tensor, num_mel_bins: int, window: str) -> None:
    """Raise ValueError for arguments the kernel does not take: a (B, N)
    float32 waveform, 1 <= n_mels <= 256, a window of
    :func:`funasr_torch.ops.fbank._window`.  Runs on tensors of any device
    (the CPU tests call it directly)."""
    if waveform.dtype != torch.float32 or waveform.dim() != 2:
        raise ValueError("fused_fbank: expects a (B, N) float32 waveform, got "
                         f"{tuple(waveform.shape)} {waveform.dtype}")
    if not 1 <= num_mel_bins <= MAX_MELS:
        raise ValueError(f"fused_fbank: num_mel_bins={num_mel_bins} outside "
                         f"1..{MAX_MELS}")
    _window(window, FRAME_LEN)  # raises for an unknown window


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
    frames = (x.unfold(1, FRAME_LEN, FRAME_SHIFT)[:, :T] if T  # (B, T, 400)
              else x.new_zeros((B, 0, FRAME_LEN)))
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
    cuda_build.refuse_autograd("fused_fbank", waveform, lengths)
    if waveform.device.type == "cpu":
        return fbank_ref(waveform, lengths, num_mel_bins, with_energy, window)
    if waveform.device.type != "cuda":
        raise ValueError(f"fused_fbank: unsupported device {waveform.device}")
    check_args(waveform, num_mel_bins, window)
    wav = waveform.contiguous()
    B, N = wav.shape
    T = num_fbank_frames(N, FRAME_LEN, FRAME_SHIFT)
    feats = torch.empty((B, T, num_mel_bins), dtype=torch.float32,
                        device=wav.device)
    db = (torch.empty((B, T), dtype=torch.float32, device=wav.device)
          if with_energy else None)
    if T > 0 and B > 0:
        tab, idx = _kernel_device_tables(wav.device, num_mel_bins, window)
        fn = cuda_build.function("fbank", "fbank_forward", _ARGTYPES)
        status = fn(wav.data_ptr(), B, N, T, tab.data_ptr(), idx.data_ptr(),
                    num_mel_bins, feats.data_ptr(),
                    None if db is None else db.data_ptr(),
                    torch.cuda.current_stream(wav.device).cuda_stream)
        cuda_build.check(status, "fbank kernel launch")
        fused_fbank.launches += 1
    out = (feats, _frame_lengths(lengths))
    return out + (db,) if with_energy else out


fused_fbank.launches = 0
