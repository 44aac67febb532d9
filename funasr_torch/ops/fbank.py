"""Kaldi-compatible log-mel fbank + LFR + CMVN on tensors.

Port of funasr_tpu/ops/fbank.py.  The reference frontend
(funasr/frontends/wav_frontend.py:79 ``WavFrontend``) loops per utterance
calling ``torchaudio.compliance.kaldi.fbank``; here the chain is batched:

  frames (strided view) -> DC removal -> preemphasis -> hamming window
  -> power spectrum (DFT as a matmul) -> mel filterbank (matmul) -> log
  -> LFR stacking (gather) -> CMVN (affine)

Kaldi semantics (golden-tested in the JAX package): ``snip_edges`` framing
``1 + (N - 400) // 160``, waveform scaled by ``1 << 15``, per-frame mean
removal, preemphasis 0.97 with the first sample duplicated, hamming window,
zero-pad to 512, 80 kaldi mel bins with the Nyquist row zero,
``log(max(e, eps_f32))``; LFR left-pads ``(m-1)//2`` copies of frame 0 and
replicates the last valid frame; CMVN is ``(x + means) * vars``.

The numpy tables (mel banks, DFT matrices, windows) are built in float64
exactly as the JAX package builds them.  This module is the plain frontend;
the fused CUDA kernel is ``ops/fbank_kernel.py``.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

LOG_EPS = float(np.finfo(np.float32).eps)  # kaldi uses f32 epsilon


def _round_to_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def hz_to_mel(hz):
    return 1127.0 * np.log1p(np.asarray(hz, dtype=np.float64) / 700.0)


@functools.lru_cache(maxsize=8)
def kaldi_mel_banks(
    num_bins: int, padded_window_size: int, sample_freq: float,
    low_freq: float = 20.0, high_freq: float = 0.0,
) -> np.ndarray:
    """Kaldi triangular mel filterbank, shape (num_fft_bins+1, num_bins),
    float64; the nyquist row is zero (kaldi ``MelBanks``)."""
    nyquist = 0.5 * sample_freq
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    num_fft_bins = padded_window_size // 2
    fft_bin_width = sample_freq / padded_window_size
    mel_low = hz_to_mel(low_freq)
    mel_high = hz_to_mel(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    mel_of_bin = hz_to_mel(np.arange(num_fft_bins) * fft_bin_width)  # (F,)
    left = mel_low + np.arange(num_bins) * mel_delta  # (M,)
    center = left + mel_delta
    right = center + mel_delta
    up = (mel_of_bin[None, :] - left[:, None]) / (center - left)[:, None]
    down = (right[:, None] - mel_of_bin[None, :]) / (right - center)[:, None]
    weights = np.where(mel_of_bin[None, :] <= center[:, None], up, down)
    weights = np.maximum(weights, 0.0)
    weights = np.where(
        (mel_of_bin[None, :] > left[:, None]) & (mel_of_bin[None, :] < right[:, None]),
        weights, 0.0,
    )
    banks = np.zeros((num_fft_bins + 1, num_bins), dtype=np.float64)
    banks[:num_fft_bins, :] = weights.T  # nyquist row stays zero
    return banks


@functools.lru_cache(maxsize=8)
def _dft_matrices(window_size: int, padded_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Real/imag DFT matrices (window_size, padded_size//2 + 1), float64.
    Only the first ``window_size`` input rows are kept: the zero padding
    contributes nothing."""
    n_out = padded_size // 2 + 1
    k = np.arange(n_out)[None, :]
    n = np.arange(window_size)[:, None]
    ang = -2.0 * np.pi * n * k / padded_size
    return np.cos(ang), np.sin(ang)


@functools.lru_cache(maxsize=8)
def _window(window_type: str, size: int) -> np.ndarray:
    n = np.arange(size, dtype=np.float64)
    a = 2.0 * np.pi / (size - 1)
    if window_type == "hamming":
        return 0.54 - 0.46 * np.cos(a * n)
    if window_type == "hanning":
        return 0.5 - 0.5 * np.cos(a * n)
    if window_type == "povey":
        return (0.5 - 0.5 * np.cos(a * n)) ** 0.85
    if window_type == "rectangular":
        return np.ones(size)
    raise ValueError(f"unknown window type {window_type!r}")


def num_fbank_frames(num_samples, frame_length: int, frame_shift: int):
    """snip_edges frame count; works on ints or integer tensors."""
    if isinstance(num_samples, torch.Tensor):
        n = torch.div(num_samples - frame_length, frame_shift,
                      rounding_mode="floor") + 1
        return torch.clamp(n, min=0)
    return max(int((num_samples - frame_length) // frame_shift + 1), 0)


def fbank(
    waveform: torch.Tensor,
    lengths: torch.Tensor,
    *,
    num_mel_bins: int = 80,
    frame_length_ms: float = 25.0,
    frame_shift_ms: float = 10.0,
    fs: int = 16000,
    window_type: str = "hamming",
    preemphasis: float = 0.97,
    remove_dc_offset: bool = True,
    upscale: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched kaldi fbank with dither 0.

    waveform: (B, N) float in [-1, 1] (scaled by 1<<15 when ``upscale``);
    lengths: (B,) valid sample counts.  Returns feats (B, T, num_mel_bins)
    float32 (T from N; frames past a row's length are padding) and
    feat_lengths (B,) int32.
    """
    B, N = waveform.shape
    frame_length = int(fs * frame_length_ms / 1000)
    frame_shift = int(fs * frame_shift_ms / 1000)
    padded = _round_to_pow2(frame_length)
    dev = waveform.device

    x = waveform.to(torch.float32)
    if upscale:
        x = x * float(1 << 15)
    T = num_fbank_frames(N, frame_length, frame_shift)
    if T == 0:
        return (torch.zeros((B, 0, num_mel_bins), dtype=torch.float32, device=dev),
                torch.zeros((B,), dtype=torch.int32, device=dev))
    frames = x.unfold(1, frame_length, frame_shift)[:, :T]  # (B, T, L)

    if remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if preemphasis != 0.0:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - preemphasis * prev
    win = torch.as_tensor(_window(window_type, frame_length), dtype=torch.float32,
                          device=dev)
    frames = frames * win

    cos_m, sin_m = _dft_matrices(frame_length, padded)
    re = frames @ torch.as_tensor(cos_m, dtype=torch.float32, device=dev)
    im = frames @ torch.as_tensor(sin_m, dtype=torch.float32, device=dev)
    power = re * re + im * im  # (B, T, padded//2+1)

    mel = torch.as_tensor(kaldi_mel_banks(num_mel_bins, padded, float(fs)),
                          dtype=torch.float32, device=dev)
    feats = torch.log(torch.clamp_min(power @ mel, LOG_EPS))
    feat_lengths = num_fbank_frames(lengths.to(torch.int64), frame_length,
                                    frame_shift).to(torch.int32)
    return feats, feat_lengths


def apply_lfr(feats: torch.Tensor, feat_lengths: torch.Tensor, lfr_m: int,
              lfr_n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Low-frame-rate stacking (wav_frontend.py:58 ``apply_lfr``).

    Output frame t stacks source frames ``t*n + j - (m-1)//2`` for j < m,
    clamped to each row's own ``[0, len-1]``, so a padded batch matches the
    reference's per-utterance loop exactly.
    """
    B, T, D = feats.shape
    dev = feats.device
    left = (lfr_m - 1) // 2
    T_lfr = -(-T // lfr_n)
    src = (torch.arange(T_lfr, device=dev)[:, None] * lfr_n
           + torch.arange(lfr_m, device=dev)[None, :] - left)  # (T_lfr, m)
    last = torch.clamp_min(feat_lengths.to(torch.int64), 1)[:, None, None] - 1
    src = torch.minimum(torch.clamp_min(src[None], 0), last)  # (B, T_lfr, m)
    idx = src.reshape(B, T_lfr * lfr_m, 1).expand(B, T_lfr * lfr_m, D)
    out = torch.gather(feats, 1, idx).reshape(B, T_lfr, lfr_m * D)
    out_lengths = torch.ceil(feat_lengths.to(torch.float32) / lfr_n).to(torch.int32)
    return out, out_lengths


def apply_cmvn(feats: torch.Tensor, cmvn: torch.Tensor) -> torch.Tensor:
    """Affine CMVN: ``(x + means) * vars`` (wav_frontend.py:41)."""
    return (feats + cmvn[0][None, None, :]) * cmvn[1][None, None, :]


def load_cmvn_file(path: str) -> np.ndarray:
    """Parse a kaldi-nnet ``am.mvn`` file into a (2, D) [means; vars] array
    (reference ``load_cmvn``, wav_frontend.py:15)."""
    means, variances = None, None
    with open(path, "r", encoding="utf-8") as f:
        lines = f.readlines()
    for i, line in enumerate(lines):
        item = line.split()
        if not item:
            continue
        if item[0] == "<AddShift>":
            nxt = lines[i + 1].split()
            if nxt[0] == "<LearnRateCoef>":
                means = np.array(nxt[3: len(nxt) - 1], dtype=np.float32)
        elif item[0] == "<Rescale>":
            nxt = lines[i + 1].split()
            if nxt[0] == "<LearnRateCoef>":
                variances = np.array(nxt[3: len(nxt) - 1], dtype=np.float32)
    if means is None or variances is None:
        raise ValueError(f"could not parse cmvn file {path}")
    return np.stack([means, variances])


def pad_frames(feats: torch.Tensor, multiple: int = 128) -> torch.Tensor:
    """Zero-pad the frame axis of (B, T, D) features up to a multiple.
    Padding frames sit beyond the length mask, so results are unchanged;
    the padded shapes are the ones the JAX serving path runs."""
    T = feats.shape[1]
    Tp = -(-T // multiple) * multiple
    if Tp == T:
        return feats
    return F.pad(feats, (0, 0, 0, Tp - T))
