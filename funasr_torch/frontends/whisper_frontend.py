"""Whisper log-mel frontend (port of funasr_tpu/frontends/whisper_frontend.py;
reference funasr/frontends/whisper_frontend.py ``WhisperFrontend`` wraps
openai-whisper's log_mel_spectrogram).

Whisper semantics: n_fft=400, hop=160, Hann window, center-padded
(reflect), n_mels=80 (128 for large-v3), Slaney-scale mel filterbank,
``log10(max(S, 1e-10))`` clamped to each utterance's ``max - 8`` over
(mels, T), then ``(x + 4) / 4``.

The JAX package computes the framed DFT as two float32 matrix products in
XLA (no Pallas kernel), so here they are two ``torch.matmul`` calls on the
device, in float32 (torch's default keeps TF32 off for them, as for every
float32 product of the port).  The tables (window, DFT matrices, mel bank)
are host numpy, uploaded once per device.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from funasr_torch.device import resolve_device, upload
from funasr_torch.registry import tables

N_FFT = 400
HOP = 160


def _slaney_mel_banks(n_mels: int, n_fft: int = N_FFT, fs: int = 16000
                      ) -> np.ndarray:
    """librosa-style (Slaney) mel filterbank, matching whisper's
    mel_filters asset (copied from the JAX package)."""
    n_freqs = n_fft // 2 + 1
    fmin, fmax = 0.0, fs / 2.0

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / (200.0 / 3)
        logstep = np.log(6.4) / 27.0
        mel = f / (200.0 / 3)
        log_t = f >= min_log_hz
        mel = np.where(log_t, min_log_mel
                       + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                       mel)
        return mel

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / (200.0 / 3)
        logstep = np.log(6.4) / 27.0
        f = m * (200.0 / 3)
        log_t = m >= min_log_mel
        return np.where(log_t, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                        f)

    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz = mel_to_hz(mels)
    freqs = np.linspace(0, fs / 2, n_freqs)
    banks = np.zeros((n_mels, n_freqs))
    for i in range(n_mels):
        lo, ctr, hi = hz[i], hz[i + 1], hz[i + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - freqs) / max(hi - ctr, 1e-10)
        banks[i] = np.maximum(0.0, np.minimum(up, down))
        # Slaney normalization: constant energy per band
        banks[i] *= 2.0 / (hi - lo)
    return banks.astype(np.float32)


def host_tables(n_mels: int) -> Dict[str, np.ndarray]:
    """The frontend's float32 tables: the periodic Hann window, the real and
    imaginary DFT matrices (n_fft, n_fft/2 + 1) and the mel bank."""
    n_freqs = N_FFT // 2 + 1
    k = np.arange(N_FFT)[:, None] * np.arange(n_freqs)[None, :]
    return {"window": np.hanning(N_FFT + 1)[:-1].astype(np.float32),
            "cos": np.cos(2 * np.pi * k / N_FFT).astype(np.float32),
            "sin": (-np.sin(2 * np.pi * k / N_FFT)).astype(np.float32),
            "banks": _slaney_mel_banks(n_mels)}


@functools.lru_cache(maxsize=None)
def _device_tables(n_mels: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """:func:`host_tables` on ``device``, uploaded once (a copy from pageable
    memory inside a batch would wait on the card)."""
    return {k: upload(v, device) for k, v in host_tables(n_mels).items()}


def log_mel_spectrogram(wav: torch.Tensor, n_mels: int = 80,
                        pad_to: Optional[int] = None) -> torch.Tensor:
    """(B, N) float waveform -> (B, n_mels, T) whisper log-mel, float32, on
    ``wav``'s device.

    T = N // HOP (whisper drops the last frame).  ``pad_to`` right-pads the
    time axis with -1, the floor value, to that length (3000 for 30 s)."""
    wav = wav.to(torch.float32)
    tab = _device_tables(n_mels, wav.device)
    half = N_FFT // 2
    x = F.pad(wav[:, None], (half, half), mode="reflect")[:, 0]
    frames = x.unfold(-1, N_FFT, HOP) * tab["window"]  # (B, N // HOP + 1, n_fft)
    re = frames @ tab["cos"]
    im = frames @ tab["sin"]
    power = (re * re + im * im)[:, :-1]  # whisper: magnitudes[..., :-1]
    mel = tab["banks"] @ power.transpose(1, 2)  # (B, n_mels, T)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    floor = log_spec.amax(dim=(1, 2), keepdim=True) - 8.0
    log_spec = (torch.maximum(log_spec, floor) + 4.0) / 4.0
    if pad_to is not None and pad_to > log_spec.shape[-1]:
        log_spec = F.pad(log_spec, (0, pad_to - log_spec.shape[-1]), value=-1.0)
    return log_spec


@tables.register("frontend_classes", "WhisperFrontend")
class WhisperFrontend:
    """One 30 s window a waveform: zero-padded or truncated to
    ``chunk_seconds``, then :func:`log_mel_spectrogram` padded to
    ``chunk_samples // HOP`` frames.  Runs on ``device`` (None: the card)."""

    def __init__(self, n_mels: int = 80, fs: int = 16000, chunk_seconds: int = 30,
                 device=None, **kwargs):
        self.n_mels = n_mels
        self.fs = fs
        self.chunk_samples = chunk_seconds * fs
        self.pad_to = self.chunk_samples // HOP
        self.device = resolve_device(device)

    def window(self, wav: np.ndarray) -> np.ndarray:
        """A waveform cut or zero-padded to one window, float32."""
        w = np.zeros((self.chunk_samples,), np.float32)
        n = min(len(wav), self.chunk_samples)
        w[:n] = wav[:n]
        return w

    def batch(self, wavs: Sequence[np.ndarray]) -> torch.Tensor:
        """Waveforms -> (B, n_mels, 3000) input features on the device: one
        upload through pinned memory, one frontend pass."""
        w = upload(np.stack([self.window(x) for x in wavs]), self.device)
        return log_mel_spectrogram(w, self.n_mels, pad_to=self.pad_to)

    def __call__(self, wav: np.ndarray) -> torch.Tensor:
        """Mono waveform -> (1, n_mels, 3000) whisper input features."""
        return self.batch([wav])
