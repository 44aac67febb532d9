"""Streaming fbank + LFR + CMVN frontend (port of
funasr_tpu/frontends/streaming.py ``StreamingFrontend``; reference
funasr/frontends/wav_frontend.py:212 ``WavFrontendOnline``).

The host state of a stream is the JAX package's: the samples below a frame
boundary (``sample_cache``), the LFR splice cache of fbank frames not yet
consumed by a complete LFR window, with ``(lfr_m - 1) // 2`` copies of the
first frame as its left pad, and on the final chunk the offline tail (the
last frame replicated).  Chunked output equals the offline frontend on the
same audio.

Each step that yields frames runs fbank once on the device, through
``ops/fbank_kernel.py`` ``fused_fbank`` (the CUDA kernel on the card, its
twin on the CPU): 16 kHz, 25 ms / 10 ms frames, the kernel's framing; other
framings raise.  The frames come back to the host, where LFR and CMVN run
in float32 numpy as the JAX step computes them (its ``apply_cmvn`` is
``(x + means) * vars`` in float32).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from funasr_torch.device import resolve_device, upload
from funasr_torch.ops import fbank_kernel as FK


@dataclass
class FrontendState:
    sample_cache: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    splice_cache: Optional[np.ndarray] = None  # (n_cached, n_mels)


class StreamingFrontend:
    """``device=None`` means the card (raises without one unless
    ``device="cpu"``); ``kw`` takes the config's other frontend settings
    (``dither``...), which a deterministic serving frontend ignores."""

    def __init__(self, fs=16000, n_mels=80, lfr_m=7, lfr_n=6, cmvn=None,
                 window="hamming", frame_length_ms=25.0, frame_shift_ms=10.0,
                 device=None, **kw):
        self.fs = fs
        self.n_mels = n_mels
        self.lfr_m = lfr_m
        self.lfr_n = lfr_n
        self.window = window
        self.frame_len = int(fs * frame_length_ms / 1000)
        self.frame_shift = int(fs * frame_shift_ms / 1000)
        if (fs, self.frame_len, self.frame_shift) != (FK.SAMPLE_RATE, FK.FRAME_LEN,
                                                      FK.FRAME_SHIFT):
            raise ValueError(f"StreamingFrontend: the fbank kernel computes {FK.SAMPLE_RATE}"
                             f" Hz, {FK.FRAME_LEN}/{FK.FRAME_SHIFT}-sample frames")
        self.device = resolve_device(device)
        if cmvn is None:
            d = n_mels * lfr_m
            cmvn = np.stack([np.zeros(d, np.float32), np.ones(d, np.float32)])
        self.cmvn = np.asarray(cmvn, np.float32)

    def init_state(self) -> FrontendState:
        return FrontendState()

    def _fbank(self, samples: np.ndarray) -> np.ndarray:
        """(N,) samples -> (n_frames, n_mels) fbank frames on the host."""
        wav = upload(samples[None], self.device)
        lens = torch.full((1,), len(samples), dtype=torch.int32, device=self.device)
        feats, _ = FK.fused_fbank(wav, lens, num_mel_bins=self.n_mels, window=self.window)
        return feats[0].cpu().numpy()

    def step(self, state: FrontendState, samples: np.ndarray, is_final: bool = False
             ) -> Tuple[np.ndarray, FrontendState]:
        """Feed a chunk of samples; returns (lfr_cmvn_feats (T', m*mels), state)."""
        buf = np.concatenate([state.sample_cache, np.asarray(samples, np.float32)])
        n_frames = max(0, (len(buf) - self.frame_len) // self.frame_shift + 1)
        new_frames = np.zeros((0, self.n_mels), np.float32)
        if n_frames > 0:
            consumed = n_frames * self.frame_shift
            state.sample_cache = buf[consumed:]
            new_frames = self._fbank(buf[: (n_frames - 1) * self.frame_shift
                                         + self.frame_len])
        else:
            state.sample_cache = buf

        if self.lfr_m == 1 and self.lfr_n == 1:
            out = new_frames
        else:
            if state.splice_cache is None:
                if len(new_frames) == 0:
                    return np.zeros((0, self.n_mels * self.lfr_m), np.float32), state
                left = (self.lfr_m - 1) // 2
                state.splice_cache = np.repeat(new_frames[:1], left, axis=0)
            frames = np.concatenate([state.splice_cache, new_frames], axis=0)
            T = len(frames)
            if is_final:
                # offline tail semantics: T_lfr windows, replicate last frame
                right = (self.lfr_m - 1) // 2
                T_lfr = max(0, int(np.ceil((T - right) / self.lfr_n)))
                if T_lfr == 0:
                    return np.zeros((0, self.n_mels * self.lfr_m), np.float32), state
                idx = (np.arange(T_lfr)[:, None] * self.lfr_n
                       + np.arange(self.lfr_m)[None, :])
                idx = np.minimum(idx, T - 1)
                out = frames[idx].reshape(T_lfr, -1)
                state.splice_cache = frames[T_lfr * self.lfr_n:]
            else:
                # only complete windows (full right context available)
                T_lfr = max(0, (T - self.lfr_m) // self.lfr_n + 1)
                if T_lfr > 0:
                    idx = (np.arange(T_lfr)[:, None] * self.lfr_n
                           + np.arange(self.lfr_m)[None, :])
                    out = frames[idx].reshape(T_lfr, -1)
                    state.splice_cache = frames[T_lfr * self.lfr_n:]
                else:
                    out = np.zeros((0, self.n_mels * self.lfr_m), np.float32)
                    state.splice_cache = frames
        if len(out):
            out = (out.astype(np.float32) + self.cmvn[0]) * self.cmvn[1]
        return out.astype(np.float32), state
