"""Audio input without external dependencies (port of the wav/pcm part of
funasr_tpu/utils/audio.py; reference funasr/utils/load_utils.py:48, which
uses torchaudio/ffmpeg).

``load_audio`` takes a float array, raw PCM16 bytes, or a ``.wav`` / ``.pcm``
path, and returns float32 mono at ``fs`` through a linear resampler (the
C++ runtime's ``LinearResample`` for 8k -> 16k).  Any other container
raises: the JAX package decodes mp3/flac/ogg/ffmpeg formats through its
native C++ runtime, which the port does not carry.
"""

from __future__ import annotations

import os
import wave
from typing import Optional, Tuple, Union

import numpy as np


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a RIFF/WAVE file -> (float32 mono waveform in [-1, 1], fs)."""
    with wave.open(path, "rb") as w:
        fs = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width} in {path}")
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    return data, fs


def load_pcm(path: str, dtype="<i2") -> np.ndarray:
    """Raw little-endian PCM16 samples -> float32 in [-1, 1]."""
    return np.fromfile(path, dtype=dtype).astype(np.float32) / 32768.0


def resample_linear(x: np.ndarray, fs_in: int, fs_out: int) -> np.ndarray:
    """Linear-interpolation resample (runtime/onnxruntime/src/resample.cpp
    equivalent for the common 8k/22k/44.1k -> 16k serving path)."""
    if fs_in == fs_out:
        return x
    n_out = int(round(len(x) * fs_out / fs_in))
    if n_out == 0 or len(x) == 0:  # a server's final flush sends no samples
        return np.zeros(n_out if len(x) else 0, np.float32)
    t_out = np.arange(n_out, dtype=np.float64) * fs_in / fs_out
    return np.interp(t_out, np.arange(len(x), dtype=np.float64), x).astype(np.float32)


def load_audio(source: Union[str, bytes, np.ndarray], fs: int = 16000,
               audio_fs: Optional[int] = None) -> np.ndarray:
    """A float array, raw PCM16 bytes, or a ``.wav``/``.pcm`` path -> float32
    mono waveform at ``fs``; ``audio_fs`` is the rate of a raw input (array,
    bytes, pcm), default ``fs``."""
    if isinstance(source, np.ndarray):
        wav = source.astype(np.float32)
        in_fs = audio_fs or fs
    elif isinstance(source, (bytes, bytearray)):
        wav = np.frombuffer(bytes(source), dtype="<i2").astype(np.float32) / 32768.0
        in_fs = audio_fs or fs
    elif isinstance(source, str):
        ext = os.path.splitext(source)[1].lower()
        if ext == ".wav":
            wav, in_fs = load_wav(source)
        elif ext == ".pcm":
            wav, in_fs = load_pcm(source), (audio_fs or fs)
        else:
            raise ValueError(f"unsupported audio format {ext!r}: the port reads "
                             ".wav and .pcm (and arrays or PCM16 bytes)")
    else:
        raise TypeError(f"cannot load audio from {type(source)}")
    return resample_linear(wav, in_fs, fs)
