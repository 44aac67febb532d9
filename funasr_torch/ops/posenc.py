"""Position encodings (port of funasr_tpu/ops/posenc.py).

``sinusoidal_encoding`` reproduces the reference's
``SinusoidalPositionEncoder`` (funasr/models/transformer/embedding.py:383):
positions start at 1, the timescale uses ``depth/2 - 1`` in the denominator,
and the encoding is ``concat([sin, cos], -1)`` (not interleaved).  Built in
float64, then cast.  Paraformer's SANM encoder adds it at the input
feature width (560 for LFR-stacked features).  ``transformer_encoding`` is
the Transformer decoder's.  Both go up by ``device.upload``: a batch's
dispatch does not wait for the card.
"""

from __future__ import annotations

import numpy as np
import torch

from funasr_torch.device import upload


def sinusoidal_encoding(length: int, depth: int, start: int = 1,
                        dtype: torch.dtype = torch.float32,
                        device=None) -> torch.Tensor:
    """(length, depth) funasr-style sinusoidal position encoding."""
    positions = np.arange(start, start + length, dtype=np.float64)
    log_timescale_increment = np.log(10000.0) / (depth / 2 - 1)
    inv_timescales = np.exp(
        np.arange(depth // 2, dtype=np.float64) * -log_timescale_increment)
    scaled = positions[:, None] * inv_timescales[None, :]
    enc = np.concatenate([np.sin(scaled), np.cos(scaled)], axis=-1)
    return upload(enc.astype(np.float32), device).to(dtype)


def transformer_encoding(length: int, depth: int,
                         dtype: torch.dtype = torch.float32,
                         device=None) -> torch.Tensor:
    """(length, depth) Vaswani-style encoding, positions from 0, interleaved
    ``pe[:, 0::2] = sin``, ``pe[:, 1::2] = cos`` (the reference
    ``PositionalEncoding``, funasr/models/transformer/embedding.py:36).
    Built in float64, then cast."""
    position = np.arange(0, length, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, depth, 2, dtype=np.float64)
                      * -(np.log(10000.0) / depth))
    pe = np.zeros((length, depth), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return upload(pe.astype(np.float32), device).to(dtype)
