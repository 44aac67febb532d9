"""Length-mask utilities (port of funasr_tpu/ops/masks.py).

Every variable-length tensor travels with an int lengths vector; masks are
derived from it.  Semantics of the reference's ``make_pad_mask`` /
``sequence_mask`` (funasr/models/transformer/utils/nets_utils.py).
"""

from __future__ import annotations

import torch


def sequence_mask(lengths: torch.Tensor, maxlen: int,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B,) lengths -> (B, maxlen) mask, 1 for valid positions."""
    pos = torch.arange(maxlen, device=lengths.device)[None, :]
    return (pos < lengths.to(torch.int64)[:, None]).to(dtype)


def key_mask(lengths: torch.Tensor, maxlen: int,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B,) lengths -> (B, 1, maxlen) attention key mask (1 valid)."""
    return sequence_mask(lengths, maxlen, dtype)[:, None, :]


def key_bias(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    """(B,) lengths -> (B, maxlen) float32 additive key bias: 0 for valid
    keys, -1e30 for padding (the attention kernel's mask contract,
    funasr_tpu/models/sanm.py:162)."""
    return (1.0 - sequence_mask(lengths, maxlen, torch.float32)) * -1e30


def chunk_attn_mask(T: int, chunk_size: int, left_chunks: int = -1,
                    device=None) -> torch.Tensor:
    """(T, T) float32 chunkwise attention mask (funasr_tpu/models/uniasr/
    model.py:47 ``chunk_attn_mask``): frame t sees the frames of its own chunk
    and of ``left_chunks`` chunks before it (every earlier chunk if -1), the
    SCAMA/UniASR streaming context limit (reference scama/chunk_utilis.py)."""
    idx = torch.arange(T, device=device) // chunk_size
    same_or_past = idx[:, None] >= idx[None, :]
    if left_chunks >= 0:
        same_or_past = same_or_past & (idx[:, None] - idx[None, :] <= left_chunks)
    return same_or_past.to(torch.float32)
