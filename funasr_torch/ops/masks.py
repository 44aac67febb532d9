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
