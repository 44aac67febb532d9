"""Depthwise 1-D convolution over (B, T, C) (the forward of
funasr_tpu/ops/dwconv.py:47 ``conv1d_grouped`` with one group a channel, as
funasr_tpu/models/branchformer.py:40-49 ``_depthwise_conv1d`` uses it).

Same padding, (K - 1) // 2 frames on each side, and no mask: pad frames take
part, as in the reference's CSGU and E-Branchformer merge convolutions.  The
JAX package computes it as an XLA grouped convolution, not a Pallas kernel;
here it is ``F.conv1d`` with ``groups=C``, in the input's dtype.  A float32
convolution on the card goes through cuDNN, which uses TF32 unless
``torch.backends.cudnn.allow_tf32`` is False: float32 references set it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def depthwise_conv1d(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, T, C); weight (C, 1, K) (a depthwise ``nn.Conv1d``'s), cast to
    x's dtype; bias (C,) added in x's dtype after the convolution."""
    pad = (weight.shape[-1] - 1) // 2
    out = F.conv1d(x.transpose(1, 2), weight.to(x.dtype), None, padding=pad,
                   groups=x.shape[-1]).transpose(1, 2)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out
