"""Depthwise 1-D convolution over (B, T, C): the forward of
funasr_tpu/ops/dwconv.py:47 ``conv1d_grouped`` with one group a channel, as
funasr_tpu/models/branchformer.py:40-49 ``_depthwise_conv1d`` (same padding),
funasr_tpu/models/sanm.py ``fsmn_memory`` and the PIF predictor's alpha head
(their own left and right padding) use it.

Zero padding and no mask: pad frames take part.  The JAX package computes it
as an XLA grouped convolution, not a Pallas kernel; here it is ``F.conv1d``
with ``groups=C`` in the input's dtype.  float32 means float32: on the card a
float32 convolution runs with cuDNN's TF32 off (``device.cudnn_float32``;
cuDNN's default is on), whatever the caller's setting.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from funasr_torch.device import cudnn_float32


def depthwise_conv1d(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     padding: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """x (B, T, C); weight (C, 1, K) (a depthwise ``nn.Conv1d``'s), cast to
    x's dtype; ``padding`` (left, right) zero frames, by default (K - 1) // 2
    on each side; bias (C,) added in x's dtype after the convolution."""
    if padding is None:
        padding = ((weight.shape[-1] - 1) // 2,) * 2
    full = x.dtype == torch.float32 and x.is_cuda
    with cudnn_float32() if full else contextlib.nullcontext():
        out = F.conv1d(F.pad(x.transpose(1, 2), padding), weight.to(x.dtype),
                       groups=x.shape[-1]).transpose(1, 2)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out
