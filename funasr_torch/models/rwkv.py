"""The RWKV time mix, the self-attention of the RWKV decoder (port of
funasr_tpu/models/rwkv.py:31-86 ``wkv_scan``, ``_token_shift``,
``TimeMix``; reference funasr/models/conformer_rwkv/decoder.py, BlinkDL's
RWKV-4 ``RWKV_TimeMix``).

The WKV recurrence is a loop over time in float32 with a running
log-sum-exp state per channel, the JAX ``lax.scan`` step by step: ``pp``
starts at -1e30, the decay is ``exp(time_decay)``, and the max-exponent
updates come in the JAX order.  It is causal, so positions after a prefix
cannot reach it.  The JAX package computes it with XLA, not a Pallas kernel;
here it is plain PyTorch (one small launch an operation a position on the
card).  The time mix runs in float32 whatever the model's dtype, its four
projections plain (never int8), as the JAX ``nn.Dense`` on float32 inputs.

Parameter names are RWKV-4's torch names: ``time_decay``, ``time_first``,
``time_mix_k``/``_v``/``_r`` (the JAX package's ``mu_k``/``mu_v``/
``mu_r``), ``key``, ``value``, ``receptance`` (``recept``), ``output``.
The RWKV encoder and BAT (``ChannelMix``, ``RWKVBlock``) are not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from funasr_torch.models.sanm import PlainDense


def wkv_scan(k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
             u: torch.Tensor) -> torch.Tensor:
    """RWKV WKV recurrence: k, v (B, T, C) float32; w (C,) the decay (> 0);
    u (C,) the bonus of the current token -> (B, T, C)."""
    B, T, C = k.shape
    aa = torch.zeros((B, C), dtype=torch.float32, device=k.device)
    bb = torch.zeros_like(aa)
    pp = torch.full_like(aa, -1e30)
    out = []
    for t in range(T):
        kt, vt = k[:, t], v[:, t]
        ww = u + kt
        p = torch.maximum(pp, ww)
        e1 = torch.exp(pp - p)
        e2 = torch.exp(ww - p)
        out.append((e1 * aa + e2 * vt) / (e1 * bb + e2))
        ww2 = pp - w
        p2 = torch.maximum(ww2, kt)
        e1 = torch.exp(ww2 - p2)
        e2 = torch.exp(kt - p2)
        aa, bb, pp = e1 * aa + e2 * vt, e1 * bb + e2, p2
    return torch.stack(out, dim=1)


def token_shift(x: torch.Tensor) -> torch.Tensor:
    """x_{t-1} along axis 1, zeros at t = 0 (RWKV's one-step shift)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


class TimeMix(nn.Module):
    """RWKV time mix: token-shift interpolation -> key, value, receptance ->
    WKV scan -> sigmoid(r) * wkv -> output, all in float32."""

    def __init__(self, dim: int):
        super().__init__()
        f32 = dict(bias=False, dtype=torch.float32)
        self.time_mix_k = nn.Parameter(torch.zeros(dim))
        self.time_mix_v = nn.Parameter(torch.zeros(dim))
        self.time_mix_r = nn.Parameter(torch.zeros(dim))
        self.key = PlainDense(dim, dim, **f32)
        self.value = PlainDense(dim, dim, **f32)
        self.receptance = PlainDense(dim, dim, **f32)
        self.time_decay = nn.Parameter(torch.zeros(dim))
        self.time_first = nn.Parameter(torch.zeros(dim))
        self.output = PlainDense(dim, dim, **f32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, T, dim) -> (B, T, dim) float32."""
        xf = x.to(torch.float32)
        prev = token_shift(xf)
        mix = lambda mu: xf * mu + prev * (1 - mu)  # noqa: E731
        k = self.key(mix(self.time_mix_k))
        v = self.value(mix(self.time_mix_v))
        r = torch.sigmoid(self.receptance(mix(self.time_mix_r)))
        wkv = wkv_scan(k, v, torch.exp(self.time_decay), self.time_first)
        return self.output(r * wkv)
