"""RWKV blocks: the time mix of the RWKV decoder, and the RWKV encoder and
BAT (port of funasr_tpu/models/rwkv.py; reference
funasr/models/conformer_rwkv/decoder.py and funasr/models/rwkv_bat/,
BlinkDL's RWKV-4 ``RWKV_TimeMix`` / ``RWKV_ChannelMix``).

The WKV recurrence runs through ``ops/wkv.py`` ``wkv``: the CUDA kernel on
the card (one launch a time mix), its plain twin (a float32 loop over time
with a running log-sum-exp state per channel, the JAX ``lax.scan`` step by
step) on the CPU.  The time mix, the channel mix and the whole encoder run
in float32 whatever the model's dtype, their projections plain (never
int8), as the JAX ``nn.Dense`` on float32 inputs; the encoder casts its
output to the model's dtype.

- :class:`TimeMix` (the decoder's self-attention and the blocks' ``att``):
  token-shift interpolation -> key, value, receptance -> WKV ->
  sigmoid(r) * wkv -> output;
- :class:`ChannelMix` (``ffn``): token shift -> relu(key)^2 -> value, gated
  by sigmoid(receptance);
- :class:`RWKVBlock`: ``x += att(ln1(x)); x += ffn(ln2(x))``;
- :class:`RWKVEncoder`: ``embed`` (a dense layer on the features, no
  subsampling: a frame an input frame) -> ``ln_in`` -> blocks -> ``ln_out``;
- :class:`RWKVBAT` (registered also as ``BAT``): the Transducer
  (``models/transducer``) over the RWKV encoder.

Parameter names are RWKV-4's torch names: ``time_decay``, ``time_first``,
``time_mix_k``/``_v``/``_r`` (the JAX package's ``mu_k``/``mu_v``/``mu_r``),
``key``, ``value``, ``receptance`` (``recept``), ``output``, ``blocks.{i}.
{ln1,att,ln2,ffn}``, ``ln_out``; the encoder's input layers keep the JAX
names ``embed`` and ``ln_in``.  The JAX package has no torch converter for
this encoder: ``convert.rwkv_bat_from_jax`` is the only mapping.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from funasr_torch.models.sanm import LayerNormF32, PlainDense
from funasr_torch.models.transducer.model import Transducer
from funasr_torch.ops import wkv as W
from funasr_torch.ops.wkv import wkv_ref as wkv_scan  # noqa: F401  (the twin, by its JAX name)
from funasr_torch.registry import tables

_F32 = dict(bias=False, dtype=torch.float32)


def token_shift(x: torch.Tensor) -> torch.Tensor:
    """x_{t-1} along axis 1, zeros at t = 0 (RWKV's one-step shift)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _mix(x: torch.Tensor, prev: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    return x * mu + prev * (1 - mu)


class TimeMix(nn.Module):
    """RWKV time mix: token-shift interpolation -> key, value, receptance ->
    WKV (``ops/wkv.py``) -> sigmoid(r) * wkv -> output, all in float32."""

    def __init__(self, dim: int):
        super().__init__()
        self.time_mix_k = nn.Parameter(torch.zeros(dim))
        self.time_mix_v = nn.Parameter(torch.zeros(dim))
        self.time_mix_r = nn.Parameter(torch.zeros(dim))
        self.key = PlainDense(dim, dim, **_F32)
        self.value = PlainDense(dim, dim, **_F32)
        self.receptance = PlainDense(dim, dim, **_F32)
        self.time_decay = nn.Parameter(torch.zeros(dim))
        self.time_first = nn.Parameter(torch.zeros(dim))
        self.output = PlainDense(dim, dim, **_F32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, T, dim) -> (B, T, dim) float32."""
        xf = x.to(torch.float32)
        prev = token_shift(xf)
        k = self.key(_mix(xf, prev, self.time_mix_k))
        v = self.value(_mix(xf, prev, self.time_mix_v))
        r = torch.sigmoid(self.receptance(_mix(xf, prev, self.time_mix_r)))
        return self.output(r * W.wkv(k, v, torch.exp(self.time_decay), self.time_first))


class ChannelMix(nn.Module):
    """RWKV channel mix: token shift -> sigmoid(receptance) *
    value(relu(key)^2), in float32 (funasr_tpu/models/rwkv.py:89)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.time_mix_k = nn.Parameter(torch.zeros(dim))
        self.time_mix_r = nn.Parameter(torch.zeros(dim))
        self.key = PlainDense(dim, hidden, **_F32)
        self.receptance = PlainDense(dim, dim, **_F32)
        self.value = PlainDense(hidden, dim, **_F32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        prev = token_shift(xf)
        k = torch.square(torch.relu(self.key(_mix(xf, prev, self.time_mix_k))))
        r = torch.sigmoid(self.receptance(_mix(xf, prev, self.time_mix_r)))
        return r * self.value(k)


class RWKVBlock(nn.Module):
    """``x += att(ln1(x)); x += ffn(ln2(x))``, float32 (rwkv.py:107)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.ln1 = LayerNormF32(dim)
        self.att = TimeMix(dim)
        self.ln2 = LayerNormF32(dim)
        self.ffn = ChannelMix(dim, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.att(self.ln1(x))
        return x + self.ffn(self.ln2(x))


@tables.register("encoder_classes", "RWKVEncoder")
class RWKVEncoder(nn.Module):
    """embed -> ln_in -> ``num_blocks`` RWKV blocks -> ln_out, float32, the
    output cast to ``dtype``; lengths pass through (rwkv.py:120)."""

    def __init__(self, input_size: int, output_size: int = 256, num_blocks: int = 6,
                 linear_units: int = 1024, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        """``param_dtype`` is accepted for the encoders' common signature:
        every parameter here is float32."""
        super().__init__()
        self._output_size = output_size
        self.dtype = dtype
        self.embed = PlainDense(input_size, output_size, dtype=torch.float32)
        self.ln_in = LayerNormF32(output_size)
        self.blocks = nn.ModuleList([RWKVBlock(output_size, linear_units)
                                     for _ in range(num_blocks)])
        self.ln_out = LayerNormF32(output_size)

    def output_size(self) -> int:
        return self._output_size

    def forward(self, xs: torch.Tensor, lengths: torch.Tensor):
        """xs (B, T, input_size) -> (out (B, T, D) in ``dtype``, lengths)."""
        x = self.ln_in(self.embed(xs.to(torch.float32)))
        for block in self.blocks:
            x = block(x)
        return self.ln_out(x).to(self.dtype), lengths


# Conformer-only encoder_conf keys that the JAX make_encoder drops (rwkv.py:155)
_CONFORMER_ONLY = ("attention_heads", "cnn_module_kernel", "attention_dropout_rate",
                   "dropout_rate", "input_layer")


@tables.register("model_classes", "BAT")
@tables.register("model_classes", "RWKVBAT")
class RWKVBAT(Transducer):
    """The Transducer over the RWKV encoder (funasr_tpu/models/rwkv.py:147)."""

    def make_encoder(self, input_size: int, encoder_conf: Optional[Dict[str, Any]],
                     dtype: torch.dtype, param_dtype: Optional[torch.dtype]) -> nn.Module:
        conf = dict(encoder_conf or {})
        for key in _CONFORMER_ONLY:
            conf.pop(key, None)
        return RWKVEncoder(input_size=input_size, dtype=dtype, param_dtype=param_dtype,
                           **conf)
