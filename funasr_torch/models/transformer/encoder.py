"""Vanilla Transformer encoder, inference path (port of
funasr_tpu/models/transformer/encoder.py:25-108; reference
funasr/models/transformer/encoder.py ``TransformerEncoder``).

conv2d subsampling (or the linear embed: Linear -> LayerNorm -> ReLU) ->
x * sqrt(d) + the Vaswani position encoding -> N x pre-norm (multi-head
attention, position-wise FFN) layers -> after_norm.

Parameter names are FunASR's torch names (``embed.conv.0``, ``embed.out.0``
or ``embed.0``/``embed.1``, ``encoders.{i}.self_attn.linear_q``,
``feed_forward.w_1``, ``norm1``, ``norm2``, ``after_norm``).  The attention
is the decoder's :class:`~funasr_torch.models.transformer.decoder.
MultiHeadAttention` (the JAX package computes it as an einsum, outside any
Pallas kernel).  The FFN is the SANM encoder's
:class:`~funasr_torch.models.sanm.PositionwiseFeedForward`: after
``quantize_weights()`` the fused int8 FFN (``ops/ffn.py``) at every row
count, where the JAX package takes its Pallas FFN only when the rows, K, H
and N are multiples of 128 (``funasr_tpu/models/sanm.py:320-345``).  The
other projections follow the QDense rule of
:class:`~funasr_torch.models.sanm.Dense`.  Inference only: the dropout
rates are accepted and ignored.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from funasr_torch.models.conformer import Conv2dSubsampling
from funasr_torch.models.sanm import Dense, LayerNormF32, PositionwiseFeedForward
from funasr_torch.models.transformer.decoder import MultiHeadAttention
from funasr_torch.ops.masks import key_mask
from funasr_torch.ops.posenc import transformer_encoding
from funasr_torch.registry import tables


class TransformerEncoderLayer(nn.Module):
    def __init__(self, size: int, n_head: int, linear_units: int,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm1 = LayerNormF32(size, dtype)
        self.self_attn = MultiHeadAttention(n_head, size, dtype, param_dtype)
        self.norm2 = LayerNormF32(size, dtype)
        self.feed_forward = PositionwiseFeedForward(size, linear_units, dtype, param_dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x)
        x = x + self.self_attn(h, h, mask)
        return x + self.feed_forward(self.norm2(x))


@tables.register("encoder_classes", "TransformerEncoder")
class TransformerEncoder(nn.Module):
    def __init__(self, input_size: int, output_size: int = 256,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, input_layer: str = "conv2d",
                 dtype: torch.dtype = torch.float32, dropout_rate: float = 0.0,
                 attention_dropout_rate: float = 0.0,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if input_layer == "conv2d":
            self.embed = Conv2dSubsampling(input_size, output_size, dtype, param_dtype)
        elif input_layer == "linear":
            self.embed = nn.Sequential(
                Dense(input_size, output_size, dtype=dtype, param_dtype=param_dtype),
                LayerNormF32(output_size, dtype))
        else:
            raise NotImplementedError(f"input_layer={input_layer!r} ('conv2d' or 'linear')")
        self.input_layer = input_layer
        self._output_size = output_size
        self.dtype = dtype
        self.encoders = nn.ModuleList([
            TransformerEncoderLayer(output_size, attention_heads, linear_units, dtype,
                                    param_dtype) for _ in range(num_blocks)])
        self.after_norm = LayerNormF32(output_size, dtype)

    def output_size(self) -> int:
        return self._output_size

    def forward(self, xs: torch.Tensor, lengths: torch.Tensor):
        """xs (B, T, input_size); lengths (B,) -> (out (B, T', D), lengths')."""
        if self.input_layer == "conv2d":
            x, lengths = self.embed(xs, lengths)
        else:
            x = torch.relu(self.embed[1](self.embed[0](xs)))
        T, d = x.shape[1], self._output_size
        pe = transformer_encoding(T, d, device=x.device)
        x = x * (d ** 0.5) + pe[None].to(x.dtype)
        mask = key_mask(lengths, T)[:, None]  # (B, 1, 1, T)
        for layer in self.encoders:
            x = layer(x, mask)
        return self.after_norm(x), lengths
