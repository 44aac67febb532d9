"""Autoregressive Transformer and RWKV decoders, full-prefix forward (port
of funasr_tpu/models/transformer/decoder.py:31-245; reference
funasr/models/transformer/decoder.py ``TransformerDecoder``,
funasr/models/conformer_rwkv/decoder.py ``TransformerRWKVDecoder``).

embed + scaled positional encoding -> N x (causal self-attn, cross-attn,
FFN) pre-norm -> after_norm -> output projection.  ``forward`` scores whole
padded target grids; the beam scores incrementally through the KV-cached
step scorer over this module's weights (``ops/cached_decoder.py``), and
uses ``forward`` only with ``decode_beam(use_cache=False)``.

Parameter names are FunASR's torch names (``embed.0``, ``decoders.{i}.
self_attn.linear_q``, ``src_attn``, ``feed_forward.w_1``, ``norm1..3``,
``after_norm``, ``output_layer``).  Every projection is a
:class:`~funasr_torch.models.sanm.Dense` (the JAX QDense).

``TransformerRWKVDecoder`` (the reference's conformer_rwkv decoder) puts
the RWKV time mix (``models/rwkv.py``, float32, causal by construction) in
place of the causal self-attention, ``decoders.{i}.self_attn.time_decay``
...; its FFN is the SANM :class:`~funasr_torch.models.sanm.
PositionwiseFeedForward`, fused int8 after ``quantize_weights()``.  The
beam scores it through the full prefix every step.  The four
``*ConvolutionTransformerDecoder`` classes of the JAX package
(decoder.py:489-509) are registered and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from funasr_torch.models.rwkv import TimeMix
from funasr_torch.models.sanm import (Dense, LayerNormF32, PositionwiseFeedForward,
                                      masked_softmax)
from funasr_torch.ops import attention as A
from funasr_torch.ops.masks import key_mask, sequence_mask
from funasr_torch.ops.posenc import transformer_encoding
from funasr_torch.registry import not_ported, tables


class MultiHeadAttention(nn.Module):
    """Scaled dot-product attention: q scaled by d_k^-0.5 before the score
    product in the compute dtype, float32 masked softmax, probabilities cast
    to v's dtype before the PV product.  Given a (B, Tk) float32
    ``key_bias`` in place of a mask (a key mask alone, as the Paraformer SAN
    decoder's), the attention runs through ``ops/attention.py``
    ``fused_attention``: float32 scores, the normalised p cast to v's dtype."""

    def __init__(self, n_head: int, n_feat: int, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_head = n_head
        self.n_feat = n_feat
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.linear_q = Dense(n_feat, n_feat, **kw)
        self.linear_k = Dense(n_feat, n_feat, **kw)
        self.linear_v = Dense(n_feat, n_feat, **kw)
        self.linear_out = Dense(n_feat, n_feat, **kw)

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor,
                mask: Optional[torch.Tensor], key_bias: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        B, Tq, _ = q_in.shape
        Tk = kv_in.shape[1]
        H = self.n_head
        d_k = self.n_feat // H
        if key_bias is not None:
            ctx = A.fused_attention(self.linear_q(q_in) * (d_k ** -0.5), self.linear_k(kv_in),
                                    self.linear_v(kv_in), key_bias, H)
            return self.linear_out(ctx)
        q = self.linear_q(q_in).reshape(B, Tq, H, d_k).transpose(1, 2) * (d_k ** -0.5)
        k = self.linear_k(kv_in).reshape(B, Tk, H, d_k).transpose(1, 2)
        v = self.linear_v(kv_in).reshape(B, Tk, H, d_k).transpose(1, 2)
        attn = masked_softmax(torch.matmul(q, k.transpose(-1, -2)), mask)
        ctx = torch.matmul(attn.to(v.dtype), v)
        return self.linear_out(ctx.transpose(1, 2).reshape(B, Tq, self.n_feat))


class FeedForward(nn.Module):
    """w_2(relu(w_1(x))), both QDense-rule :class:`Dense` projections."""

    def __init__(self, idim: int, hidden: int, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.w_1 = Dense(idim, hidden, dtype=dtype, param_dtype=param_dtype)
        self.w_2 = Dense(hidden, idim, dtype=dtype, param_dtype=param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w_2(torch.relu(self.w_1(x)))


class TransformerDecoderLayer(nn.Module):
    """Pre-norm self-attention, cross-attention and FFN, each with its
    residual.  ``fused_ffn``: the FFN is the SANM
    :class:`~funasr_torch.models.sanm.PositionwiseFeedForward` (fused int8
    after ``quantize_weights()``), as the Paraformer SAN decoder serves it;
    else two QDense-rule projections (the cached beam scorer reads them).
    ``tgt_bias`` / ``mem_bias``: (B, U) / (B, T) key biases in place of the
    masks, through the fused attention kernel."""

    def __init__(self, size: int, n_head: int, linear_units: int,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None, fused_ffn: bool = False):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.self_attn = MultiHeadAttention(n_head, size, **kw)
        self.src_attn = MultiHeadAttention(n_head, size, **kw)
        self.feed_forward = (PositionwiseFeedForward if fused_ffn else FeedForward)(
            size, linear_units, **kw)
        self.norm1 = LayerNormF32(size, dtype)
        self.norm2 = LayerNormF32(size, dtype)
        self.norm3 = LayerNormF32(size, dtype)

    def forward(self, x, tgt_mask, memory, memory_mask, tgt_bias=None, mem_bias=None):
        h = self.norm1(x)
        x = x + self.self_attn(h, h, tgt_mask, tgt_bias)
        x = x + self.src_attn(self.norm2(x), memory, memory_mask, mem_bias)
        return x + self.feed_forward(self.norm3(x))


@tables.register("decoder_classes", "TransformerDecoder")
class TransformerDecoder(nn.Module):
    def __init__(self, vocab_size: int, encoder_output_size: int,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0, self_attention_dropout_rate: float = 0.0,
                 src_attention_dropout_rate: float = 0.0,
                 param_dtype: Optional[torch.dtype] = None):
        """The dropout rates are training-only settings that inference
        ignores."""
        super().__init__()
        d = encoder_output_size
        self.attention_heads = attention_heads
        self.dtype = dtype
        self.embed = nn.Sequential(nn.Embedding(vocab_size, d))
        self.decoders = nn.ModuleList([
            TransformerDecoderLayer(d, attention_heads, linear_units, dtype, param_dtype)
            for _ in range(num_blocks)])
        self.after_norm = LayerNormF32(d, dtype)
        self.output_layer = Dense(d, vocab_size, dtype=dtype, param_dtype=param_dtype)

    def forward(self, memory: torch.Tensor, memory_lengths: torch.Tensor,
                ys_in: torch.Tensor, ys_in_lengths: torch.Tensor) -> torch.Tensor:
        """memory (B, T, D); ys_in (B, U) with sos prepended -> logits
        (B, U, V) in the compute dtype."""
        B, U = ys_in.shape
        T = memory.shape[1]
        d = self.embed[0].embedding_dim
        x = self.embed[0].weight[ys_in].to(self.dtype)
        pe = transformer_encoding(U, d, device=x.device)
        x = x * (d ** 0.5) + pe[None].to(x.dtype)
        causal = torch.tril(torch.ones((U, U), device=x.device))[None, None]
        tgt_mask = causal * sequence_mask(ys_in_lengths, U)[:, None, None, :]
        memory_mask = key_mask(memory_lengths, T)[:, None, :, :]
        memory = memory.to(self.dtype)
        for layer in self.decoders:
            x = layer(x, tgt_mask, memory, memory_mask)
        return self.output_layer(self.after_norm(x))


class RWKVDecoderLayer(nn.Module):
    """norm1 -> RWKV time mix (float32, cast back) -> norm2 -> cross-attention
    -> norm3 -> position-wise FFN, each with its residual
    (decoder.py:154-197 of the JAX package)."""

    def __init__(self, size: int, n_head: int, linear_units: int,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.self_attn = TimeMix(size)
        self.src_attn = MultiHeadAttention(n_head, size, dtype, param_dtype)
        self.feed_forward = PositionwiseFeedForward(size, linear_units, dtype, param_dtype)
        self.norm1 = LayerNormF32(size, dtype)
        self.norm2 = LayerNormF32(size, dtype)
        self.norm3 = LayerNormF32(size, dtype)

    def forward(self, x, memory, memory_mask):
        x = x + self.self_attn(self.norm1(x)).to(x.dtype)
        x = x + self.src_attn(self.norm2(x), memory, memory_mask)
        return x + self.feed_forward(self.norm3(x))


@tables.register("decoder_classes", "TransformerRWKVDecoder")
class TransformerRWKVDecoder(nn.Module):
    """embed + scaled positional encoding -> N RWKV decoder layers ->
    after_norm -> output projection; ``TransformerDecoder``'s call
    contract (decoder.py:200-245 of the JAX package)."""

    def __init__(self, vocab_size: int, encoder_output_size: int,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0, self_attention_dropout_rate: float = 0.0,
                 src_attention_dropout_rate: float = 0.0,
                 param_dtype: Optional[torch.dtype] = None):
        """The dropout rates are training-only settings that inference
        ignores."""
        super().__init__()
        d = encoder_output_size
        self.attention_heads = attention_heads
        self.dtype = dtype
        self.embed = nn.Sequential(nn.Embedding(vocab_size, d))
        self.decoders = nn.ModuleList([
            RWKVDecoderLayer(d, attention_heads, linear_units, dtype, param_dtype)
            for _ in range(num_blocks)])
        self.after_norm = LayerNormF32(d, dtype)
        self.output_layer = Dense(d, vocab_size, dtype=dtype, param_dtype=param_dtype)

    def forward(self, memory: torch.Tensor, memory_lengths: torch.Tensor,
                ys_in: torch.Tensor, ys_in_lengths: torch.Tensor) -> torch.Tensor:
        """memory (B, T, D); ys_in (B, U) with sos prepended -> logits
        (B, U, V) in the compute dtype.  ``ys_in_lengths`` is unused: the
        time mix is causal, so padding after a prefix cannot reach it."""
        U, T = ys_in.shape[1], memory.shape[1]
        d = self.embed[0].embedding_dim
        x = self.embed[0].weight[ys_in].to(self.dtype)
        x = x * (d ** 0.5) + transformer_encoding(U, d, device=x.device)[None].to(x.dtype)
        memory_mask = key_mask(memory_lengths, T)[:, None, :, :]
        memory = memory.to(self.dtype)
        for layer in self.decoders:
            x = layer(x, memory, memory_mask)
        return self.output_layer(self.after_norm(x))


for _name in ("LightweightConvolutionTransformerDecoder",
              "LightweightConvolution2DTransformerDecoder",
              "DynamicConvolutionTransformerDecoder",
              "DynamicConvolution2DTransformerDecoder"):
    tables.register("decoder_classes", _name)(not_ported(
        "decoder", _name, "a lightweight/dynamic convolution decoder"))
