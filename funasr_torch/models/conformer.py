"""Conformer encoder, inference path (port of funasr_tpu/models/conformer.py;
reference funasr/models/conformer/encoder.py:287).

Layer: 0.5x macaron FFN -> rel-pos MHA (Transformer-XL style, pos_bias_u/v +
rel_shift) -> conv module (pointwise-GLU -> depthwise -> BatchNorm -> swish
-> pointwise) -> 0.5x FFN -> final LN, all pre-norm with residuals.
Input layer: Conv2dSubsampling x4 (two stride-2 3x3 Conv2d + linear), or
``input_layer="linear"`` (the aishell Paraformer-Conformer): one dense
layer ``embed.0``, no subsampling, as the JAX package has it (no layer norm
after it; funasr_tpu/models/conformer.py:256-264).

Computation in the module ``dtype`` (bfloat16 in serving), layer norms,
softmax and BatchNorm in float32, as in the JAX package.  Parameter names
are FunASR's torch names (``embed.conv.0``, ``embed.out.0``,
``encoders.{i}.self_attn.linear_pos``, ``conv_module.norm.running_mean``...),
the layout ``funasr_tpu/convert.py`` ``conformer_from_torch`` reads.  Every
projection is a :class:`~funasr_torch.models.sanm.Dense` (the JAX QDense):
after ``quantize_weights()`` a contraction that passes the ``ops/quant.py``
gate runs in int8 (at D=256 only the FFNs' ``w_1``).  Inference only: no
dropout, BatchNorm from its running statistics.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from funasr_torch.device import upload
from funasr_torch.models.sanm import Dense, LayerNormF32, PointwiseConv, masked_softmax
from funasr_torch.ops.dwconv import depthwise_conv1d
from funasr_torch.ops.masks import key_mask
from funasr_torch.registry import tables


def rel_positional_encoding(length: int, d_model: int,
                            dtype: torch.dtype = torch.float32,
                            device=None) -> torch.Tensor:
    """espnet RelPositionalEncoding: positions T-1 .. -(T-1), interleaved
    sin/cos; shape (2T-1, d).  Built in float64, then cast; up by
    ``device.upload`` (no wait for the card)."""
    pos = np.arange(length - 1, -length, -1, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                 * -(np.log(10000.0) / d_model))
    pe = np.zeros((2 * length - 1, d_model))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return upload(pe.astype(np.float32), device).to(dtype)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, 2T-1) -> (B, H, T, T) Transformer-XL relative shift, as a
    pad/reshape/slice."""
    B, H, T, L = x.shape
    x = F.pad(x, (1, 0)).reshape(B, H, L + 1, T)
    x = x[:, :, 1:, :].reshape(B, H, T, L)
    return x[:, :, :, : (L // 2 + 1)][:, :, :, :T]


class RelPosMultiHeadAttention(nn.Module):
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
        self.linear_pos = Dense(n_feat, n_feat, bias=False, **kw)
        d_k = n_feat // n_head
        self.pos_bias_u = nn.Parameter(torch.zeros(n_head, d_k))
        self.pos_bias_v = nn.Parameter(torch.zeros(n_head, d_k))
        self.dtype = dtype

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        """x (B, T, D); pos_emb (2T-1, D) float32; mask (B, 1, T)."""
        B, T, _ = x.shape
        H = self.n_head
        d_k = self.n_feat // H
        q = self.linear_q(x).reshape(B, T, H, d_k)
        k = self.linear_k(x).reshape(B, T, H, d_k).transpose(1, 2)
        v = self.linear_v(x).reshape(B, T, H, d_k).transpose(1, 2)
        p = self.linear_pos(pos_emb.to(self.dtype)).reshape(-1, H, d_k)
        q_u = (q + self.pos_bias_u.to(q.dtype)).transpose(1, 2)  # (B, H, T, d_k)
        q_v = q + self.pos_bias_v.to(q.dtype)
        ac = torch.matmul(q_u, k.transpose(-1, -2))  # (B, H, T, T)
        bd = rel_shift(torch.einsum("bthd,lhd->bhtl", q_v, p))
        scores = (ac + bd) * (d_k ** -0.5)
        attn = masked_softmax(scores, mask[:, None, :, :])
        ctx = torch.matmul(attn.to(v.dtype), v)  # (B, H, T, d_k)
        return self.linear_out(ctx.transpose(1, 2).reshape(B, T, self.n_feat))


class ConvolutionModule(nn.Module):
    """pointwise (D -> 2D) -> GLU -> depthwise conv (padding (K-1)/2 on each
    side) -> BatchNorm (float32, running statistics) -> swish -> pointwise.
    Pad frames are not masked before the depthwise conv: the reference
    (conformer/encoder.py:53) does not, and its checkpoints bake that in."""

    def __init__(self, channels: int, kernel_size: int = 15,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.pointwise_conv1 = PointwiseConv(channels, 2 * channels, **kw)
        self.depthwise_conv = nn.Conv1d(channels, channels, kernel_size,
                                        groups=channels, bias=True,
                                        dtype=param_dtype or dtype)
        self.norm = nn.BatchNorm1d(channels)
        self.pointwise_conv2 = PointwiseConv(channels, channels, **kw)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.pointwise_conv1(x).chunk(2, dim=-1)
        h = a * torch.sigmoid(b)  # GLU
        h = depthwise_conv1d(h, self.depthwise_conv.weight, self.depthwise_conv.bias)
        # flax BatchNorm: (x - mean) * (rsqrt(var + eps) * scale) + bias
        bn = self.norm
        mul = torch.rsqrt(bn.running_var.to(torch.float32) + bn.eps) * bn.weight
        h = ((h.to(torch.float32) - bn.running_mean) * mul + bn.bias).to(self.dtype)
        h = h * torch.sigmoid(h)  # swish
        return self.pointwise_conv2(h)


class FeedForward(nn.Module):
    """w_2(swish(w_1(x)))."""

    def __init__(self, idim: int, hidden: int, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.w_1 = Dense(idim, hidden, dtype=dtype, param_dtype=param_dtype)
        self.w_2 = Dense(hidden, idim, dtype=dtype, param_dtype=param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.w_1(x)
        return self.w_2(h * torch.sigmoid(h))


class ConformerEncoderLayer(nn.Module):
    def __init__(self, size: int, n_head: int, linear_units: int,
                 cnn_kernel: int = 15, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.feed_forward_macaron = FeedForward(size, linear_units, **kw)
        self.self_attn = RelPosMultiHeadAttention(n_head, size, **kw)
        self.conv_module = ConvolutionModule(size, cnn_kernel, **kw)
        self.feed_forward = FeedForward(size, linear_units, **kw)
        for name in ("norm_ff_macaron", "norm_mha", "norm_conv", "norm_ff",
                     "norm_final"):
            setattr(self, name, LayerNormF32(size, dtype))

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        x = x + 0.5 * self.feed_forward_macaron(self.norm_ff_macaron(x))
        x = x + self.self_attn(self.norm_mha(x), pos_emb, mask)
        x = x + self.conv_module(self.norm_conv(x))
        x = x + 0.5 * self.feed_forward(self.norm_ff(x))
        return self.norm_final(x)


class Conv2dSubsampling(nn.Module):
    """x4 subsampling: two stride-2 3x3 Conv2d + relu, then a linear over the
    (channel, frequency) features, flattened channel-major as in FunASR."""

    def __init__(self, idim: int, odim: int, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        pdt = param_dtype or dtype
        self.conv = nn.Sequential(nn.Conv2d(1, odim, 3, 2, dtype=pdt), nn.ReLU(),
                                  nn.Conv2d(odim, odim, 3, 2, dtype=pdt), nn.ReLU())
        f2 = ((idim - 1) // 2 - 1) // 2
        self.out = nn.Sequential(Dense(odim * f2, odim, dtype=dtype,
                                       param_dtype=param_dtype))
        self.dtype = dtype

    def forward(self, x: torch.Tensor, lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        h = x[:, None].to(self.dtype)  # (B, 1, T, D)
        for conv in (self.conv[0], self.conv[2]):
            h = torch.relu(F.conv2d(h, conv.weight.to(self.dtype),
                                    conv.bias.to(self.dtype), stride=2))
        B, C, T2, F2 = h.shape
        h = self.out(h.transpose(1, 2).reshape(B, T2, C * F2))
        # the reference slices the pad mask [:-2:2][:-2:2]: subsampled frame
        # j is valid iff 4j < L, so olens = min(ceil(L / 4), T'), not the
        # conv arithmetic count
        out_lengths = torch.clamp(torch.minimum((lengths + 3) // 4,
                                                torch.full_like(lengths, T2)), min=0)
        return h, out_lengths


@tables.register("encoder_classes", "ConformerEncoder")
class ConformerEncoder(nn.Module):
    """Conv2dSubsampling (or a dense ``linear`` input layer) -> x * sqrt(D)
    -> ``num_blocks`` Conformer layers with relative position encodings ->
    after_norm."""

    def __init__(self, input_size: int, output_size: int = 256,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 12, cnn_module_kernel: int = 15,
                 input_layer: str = "conv2d", dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0, attention_dropout_rate: float = 0.0,
                 param_dtype: Optional[torch.dtype] = None):
        """The dropout rates are training-only settings that inference
        ignores.  ``param_dtype``: storage of the weights (default
        ``dtype``; float32 for int8 serving)."""
        super().__init__()
        if input_layer not in ("conv2d", "linear"):
            raise NotImplementedError(f"input_layer={input_layer!r} ('conv2d' or 'linear')")
        self._output_size = output_size
        self.dtype = dtype
        self.input_layer = input_layer
        self.embed = (Conv2dSubsampling(input_size, output_size, dtype, param_dtype)
                      if input_layer == "conv2d" else
                      nn.Sequential(Dense(input_size, output_size, dtype=dtype,
                                          param_dtype=param_dtype)))
        self.encoders = nn.ModuleList([
            ConformerEncoderLayer(output_size, attention_heads, linear_units,
                                  cnn_module_kernel, dtype, param_dtype)
            for _ in range(num_blocks)])
        self.after_norm = LayerNormF32(output_size, dtype)

    def output_size(self) -> int:
        return self._output_size

    def forward(self, xs: torch.Tensor, lengths: torch.Tensor):
        """xs (B, T, input_size); lengths (B,) -> (out (B, T', D), lengths')."""
        if self.input_layer == "conv2d":
            x, lengths = self.embed(xs, lengths)
        else:
            x = self.embed(xs)
        x = x * (self._output_size ** 0.5)
        T = x.shape[1]
        pos_emb = rel_positional_encoding(T, self._output_size, device=x.device)
        mask = key_mask(lengths, T)  # (B, 1, T)
        for layer in self.encoders:
            x = layer(x, pos_emb, mask)
        return self.after_norm(x), lengths
