"""Branchformer and E-Branchformer encoders and their CTC/attention hybrids,
inference path (port of funasr_tpu/models/branchformer.py; reference
funasr/models/branchformer/{encoder.py,cgmlp.py},
funasr/models/e_branchformer/encoder.py).

A layer runs a global branch (relative-position multi-head attention, the
Conformer's) and a local branch (cgMLP: channel projection, GELU, the
convolutional spatial gating unit, channel projection) side by side and
merges them: Branchformer by concat -> linear, E-Branchformer by concat ->
depthwise conv (residual) -> linear, between two macaron 0.5x FFNs.

Computation in the module ``dtype``, layer norms and softmax in float32, as
in the JAX package.  The CSGU and merge convolutions see the pad frames
(``ops/dwconv.py``, no mask), as the reference's do, so valid frames near a
row's end depend on the padding.  Under ``quantize=True`` the attention
projections and the macaron FFNs follow the QDense rule of
:class:`~funasr_torch.models.sanm.Dense` (at the aishell widths only the
E-Branchformer's FFN ``w_1``, N = 1024, passes the int8 gate); the cgMLP's
``channel_proj1``/``channel_proj2``, ``merge_proj`` and the linear input
layer are the JAX package's plain ``nn.Dense``, never int8
(:class:`~funasr_torch.models.sanm.PlainDense`).

Parameter names are FunASR's torch names: ``encoders.{i}.attn.linear_q``,
``norm_mha``, ``norm_mlp``, ``cgmlp.channel_proj1.0``, ``cgmlp.csgu.norm``,
``cgmlp.csgu.conv`` (a depthwise ``Conv1d``), ``cgmlp.channel_proj2``,
``merge_proj``, ``norm_final``; E-Branchformer also ``feed_forward_macaron``
/ ``norm_ff_macaron`` (the JAX package's ``feed_forward1``/``norm_ff1``),
``feed_forward``/``norm_ff`` (``feed_forward2``/``norm_ff2``) and
``depthwise_conv_fusion`` (the JAX ``merge_conv``, which has no bias: the
converter gives FunASR's bias zeros).  Inference only: the dropout rates
and the reference's other training settings are accepted and ignored.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from funasr_torch.models.conformer import (Conv2dSubsampling, FeedForward,
                                           RelPosMultiHeadAttention, rel_positional_encoding)
from funasr_torch.models.sanm import LayerNormF32, PlainDense
from funasr_torch.models.transformer.model import _HybridModel
from funasr_torch.ops.dwconv import depthwise_conv1d
from funasr_torch.ops.masks import key_mask
from funasr_torch.registry import tables


class ConvolutionalSpatialGatingUnit(nn.Module):
    """CSGU (cgmlp.py): split the channels in halves a, g; g -> layer norm ->
    depthwise conv (same padding, no mask) + bias; out = a * g."""

    def __init__(self, size: int, kernel_size: int = 31,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        ch = size // 2
        self.norm = LayerNormF32(ch, dtype)
        self.conv = nn.Conv1d(ch, ch, kernel_size, padding=(kernel_size - 1) // 2, groups=ch,
                              dtype=param_dtype or dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, g = x.chunk(2, dim=-1)
        g = depthwise_conv1d(self.norm(g), self.conv.weight, self.conv.bias)
        return a * g


class ConvolutionalGatingMLP(nn.Module):
    """cgMLP (cgmlp.py ``ConvolutionalGatingMLP``): channel_proj1 (D -> U)
    -> GELU (tanh form, flax's default) -> CSGU (U -> U/2) ->
    channel_proj2 (U/2 -> D)."""

    def __init__(self, size: int, linear_units: int, kernel_size: int = 31,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.channel_proj1 = nn.Sequential(PlainDense(size, linear_units, **kw))
        self.csgu = ConvolutionalSpatialGatingUnit(linear_units, kernel_size, **kw)
        self.channel_proj2 = PlainDense(linear_units // 2, size, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self.channel_proj1[0](x), approximate="tanh")
        return self.channel_proj2(self.csgu(h))


class BranchformerLayer(nn.Module):
    def __init__(self, size: int, n_head: int, linear_units: int, cgmlp_kernel: int = 31,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.norm_mha = LayerNormF32(size, dtype)
        self.attn = RelPosMultiHeadAttention(n_head, size, **kw)
        self.norm_mlp = LayerNormF32(size, dtype)
        self.cgmlp = ConvolutionalGatingMLP(size, linear_units, cgmlp_kernel, **kw)
        self.merge_proj = PlainDense(2 * size, size, **kw)
        self.norm_final = LayerNormF32(size, dtype)

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        h1 = self.attn(self.norm_mha(x), pos_emb, mask)
        h2 = self.cgmlp(self.norm_mlp(x))
        x = x + self.merge_proj(torch.cat([h1, h2], dim=-1))
        return self.norm_final(x)


class EBranchformerLayer(nn.Module):
    def __init__(self, size: int, n_head: int, linear_units: int, cgmlp_linear_units: int,
                 cgmlp_kernel: int = 31, merge_kernel: int = 3,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.norm_ff_macaron = LayerNormF32(size, dtype)
        self.feed_forward_macaron = FeedForward(size, linear_units, **kw)
        self.norm_mha = LayerNormF32(size, dtype)
        self.attn = RelPosMultiHeadAttention(n_head, size, **kw)
        self.norm_mlp = LayerNormF32(size, dtype)
        self.cgmlp = ConvolutionalGatingMLP(size, cgmlp_linear_units, cgmlp_kernel, **kw)
        self.depthwise_conv_fusion = nn.Conv1d(
            2 * size, 2 * size, merge_kernel, padding=(merge_kernel - 1) // 2,
            groups=2 * size, dtype=param_dtype or dtype)
        self.merge_proj = PlainDense(2 * size, size, **kw)
        self.norm_ff = LayerNormF32(size, dtype)
        self.feed_forward = FeedForward(size, linear_units, **kw)
        self.norm_final = LayerNormF32(size, dtype)

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        x = x + 0.5 * self.feed_forward_macaron(self.norm_ff_macaron(x))
        h1 = self.attn(self.norm_mha(x), pos_emb, mask)
        h2 = self.cgmlp(self.norm_mlp(x))
        cat = torch.cat([h1, h2], dim=-1)
        fusion = self.depthwise_conv_fusion
        cat = cat + depthwise_conv1d(cat, fusion.weight, fusion.bias)
        x = x + self.merge_proj(cat)
        x = x + 0.5 * self.feed_forward(self.norm_ff(x))
        return self.norm_final(x)


class _BranchEncoderBase(nn.Module):
    """Embed (``conv2d``: Conv2dSubsampling x4; ``linear``: a plain dense
    layer) -> x * sqrt(D) (the reference's RelPositionalEncoding scales,
    embedding.py:273,321) -> the layers with relative position encodings
    -> after_norm."""

    def __init__(self, input_size: int, output_size: int = 256, attention_heads: int = 4,
                 linear_units: int = 2048, num_blocks: int = 12,
                 cgmlp_linear_units: int = 2048, cgmlp_conv_kernel: int = 31,
                 merge_conv_kernel: int = 3, input_layer: str = "conv2d",
                 dtype: torch.dtype = torch.float32, dropout_rate: float = 0.0,
                 attention_dropout_rate: float = 0.0,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if input_layer == "conv2d":
            self.embed = Conv2dSubsampling(input_size, output_size, dtype, param_dtype)
        elif input_layer == "linear":
            self.embed = nn.Sequential(PlainDense(input_size, output_size, dtype=dtype,
                                                  param_dtype=param_dtype))
        else:
            raise NotImplementedError(f"input_layer={input_layer!r} ('conv2d' or 'linear')")
        self.input_layer = input_layer
        self._output_size = output_size
        self.dtype = dtype
        self.encoders = nn.ModuleList([
            self.make_layer(output_size, attention_heads, linear_units, cgmlp_linear_units,
                            cgmlp_conv_kernel, merge_conv_kernel, dtype, param_dtype)
            for _ in range(num_blocks)])
        self.after_norm = LayerNormF32(output_size, dtype)

    def make_layer(self, *args) -> nn.Module:
        raise NotImplementedError

    def output_size(self) -> int:
        return self._output_size

    def forward(self, xs: torch.Tensor, lengths: torch.Tensor):
        """xs (B, T, input_size); lengths (B,) -> (out (B, T', D), lengths')."""
        if self.input_layer == "conv2d":
            x, lengths = self.embed(xs, lengths)
        else:
            x = self.embed[0](xs)
        x = x * (self._output_size ** 0.5)
        T = x.shape[1]
        pos_emb = rel_positional_encoding(T, self._output_size, device=x.device)
        mask = key_mask(lengths, T)  # (B, 1, T)
        for layer in self.encoders:
            x = layer(x, pos_emb, mask)
        return self.after_norm(x), lengths


@tables.register("encoder_classes", "BranchformerEncoder")
class BranchformerEncoder(_BranchEncoderBase):
    """Branchformer layers of ``cgmlp_linear_units`` (``linear_units`` is
    unused, as in the JAX package)."""

    def make_layer(self, size, n_head, linear_units, cgmlp_units, cgmlp_kernel,
                   merge_kernel, dtype, param_dtype):
        return BranchformerLayer(size, n_head, cgmlp_units, cgmlp_kernel, dtype, param_dtype)


@tables.register("encoder_classes", "EBranchformerEncoder")
class EBranchformerEncoder(_BranchEncoderBase):
    def make_layer(self, size, n_head, linear_units, cgmlp_units, cgmlp_kernel,
                   merge_kernel, dtype, param_dtype):
        return EBranchformerLayer(size, n_head, linear_units, cgmlp_units, cgmlp_kernel,
                                  merge_kernel, dtype, param_dtype)


def _filtered(conf: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """The reference encoder_conf keys the JAX package drops
    (branchformer.py:277-289), ``input_layer`` defaulting to conv2d."""
    conf = dict(conf or {})
    for k in ("attn_branch_drop_rate", "pos_enc_layer_type", "rel_pos_type",
              "positional_dropout_rate", "stochastic_depth_rate", "use_attn", "use_cgmlp",
              "merge_method", "cgmlp_weight", "gate_activation", "use_linear_after_conv",
              "attention_layer_type"):
        conf.pop(k, None)
    conf.setdefault("input_layer", "conv2d")
    return conf


@tables.register("model_classes", "Branchformer")
class Branchformer(_HybridModel):
    """CTC/attention hybrid over a BranchformerEncoder, whatever the config's
    ``encoder`` key (reference funasr/models/branchformer/model.py)."""

    def make_encoder(self, input_size, encoder_conf, dtype, param_dtype):
        return BranchformerEncoder(input_size=input_size, dtype=dtype, param_dtype=param_dtype,
                                   **_filtered(encoder_conf))


@tables.register("model_classes", "EBranchformer")
class EBranchformer(_HybridModel):
    """CTC/attention hybrid over an EBranchformerEncoder (reference
    funasr/models/e_branchformer/model.py)."""

    def make_encoder(self, input_size, encoder_conf, dtype, param_dtype):
        return EBranchformerEncoder(input_size=input_size, dtype=dtype,
                                    param_dtype=param_dtype, **_filtered(encoder_conf))
