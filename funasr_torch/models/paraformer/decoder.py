"""Paraformer SANM and SAN decoders (port of
funasr_tpu/models/paraformer/decoder.py; reference
funasr/models/paraformer/decoder.py:225 and :982).

Bidirectional decoder over the CIF acoustic-embedding grid: each layer is
FFN -> FSMN memory ("self-attention", attention.py:471) -> cross-attention
into the encoder memory.  ``att_layer_num`` full layers, then optional
FSMN-only layers (``decoders2``), then one FFN-only layer (``decoders3``)
whose output replaces its input (no residual), ``after_norm`` and the
output projection.  Parameter names are FunASR's (``decoders.{i}``,
``decoders3.0``, ``src_attn.linear_k_v``...).

int8 serving (decoder.py:243-269 of the JAX package), after
``quantize_weights()`` on a model with float32 parameters: the full layers
run through ``ops/decoder_layer.py`` ``fused_decoder_layer`` on int8
weights quantized once from the float32 parameters, the encoder memory
row-quantized once per batch for all of them; the other layers
(``decoders2``, ``decoders3``) and ``output_layer`` keep the module path,
whose Dense layers follow the QDense rule (``models/sanm.py`` ``Dense``).

Training is the module's ``self.training`` (the JAX package's
``deterministic=False``, decoder.py:49,154,182-205,232-244 there): dropout on
the FFN's hidden units, on the FSMN memory (self-attention rate), on the
cross-attention weights (source-attention rate) and on the FSMN and
cross-attention outputs (the layer's rate); the cross-attention in plain
PyTorch (``models/sanm.py`` ``masked_attention``), never the kernel.  The
decoders are built in ``eval()`` mode.

``use_output_layer=False`` builds no projection and returns the hiddens
(``after_norm(x)``): SeACo's bias decoder over its hotword memory;
``return_hidden=True`` returns them from a model that has one, and
:meth:`ParaformerSANMDecoder.project` applies it (decoder.py:318-396 of the
JAX package).

:class:`ParaformerSANDecoder` (decoder.py:405-478 of the JAX package, the
aishell Paraformer-Conformer's and E-Paraformer's decoder) is the same call
contract over Transformer decoder layers (``models/transformer/decoder.py``
``TransformerDecoderLayer``): bidirectional, its self-attention masked by
the token lengths alone (no subsequent mask), its cross-attention by the
memory lengths, both key masks, so both run through the fused attention
kernel (``ops/attention.py``; head size 64 at the aishell widths); its FFN
is the SANM position-wise FFN (fused int8 after ``quantize_weights()``),
then ``after_norm`` and the QDense-rule ``output_layer``.  The JAX package
computes that attention and FFN in XLA (its kernels gate on TPU shapes);
the port keeps its kernels at every shape.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from funasr_torch.models.sanm import (
    Dense,
    LayerNormF32,
    fsmn_memory,
    fsmn_padding,
    int8_buffers,
    masked_attention,
    quantize_dense_layers,
)
from funasr_torch.models.transformer.decoder import TransformerDecoderLayer
from funasr_torch.ops import attention as A
from funasr_torch.ops import decoder_layer as DL
from funasr_torch.ops.masks import key_bias, sequence_mask
from funasr_torch.registry import tables


class FeedForwardDecoderSANM(nn.Module):
    """w_2(norm(relu(w_1 x))), w_2 without bias
    (sanm/positionwise_feed_forward.py ``PositionwiseFeedForwardDecoderSANM``)."""

    def __init__(self, idim: int, hidden_units: int,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.w_1 = Dense(idim, hidden_units, dtype=dtype, param_dtype=param_dtype)
        self.norm = LayerNormF32(hidden_units, dtype)
        self.w_2 = Dense(hidden_units, idim, bias=False, dtype=dtype,
                         param_dtype=param_dtype)
        self.dropout_rate = dropout_rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.dropout(torch.relu(self.w_1(x)), self.dropout_rate, self.training)
        return self.w_2(self.norm(h))


class FsmnSelfAttention(nn.Module):
    """Decoder 'self-attention': the FSMN depthwise memory alone
    (attention.py:471 ``MultiHeadedAttentionSANMDecoder``)."""

    def __init__(self, n_feat: int, kernel_size: int = 11, sanm_shift: int = 0,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.fsmn_block = nn.Conv1d(n_feat, n_feat, kernel_size, groups=n_feat,
                                    bias=False, dtype=param_dtype or dtype)
        self.left, self.right = fsmn_padding(kernel_size, sanm_shift)
        self.dropout_rate = dropout_rate

    def forward(self, x: torch.Tensor, tgt_mask: torch.Tensor) -> torch.Tensor:
        out = fsmn_memory(x, self.fsmn_block.weight, tgt_mask, self.left,
                          self.right)
        return F.dropout(out, self.dropout_rate, self.training)


class CrossAttention(nn.Module):
    """Cross-attention with a fused KV projection
    (attention.py:568 ``MultiHeadedAttentionCrossAtt``)."""

    def __init__(self, n_head: int, n_feat: int,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.n_head = n_head
        self.n_feat = n_feat
        self.dropout_rate = dropout_rate
        self.linear_q = Dense(n_feat, n_feat, dtype=dtype, param_dtype=param_dtype)
        self.linear_k_v = Dense(n_feat, 2 * n_feat, dtype=dtype,
                                param_dtype=param_dtype)
        self.linear_out = Dense(n_feat, n_feat, dtype=dtype, param_dtype=param_dtype)

    def forward(self, x: torch.Tensor, memory: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
        """x (B, U, D); memory (B, T, D); bias (B, T) float32 key bias
        (0 valid, -1e30 padding)."""
        d_k = self.n_feat // self.n_head
        q = self.linear_q(x)
        k, v = self.linear_k_v(memory).split(self.n_feat, dim=-1)
        if self.training:
            ctx = masked_attention(q, k, v, (bias == 0)[:, None, :], self.n_head,
                                   self.dropout_rate)
        else:
            ctx = A.fused_attention(q * (d_k ** -0.5), k, v, bias, self.n_head)
        return self.linear_out(ctx)


class DecoderLayerSANM(nn.Module):
    """FFN -> FSMN memory -> cross-attention, pre-norm
    (paraformer/decoder.py:26 ``DecoderLayerSANM``, :78-121)."""

    def __init__(self, size: int, n_head: int, linear_units: int,
                 kernel_size: int = 11, sanm_shift: int = 0,
                 has_self_attn: bool = True, has_src_attn: bool = True,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None,
                 dropout_rate: float = 0.0, self_attention_dropout_rate: float = 0.0,
                 src_attention_dropout_rate: float = 0.0):
        super().__init__()
        self.n_head = n_head
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.norm1 = LayerNormF32(size, dtype)
        self.feed_forward = FeedForwardDecoderSANM(size, linear_units, dtype,
                                                   param_dtype, dropout_rate)
        self.self_attn = None
        self.src_attn = None
        if has_self_attn:
            self.norm2 = LayerNormF32(size, dtype)
            self.self_attn = FsmnSelfAttention(size, kernel_size, sanm_shift,
                                               dtype, param_dtype,
                                               self_attention_dropout_rate)
        if has_src_attn:
            self.norm3 = LayerNormF32(size, dtype)
            self.src_attn = CrossAttention(n_head, size, dtype, param_dtype,
                                           src_attention_dropout_rate)
        self.int8 = None

    def quantize_weights(self) -> None:
        """int8 operands for the fused layer (FFN + FSMN + cross-attention);
        a partial layer quantizes its Dense layers for the QDense rule."""
        if self.self_attn is None or self.src_attn is None:
            for mod in self.modules():
                if isinstance(mod, Dense):
                    mod.quantize_weights()
            return
        d = lambda t: t.detach()
        ln = lambda m: (d(m.weight), d(m.bias))
        ff, src = self.feed_forward, self.src_attn
        w = DL.quantize_decoder_layer(
            ln(self.norm1), d(ff.w_1.weight), d(ff.w_1.bias), ln(ff.norm),
            d(ff.w_2.weight), ln(self.norm2), d(self.self_attn.fsmn_block.weight),
            ln(self.norm3), d(src.linear_q.weight), d(src.linear_q.bias),
            d(src.linear_k_v.weight), d(src.linear_k_v.bias),
            d(src.linear_out.weight), d(src.linear_out.bias))
        self.int8 = int8_buffers(self, "dec_", w)

    def forward(self, tgt: torch.Tensor, tgt_mask: torch.Tensor,
                memory: torch.Tensor, mem_bias: torch.Tensor,
                tgt_lengths: Optional[torch.Tensor] = None,
                mem_lengths: Optional[torch.Tensor] = None,
                memory_q=None) -> torch.Tensor:
        """tgt (B, U, D); tgt_mask (B, U, 1); memory (B, T, D);
        mem_bias (B, T) float32; the lengths and ``memory_q`` (the memory's
        ``DL.quantize_memory``) feed the fused int8 layer."""
        if self.int8 is not None:
            return DL.fused_decoder_layer(
                tgt.to(self.dtype), memory.to(self.dtype), tgt_lengths, mem_lengths,
                self.int8(self), self.n_head, self.self_attn.left, mem_bias,
                memory_q)
        p, train = self.dropout_rate, self.training
        x = self.feed_forward(self.norm1(tgt))
        if self.self_attn is not None:
            x = tgt + F.dropout(self.self_attn(self.norm2(x), tgt_mask), p, train)
        if self.src_attn is not None:
            x = x + F.dropout(self.src_attn(self.norm3(x), memory, mem_bias), p, train)
        return x


@tables.register("decoder_classes", "ParaformerSANMDecoder")
class ParaformerSANMDecoder(nn.Module):
    """Stack of DecoderLayerSANM + FFN-only tail layer + output projection
    (paraformer/decoder.py:225 ``ParaformerSANMDecoder``).

    ``embed`` (the training sampler's token embedding, FunASR's
    ``decoder.embed.0``) is kept so reference checkpoints load strictly;
    inference does not use it.
    """

    def __init__(self, vocab_size: int, encoder_output_size: int,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, att_layer_num: int = 6,
                 kernel_size: int = 11, sanm_shift: int = 0,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.1,
                 self_attention_dropout_rate: float = 0.0,
                 src_attention_dropout_rate: float = 0.0,
                 param_dtype: Optional[torch.dtype] = None,
                 use_output_layer: bool = True):
        """The dropout rates act in training only (defaults: the JAX
        package's).  ``param_dtype``: storage of the Dense and FSMN weights
        (default ``dtype``; float32 for int8 serving)."""
        super().__init__()
        d = encoder_output_size
        self.dtype = dtype
        pd = param_dtype
        rates = dict(dropout_rate=dropout_rate,
                     self_attention_dropout_rate=self_attention_dropout_rate,
                     src_attention_dropout_rate=src_attention_dropout_rate)
        self.embed = nn.Sequential(nn.Embedding(vocab_size, d))
        self.decoders = nn.ModuleList([
            DecoderLayerSANM(d, attention_heads, linear_units, kernel_size,
                             sanm_shift, True, True, dtype, pd, **rates)
            for _ in range(att_layer_num)])
        self.decoders2: Optional[nn.ModuleList] = None
        if num_blocks - att_layer_num > 0:
            self.decoders2 = nn.ModuleList([
                DecoderLayerSANM(d, attention_heads, linear_units, kernel_size,
                                 0, True, False, dtype, pd, **rates)
                for _ in range(num_blocks - att_layer_num)])
        self.decoders3 = nn.ModuleList([DecoderLayerSANM(
            d, attention_heads, linear_units, kernel_size, sanm_shift,
            False, False, dtype, pd, **rates)])
        self.after_norm = LayerNormF32(d, dtype)
        self.output_layer = (Dense(d, vocab_size, dtype=dtype, param_dtype=pd)
                             if use_output_layer else None)
        self.eval()  # built for inference; train() switches to the training path

    def _layers(self):
        return list(self.decoders) + list(self.decoders2 or []) + list(self.decoders3)

    def quantize_weights(self) -> None:
        """Quantize every layer's weights and the output projection once."""
        for layer in self._layers():
            layer.quantize_weights()
        if self.output_layer is not None:
            self.output_layer.quantize_weights()

    def forward(self, memory: torch.Tensor, memory_lengths: torch.Tensor,
                semantic_embeds: torch.Tensor, token_lengths: torch.Tensor,
                return_hidden: bool = False) -> torch.Tensor:
        """-> logits (B, U, vocab) in the compute dtype, or the hiddens
        (B, U, D) with ``return_hidden`` or without an output layer.  An int8
        stack row-quantizes ``memory`` once for its full layers
        (``DL.quantize_memory``), an encoder output or a hotword memory."""
        B, U, _ = semantic_embeds.shape
        T = memory.shape[1]
        tgt_mask = sequence_mask(token_lengths, U)[:, :, None]
        mem_bias = key_bias(memory_lengths, T)
        memory = memory.to(self.dtype)
        x = semantic_embeds.to(self.dtype)
        memory_q = None
        if any(layer.int8 is not None for layer in self.decoders):
            memory_q = DL.quantize_memory(memory)
        for layer in self._layers():
            x = layer(x, tgt_mask, memory, mem_bias, token_lengths, memory_lengths,
                      memory_q)
        hidden = self.after_norm(x)
        if return_hidden or self.output_layer is None:
            return hidden
        return self.output_layer(hidden)

    def project(self, hidden: torch.Tensor) -> torch.Tensor:
        """The output projection of :meth:`forward`'s hiddens."""
        return self.output_layer(hidden)

    def embed_tokens(self, ids: torch.Tensor) -> torch.Tensor:
        """Token embedding lookup in the compute dtype (the training
        sampler's ground-truth embeddings)."""
        return self.embed(ids).to(self.dtype)


@tables.register("decoder_classes", "ParaformerSANDecoder")
class ParaformerSANDecoder(nn.Module):
    """Transformer decoder layers over the CIF embeddings, bidirectional
    (paraformer/decoder.py:982 ``ParaformerSANDecoder``; decoder.py:405 of
    the JAX package): the ``ParaformerSANMDecoder`` call contract, FunASR's
    parameter names (``decoders.{i}.self_attn.linear_q``, ``src_attn``,
    ``feed_forward.w_1``, ``norm1..3``, ``after_norm``, ``output_layer``,
    the training sampler's ``embed.0``)."""

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
        self.dtype = dtype
        self.embed = nn.Sequential(nn.Embedding(vocab_size, d))
        self.decoders = nn.ModuleList([
            TransformerDecoderLayer(d, attention_heads, linear_units, dtype, param_dtype,
                                    fused_ffn=True)
            for _ in range(num_blocks)])
        self.after_norm = LayerNormF32(d, dtype)
        self.output_layer = Dense(d, vocab_size, dtype=dtype, param_dtype=param_dtype)

    def quantize_weights(self) -> None:
        """The fused int8 FFNs and the QDense projections, once."""
        quantize_dense_layers(self)

    def forward(self, memory: torch.Tensor, memory_lengths: torch.Tensor,
                semantic_embeds: torch.Tensor, token_lengths: torch.Tensor) -> torch.Tensor:
        """-> logits (B, U, vocab) in the compute dtype."""
        U, T = semantic_embeds.shape[1], memory.shape[1]
        tgt_bias = key_bias(token_lengths, U)
        mem_bias = key_bias(memory_lengths, T)
        memory = memory.to(self.dtype)
        x = semantic_embeds.to(self.dtype)
        for layer in self.decoders:
            x = layer(x, None, memory, None, tgt_bias, mem_bias)
        return self.output_layer(self.after_norm(x))
