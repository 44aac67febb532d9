"""Contextual Paraformer decoder (port of
funasr_tpu/models/contextual_paraformer/decoder.py; reference
funasr/models/contextual_paraformer/decoder.py:115
``ContextualParaformerDecoder``).

``att_layer_num - 1`` plain SANM decoder layers (``decoders``), then the
last attention layer (``last_decoder``), which also hands out its
post-FSMN hidden ``x_self`` and its raw cross-attention output ``x_src``.
With a hotword memory (B, H, D), ``bias_decoder`` (a layer norm and a
cross-attention with no key mask: every hotword row is a key) attends
``x_self`` into it; ``bias_output``, a bias-free 1x1 Conv1d(2D -> D),
merges ``[x_src, clas_scale * context]`` and the sum re-enters at
``x_self`` (reference :299-301).  Then the FFN-only ``decoders3``,
``after_norm`` and the output projection.  Without a memory the bias
branch is skipped and the residual is ``x_self + x_src``.  Like the JAX
decoder it has no FSMN-only ``decoders2`` layers: ``num_blocks`` beyond
``att_layer_num`` is ignored.

Parameter names are FunASR's (``decoders.{i}``, ``last_decoder``,
``bias_decoder.norm3``, ``bias_decoder.src_attn.*``, ``bias_output.weight``
(D, 2D, 1), ``decoders3.0``).

int8 serving (``quantize_weights``): the ``decoders`` layers run through
the fused int8 decoder layer (``ops/decoder_layer.py``), the encoder memory
row-quantized once for them, as in :class:`ParaformerSANMDecoder`; the last
layer, the bias attention, ``decoders3`` and the output layer keep the
module path, whose Dense layers follow the QDense rule; ``bias_output`` is a
plain dense layer in the compute dtype (the JAX ``nn.Dense``), never int8.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from funasr_torch.models.paraformer.decoder import (
    CrossAttention,
    DecoderLayerSANM,
    ParaformerSANMDecoder,
)
from funasr_torch.models.sanm import Dense, LayerNormF32
from funasr_torch.ops import decoder_layer as DL
from funasr_torch.ops.masks import key_bias, sequence_mask
from funasr_torch.registry import tables


class ContextualDecoderLayer(DecoderLayerSANM):
    """A full SANM decoder layer, always on the module path, that also
    returns its post-FSMN hidden and its raw cross-attention output
    (reference decoder.py:24 ``ContextualDecoderLayer``, :55-86)."""

    def forward(self, tgt: torch.Tensor, tgt_mask: torch.Tensor, memory: torch.Tensor,
                mem_bias: torch.Tensor):
        """-> (x_self + x_src, x_self, x_src), each (B, U, D)."""
        x = self.feed_forward(self.norm1(tgt))
        x_self = tgt + self.self_attn(self.norm2(x), tgt_mask)
        x_src = self.src_attn(self.norm3(x_self), memory, mem_bias)
        return x_self + x_src, x_self, x_src


class ContextualBiasDecoder(nn.Module):
    """Layer norm, then cross-attention into the hotword memory (reference
    decoder.py:88 ``ContextualBiasDecoder``)."""

    def __init__(self, size: int, n_head: int, dtype: torch.dtype,
                 param_dtype: Optional[torch.dtype]):
        super().__init__()
        self.norm3 = LayerNormF32(size, dtype)
        self.src_attn = CrossAttention(n_head, size, dtype, param_dtype)

    def forward(self, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        """x (B, U, D); memory (B, H, D), every row a key."""
        B, H = memory.shape[:2]
        no_mask = torch.zeros((B, H), dtype=torch.float32, device=memory.device)
        return self.src_attn(self.norm3(x), memory, no_mask)


@tables.register("decoder_classes", "ContextualParaformerDecoder")
class ContextualParaformerSANMDecoder(ParaformerSANMDecoder):
    """:class:`ParaformerSANMDecoder` with the hotword bias branch on its last
    attention layer (reference decoder.py:252 ``forward``)."""

    def __init__(self, vocab_size: int, encoder_output_size: int,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, att_layer_num: int = 6,
                 kernel_size: int = 11, sanm_shift: int = 0,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0,
                 self_attention_dropout_rate: float = 0.0,
                 src_attention_dropout_rate: float = 0.0,
                 param_dtype: Optional[torch.dtype] = None):
        """The dropout rates are the reference's training-only settings;
        inference ignores them."""
        d = encoder_output_size
        super().__init__(vocab_size, d, attention_heads, linear_units,
                         num_blocks=att_layer_num - 1, att_layer_num=att_layer_num - 1,
                         kernel_size=kernel_size, sanm_shift=sanm_shift, dtype=dtype,
                         param_dtype=param_dtype)
        self.last_decoder = ContextualDecoderLayer(
            d, attention_heads, linear_units, kernel_size, sanm_shift, True, True, dtype,
            param_dtype)
        self.bias_decoder = ContextualBiasDecoder(d, attention_heads, dtype, param_dtype)
        self.bias_output = nn.Conv1d(2 * d, d, 1, bias=False, dtype=param_dtype or dtype)
        self.eval()

    def quantize_weights(self) -> None:
        """The fused layers' int8 weights; the QDense rule for the Dense
        layers of the last layer and the bias attention (not
        ``bias_output``)."""
        super().quantize_weights()
        for mod in (*self.last_decoder.modules(), *self.bias_decoder.modules()):
            if isinstance(mod, Dense):
                mod.quantize_weights()

    def forward(self, memory: torch.Tensor, memory_lengths: torch.Tensor,
                semantic_embeds: torch.Tensor, token_lengths: torch.Tensor,
                contextual: Optional[torch.Tensor] = None,
                clas_scale: float = 1.0) -> torch.Tensor:
        """-> logits (B, U, vocab) in the compute dtype; ``contextual`` the
        (B, H, D) hotword memory, or None for no bias."""
        B, U, _ = semantic_embeds.shape
        tgt_mask = sequence_mask(token_lengths, U)[:, :, None]
        mem_bias = key_bias(memory_lengths, memory.shape[1])
        memory = memory.to(self.dtype)
        x = semantic_embeds.to(self.dtype)
        memory_q = None
        if any(layer.int8 is not None for layer in self.decoders):
            memory_q = DL.quantize_memory(memory)
        for layer in self.decoders:
            x = layer(x, tgt_mask, memory, mem_bias, token_lengths, memory_lengths, memory_q)
        x, x_self, x_src = self.last_decoder(x, tgt_mask, memory, mem_bias)
        if contextual is not None:
            cx = self.bias_decoder(x_self, contextual.to(self.dtype))
            merged = F.linear(torch.cat([x_src, cx * clas_scale], dim=-1),
                              self.bias_output.weight[:, :, 0].to(self.dtype))
            x = x_self + merged
        for layer in self.decoders3:
            x = layer(x, tgt_mask, memory, mem_bias)
        return self.output_layer(self.after_norm(x))
