"""SCAMA's chunk-aware FSMN decoder (port of funasr_tpu/models/scama/
decoder.py; reference funasr/models/scama/decoder.py:204
``FsmnDecoderSCAMAOpt``).

The decoder is autoregressive: token embeddings of the sos-prefixed target
(a bare ``nn.Embedding``, FunASR's ``embed.0``), then the Paraformer SANM
decoder's layers (FFN -> FSMN memory -> cross-attention; ``decoders``,
FSMN-only ``decoders2``, the FFN-only ``decoders3`` whose output replaces
its input), ``after_norm`` and ``output_layer``.  Its FSMN is causal by
default (``sanm_shift = (kernel_size - 1) // 2``: a token sees only its
past), and its cross-attention is masked per token by
:func:`scama_cross_mask`: token i sees the encoder frames up to the end of
the chunk holding its CIF fire frame, plus a bounded look-back.

Such a per-query mask is not one the attention kernels take: as in the JAX
package (paraformer/decoder.py:186-203, XLA there), the masked
cross-attention is plain PyTorch (``models/sanm.py`` ``masked_attention``).
The teacher-forced :meth:`FsmnDecoderSCAMAOpt.forward` serves the tests and
the step scorer's equivalence; serving decodes through
:class:`CachedScamaDecoder` (decoder.py:195 of the JAX package), one token
a step for every hypothesis of the beam: each layer keeps a rolling window
of its last ``kernel_size`` FSMN inputs, the cross K/V are projected once
per utterance and shared by the beam.  Every projection is a
:class:`~funasr_torch.models.sanm.Dense` under the QDense rule (int8 where
the gate passes after ``quantize_weights()``, the cross K/V over the
encoder frames; the step's B x beam rows stay under it).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from funasr_torch.models.paraformer.decoder import DecoderLayerSANM
from funasr_torch.models.sanm import Dense, LayerNormF32, masked_attention
from funasr_torch.ops.cached_decoder import _mha_step_shared
from funasr_torch.ops.masks import sequence_mask
from funasr_torch.registry import tables


def scama_cross_mask(peaks: torch.Tensor, enc_lens: torch.Tensor,
                     token_lens: torch.Tensor, n_tokens: int, chunk: int,
                     look_back: int = 1, n_frames: Optional[int] = None) -> torch.Tensor:
    """Chunk-synchronised cross-attention mask (B, U, T) float32 (decoder.py:50
    of the JAX package; reference chunk_utilis.py:370).

    peaks (B, T) the CIF fire track; token i attends frames
    [end_i - chunk * (look_back + 1), end_i), end_i the chunk boundary after
    its fire frame (``(ff // chunk + 1) * chunk``), from frame 0 when
    ``look_back < 0``, intersected with the encoder and token lengths.  A
    token that never fires keeps the last frame's window.  ``n_frames``
    pins T to the memory length (the CIF tail frame dropped, or zero
    frames padded)."""
    B, T = peaks.shape
    if n_frames is not None and T != n_frames:
        peaks = peaks[:, :n_frames] if T > n_frames else F.pad(peaks, (0, n_frames - T))
        T = n_frames
    dev = peaks.device
    cum = torch.cumsum(peaks.to(torch.int32), dim=1)  # (B, T)
    want = torch.arange(1, n_tokens + 1, device=dev)[None, :, None]
    # token i's fire frame: the frames whose cumulative fires stay under i + 1
    ff = (cum[:, None, :] < want).sum(dim=-1).clamp(0, T - 1)  # (B, U)
    end = (ff // chunk + 1) * chunk
    beg = ((end - chunk * (look_back + 1)).clamp(min=0) if look_back >= 0
           else torch.zeros_like(end))
    t = torch.arange(T, device=dev)[None, None, :]
    mask = (t >= beg[..., None]) & (t < end[..., None])
    mask &= t < enc_lens.to(dev)[:, None, None]
    mask &= (torch.arange(n_tokens, device=dev)[None, :] < token_lens.to(dev)[:, None])[..., None]
    return mask.to(torch.float32)


class ScamaDecoderLayer(DecoderLayerSANM):
    """The SANM decoder layer (FFN -> FSMN memory -> cross-attention) with a
    per-token cross-attention mask: the module path always (the JAX package
    takes its fused int8 decoder layer only under a key mask, decoder.py:
    243-249), its Dense layers quantized for the QDense rule."""

    def quantize_weights(self) -> None:
        for mod in self.modules():
            if isinstance(mod, Dense):
                mod.quantize_weights()

    def forward(self, tgt: torch.Tensor, tgt_mask: torch.Tensor, memory: torch.Tensor,
                mem_valid: torch.Tensor) -> torch.Tensor:
        """tgt (B, U, D); tgt_mask (B, U, 1) float; memory (B, T, D);
        mem_valid (B, 1 or U, T) bool."""
        x = self.feed_forward(self.norm1(tgt))
        if self.self_attn is not None:
            x = tgt + self.self_attn(self.norm2(x), tgt_mask)
        if self.src_attn is not None:
            src = self.src_attn
            k, v = src.linear_k_v(memory).split(src.n_feat, dim=-1)
            ctx = masked_attention(src.linear_q(self.norm3(x)), k, v, mem_valid, src.n_head)
            x = x + src.linear_out(ctx)
        return x


@tables.register("decoder_classes", "FsmnDecoderSCAMAOpt")
class FsmnDecoderSCAMAOpt(nn.Module):
    """The autoregressive chunk-aware SANM decoder (decoder.py:89 of the JAX
    package).  ``sanm_shift`` -1 is the reference default
    ``(kernel_size - 1) // 2``, a causal FSMN."""

    def __init__(self, vocab_size: int, encoder_output_size: int,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, att_layer_num: int = 6, kernel_size: int = 21,
                 sanm_shift: int = -1, dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.1, self_attention_dropout_rate: float = 0.0,
                 src_attention_dropout_rate: float = 0.0, use_output_layer: bool = True,
                 param_dtype: Optional[torch.dtype] = None):
        """The dropout rates are the reference's training-only settings;
        inference ignores them."""
        super().__init__()
        d, pd = encoder_output_size, param_dtype
        shift = (kernel_size - 1) // 2 if sanm_shift < 0 else sanm_shift
        self.dtype = dtype
        self.attention_heads = attention_heads
        self.kernel_size = kernel_size

        def layers(n, self_attn, src_attn):
            return nn.ModuleList([ScamaDecoderLayer(d, attention_heads, linear_units,
                                                    kernel_size, shift, self_attn, src_attn,
                                                    dtype, pd) for _ in range(n)])

        self.embed = nn.Sequential(nn.Embedding(vocab_size, d))
        self.decoders = layers(att_layer_num, True, True)
        self.decoders2 = (layers(num_blocks - att_layer_num, True, False)
                          if num_blocks - att_layer_num > 0 else None)
        self.decoders3 = layers(1, False, False)
        self.after_norm = LayerNormF32(d, dtype)
        self.output_layer = (Dense(d, vocab_size, dtype=dtype, param_dtype=pd)
                             if use_output_layer else None)
        self.eval()

    def fsmn_layers(self):
        """The layers with an FSMN memory, in order: ``decoders`` then
        ``decoders2``."""
        return list(self.decoders) + list(self.decoders2 or [])

    def quantize_weights(self) -> None:
        """The QDense weights of every layer and of the output projection."""
        for layer in self.fsmn_layers() + list(self.decoders3):
            layer.quantize_weights()
        if self.output_layer is not None:
            self.output_layer.quantize_weights()

    def forward(self, memory: torch.Tensor, memory_lengths: torch.Tensor,
                ys_in: torch.Tensor, ys_in_lengths: torch.Tensor,
                chunk_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Teacher-forced scoring (reference decoder.py:353 ``forward``):
        ys_in (B, U) sos-prefixed ids, ``chunk_mask`` (B, U, T) of
        :func:`scama_cross_mask` -> logits (B, U, vocab) in the compute dtype
        (the hiddens without an output layer)."""
        U, T = ys_in.shape[1], memory.shape[1]
        tgt_mask = sequence_mask(ys_in_lengths, U)[:, :, None]
        mem_valid = sequence_mask(memory_lengths, T, torch.bool)[:, None, :]
        if chunk_mask is not None:
            mem_valid = mem_valid & (chunk_mask != 0)
        memory = memory.to(self.dtype)
        x = self.embed[0](ys_in).to(self.dtype)
        for layer in self.fsmn_layers() + list(self.decoders3):
            x = layer(x, tgt_mask, memory, mem_valid)
        hidden = self.after_norm(x)
        return hidden if self.output_layer is None else self.output_layer(hidden)


class ScamaState(NamedTuple):
    """The rolling FSMN windows of the layers with a memory, stacked:
    (L1 + L2, N, K, D)."""

    fsmn: torch.Tensor


class CachedScamaDecoder:
    """Step scorer over an :class:`FsmnDecoderSCAMAOpt` (decoder.py:195 of the
    JAX package; the reference's ``forward_one_step`` FSMN cache).

    memory (B, T, D) is per utterance and the hypothesis axis is
    N = B * beam; the cross K/V are projected once and shared by the beam.
    ``cross_mask`` (B, U, T) is per utterance (the fire track is shared by
    the beam): step ``pos`` ANDs its row into the memory's key mask; without
    it the key mask alone gates the cross-attention."""

    def __init__(self, decoder: FsmnDecoderSCAMAOpt, memory: torch.Tensor,
                 memory_lengths: torch.Tensor, *, n_head: int, kernel_size: int,
                 dtype: torch.dtype = torch.float32,
                 cross_mask: Optional[torch.Tensor] = None, beam: int = 1):
        self.dec = decoder
        self.n_head = n_head
        self.K = kernel_size
        self.dtype = dtype
        self.beam = beam
        self.cross_mask = None if cross_mask is None else cross_mask != 0
        B, T, _ = memory.shape
        self.N = B * beam
        self.layers = decoder.fsmn_layers()
        self.D = decoder.embed[0].embedding_dim
        mem = memory.to(dtype)
        F_ = self.D
        self.ckv = [layer.src_attn.linear_k_v(mem).split(F_, dim=-1)
                    for layer in decoder.decoders]  # (B, T, F) each, beam-shared
        # (K, D) taps in the compute dtype: the JAX step casts the FSMN kernel
        self.taps = [layer.self_attn.fsmn_block.weight[:, 0, :].t().to(dtype)
                     for layer in self.layers]
        self.mem_valid = (torch.arange(T, device=memory.device)[None, :]
                          < memory_lengths[:, None])  # (B, T)

    def init_state(self) -> ScamaState:
        return ScamaState(fsmn=torch.zeros((len(self.layers), self.N, self.K, self.D),
                                           dtype=self.dtype, device=self.mem_valid.device))

    def step(self, y_tok: torch.Tensor, pos: int, state: ScamaState
             ) -> Tuple[torch.Tensor, ScamaState]:
        """y_tok (N,) the token at ``pos`` (sos at 0) -> (log-probs (N, V)
        float32, the state with the windows moved on by that token)."""
        dt = self.dtype
        x = self.dec.embed[0].weight[y_tok].to(dt)[:, None, :]  # (N, 1, D)
        key_valid = self.mem_valid
        if self.cross_mask is not None:
            key_valid = key_valid & self.cross_mask[:, pos]
        bufs = []
        for l, layer in enumerate(self.layers):
            residual = x
            h = layer.feed_forward(layer.norm1(x))
            h2 = layer.norm2(h)
            buf = torch.cat([state.fsmn[l, :, 1:], h2], dim=1)  # (N, K, D)
            x = residual + (buf * self.taps[l]).sum(dim=1, keepdim=True) + h2
            bufs.append(buf)
            if layer.src_attn is not None:
                src = layer.src_attn
                ck, cv = self.ckv[l]
                ctx = _mha_step_shared(src.linear_q(layer.norm3(x)), ck, cv, key_valid,
                                       self.n_head, self.beam, dt)
                x = x + src.linear_out(ctx)
        last = self.dec.decoders3[0]  # FFN only, its output replaces x
        x = self.dec.after_norm(last.feed_forward(last.norm1(x)))
        logits = self.dec.output_layer(x)[:, 0]
        return torch.log_softmax(logits.to(torch.float32), dim=-1), ScamaState(torch.stack(bufs))

    @staticmethod
    def reorder_state(state: ScamaState, src_flat: torch.Tensor) -> ScamaState:
        """Gather the windows along the hypothesis axis after the top-k."""
        return ScamaState(fsmn=state.fsmn[:, src_flat])
