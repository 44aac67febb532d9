"""Incremental (KV-cached) per-step scoring for the AR TransformerDecoder
(port of funasr_tpu/ops/cached_decoder.py:37-406; reference
funasr/models/transformer/decoder.py:291 ``forward_one_step``).

Self-attention K/V of past positions live in (L, N, M, F) buffers indexed by
the step counter; cross-attention K/V of the encoder memory are projected
once per utterance and shared by its ``beam`` hypotheses.  With
``int8_kv=True`` both are stored as per-row int8 codes with float32 scales
(``_q8_rows``, the ``/127`` form), the scales applied to the scores (k) and
to the attention weights (v) as in the JAX package.

The math mirrors the JAX step line for line: layer norms in float32 then
cast, projections in the compute dtype through the decoder's
:class:`~funasr_torch.models.sanm.Dense` modules (the QDense rule), scores
in the compute dtype then a float32 softmax over ``where(valid, s, -inf)``
with ``where(valid, p, 0)`` after it.  The self-attention Q/K/V projection
is one fused (D, 3F) contraction, as in the JAX package.

Unlike JAX's functional updates, :meth:`CachedTransformerDecoder.step`
writes the new position into the state's buffers in place (the beam gathers
the state into new buffers right after each step, ``reorder_state``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from funasr_torch.models.sanm import Dense
from funasr_torch.ops import quant as Q
from funasr_torch.ops import rowquant as RQ
from funasr_torch.ops.posenc import transformer_encoding


def _heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    N, T, F = x.shape
    return x.reshape(N, T, n_head, F // n_head).transpose(1, 2)


def _masked_softmax(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """softmax(where(valid, s, -inf)) then where(valid, p, 0): a row with no
    valid key is NaN before the second where and 0 after it."""
    attn = torch.softmax(torch.where(valid, scores, float("-inf")), dim=-1)
    return torch.where(valid, attn, 0.0)


def _mha_step(q, k, v, key_valid, n_head, dtype):
    """Single-query attention over cached keys: q (N, 1, F); k, v (N, M, F);
    key_valid (N, M) bool."""
    N, _, F = q.shape
    d_k = F // n_head
    qh = _heads(q, n_head) * (d_k ** -0.5)  # (N, H, 1, d_k)
    kh, vh = _heads(k, n_head), _heads(v, n_head)
    scores = torch.matmul(qh.to(dtype), kh.to(dtype).transpose(-1, -2))
    attn = _masked_softmax(scores.to(torch.float32), key_valid[:, None, None, :])
    ctx = torch.matmul(attn.to(vh.dtype), vh)
    return ctx.transpose(1, 2).reshape(N, 1, F)


def _mha_step_int8(q, k8, ks, v8, vs, key_valid, n_head, dtype):
    """``_mha_step`` over a per-row int8 cache: k scales on the scores, v
    scales on the attention weights (row-exact)."""
    N, _, F = q.shape
    d_k = F // n_head
    qh = _heads(q, n_head) * (d_k ** -0.5)
    kh, vh = _heads(k8.to(dtype), n_head), _heads(v8.to(dtype), n_head)
    scores = torch.matmul(qh.to(dtype), kh.transpose(-1, -2))
    scores = scores.to(torch.float32) * ks[:, None, None, :]
    attn = _masked_softmax(scores, key_valid[:, None, None, :]) * vs[:, None, None, :]
    ctx = torch.matmul(attn.to(vh.dtype), vh)
    return ctx.transpose(1, 2).reshape(N, 1, F)


def _beam_heads(q, n_head, beam):
    N, _, F = q.shape
    d_k = F // n_head
    return (q.reshape(N // beam, beam, n_head, d_k).transpose(1, 2)
            * (d_k ** -0.5))  # (B, H, beam, d_k)


def _mha_step_shared(q, k, v, key_valid, n_head, beam, dtype):
    """Single-query attention with beam-shared keys/values: q (B*beam, 1, F)
    against k, v (B, T, F), key_valid (B, T)."""
    N, _, F = q.shape
    qh = _beam_heads(q, n_head, beam)
    kh, vh = _heads(k, n_head), _heads(v, n_head)  # (B, H, T, d_k)
    scores = torch.matmul(qh.to(dtype), kh.to(dtype).transpose(-1, -2))
    attn = _masked_softmax(scores.to(torch.float32), key_valid[:, None, None, :])
    ctx = torch.matmul(attn.to(vh.dtype), vh)  # (B, H, beam, d_k)
    return ctx.transpose(1, 2).reshape(N, 1, F)


def _mha_step_shared_int8(q, k8, ks, v8, vs, key_valid, n_head, beam, dtype):
    """Beam-shared cross-attention over per-row int8 encoder K/V (B, T, F)
    with float32 row scales (B, T)."""
    N, _, F = q.shape
    qh = _beam_heads(q, n_head, beam)
    kh, vh = _heads(k8.to(dtype), n_head), _heads(v8.to(dtype), n_head)
    scores = torch.matmul(qh.to(dtype), kh.transpose(-1, -2))
    scores = scores.to(torch.float32) * ks[:, None, None, :]
    attn = _masked_softmax(scores, key_valid[:, None, None, :]) * vs[:, None, None, :]
    ctx = torch.matmul(attn.to(vh.dtype), vh)
    return ctx.transpose(1, 2).reshape(N, 1, F)


class DecoderState(NamedTuple):
    """Per-hypothesis cache of projected self-attention K/V, layer-stacked.
    With the int8 cache ``k``/``v`` hold int8 codes and ``k_scale``/
    ``v_scale`` their per-(layer, row, position) scales; otherwise None."""

    k: torch.Tensor  # (L, N, M, F) compute dtype or int8
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None  # (L, N, M) float32
    v_scale: Optional[torch.Tensor] = None


def _q8_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 over the last axis: (codes int8, scale float32
    of the leading shape), scale = max(absmax, 1e-8) / 127 as an IEEE
    division (``rowquant.quantize_ref`` "div")."""
    return RQ.quantize_ref(x.to(torch.float32), "div")


def resize_state(state: DecoderState, new_len: int) -> DecoderState:
    """Resize the position axis to exactly ``new_len``: zero-pads (growth) or
    truncates (the beam only cuts unwritten rows).  Identity when the length
    already matches."""
    cur = state.k.shape[2]
    if cur == new_len:
        return state

    def rs(x):
        if cur > new_len:
            return x[:, :, :new_len]
        pad = torch.zeros((*x.shape[:2], new_len - cur, *x.shape[3:]),
                          dtype=x.dtype, device=x.device)
        return torch.cat([x, pad], dim=2)

    return DecoderState(*(None if x is None else rs(x) for x in state))


class CachedTransformerDecoder:
    """Step scorer over a :class:`~funasr_torch.models.transformer.decoder.
    TransformerDecoder`'s modules.  An instance holds the per-batch
    precomputed tensors: the cross K/V and the fused QKV projections."""

    def __init__(self, decoder, memory: torch.Tensor, memory_lengths: torch.Tensor,
                 *, n_head: int, maxlen: int, dtype: torch.dtype = torch.float32,
                 beam: int = 1, int8_kv: bool = False):
        """memory (B, T, D) is per utterance (not repeated); ``beam`` makes
        the hypothesis axis N = B*beam for the self-attention caches while
        the cross K/V stay beam-shared.  ``int8_kv`` stores both as per-row
        int8."""
        self.dec = decoder
        self.layers = list(decoder.decoders)
        self.n_head = n_head
        self.maxlen = maxlen
        self.dtype = dtype
        self.beam = beam
        self.int8_kv = int8_kv
        B, T, _ = memory.shape
        self.N = B * beam
        self.L = len(self.layers)
        self.F = self.layers[0].self_attn.linear_q.out_features
        self.d = decoder.embed[0].embedding_dim
        mem = memory.to(dtype)
        # cross K/V projected once per utterance, shared by the beam rows
        self.ck = torch.stack([l.src_attn.linear_k(mem) for l in self.layers])
        self.cv = torch.stack([l.src_attn.linear_v(mem) for l in self.layers])
        if int8_kv:
            self.ck, self.cks = _q8_rows(self.ck)
            self.cv, self.cvs = _q8_rows(self.cv)
        self.mem_valid = (torch.arange(T, device=memory.device)[None, :]
                          < memory_lengths[:, None])  # (B, T)
        self.qkv = [self._fused_qkv(l.self_attn) for l in self.layers]
        self.pe = transformer_encoding(maxlen + 1, self.d, device=memory.device)

    def _fused_qkv(self, att) -> Dense:
        """One (D, 3F) projection from linear_q/k/v, quantized as QDense
        quantizes it when the model is quantized and N rows pass the gate."""
        lq, lk, lv = att.linear_q, att.linear_k, att.linear_v
        with torch.device("meta"):
            fused = Dense(lq.in_features, 3 * self.F, dtype=lq.compute_dtype,
                          param_dtype=lq.weight.dtype)
        fused.weight = torch.nn.Parameter(
            torch.cat([lq.weight, lk.weight, lv.weight]), requires_grad=False)
        fused.bias = torch.nn.Parameter(
            torch.cat([lq.bias, lk.bias, lv.bias]), requires_grad=False)
        if lq.w8 is not None and Q.gate(self.N, 3 * self.F):
            fused.quantize_weights()
        return fused

    def init_state(self) -> DecoderState:
        """Zeroed caches for all ``maxlen + 1`` positions."""
        shape = (self.L, self.N, self.maxlen + 1, self.F)
        dev = self.ck.device
        if self.int8_kv:
            z = lambda s, dt: torch.zeros(s, dtype=dt, device=dev)
            return DecoderState(z(shape, torch.int8), z(shape, torch.int8),
                                z(shape[:3], torch.float32), z(shape[:3], torch.float32))
        return DecoderState(torch.zeros(shape, dtype=self.dtype, device=dev),
                            torch.zeros(shape, dtype=self.dtype, device=dev))

    def step(self, y_tok: torch.Tensor, pos: int, state: DecoderState
             ) -> Tuple[torch.Tensor, DecoderState]:
        """Score the next token after prefix position ``pos``: y_tok (N,)
        token at ``pos`` (sos for 0) -> (log-probs (N, V) float32, state with
        position ``pos`` written)."""
        dtype, H = self.dtype, self.n_head
        M = state.k.shape[2]  # the live buffer length (staged growth)
        emb = self.dec.embed[0].weight[y_tok].to(dtype)  # (N, d)
        x = (emb * (self.d ** 0.5) + self.pe[pos:pos + 1].to(dtype))[:, None, :]
        kv_valid = (torch.arange(M, device=x.device) <= pos)[None].expand(self.N, M)
        for l, layer in enumerate(self.layers):
            qs, ks, vs = self.qkv[l](layer.norm1(x)).split(self.F, dim=-1)
            if self.int8_kv:
                kq, ksc = _q8_rows(ks)
                vq, vsc = _q8_rows(vs)
                state.k[l, :, pos] = kq[:, 0]
                state.v[l, :, pos] = vq[:, 0]
                state.k_scale[l, :, pos] = ksc[:, 0]
                state.v_scale[l, :, pos] = vsc[:, 0]
                ctx = _mha_step_int8(qs, state.k[l], state.k_scale[l], state.v[l],
                                     state.v_scale[l], kv_valid, H, dtype)
            else:
                state.k[l, :, pos] = ks[:, 0]
                state.v[l, :, pos] = vs[:, 0]
                ctx = _mha_step(qs, state.k[l], state.v[l], kv_valid, H, dtype)
            x = x + layer.self_attn.linear_out(ctx)
            q2 = layer.src_attn.linear_q(layer.norm2(x))
            if self.int8_kv:
                ctx2 = _mha_step_shared_int8(q2, self.ck[l], self.cks[l], self.cv[l],
                                             self.cvs[l], self.mem_valid, H,
                                             self.beam, dtype)
            else:
                ctx2 = _mha_step_shared(q2, self.ck[l], self.cv[l], self.mem_valid,
                                        H, self.beam, dtype)
            x = x + layer.src_attn.linear_out(ctx2)
            x = x + layer.feed_forward(layer.norm3(x))
        logits = self.dec.output_layer(self.dec.after_norm(x))[:, 0]  # (N, V)
        return torch.log_softmax(logits.to(torch.float32), dim=-1), state

    @staticmethod
    def reorder_state(state: DecoderState, src_flat: torch.Tensor) -> DecoderState:
        """Gather the cache along the hypothesis axis (N,) after the top-k."""
        return DecoderState(*(None if x is None else x[:, src_flat] for x in state))

