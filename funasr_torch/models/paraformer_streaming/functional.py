"""Streaming Paraformer forward as plain functions over the port's offline
modules (port of funasr_tpu/models/paraformer_streaming/functional.py).

The functions take the layers of a float32 :class:`~funasr_torch.models.
paraformer.model.Paraformer` (``models/sanm.py``, ``paraformer/decoder.py``,
``paraformer/predictor.py``), so one set of weights serves the offline and
the streaming path.  Chunk semantics are the JAX package's (reference
sanm/encoder.py:440 ``forward_chunk``, sanm/attention.py:313 the attention
KV cache, paraformer/cif_predictor.py:255 online CIF, sanm/attention.py:499
the decoder FSMN cache):

- window = [l + r cached feature frames | c new frames] for chunk_size
  (l, c, r);
- self-attention attends over [KV cache (look_back * c frames) | window];
  the window's first ``keep = l + c`` frames enter the cache and its last
  C are kept, a shift (not a ring), so the keys keep the JAX order;
- CIF fires inside window frames [l, l + c); on the final chunk also in the
  lookahead, plus a zero-hidden tail pseudo-frame; integrate/frame carry;
- the decoder FSMN memory carries the token stream's (K - 1)-entry tail with
  the reference's symmetric-first / causal-later alignment (``fsmn_stream``).

Attention runs through ``ops/attention.py`` ``fused_attention`` (the CUDA
kernel on the card, its twin on the CPU); the rest is plain float32
PyTorch, as the JAX package computes it in XLA: Dense layers, FFNs, layer
norms, the FSMN depthwise convolutions (a multiply and a sum over the taps,
so no cuDNN convolution and no TF32), the CIF and the predictor's
convolution.  What the JAX step keeps in device scalars that only count
windows (the cache fill ``kv_valid``, the absolute frame position, the
valid window length) is a host int here: no step reads the device to know
them.  Data-dependent state (the CIF carry, the decoder caches, ``started``)
stays on the device.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from funasr_torch.ops import attention as A

NEG_BIAS = -1e30  # the attention kernel's key-mask value (ops/masks.key_bias)


def depthwise_conv(x: torch.Tensor, weight: torch.Tensor, left: int,
                   right: int) -> torch.Tensor:
    """x (B, T, D), depthwise filters (D, 1, K) -> (B, T + left + right - K + 1,
    D): ``out[j] = sum_k xpad[j + k] * w[k]`` with ``left``/``right`` zero
    frames around x (lax.conv's cross-correlation, float32 on any device)."""
    K = weight.shape[-1]
    xp = torch.nn.functional.pad(x, (0, 0, left, right))
    return (xp.unfold(1, K, 1) * weight[:, 0, :]).sum(-1)


def span_bias(T: int, lo: int, hi: int, device) -> torch.Tensor:
    """(1, T) float32 key bias: 0 on [lo, hi), -1e30 elsewhere."""
    bias = torch.full((1, T), NEG_BIAS, dtype=torch.float32, device=device)
    bias[:, lo:hi] = 0.0
    return bias


# ------------------------------------------------------------ encoder chunk
class EncChunkState(NamedTuple):
    kv: List[torch.Tensor]  # per layer (B, C, 2D) cached [k | v]
    kv_valid: int  # valid cache frames (the same in every layer)


def _enc_layer_chunk(layer, x, kv_cache, bias, wvalid, *, first: bool, keep: int):
    """One SANM layer (``models/sanm.py`` ``EncoderLayerSANM``) on a window with
    its attention KV cache (functional.py:68).

    x (B, W, D_in); kv_cache (B, C, 2D); bias (B, C + W) float32 key bias
    (0 on the filled cache slots and the valid window frames); wvalid (1, W,
    1) the valid window frames.  Returns (y (B, W, D), new cache (B, C, 2D)).
    """
    at = layer.self_attn
    C = kv_cache.shape[1]
    D, H = at.n_feat, at.n_head
    d_k = D // H
    q, k, v = at.linear_q_k_v(layer.norm1(x)).split(D, dim=-1)
    # FSMN memory over the window alone (the reference passes mask=None);
    # frames past win_valid are zeroed so they cannot leak into the taps of
    # real frames
    v = v * wvalid
    K = at.fsmn_block.weight.shape[-1]
    left = (K - 1) // 2
    mem = depthwise_conv(v, at.fsmn_block.weight, left, K - 1 - left) + v
    # k and v are column slices of [cache | window]; the cache's empty
    # slots and the window's padding frames carry the -1e30 bias.  No query
    # row is ever fully masked (win_valid >= l + r > 0): the kernel would
    # give such a row uniform weights where the JAX step gives zeros.
    full_kv = torch.cat([kv_cache, torch.cat([k * wvalid, v], dim=-1)], dim=1)
    ctx = A.fused_attention(q * (d_k ** -0.5), full_kv[..., :D], full_kv[..., D:],
                            bias, H)
    att_out = at.linear_out(ctx) + mem
    y = att_out if first else x + att_out
    y = y + layer.feed_forward(layer.norm2(y))
    # append the first `keep` window frames, keep the last C
    return y, full_kv[:, keep:keep + C]


def streaming_inv_timescales(depth: int, device) -> torch.Tensor:
    """``inv_ts`` of the JAX ``_streaming_pe`` (functional.py:126) in float32:
    ``exp(i * -log(10000) / (depth / 2 - 1))``, i < depth // 2."""
    log_inc = torch.log(torch.tensor(10000.0)) / (depth / 2 - 1)
    return torch.exp(torch.arange(depth // 2, dtype=torch.float32) * -log_inc).to(device)


def streaming_pe(first_pos: int, W: int, inv_ts: torch.Tensor) -> torch.Tensor:
    """(W, depth) ``[sin(p * inv_ts), cos(p * inv_ts)]`` at positions
    ``first_pos + i`` (reference SinusoidalPositionEncoderOnline.encode,
    embedding.py:423), rows at positions < 1 zero."""
    pos = torch.arange(W, dtype=torch.float32, device=inv_ts.device) + float(first_pos)
    scaled = pos[:, None] * inv_ts
    pe = torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=-1)
    n_neg = min(max(0, 1 - first_pos), W)
    if n_neg:
        pe[:n_neg] = 0.0
    return pe


def encoder_chunk(encoder, window, state: EncChunkState, start_idx: int,
                  win_valid: int, inv_ts, *, keep: int, overlap: int):
    """window (B, W, D_in) = [overlap cached frames | c new frames] ->
    (enc_out (B, W, D), state') (functional.py:136).

    Each frame gets the encoding of its ABSOLUTE position: new frames
    ``start_idx + 1``..., cached frames the one they had when they were
    new, and the initial zero frames (absolute position < 0) none.  The PE
    is at the input width D_in (``inv_ts`` from
    :func:`streaming_inv_timescales`)."""
    B, W, _ = window.shape
    dev = window.device
    x = window.to(torch.float32) * (encoder.output_size() ** 0.5)
    x = x + streaming_pe(start_idx - overlap + 1, W, inv_ts)
    C = state.kv[0].shape[1]
    wvalid = (torch.arange(W, device=dev) < win_valid).to(torch.float32)[None, :, None]
    # the first C - kv_valid cache slots are empty; window pads at the end
    bias = span_bias(C + W, C - state.kv_valid, C + win_valid, dev).expand(B, -1)
    layers = list(encoder.encoders0) + list(encoder.encoders)
    new_kv = []
    for i, (layer, cache) in enumerate(zip(layers, state.kv)):
        x, nc = _enc_layer_chunk(layer, x, cache, bias, wvalid, first=i == 0, keep=keep)
        new_kv.append(nc)
    x = encoder.after_norm(x)
    return x, EncChunkState(new_kv, min(state.kv_valid + keep, C))


def init_enc_state(n_layers: int, batch: int, cache_len: int, d_model: int,
                   device) -> EncChunkState:
    return EncChunkState([torch.zeros((batch, cache_len, 2 * d_model), device=device)
                          for _ in range(n_layers)], 0)


# ---------------------------------------------------------------- CIF chunk
class CifState(NamedTuple):
    integrate: torch.Tensor  # (B,)
    frame: torch.Tensor  # (B, D) accumulated weighted hidden


def predictor_alphas(predictor, hidden: torch.Tensor) -> torch.Tensor:
    """conv -> relu -> linear -> sigmoid (the CifPredictorV2 head,
    functional.py:193), float32."""
    return predictor.conv_alphas(hidden.to(torch.float32))[1]


def cif_chunk(hidden: torch.Tensor, alphas: torch.Tensor, state: CifState,
              max_tokens: int):
    """Integrate-and-fire over one chunk with carried state (functional.py:205).

    hidden/alphas (B, T, D)/(B, T), alphas already masked to the firing
    region.  Returns (embeds (B, U, D), n_tokens (B,) int32, state')."""
    B, T, D = hidden.shape
    integ = state.integrate[:, None]
    # the carry as a pseudo-frame: alpha = integrate, hidden = frame / integrate
    carry_hidden = torch.where(integ > 0, state.frame / torch.clamp_min(integ, 1e-9),
                               state.frame)[:, None, :]
    a = torch.cat([integ, alphas.to(torch.float32)], dim=1)
    h = torch.cat([carry_hidden, hidden.to(torch.float32)], dim=1)
    S = torch.cumsum(a, dim=-1)
    P = S - a
    grid = torch.arange(max_tokens, dtype=torch.float32, device=a.device)[None, :, None]
    w = torch.clamp(torch.minimum(S[:, None, :], grid + 1.0)
                    - torch.maximum(P[:, None, :], grid), 0.0, 1.0)
    embeds = torch.bmm(w, h)
    total = S[:, -1]
    n_tokens = torch.floor(total).to(torch.int32)
    new_integrate = total - n_tokens
    # the trailing token's unnormalised partial mass
    idx = torch.clamp(n_tokens, 0, max_tokens - 1).to(torch.int64)
    tail = torch.gather(embeds, 1, idx[:, None, None].expand(B, 1, D))[:, 0]
    return embeds, n_tokens, CifState(new_integrate, tail)


def init_cif_state(batch: int, d_model: int, device) -> CifState:
    return CifState(torch.zeros((batch,), device=device),
                    torch.zeros((batch, d_model), device=device))


# ------------------------------------------------------------ decoder chunk
class DecChunkState(NamedTuple):
    fsmn: List[torch.Tensor]  # per layer (B, K - 1, D) conv-input tails
    started: torch.Tensor  # (B,) bool: this row's FSMN stream has begun


def fsmn_stream(h2: torch.Tensor, n_tokens: torch.Tensor, weight: torch.Tensor,
                fsmn_cache: torch.Tensor, started: torch.Tensor):
    """Streaming decoder FSMN memory over a padded token grid
    (functional.py:249; reference sanm/attention.py:499-537).

    h2 (B, U, D) token hiddens, rows >= n_tokens zero; weight (D, 1, K);
    fsmn_cache (B, K - 1, D); started (B,) bool.  Returns (mem = conv + h2,
    new cache).  The first chunk that fires is convolved with symmetric
    padding (like offline) and its right zero pad enters the stream; later
    chunks are causal over [cache, tokens]; the cache advances only on
    chunks that fire."""
    B, U, D = h2.shape
    K = weight.shape[-1]
    right = K - 1 - (K - 1) // 2
    ctx = torch.cat([fsmn_cache, h2, h2.new_zeros((B, right, D))], dim=1)
    out = depthwise_conv(ctx, weight, 0, 0)  # out[j] covers ctx[j : j + K]
    # token t sits at ctx index K - 1 + t: causal -> j = t, symmetric -> j = t + right
    mem = torch.where(started[:, None, None], out[:, :U], out[:, right:right + U]) + h2
    # the last K - 1 entries up to the last valid token, plus the one-time
    # right-pad gap after the first chunk that fires
    gap = torch.where(started, 0, right)
    idx = (n_tokens.to(torch.int64) + gap)[:, None] + torch.arange(K - 1, device=h2.device)
    cand = torch.gather(ctx, 1, idx[:, :, None].expand(B, K - 1, D))
    new_cache = torch.where((n_tokens > 0)[:, None, None], cand, fsmn_cache)
    return mem, new_cache


def decoder_chunk(decoder, embeds, n_tokens, memory, state: DecChunkState,
                  memory_valid: int):
    """embeds (B, U, D) CIF tokens (padded), n_tokens (B,), memory (B, W, D)
    the chunk's encoder output of which the first ``memory_valid`` frames
    are real -> (log_probs (B, U, V) float32, state') (functional.py:347).
    Runs on the whole U grid whatever ``n_tokens`` is, as the JAX step does."""
    B, U, _ = embeds.shape
    tgt_mask = (torch.arange(U, device=embeds.device)[None, :]
                < n_tokens[:, None]).to(torch.float32)[:, :, None]
    mem_bias = span_bias(memory.shape[1], 0, memory_valid, memory.device).expand(B, -1)
    x = embeds
    new_fsmn = []
    for layer, cache in zip(decoder.decoders, state.fsmn):
        h = layer.feed_forward(layer.norm1(x))
        h2 = layer.norm2(h) * tgt_mask  # pad rows stay zero (the stream gathers)
        mem, nc = fsmn_stream(h2, n_tokens, layer.self_attn.fsmn_block.weight, cache,
                              state.started)
        y = x + mem * tgt_mask
        # cross-attention: U = c + r + 3 query rows over the window frames,
        # the first memory_valid >= l + r of them keys (no row fully masked)
        x = y + layer.src_attn(layer.norm3(y), memory, mem_bias)
        new_fsmn.append(nc)
    # decoders3: FFN only, no residual (reference decoder.py:96-121)
    lp3 = decoder.decoders3[0]
    x = lp3.feed_forward(lp3.norm1(x))
    logits = decoder.output_layer(decoder.after_norm(x))
    log_probs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    # the stream starts once a chunk fires (the reference keeps cache=None,
    # offline-style symmetric padding, until its first decoded chunk)
    return log_probs, DecChunkState(new_fsmn, state.started | (n_tokens > 0))


def init_dec_state(n_layers: int, batch: int, kernel_size: int, d_model: int,
                   device) -> DecChunkState:
    return DecChunkState([torch.zeros((batch, kernel_size - 1, d_model), device=device)
                          for _ in range(n_layers)],
                         torch.zeros((batch,), dtype=torch.bool, device=device))
