"""Joint CTC/attention beam search (port of funasr_tpu/ops/beam_search.py).

Fixed beam tensors, as in the JAX package:

- hypotheses: (B, K, L+1) token grid, (B, K) scores, (B, K) finished flags;
- attention scores per step from a KV-cached incremental scorer
  (``step_score_fn``, ops/cached_decoder.py) or from a full-prefix decoder
  call (``decode_fn``);
- CTC prefix scores from the (r_nb, r_b) recurrence over the encoder frames,
  evaluated only for the ``W`` pre-beam candidates of each hypothesis: the
  whole prefix step (gather, phi, recurrence, sigma) is one launch of the
  ``ops/ctc_prefix.py`` step kernel per decode step on the card.

The JAX ``lax.while_loop`` with early exit becomes a Python loop over steps:
it ends when every hypothesis has emitted eos, read with one host sync per
step (:func:`all_finished`, the search's only host sync), or at ``maxlen``.
Staged cache growth (``cache_stages``) grows the scorer's buffers at each
stage bound as there.

Ties: ``lax.top_k`` returns equal values lowest index first and
``jnp.argsort`` is stable; ``torch.topk`` promises neither, and ties are
real here (at step 0 every hypothesis but the first sits at ``NEG_INF``,
and ``NEG_INF + x`` is ``NEG_INF`` in float32).  Every selection therefore
goes through a stable descending sort (:func:`topk_stable`).

Frame masking: CTC log-probs must be prepared with :func:`mask_ctc_frames`
so padded frames are (blank: 0, others: NEG_INF); they then leave prefix
scores unchanged.

Left out of this port (ROADMAP.md): LM shallow fusion, hotword tables, the
length bonus, a pre-beam width other than ``min(1.5 K + 1, V)`` and the
``approx_max_k`` pre-beam.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from funasr_torch.ops import ctc_prefix as CP
from funasr_torch.ops.ctc_prefix import NEG_INF, logaddexp


def mask_ctc_frames(ctc_logp: torch.Tensor, lengths: torch.Tensor,
                    blank_id: int = 0) -> torch.Tensor:
    """Make padded frames transparent to the prefix recurrence."""
    B, T, V = ctc_logp.shape
    valid = torch.arange(T, device=ctc_logp.device)[None, :] < lengths[:, None]
    pad_row = torch.full((V,), NEG_INF, dtype=ctc_logp.dtype, device=ctc_logp.device)
    pad_row[blank_id].fill_(0.0)  # fill_: a Python value set by index syncs the card
    return torch.where(valid[:, :, None], ctc_logp, pad_row)


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` along the last axis, equal values lowest index first
    (``lax.top_k``'s order)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def ctc_prefix_step(x_t: torch.Tensor, r_prev: torch.Tensor,
                    last: torch.Tensor, cand: torch.Tensor,
                    prefix_empty: bool, blank_id: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score extending each prefix with each candidate: x_t (B, V, T) masked
    CTC log-probs, time-minor (transposed once before the decode loop, so
    the candidates' emission rows are a row gather); r_prev (B, K, T, 2)
    [nb, b] state of each prefix; last (B, K) last token; cand (B, K, W)
    candidate extensions; prefix_empty: the prefixes hold no token yet
    (step 0).  Returns (sigma (B, K, W) total prefix scores, r_new (B, K,
    W, T, 2)).  One launch of ``ops/ctc_prefix.py`` ``ctc_prefix_step`` on
    the card, its twin on the CPU."""
    return CP.ctc_prefix_step(x_t, r_prev, last, cand, prefix_empty, blank_id)


def ctc_init_state(x: torch.Tensor, blank_id: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """State and score of the empty prefix, all-blank paths: x (B, T, V) ->
    (r0 (B, T, 2), sigma0 (B,))."""
    r_b = torch.cumsum(x[:, :, blank_id], dim=-1)
    r_nb = torch.full_like(r_b, NEG_INF)
    return torch.stack([r_nb, r_b], dim=-1), r_b[:, -1]


def all_finished(finished: torch.Tensor) -> bool:
    """Whether every hypothesis has emitted eos: the beam's one host sync a
    step (and one before the forced-eos rescore)."""
    return bool(finished.all())


class BeamResult(NamedTuple):
    tokens: torch.Tensor   # (B, K, L) best-first hypotheses (sos stripped)
    lengths: torch.Tensor  # (B, K) token counts (before eos)
    scores: torch.Tensor   # (B, K)
    steps: int             # decode steps run (the forced-eos pass not counted)


def beam_search(
    decode_fn: Optional[Callable],  # (ys (N, L+1), step) -> next logp (N, V)
    batch: int,
    beam: int,
    vocab: int,
    sos: int,
    eos: int,
    maxlen: int,
    ctc_logp: Optional[torch.Tensor] = None,  # (B, T, V) pre-masked
    ctc_weight: float = 0.0,
    blank_id: int = 0,
    step_score_fn: Optional[Callable] = None,
    dec_state=None,
    state_reorder_fn: Optional[Callable] = None,
    cache_stages: Optional[Sequence[int]] = None,  # e.g. (24, 48, 72, 96)
    state_grow_fn: Optional[Callable] = None,  # (state, new_len) -> state
    device=None,
) -> BeamResult:
    """Batched fixed-beam search.

    Two attention-scorer interfaces, as in the JAX package:

    - ``decode_fn(ys, step)``: full-prefix rescoring each step;
    - ``step_score_fn(last_tok (N,), step, state) -> (logp (N, V), state)``
      with ``dec_state`` the initial cache and
      ``state_reorder_fn(state, src_flat (N,))`` the beam gather.

    ``cache_stages`` (incremental path only, with ``state_grow_fn``) runs the
    decode in consecutive stages with the cache grown to each stage's step
    bound, and to ``maxlen + 1`` for the forced-eos rescore.  ``device``
    defaults to ``ctc_logp``'s, else the CPU.
    """
    B, K, V = batch, beam, vocab
    incremental = step_score_fn is not None
    if not incremental and decode_fn is None:
        raise ValueError("need decode_fn or step_score_fn")
    if incremental and state_reorder_fn is None:
        raise ValueError("step_score_fn requires state_reorder_fn")
    use_ctc = ctc_logp is not None and ctc_weight > 0.0
    if device is None:
        device = ctc_logp.device if ctc_logp is not None else torch.device("cpu")
    W = min(int(1.5 * K) + 1, V)  # pre-beam candidates per hypothesis
    i64 = dict(dtype=torch.int64, device=device)

    ys = torch.full((B, K, maxlen + 1), eos, **i64)
    ys[:, :, 0].fill_(sos)
    scores = torch.full((B, K), NEG_INF, dtype=torch.float32, device=device)
    scores[:, 0].fill_(0.0)
    finished = torch.zeros((B, K), dtype=torch.bool, device=device)
    lengths = torch.zeros((B, K), **i64)
    b_idx = torch.arange(B, **i64)[:, None]  # (B, 1)
    if use_ctc:
        T = ctc_logp.shape[1]
        r0, sigma0 = ctc_init_state(ctc_logp, blank_id)
        r_state = r0[:, None].expand(B, K, T, 2)
        sigma_g = sigma0[:, None].expand(B, K)
        ctc_logp_t = ctc_logp.transpose(1, 2).contiguous()  # (B, V, T)
    att_w = 1.0 - ctc_weight if use_ctc else 1.0
    eos_only = torch.full((V,), NEG_INF, dtype=torch.float32, device=device)
    eos_only[eos].fill_(0.0)

    def gather_hyp(x, src):
        return x[b_idx, src]

    def step_fn(step: int):
        nonlocal ys, scores, finished, lengths, dec_state, r_state, sigma_g
        N = B * K
        last = ys[:, :, step]  # (B, K) token at position `step`
        if incremental:
            logp, dec_state = step_score_fn(last.reshape(N), step, dec_state)
        else:
            logp = decode_fn(ys.reshape(N, -1), step)  # (N, V)
        logp = logp.reshape(B, K, V).to(torch.float32)

        if use_ctc:
            # pre-beam candidates by the attention score
            cf, c = topk_stable((att_w * logp).reshape(N, V), W)
            cand_fused, cand = cf.reshape(B, K, W), c.reshape(B, K, W)
            sigma, r_new = ctc_prefix_step(ctc_logp_t, r_state, last, cand,
                                           step == 0, blank_id)
            # eos is "prefix complete", not a CTC symbol: its score is the
            # full-utterance CTC probability of the prefix itself
            prefix_complete = logaddexp(r_state[..., -1, 0], r_state[..., -1, 1])
            sigma = torch.where(cand == eos, prefix_complete[:, :, None], sigma)
            combined = cand_fused + ctc_weight * (sigma - sigma_g[:, :, None])
            # candidate-space selection over (B, K*(W+1)); column W is the
            # zero-cost forced eos of finished hypotheses
            Wc = W + 1
            ext = torch.where(finished[:, :, None], NEG_INF, combined)
            eos_col = torch.where(finished, 0.0, NEG_INF)[:, :, None]
            total = scores[:, :, None] + torch.cat([ext, eos_col], dim=2)
            top_scores, top_idx = topk_stable(total.reshape(B, K * Wc), K)
            src_hyp = top_idx // Wc  # (B, K)
            w_idx = top_idx % Wc
            w_sel = torch.clamp(w_idx, max=W - 1)
            tok = torch.where(w_idx == W, eos, cand[b_idx, src_hyp, w_sel])
        else:
            # finished hyps may only extend with eos at zero cost
            total_ext = torch.where(finished[:, :, None], eos_only, logp)
            total = scores[:, :, None] + total_ext  # (B, K, V)
            top_scores, top_idx = topk_stable(total.reshape(B, K * V), K)
            src_hyp = top_idx // V
            tok = top_idx % V

        ys = gather_hyp(ys, src_hyp)
        if incremental:
            src_flat = (b_idx * K + src_hyp).reshape(N)
            dec_state = state_reorder_fn(dec_state, src_flat)
        finished = gather_hyp(finished, src_hyp)
        lengths = gather_hyp(lengths, src_hyp)
        ys[:, :, step + 1] = torch.where(finished, eos, tok)
        newly_finished = (tok == eos) & ~finished
        lengths = torch.where(finished | newly_finished, lengths, lengths + 1)

        if use_ctc:
            # the chosen candidate's state; column W (forced eos) keeps the
            # source hypothesis's
            took_cand = (w_idx < W) & ~finished & (tok != eos)
            r_sel = r_new[b_idx, src_hyp, w_sel]  # (B, K, T, 2)
            sig_sel = sigma[b_idx, src_hyp, w_sel]
            r_state = torch.where(took_cand[:, :, None, None], r_sel,
                                  gather_hyp(r_state, src_hyp))
            sigma_g = torch.where(took_cand, sig_sel, gather_hyp(sigma_g, src_hyp))
        finished = finished | (tok == eos)
        scores = top_scores

    if incremental and cache_stages and state_grow_fn is not None:
        bounds = sorted({int(b) for b in cache_stages if 0 < b < maxlen})
        bounds.append(maxlen)
    else:
        bounds = [maxlen]

    step = 0
    for hi in bounds:
        if len(bounds) > 1:
            dec_state = state_grow_fn(dec_state, hi)
        while step < hi and not all_finished(finished):
            step_fn(step)
            step += 1
    if len(bounds) > 1:
        # the forced-eos rescore below writes at position maxlen
        dec_state = state_grow_fn(dec_state, maxlen + 1)

    # forced-eos finalisation: hypotheses still running at maxlen pay the eos
    # term before ranking against finished ones.  When every hypothesis has
    # finished the term is never used, so the rescore is skipped.
    if not all_finished(finished):
        if incremental:
            final_logp, _ = step_score_fn(ys[:, :, maxlen].reshape(B * K), maxlen,
                                          dec_state)
        else:
            final_logp = decode_fn(ys.reshape(B * K, -1), maxlen)
        final_eos = final_logp.reshape(B, K, V)[..., eos].to(torch.float32)
        eos_term = att_w * final_eos
        if use_ctc:
            prefix_complete = logaddexp(r_state[..., -1, 0], r_state[..., -1, 1])
            eos_term = eos_term + ctc_weight * (prefix_complete - sigma_g)
        scores = torch.where(finished, scores, scores + eos_term)

    order = torch.argsort(-scores, dim=1, stable=True)
    return BeamResult(gather_hyp(ys, order)[:, :, 1:], gather_hyp(lengths, order),
                      gather_hyp(scores, order), step)
