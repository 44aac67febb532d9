"""CTC forced alignment: a Viterbi over the blank-interleaved lattice (port
of funasr_tpu/ops/ctc_align.py:27; reference
funasr/models/sense_voice/utils/ctc_alignment.py ``ctc_forced_align``).

The JAX package runs the DP as two ``lax.scan``s on the device (not a TPU
kernel).  Here it is split where the work is:

- :func:`align_emissions` on the device: the emission of every (frame,
  lattice state), ``em[b, t, s] = scores[b, t, ext[b, s]]`` with ``ext`` the
  target row with blanks between and around its labels (S = 2 U + 1), pad
  frames free for blank and closed to labels, states past
  ``2 * target_length`` closed.  One gather; its (B, T, S) result is what
  the host reads back, in place of the (B, T, V) scores.
- :func:`viterbi` on the host in float32 numpy, vectorised over the batch
  and the states, one step a frame: on the card a per-frame loop would be
  about ten launches a frame on a path whose batches the host already
  paces.

An alignment is the two in turn with one read back between them:
``SenseVoiceEngine`` (greedy CTC tokens) and ``decode_beam_align`` of the
hybrid models (each returned beam hypothesis) compose them so.

Kept exactly, so the alignments equal JAX's: float32 additions in the
same order; ``NEG_INF`` = -1e30 for closed emissions and states; the
three-way choice stay / step / skip with the first of equal maxima
(``jnp.argmax``'s order); skips only between different labels; the end
state ``2 U - 1`` (last label) when its score is ``>=`` that of ``2 U``
(trailing blank), taken after the last, padded, frame; pad frames blank in
the output.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


def align_emissions(scores: torch.Tensor, targets: torch.Tensor,
                    input_lengths: torch.Tensor, target_lengths: torch.Tensor,
                    blank: int = 0) -> torch.Tensor:
    """scores (B, T, C) (log-probabilities, or the probabilities SenseVoice
    passes); targets (B, U), blank-padded, or (B, K, U), K targets aligned
    to each row's scores; input lengths (B,), target lengths (B,) or (B, K)
    -> float32 (B, T, 2 U + 1), or (B, K, T, 2 U + 1), emissions on the
    scores' device with no host sync (one gather for all K)."""
    rows = targets.dim() == 3
    if not rows:
        targets, target_lengths = targets[:, None], target_lengths[:, None]
    B, T, C = scores.shape
    K, U = targets.shape[1:]
    S = 2 * U + 1
    dev = scores.device
    ext = torch.full((B, K, S), blank, dtype=torch.int64, device=dev)
    ext[..., 1::2] = targets.to(torch.int64)
    lp = scores.to(torch.float32)
    tmask = torch.arange(T, device=dev)[None] < input_lengths.to(torch.int64)[:, None]
    em = torch.gather(lp, 2, ext.reshape(B, 1, K * S).expand(B, T, K * S))
    em = em.reshape(B, T, K, S).transpose(1, 2)
    # pad frames: blank free (0), labels closed
    pad = torch.where(ext == blank, 0.0, NEG_INF).to(torch.float32)
    em = torch.where(tmask[:, None, :, None], em, pad[:, :, None, :])
    valid_state = (torch.arange(S, device=dev)
                   <= 2 * target_lengths.to(torch.int64)[..., None])  # (B, K, S)
    em = torch.where(valid_state[:, :, None, :], em, NEG_INF)
    return em if rows else em[:, 0]


def viterbi(em: np.ndarray, targets: np.ndarray, input_lengths: np.ndarray,
            target_lengths: np.ndarray, blank: int = 0) -> np.ndarray:
    """Host DP over :func:`align_emissions`' (B, T, S) output -> (B, T)
    int64 frame labels (``blank`` on non-emitting and pad frames).  States
    above ``2 * max(target_lengths)`` are never reached and are left out."""
    em = np.asarray(em, np.float32)
    targets = np.asarray(targets, np.int64)
    tl = np.asarray(target_lengths, np.int64)
    B, T, S = em.shape
    if B == 0 or T == 0:
        return np.full((B, T), blank, np.int64)
    S = min(S, 2 * int(tl.max()) + 1)
    em = em[:, :, :S]
    ext = np.full((B, 2 * targets.shape[1] + 1), blank, np.int64)  # [blank, y1, blank, ...]
    ext[:, 1::2] = targets
    ext = ext[:, :S]
    neg = np.float32(NEG_INF)
    diff = np.zeros((B, S), bool)
    diff[:, 2:] = ext[:, 2:] != ext[:, :-2]

    score = np.full((B, S), neg, np.float32)
    score[:, 0] = em[:, 0, 0]
    if S > 1:
        score[:, 1] = np.where(tl > 0, em[:, 0, 1], neg)
    bps = np.empty((T, B, S), np.int8)
    no_skip = ~diff
    step = np.full((B, S), neg, np.float32)  # the score one state back
    skip = np.full((B, S), neg, np.float32)  # two back, where a skip is allowed
    best = np.empty((B, S), np.float32)
    for t in range(1, T):
        step[:, 1:] = score[:, :-1]
        skip[:, 2:] = score[:, :-2]
        np.copyto(skip, neg, where=no_skip)
        # argmax over (stay, step, skip), the first of equal maxima
        np.maximum(score, step, out=best)
        bps[t] = np.where(skip > best, 2, step > score)
        score = em[:, t] + np.maximum(best, skip)

    rows = np.arange(B)
    e1, e2 = 2 * tl - 1, 2 * tl
    s = np.where(score[rows, e1 % S] >= score[rows, e2], e1, e2)
    s = np.maximum(s, 0)
    states = np.empty((T, B), np.int64)
    states[T - 1] = s
    for t in range(T - 1, 0, -1):
        s = s - bps[t, rows, s]
        states[t - 1] = s
    align = np.take_along_axis(ext, states.T, axis=1)
    tmask = np.arange(T)[None] < np.asarray(input_lengths, np.int64)[:, None]
    return np.where(tmask, align, blank)
