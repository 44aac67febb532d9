"""Training losses (port of funasr_tpu/losses.py; reference
funasr/losses/label_smoothing_loss.py, funasr/models/paraformer/cif_predictor.py:609
``mae_loss``, funasr/metrics/compute_acc.py ``th_accuracy``).

Every function returns a 0-d float32 tensor on its inputs' device and reads
nothing back to the host.  ``ctc_loss`` follows ``optax.ctc_loss`` followed
by a plain mean over the batch (the JAX package's form); it calls
``F.ctc_loss`` with ``reduction="none"``, since ``"mean"`` would divide each
sequence's loss by its target length.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def label_smoothing_loss(logits: torch.Tensor, targets: torch.Tensor,
                         ignore_id: int = -1, smoothing: float = 0.0,
                         normalize_length: bool = False) -> torch.Tensor:
    """Label-smoothed KL-divergence loss, espnet semantics: the smoothed
    target puts ``smoothing/(V-1)`` on every off-target class, the KL keeps
    its constant entropy term, pad positions are dropped, and the sum is
    divided by the batch size (by the token count with ``normalize_length``).

    logits (B, U, V); targets (B, U) ids, ``ignore_id`` at pads."""
    B, U, V = logits.shape
    valid = targets != ignore_id
    tgt = torch.where(valid, targets, 0).to(torch.int64)
    confidence = 1.0 - smoothing
    low = smoothing / (V - 1)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    logp_tgt = torch.gather(logp, -1, tgt[..., None])[..., 0]
    sum_logp = logp.sum(dim=-1)
    cross = -(confidence * logp_tgt + low * (sum_logp - logp_tgt))
    entropy = -(confidence * math.log(max(confidence, 1e-20))
                + (V - 1) * low * math.log(max(low, 1e-20)))
    kl = torch.where(valid, cross - entropy, 0.0)
    denom = valid.sum() if normalize_length else torch.full((), B, device=logits.device)
    return kl.sum() / torch.clamp(denom, min=1).to(torch.float32)


def th_accuracy(logits: torch.Tensor, targets: torch.Tensor,
                ignore_id: int = -1) -> torch.Tensor:
    """Token accuracy over the positions that are not ``ignore_id``."""
    pred = torch.argmax(logits, dim=-1)
    valid = targets != ignore_id
    correct = ((pred == targets) & valid).sum()
    return correct.to(torch.float32) / torch.clamp(valid.sum(), min=1).to(torch.float32)


def mae_length_loss(target_length: torch.Tensor, pred_length: torch.Tensor,
                    normalize_length: bool = False) -> torch.Tensor:
    """The predictor's token-count L1 loss (cif_predictor.py:609)."""
    loss = (target_length.to(torch.float32) - pred_length).abs().sum()
    if normalize_length:
        denom = target_length.sum().to(torch.float32)
    else:
        denom = torch.full((), float(target_length.shape[0]), device=loss.device)
    return loss / torch.clamp(denom, min=1.0)


def ctc_loss(logits: torch.Tensor, logit_lengths: torch.Tensor,
             targets: torch.Tensor, target_lengths: torch.Tensor,
             ignore_id: int = -1, blank_id: int = 0) -> torch.Tensor:
    """CTC loss of encoder-frame logits (B, T, V) against ``ignore_id``-padded
    targets (B, U): each sequence's negative log-likelihood, then the mean
    over the batch (reference ctc/ctc.py:53)."""
    labels = torch.where(targets == ignore_id, 0, targets).to(torch.int64)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1).transpose(0, 1)
    per_seq = F.ctc_loss(logp, labels, logit_lengths.to(torch.int64),
                         target_lengths.to(torch.int64), blank=blank_id,
                         reduction="none", zero_infinity=False)
    return per_seq.mean()
