"""Continuous Integrate-and-Fire (CIF) (port of funasr_tpu/ops/cif.py).

With threshold 1.0, CIF is an interval overlap between the cumulative-alpha
line and the integer token grid: with ``S_t = sum(alpha[:t+1])`` and
``P_t = S_t - alpha_t``, frame ``t`` gives token ``u`` the weight
``clip(min(S_t, u+1) - max(P_t, u), 0, 1)``, and the acoustic embeddings
are one (B, U, T) x (B, T, D) product.  Two documented divergences from the
reference ``cif_v1`` are part of the contract (funasr_tpu/ops/cif.py:20-30):
a final token that never crosses the threshold keeps its partial mass (then
masked by ``n_fired``), and the tail frame integrates the hidden value at
``lengths``.

Fire boundaries are decided by the prefix sum, so it must be bit-identical
to the JAX path: :func:`compensated_cumsum` replays the TwoSum combine in
exactly the evaluation tree of ``jax.lax.associative_scan``.  Additions
and subtractions are correctly rounded on the CPU and the card alike, so
``peaks`` come out identical on both.  The (B, U, T) contraction is a plain
float32 ``bmm`` (XLA's dot in the JAX package, not a Pallas kernel).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


def _two_sum(a: Tuple[torch.Tensor, torch.Tensor],
             b: Tuple[torch.Tensor, torch.Tensor]):
    s1, c1 = a
    s2, c2 = b
    s = s1 + s2
    bp = s - s1
    e = (s1 - (s - bp)) + (s2 - bp)
    return s, c1 + c2 + e


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    n = even.shape[-1] + odd.shape[-1]
    out = even.new_empty(even.shape[:-1] + (n,))
    out[..., 0::2] = even
    out[..., 1::2] = odd
    return out


def _assoc_scan(s: torch.Tensor, c: torch.Tensor):
    """``lax.associative_scan(_two_sum, (s, c), axis=-1)``, same tree."""
    n = s.shape[-1]
    if n < 2:
        return s, c
    rs, rc = _two_sum((s[..., 0:n - 1:2], c[..., 0:n - 1:2]),
                      (s[..., 1::2], c[..., 1::2]))
    os_, oc = _assoc_scan(rs, rc)
    if n % 2 == 0:
        es, ec = _two_sum((os_[..., :-1], oc[..., :-1]),
                          (s[..., 2::2], c[..., 2::2]))
    else:
        es, ec = _two_sum((os_, oc), (s[..., 2::2], c[..., 2::2]))
    es = torch.cat([s[..., :1], es], dim=-1)
    ec = torch.cat([c[..., :1], ec], dim=-1)
    return _interleave(es, os_), _interleave(ec, oc)


def compensated_cumsum(x: torch.Tensor):
    """Prefix sum over the last axis with TwoSum compensation: returns
    ``(s, c)`` with the true prefix sum ``s + c`` to O(ulp)."""
    return _assoc_scan(x, torch.zeros_like(x))


class CifOutput(NamedTuple):
    embeds: torch.Tensor  # (B, U, D) acoustic embeddings, zero-padded
    token_num: torch.Tensor  # (B,) float: total integrated alpha
    fires: torch.Tensor  # (B, T) reference-compatible fire track
    peaks: torch.Tensor  # (B, T) bool: frame fired (token boundary)


def cif(hidden: torch.Tensor, alphas: torch.Tensor, max_tokens: int) -> CifOutput:
    """Integrate-and-fire with threshold 1.0.

    hidden (B, T, D); alphas (B, T) nonnegative, pre-masked, each <= 1;
    ``max_tokens`` is the token-grid size U.
    """
    if hidden.dim() != 3 or alphas.dim() != 2:
        raise ValueError(f"cif expects (B,T,D)/(B,T), got "
                         f"{tuple(hidden.shape)}/{tuple(alphas.shape)}")
    alphas = alphas.to(torch.float32)
    s, c = compensated_cumsum(alphas)
    S = s + c  # inclusive prefix sum
    P = S - alphas  # exclusive prefix sum

    floor_S = torch.floor(S)
    peaks = floor_S > torch.floor(P)
    fires = peaks.to(torch.float32) + (S - floor_S)

    grid = torch.arange(max_tokens, dtype=torch.float32,
                        device=alphas.device)[None, :, None]  # (1, U, 1)
    lo = torch.maximum(P[:, None, :], grid)
    hi = torch.minimum(S[:, None, :], grid + 1.0)
    # jnp.clip's form, so a gradient at a bound splits as there
    zero = torch.zeros((), device=alphas.device)
    w = torch.minimum(torch.maximum(hi - lo, zero), zero + 1.0)  # (B, U, T)
    embeds = torch.bmm(w, hidden.to(torch.float32))

    token_num = S[:, -1]
    # only fired tokens exist: token u iff the integration crossed u + 1
    n_fired = torch.floor(token_num + 1e-4)
    valid = (grid[..., 0] < n_fired[:, None]).to(torch.float32)[:, :, None]
    embeds = embeds * valid
    return CifOutput(embeds.to(hidden.dtype), token_num, fires, peaks)


def cif_tail(hidden: torch.Tensor, alphas: torch.Tensor, lengths: torch.Tensor,
             tail_threshold: float):
    """Append the inference-time tail frame (reference ``tail_process_fn``,
    cif_predictor.py:346): alpha ``tail_threshold`` at position ``lengths``
    and a zero hidden frame at the end.  Returns (hidden', alphas',
    floor(sum(alphas'))) with T+1 frames."""
    b, t, d = hidden.shape
    pos = torch.arange(t + 1, device=alphas.device)[None, :]
    onehot = (pos == lengths.to(torch.int64)[:, None]).to(alphas.dtype)
    alphas = torch.nn.functional.pad(alphas, (0, 1)) + tail_threshold * onehot
    hidden = torch.nn.functional.pad(hidden, (0, 0, 0, 1))
    token_num = torch.floor(alphas.sum(dim=-1))
    return hidden, alphas, token_num
