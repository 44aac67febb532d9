"""Device CTC greedy decoding (port of funasr_tpu/ops/ctc_decode.py;
reference sense_voice/model.py:899-906, which collapses each utterance on
the host with ``unique_consecutive``).

``ctc_greedy_decode`` is the batched argmax -> collapse repeats -> drop
blanks path, left-packing the kept tokens by a stable sort of the drop
flags: static shapes, no host sync.  ``torch.argmax`` returns the first of
equal maxima, as ``jnp.argmax`` does, and the stable sort keeps the kept
tokens in frame order (the rule the port keeps for every top-k).
"""

from __future__ import annotations

from typing import Tuple

import torch


def ctc_greedy_decode(log_probs: torch.Tensor, lengths: torch.Tensor,
                      blank_id: int = 0, pad_id: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """log_probs (B, T, V), lengths (B,) -> (tokens (B, T) int64 left-packed
    and ``pad_id``-padded, token_lengths (B,) int32)."""
    B, T, _ = log_probs.shape
    pred = torch.argmax(log_probs, dim=-1)
    pos = torch.arange(T, device=pred.device)[None]
    valid = pos < lengths.to(torch.int64)[:, None]
    prev = torch.cat([torch.full_like(pred[:, :1], -1), pred[:, :-1]], dim=1)
    keep = (pred != prev) & (pred != blank_id) & valid
    order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
    packed = torch.gather(pred, 1, order)
    token_lengths = keep.sum(dim=1, dtype=torch.int32)
    packed = torch.where(pos < token_lengths[:, None], packed, pad_id)
    return packed, token_lengths
