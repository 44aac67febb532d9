"""CIF predictor (port of funasr_tpu/models/paraformer/predictor.py;
reference ``CifPredictorV2``, cif_predictor.py:173).

conv1d (k = l_order + r_order + 1) -> relu -> linear -> sigmoid -> alphas,
then the interval-overlap CIF (``ops/cif.py``).  The alpha head runs in
float32 on the unmasked hidden state, its parameters stay float32 whatever
the model dtype, and the conv is evaluated as one float32 matmul over the
unfolded window (``torch.matmul`` keeps full float32 on the card; a cuDNN
conv would default to TF32).

Training (``self.training``, the JAX package's ``deterministic=False``):
dropout on the conv features, and with ``target_length`` the alphas are
rescaled to integrate to it (predictor.py:89-96 of the JAX package) with no
tail frame; ``token_num`` is then the unscaled sum the MAE loss reads.
Gradients flow to the alphas through the compensated prefix sum.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from funasr_torch.ops.cif import cif, cif_tail
from funasr_torch.ops.masks import sequence_mask
from funasr_torch.registry import tables


class PredictorOutput(NamedTuple):
    acoustic_embeds: torch.Tensor  # (B, U, D)
    token_num: torch.Tensor  # (B,) float
    alphas: torch.Tensor  # (B, T') per-frame weights (incl. tail frame)
    fires: torch.Tensor  # (B, T') cif fire track
    peaks: torch.Tensor  # (B, T') bool fire indicator


@tables.register("predictor_classes", "CifPredictorV2")
class CifPredictorV2(nn.Module):
    def __init__(self, idim: int, l_order: int = 1, r_order: int = 1,
                 threshold: float = 1.0, smooth_factor: float = 1.0,
                 noise_threshold: float = 0.0, tail_threshold: float = 0.45,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.1):
        """``dropout`` acts in training only (default: the JAX package's)."""
        super().__init__()
        if threshold != 1.0:
            raise NotImplementedError("the interval-overlap CIF needs threshold 1.0")
        self.l_order = l_order
        self.r_order = r_order
        self.smooth_factor = smooth_factor
        self.noise_threshold = noise_threshold
        self.tail_threshold = tail_threshold
        self.dtype = dtype
        self.dropout = dropout
        self.cif_conv1d = nn.Conv1d(idim, idim, l_order + r_order + 1)
        self.cif_output = nn.Linear(idim, 1)
        self.eval()  # built for inference; train() switches to the training path

    def conv_alphas(self, h: torch.Tensor):
        """float32 hidden (B, T, D) -> (relu of the conv features, unmasked
        alphas)."""
        B, T, D = h.shape
        K = self.l_order + self.r_order + 1
        win = F.pad(h, (0, 0, self.l_order, self.r_order)).unfold(1, K, 1)
        q = torch.relu(F.linear(win.reshape(B, T, D * K),
                                self.cif_conv1d.weight.reshape(D, D * K),
                                self.cif_conv1d.bias))
        q = F.dropout(q, self.dropout, self.training)
        alphas = torch.sigmoid(self.cif_output(q)[..., 0])
        return q, torch.relu(alphas * self.smooth_factor - self.noise_threshold)

    def forward(self, hidden: torch.Tensor, lengths: torch.Tensor,
                max_tokens: int, target_length=None) -> PredictorOutput:
        """hidden (B, T, D) encoder output; lengths (B,); ``target_length``
        (B,) float, training only: the alphas are rescaled to it."""
        T = hidden.shape[1]
        h = hidden.to(torch.float32)
        _, alphas = self.conv_alphas(h)
        alphas = alphas * sequence_mask(lengths, T)

        token_num = alphas.sum(dim=-1)
        if target_length is not None:
            scale = target_length.to(torch.float32) / torch.clamp(token_num, min=1e-6)
            alphas = alphas * scale[:, None]
            out = cif(h, alphas, max_tokens)
            return PredictorOutput(out.embeds.to(self.dtype), token_num, alphas,
                                   out.fires, out.peaks)
        if self.tail_threshold > 0.0:
            h, alphas, token_num = cif_tail(h, alphas, lengths,
                                            self.tail_threshold)
        out = cif(h, alphas, max_tokens)
        return PredictorOutput(out.embeds.to(self.dtype), token_num, alphas,
                               out.fires, out.peaks)
