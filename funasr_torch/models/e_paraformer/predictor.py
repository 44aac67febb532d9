"""PIF predictor, parallel integrate-and-fire (port of
funasr_tpu/models/e_paraformer/predictor.py:33-109; reference
funasr/models/e_paraformer/pif_predictor.py:18 ``PifPredictor``).

In float32, whatever the model dtype:

    q      = relu(depthwise_conv(h) + conv_bias + h)          alpha head
    alphas = relu(sigmoid(cif_output(q)) * smooth - noise) * mask
    token_num = sum alphas;  alphas *= round(token_num) / max(token_num, 1e-6)
    scores[b, h, u, t] = -((u + 0.5 - cumsum(alphas)[b, t]) * sigma[h])^2 + bias[h]
    embeds = softmax_t(scores, padded frames at -1e30) @ h split into heads

with the grid zeroed past ``ceil(round(token_num))``.  No fire track: the
output's ``fires`` are zeros and ``peaks`` all false, as in the JAX
package.  Plain PyTorch (one softmax and one batched product); the JAX
package has no kernel for it either.  Parameter names: ``cif_conv1d``
(a depthwise ``Conv1d`` (D, 1, K) with its bias), ``cif_output``,
``sigma`` and ``bias`` (one each a sigma head).
"""

from __future__ import annotations

import torch
from torch import nn

from funasr_torch.models.paraformer.predictor import PredictorOutput
from funasr_torch.ops.dwconv import depthwise_conv1d
from funasr_torch.ops.masks import sequence_mask
from funasr_torch.registry import tables

NEG_INF = -1e30


@tables.register("predictor_classes", "PifPredictor")
class PifPredictor(nn.Module):
    def __init__(self, idim: int, l_order: int = 1, r_order: int = 1,
                 threshold: float = 1.0, dropout: float = 0.1, smooth_factor: float = 1.0,
                 noise_threshold: float = 0.0, sigma: float = 0.5, bias: float = 0.0,
                 sigma_heads: int = 4, dtype: torch.dtype = torch.float32):
        """``dropout`` is a training-only setting and ``threshold`` unused at
        inference, as in the JAX package."""
        super().__init__()
        if idim % sigma_heads:
            raise ValueError(f"PifPredictor: idim {idim} is not a multiple of "
                             f"sigma_heads {sigma_heads}")
        self.l_order, self.r_order = l_order, r_order
        self.smooth_factor = smooth_factor
        self.noise_threshold = noise_threshold
        self.sigma_heads = sigma_heads
        self.dtype = dtype
        self.cif_conv1d = nn.Conv1d(idim, idim, l_order + r_order + 1, groups=idim)
        self.cif_output = nn.Linear(idim, 1)
        self.sigma = nn.Parameter(torch.full((sigma_heads,), float(sigma)))
        self.bias = nn.Parameter(torch.full((sigma_heads,), float(bias)))

    def forward(self, hidden: torch.Tensor, lengths: torch.Tensor,
                max_tokens: int) -> PredictorOutput:
        """hidden (B, T, D) encoder output; lengths (B,)."""
        B, T, D = hidden.shape
        H = self.sigma_heads
        h = hidden.to(torch.float32)
        q = depthwise_conv1d(h, self.cif_conv1d.weight, self.cif_conv1d.bias,
                             (self.l_order, self.r_order))
        q = torch.relu(q + h)
        alphas = torch.sigmoid(self.cif_output(q)[..., 0])
        alphas = torch.relu(alphas * self.smooth_factor - self.noise_threshold)
        mask = sequence_mask(lengths, T)
        alphas = alphas * mask

        token_num = alphas.sum(-1)
        tgt = torch.round(token_num)
        alphas = alphas * (tgt / torch.clamp(token_num, min=1e-6))[:, None]
        alignment = torch.cumsum(alphas, dim=-1)  # (B, T)
        fire_pos = torch.arange(max_tokens, dtype=torch.float32, device=h.device) + 0.5
        diff = fire_pos[None, None, :, None] - alignment[:, None, None, :]  # (B, 1, U, T)
        scores = -(diff * self.sigma[None, :, None, None]) ** 2 + self.bias[None, :, None, None]
        scores = torch.where(mask[:, None, None, :] > 0, scores, NEG_INF)
        weights = torch.softmax(scores, dim=-1)  # (B, H, U, T)
        embeds = torch.einsum("bhut,bthd->buhd", weights,
                              h.reshape(B, T, H, D // H)).reshape(B, max_tokens, D)
        u_valid = torch.arange(max_tokens, device=h.device)[None, :] < torch.ceil(tgt)[:, None]
        embeds = embeds * u_valid[:, :, None].to(torch.float32)
        zeros = torch.zeros_like(alphas)
        return PredictorOutput(embeds.to(self.dtype), token_num, alphas, zeros, zeros > 0)
