"""BiCifParaformer: Paraformer with frame-accurate timestamps (port of
funasr_tpu/models/bicif_paraformer/model.py; reference
funasr/models/bicif_paraformer/ ``CifPredictorV3`` cif_predictor.py:97,
timestamp path model.py:135).

``CifPredictorV3`` adds a second alpha head on an ``upsample_times``
upsampling of the encoder output (or of the CIF conv features with
``use_cif1_cnn``).  Its fire track, rescaled to integrate to the token
count, gives token boundaries at 60 / ``upsample_times`` ms.  Two upsample
types, with FunASR's parameter names:

- "cnn": the stride-equals-kernel ``ConvTranspose1d`` ``upsample_cnn``, an
  einsum over the input channels (no overlap), then ``cif_output2``;
- "cnn_blstm" (the published BiCif checkpoints): the same, then a one-layer
  bidirectional ``blstm`` over the upsampled track, unpacked over padded
  frames as the reference runs it, then ``cif_output2`` on the concat.

The predictor runs in float32 whatever the model dtype.  Inference only.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch
from torch import nn

from funasr_torch.models.paraformer.model import Paraformer
from funasr_torch.models.paraformer.predictor import CifPredictorV2, PredictorOutput
from funasr_torch.ops.cif import cif, cif_tail, compensated_cumsum
from funasr_torch.ops.masks import sequence_mask
from funasr_torch.registry import tables


class PredictorOutputV3(NamedTuple):
    base: PredictorOutput
    us_alphas: torch.Tensor  # (B, T*u) upsampled alphas, rescaled
    us_peaks: torch.Tensor  # (B, T*u) bool upsampled fire indicator
    token_num2: torch.Tensor  # (B,) pre-rescale sum of the upsample head


@tables.register("predictor_classes", "CifPredictorV3")
class CifPredictorV3(CifPredictorV2):
    def __init__(self, idim: int, l_order: int = 1, r_order: int = 1,
                 threshold: float = 1.0, smooth_factor: float = 1.0,
                 noise_threshold: float = 0.0, tail_threshold: float = 0.45,
                 smooth_factor2: float = 0.25, noise_threshold2: float = 0.01,
                 upsample_times: int = 3, use_cif1_cnn: bool = False,
                 upsample_type: str = "cnn", dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__(idim, l_order, r_order, threshold, smooth_factor,
                         noise_threshold, tail_threshold, dtype, dropout)
        if upsample_type not in ("cnn", "cnn_blstm"):
            raise NotImplementedError(
                f"upsample_type {upsample_type!r} (cnn / cnn_blstm)")
        self.smooth_factor2 = smooth_factor2
        self.noise_threshold2 = noise_threshold2
        self.upsample_times = upsample_times
        self.use_cif1_cnn = use_cif1_cnn
        self.upsample_cnn = nn.ConvTranspose1d(idim, idim, upsample_times,
                                               upsample_times)
        self.blstm = None
        if upsample_type == "cnn_blstm":
            self.blstm = nn.LSTM(idim, idim, 1, batch_first=True, bidirectional=True)
        self.cif_output2 = nn.Linear(idim * (2 if self.blstm else 1), 1)

    def _us_track(self, a2: torch.Tensor, count: torch.Tensor):
        """Rescale the upsampled alphas to integrate to ``count``, then fire
        where the compensated prefix sum crosses a multiple of threshold -
        1e-4, threshold being 1.0 (reference cif_predictor.py:283-290)."""
        scale = count / torch.clamp(a2.sum(-1), min=1e-6)
        a2 = a2 * scale[:, None]
        s, c = compensated_cumsum(a2)
        S = s + c
        P = S - a2
        # a tensor on a2's device: CUDA turns a Python-scalar divisor into a
        # multiply by its reciprocal, which is another rounding; filled on
        # the device, since a copy from the host would wait for the stream
        theta = torch.full((), 1.0 - 1e-4, dtype=a2.dtype, device=a2.device)
        return a2, torch.floor(S / theta) > torch.floor(P / theta)

    def forward(self, hidden: torch.Tensor, lengths: torch.Tensor,
                max_tokens: int) -> PredictorOutputV3:
        """hidden (B, T, D) encoder output; lengths (B,)."""
        B, T, D = hidden.shape
        h = hidden.to(torch.float32)
        q, alphas = self.conv_alphas(h)
        mask = sequence_mask(lengths, T)
        alphas = alphas * mask
        hidden_masked = h * mask[:, :, None]
        token_num = alphas.sum(-1)

        u = self.upsample_times
        src = q if self.use_cif1_cnn else h
        up = (torch.einsum("btd,dok->btko", src, self.upsample_cnn.weight)
              + self.upsample_cnn.bias).reshape(B, T * u, D)
        if self.blstm is not None:
            up = self.blstm(up)[0]
        alphas2 = torch.sigmoid(self.cif_output2(up)[..., 0])
        alphas2 = torch.relu(alphas2 * self.smooth_factor2 - self.noise_threshold2)
        alphas2 = alphas2 * mask.repeat_interleave(u, dim=-1)
        token_num2 = alphas2.sum(-1)

        if self.tail_threshold > 0.0:
            hidden_masked, alphas, token_num = cif_tail(
                hidden_masked, alphas, lengths, self.tail_threshold)
        out = cif(hidden_masked, alphas, max_tokens)
        base = PredictorOutput(out.embeds.to(self.dtype), token_num, alphas,
                               out.fires, out.peaks)
        us_alphas, us_peaks = self._us_track(alphas2, token_num)
        return PredictorOutputV3(base, us_alphas, us_peaks, token_num2)


@tables.register("model_classes", "BiCifParaformer")
class BiCifParaformer(Paraformer):
    """Paraformer with the V3 predictor: the base CIF track drives the
    decoder, the upsampled one gives the timestamps.  Built, loaded and
    quantized as :class:`Paraformer` (``quantize``, ``qmm``, ``int8_attn``)."""

    def make_predictor(self, dtype: torch.dtype, pred_conf: Dict[str, Any]) -> nn.Module:
        return CifPredictorV3(dtype=dtype, **pred_conf)

    def _infer_raw_logits(self, speech, speech_lengths, max_tokens: int = 128):
        enc, enc_lens = self.encode(speech, speech_lengths)
        pred = self.predictor(enc, enc_lens, max_tokens)
        token_lengths = torch.clamp(torch.round(pred.base.token_num).to(torch.int32),
                                    0, max_tokens)
        logits = self.decoder(enc, enc_lens, pred.base.acoustic_embeds, token_lengths)
        return logits, token_lengths, pred

    @torch.inference_mode()
    def timestamps(self, speech: torch.Tensor, speech_lengths: torch.Tensor,
                   max_tokens: int = 128):
        """-> (tokens (B, U), token_lengths (B,), us_alphas (B, T*u),
        us_peaks (B, T*u)) for stamps at 60 / upsample_times ms."""
        log_probs, token_lengths, pred = self.inference_logits(
            speech, speech_lengths, max_tokens)
        return (torch.argmax(log_probs, dim=-1), token_lengths, pred.us_alphas,
                pred.us_peaks)
