"""SenseVoiceSmall: multitask non-autoregressive ASR + language, emotion and
event tags (port of funasr_tpu/models/sense_voice/model.py; reference
funasr/models/sense_voice/model.py:588 ``SenseVoiceSmall``, encoder :443
``SenseVoiceEncoderSmall``).

Four prompt embeddings ([language, event, emotion, text norm], rows of an
``nn.Embedding(16, input_size)`` at the feature width) are prepended to the
LFR fbank frames, lengths + 4.  The encoder is :class:`SANMEncoder`
(``x * sqrt(D)`` plus the sinusoidal code at the input width,
``encoders0`` 560 -> 512, ``encoders`` x (num_blocks - 1), ``after_norm``)
followed by a second stack, ``tp_encoders`` x tp_blocks, and its own
``tp_norm``; a CTC head ``ctc.ctc_lo`` (512 -> vocab) gives the frames'
log-probs, decoded greedily on the device.  The first four decoded tokens
are the rich tags (``rich_transcription_postprocess`` turns them into
emoji); the speech tokens follow.

Timestamps (reference model.py:918-931 ``output_timestamp``) force-align
the speech tokens to the speech frames, reproducing the reference's quirk:
the alignment runs on softmax *probabilities* of rows 4:, with the blank's
probability zeroed on frames whose argmax is blank.  The emissions are
gathered on the device and the Viterbi runs on the host
(``ops/ctc_align.py``).

int8 serving as :class:`Paraformer`: build with ``quantize=True`` (float32
parameters), load, :meth:`SenseVoiceSmall.quantize_weights`.  The 69 layers
with ``in_size == size`` (49 + 20) run through the fused int8 SANM layer
kernel at every length (the JAX package's Pallas layer needs T % 8 == 0 and
T + 4 never is: it leaves the fused layers there, the port does not);
``encoders0``'s projections and ``ctc_lo`` take the QDense rule of
:class:`Dense`.  The two opt-in int8 routes are not ported for this model.
Parameter names are FunASR's (``encoder.encoders0.0``,
``encoder.tp_encoders.{i}``, ``encoder.tp_norm``, ``embed``,
``ctc.ctc_lo``), so ``funasr_tpu.convert.sense_voice_from_torch`` reads
this state dict.  Inference only.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from funasr_torch.device import resolve_device
from funasr_torch.models.sanm import Dense, EncoderLayerSANM, LayerNormF32, SANMEncoder
from funasr_torch.ops.ctc_align import align_emissions
from funasr_torch.ops.ctc_decode import ctc_greedy_decode
from funasr_torch.ops.masks import key_bias, sequence_mask
from funasr_torch.registry import tables

LID_DICT = {"auto": 0, "zh": 3, "en": 4, "yue": 7, "ja": 11, "ko": 12,
            "nospeech": 13}
TEXTNORM_DICT = {"withitn": 14, "woitn": 15}
# main-vocab tag token id -> query embed id (reference model.py:643,645:
# lid_int_dict / textnorm_int_dict for the released 25k SentencePiece vocab)
LID_INT_DICT = {24884: 3, 24885: 4, 24888: 7, 24892: 11, 24896: 12,
                24992: 13}
TEXTNORM_INT_DICT = {25016: 14, 25017: 15}
EMO_UNK_TAG = "<|EMO_UNKNOWN|>"
QUERY_VOCAB = 16  # 7 + len(lid) + len(textnorm)
N_PROMPT = 4  # [language, event, emotion, text norm]

# training-only fields of the reference template and the JAX class
_TRAINING_FIELDS = {"lsm_weight", "length_normalized_loss", "ignore_id"}


def lid_id(language: str) -> int:
    return LID_DICT.get(language, 0)


def textnorm_id(use_itn: bool) -> int:
    return TEXTNORM_DICT["withitn" if use_itn else "woitn"]


@tables.register("encoder_classes", "SenseVoiceEncoderSmall")
class SenseVoiceEncoderSmall(SANMEncoder):
    """:class:`SANMEncoder` plus the ``tp_encoders`` stack and ``tp_norm``."""

    def __init__(self, input_size: int, output_size: int = 512,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 50, tp_blocks: int = 20, kernel_size: int = 11,
                 sanm_shift: int = 0, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None,
                 dropout_rate: float = 0.0, attention_dropout_rate: float = 0.0):
        """The dropout rates are training settings; inference ignores them."""
        super().__init__(input_size, output_size, attention_heads, linear_units,
                         num_blocks, kernel_size, sanm_shift, dtype=dtype,
                         param_dtype=param_dtype)
        self.tp_encoders = nn.ModuleList([
            EncoderLayerSANM(output_size, output_size, attention_heads, linear_units,
                             kernel_size, sanm_shift, dtype, param_dtype)
            for _ in range(tp_blocks)])
        self.tp_norm = LayerNormF32(output_size, dtype)
        self.eval()

    def quantize_weights(self) -> None:
        super().quantize_weights()
        for layer in self.tp_encoders:
            layer.quantize_weights()

    def forward(self, xs: torch.Tensor, lengths: torch.Tensor):
        """xs (B, T, input_size); lengths (B,) -> (out (B, T, D), lengths)."""
        x, lengths = super().forward(xs, lengths)
        T = x.shape[1]
        mask_t = sequence_mask(lengths, T)[:, :, None]
        bias = key_bias(lengths, T)
        for layer in self.tp_encoders:
            x = layer(x, mask_t, bias, lengths)
        return self.tp_norm(x), lengths


@tables.register("model_classes", "SenseVoiceSmall")
class SenseVoiceSmall(nn.Module):
    """Config fields mirror the reference template; builds on ``device``
    (default the GPU, raising without one; ``"cpu"`` only when asked).
    ``dtype`` is the compute dtype, ``quantize`` int8 serving."""

    def __init__(self, vocab_size: int, input_size: int = 560,
                 encoder_conf: Optional[Dict[str, Any]] = None, blank_id: int = 0,
                 dtype: torch.dtype = torch.float32, device=None, quantize: bool = False,
                 **training_conf):
        unknown = set(training_conf) - _TRAINING_FIELDS
        if unknown:
            raise TypeError(f"SenseVoiceSmall: unexpected arguments {sorted(unknown)}")
        super().__init__()
        self.vocab_size = vocab_size
        self.input_size = input_size
        self.blank_id = blank_id
        self.dtype = dtype
        self.quantize = quantize
        self._int8_ready = False
        param_dtype = torch.float32 if quantize else None
        conf = dict(encoder_conf or {})
        for key in ("input_layer", "pos_enc_class", "selfattention_layer_type",
                    "positional_dropout_rate"):
            conf.pop(key, None)
        conf["sanm_shift"] = conf.pop("sanm_shfit", conf.get("sanm_shift", 0))
        with torch.device(resolve_device(device)):
            self.encoder = SenseVoiceEncoderSmall(input_size, dtype=dtype,
                                                  param_dtype=param_dtype, **conf)
            self.embed = nn.Embedding(QUERY_VOCAB, input_size, dtype=param_dtype or dtype)
            # the reference's CTC module holds the head as ``ctc.ctc_lo``
            self.ctc = nn.ModuleDict({"ctc_lo": Dense(
                self.encoder.output_size(), vocab_size, dtype=dtype, param_dtype=param_dtype)})
        self.eval()
        self.register_load_state_dict_post_hook(SenseVoiceSmall._weights_changed)

    @staticmethod
    def _weights_changed(module, incompatible_keys) -> None:
        module._int8_ready = False

    @torch.no_grad()
    def quantize_weights(self) -> "SenseVoiceSmall":
        """Build the int8 weights and scales from the current float32
        parameters, once per model load (a ``quantize=True`` model only)."""
        if not self.quantize:
            raise RuntimeError("quantize_weights() needs SenseVoiceSmall(quantize=True)")
        self.encoder.quantize_weights()
        self.ctc.ctc_lo.quantize_weights()
        self._int8_ready = True
        return self

    def encode(self, speech: torch.Tensor, speech_lengths: torch.Tensor,
               lid_ids: torch.Tensor, textnorm_ids: torch.Tensor):
        """Prepend [language, event (1), emotion (2), text norm] queries
        (reference model.py:758-772) and run the encoder; lengths + 4."""
        if self.quantize and not self._int8_ready:
            raise RuntimeError("SenseVoiceSmall(quantize=True): call quantize_weights() "
                               "after loading the weights")
        B = speech.shape[0]
        ev_emo = torch.arange(1, 3, device=lid_ids.device).expand(B, 2)  # no upload
        ids = torch.cat([lid_ids.to(torch.int64)[:, None], ev_emo,
                         textnorm_ids.to(torch.int64)[:, None]], dim=1)
        prompt = self.embed(ids).to(self.dtype)
        x = torch.cat([prompt, speech.to(self.dtype)], dim=1)
        return self.encoder(x, speech_lengths + N_PROMPT)

    def log_probs(self, speech, speech_lengths, lid_ids, textnorm_ids):
        """-> float32 (B, T + 4, V) CTC log-probs and the lengths + 4."""
        enc, enc_lens = self.encode(speech, speech_lengths, lid_ids, textnorm_ids)
        return torch.log_softmax(self.ctc.ctc_lo(enc).to(torch.float32), dim=-1), enc_lens

    @torch.inference_mode()
    def greedy_decode(self, speech, speech_lengths, lid_ids, textnorm_ids):
        """Device CTC greedy decode -> (tokens (B, T + 4), token_lengths)."""
        log_probs, enc_lens = self.log_probs(speech, speech_lengths, lid_ids, textnorm_ids)
        return ctc_greedy_decode(log_probs, enc_lens, self.blank_id)

    @torch.inference_mode()
    def decode_for_alignment(self, speech, speech_lengths, lid_ids, textnorm_ids):
        """Greedy decode and the device half of its CTC forced alignment:
        (tokens, token_lengths, the alignment's emissions (B, T, 2 T + 1)
        over the speech rows, the speech frames' and speech tokens'
        lengths); ``ops/ctc_align.py`` ``viterbi`` on the host finishes it."""
        log_probs, enc_lens = self.log_probs(speech, speech_lengths, lid_ids, textnorm_ids)
        tokens, tok_lens = ctc_greedy_decode(log_probs, enc_lens, self.blank_id)
        probs = torch.exp(log_probs[:, N_PROMPT:])
        pred = torch.argmax(probs, dim=-1)
        blank = probs[..., self.blank_id]
        probs[..., self.blank_id] = torch.where(pred == self.blank_id, 0.0, blank)
        in_lens = torch.clamp(enc_lens - N_PROMPT, min=0)
        tgt_lens = torch.clamp(tok_lens - N_PROMPT, min=0)
        em = align_emissions(probs, tokens[:, N_PROMPT:], in_lens, tgt_lens, self.blank_id)
        return tokens, tok_lens, em, in_lens, tgt_lens
