"""Paraformer: non-autoregressive ASR (port of
funasr_tpu/models/paraformer/model.py; reference
funasr/models/paraformer/model.py:30).

encoder -> CIF predictor (one acoustic embedding per token) -> one
bidirectional decoder pass -> argmax.  The token grid is padded to
``max_tokens``; real counts travel as lengths.

Training: :meth:`Paraformer.forward` ``(speech, speech_lengths, text,
text_lengths)`` -> ``(loss, stats)`` (model.py:151-220 of the JAX package):
eos appended to the targets (``predictor_bias == 1``), the predictor's alphas
rescaled to the target length, the glancing-LM sampler (``sampling_ratio``,
:meth:`Paraformer._glm_sampler`) in training mode, label-smoothing loss, the
MAE token-count loss and, with ``ctc_weight > 0``, CTC on the raw targets.
In ``train()`` mode every module takes its dropout and plain PyTorch
attention; in ``eval()`` mode (validation) the attention kernel runs, under
``torch.no_grad()``.  Training covers the SANM encoder and SANM decoder of
this class; a subclass, another encoder or another decoder raises
``NotImplementedError`` (ROADMAP.md, Queue 1).

The encoder and decoder are picked by registry name as the JAX
``Paraformer.setup`` picks them (model.py:75-127 of the JAX package):
``encoder_name`` None or ``SANMEncoder`` (its reference template keys
mapped), else the named class with the conf filtered to its arguments (the
aishell Paraformer-Conformer's ``ConformerEncoder`` drops ``kernel_size``
and ``pos_enc_layer_type``); ``decoder_name`` None is
``ParaformerSANMDecoder``, else the named class (``ParaformerSANDecoder``),
its conf filtered the same way.  ``ctc_weight > 0`` builds the CTC head
``ctc.ctc_lo`` (a plain dense layer, FunASR's names): inference never runs
it, but a checkpoint carries it.

int8 serving, the JAX package's ``AutoModel(quantize=True)`` path: build
with ``quantize=True`` (the parameters are then stored in float32 whatever
the compute ``dtype``), load the float32 weights, then call
:meth:`Paraformer.quantize_weights` once.  ``qmm`` and ``int8_attn`` turn on
the two opt-in int8 routes (``models/sanm.py``): the fused int8 matmul for
the QDense layers of ``encoders0`` and the decoder, and int8 q.k scores in
encoder layers 1-49.  The int8 weights and scales are
non-persistent buffers: the state dict keeps FunASR's keys, and loading a
state dict again requires another ``quantize_weights()`` before inference.
"""

from __future__ import annotations

import inspect
import math
from typing import Any, Dict, Optional

import torch
from torch import nn

from funasr_torch import losses
from funasr_torch.device import resolve_device
from funasr_torch.models.paraformer.decoder import ParaformerSANMDecoder
from funasr_torch.models.paraformer.predictor import CifPredictorV2
from funasr_torch.models.sanm import (Dense, LayerNormF32, PlainDense, SANMEncoder,
                                      quantize_dense_layers)
from funasr_torch.ops.masks import sequence_mask
from funasr_torch.registry import tables


# training-only fields of funasr_tpu's Paraformer with its defaults (and the
# reference template's E-Paraformer first-pass decoder loss)
_TRAINING_FIELDS = {"lsm_weight": 0.1, "length_normalized_loss": True,
                    "predictor_weight": 1.0, "predictor_bias": 1, "sampling_ratio": 0.75,
                    "ignore_id": -1, "use_1st_decoder_loss": False}


def add_eos(text: torch.Tensor, text_lengths: torch.Tensor, eos: int,
            ignore_id: int = -1):
    """Append ``eos`` at position ``len`` of each row (reference
    ``add_sos_eos`` ys_out with predictor_bias=1, paraformer/model.py:297-299):
    one column wider, ``ignore_id`` at the pads."""
    B, U = text.shape
    valid = sequence_mask(text_lengths, U, torch.bool)
    body = torch.where(valid, text, ignore_id)
    padded = torch.cat([body, torch.full_like(body[:, :1], ignore_id)], dim=1)
    pos = torch.arange(U + 1, device=text.device)[None, :]
    padded = torch.where(pos == text_lengths[:, None], eos, padded)
    return padded, text_lengths + 1


def glancing_swap(noise: torch.Tensor, nonpad: torch.Tensor,
                  target_num: torch.Tensor) -> torch.Tensor:
    """The glancing sampler's choice (model.py:249-253 of the JAX package):
    the ``target_num[b]`` non-pad positions of row b with the smallest
    ``noise`` (pads sort last) -> (B, U) bool, True where the ground-truth
    embedding replaces the CIF embedding."""
    noise = torch.where(nonpad, noise, torch.inf)
    order = torch.argsort(noise, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    return (ranks < target_num[:, None]) & nonpad


def accepted_args(cls, conf: Dict[str, Any]) -> Dict[str, Any]:
    """``conf`` filtered to the keyword arguments of ``cls``'s constructor,
    as the JAX package filters a config to a module's dataclass fields."""
    names = inspect.signature(cls.__init__).parameters
    return {k: v for k, v in conf.items() if k in names}


@tables.register("model_classes", "Paraformer")
class Paraformer(nn.Module):
    """Config fields mirror the reference template.yaml.  Builds on
    ``device`` (default: the GPU, raising without one; ``"cpu"`` only when
    asked).  ``dtype`` is the compute dtype (bfloat16 in serving);
    ``quantize`` selects int8 serving (see the module docstring);
    ``param_dtype`` stores the Dense and FSMN weights (default ``dtype``;
    float32 with ``quantize``, and for training);
    ``encoder_name`` / ``decoder_name`` pick the encoder and decoder."""

    def __init__(self, vocab_size: int, input_size: int = 560,
                 encoder_conf: Optional[Dict[str, Any]] = None,
                 decoder_conf: Optional[Dict[str, Any]] = None,
                 predictor_conf: Optional[Dict[str, Any]] = None,
                 blank_id: int = 0, sos: int = 1, eos: int = 2,
                 dtype: torch.dtype = torch.float32, device=None,
                 quantize: bool = False, qmm: bool = False, int8_attn: bool = False,
                 encoder_name: Optional[str] = None, decoder_name: Optional[str] = None,
                 ctc_weight: float = 0.0, param_dtype: Optional[torch.dtype] = None,
                 **training_conf):
        """``training_conf`` takes the template's training-only settings
        (``lsm_weight``, ``sampling_ratio``, ``predictor_bias``...; the JAX
        package's defaults), which only :meth:`forward` reads."""
        unknown = set(training_conf) - set(_TRAINING_FIELDS)
        if unknown:
            raise TypeError(f"Paraformer: unexpected arguments {sorted(unknown)}")
        if (qmm or int8_attn) and not quantize:
            raise ValueError("Paraformer: qmm and int8_attn are int8 routes; they "
                             "need quantize=True")
        super().__init__()
        self.vocab_size = vocab_size
        self.blank_id = blank_id
        self.sos = sos
        self.eos = eos
        self.dtype = dtype
        self.quantize = quantize
        self.ctc_weight = ctc_weight
        self.decoder_name = decoder_name
        self.encoder_name = encoder_name
        for key, default in _TRAINING_FIELDS.items():
            setattr(self, key, training_conf.get(key, default))
        self._int8_ready = False
        param_dtype = torch.float32 if quantize else param_dtype
        dev = resolve_device(device)

        enc_conf = dict(encoder_conf or {})
        sanm = encoder_name in (None, "SANMEncoder")
        if sanm:
            for key in ("pos_enc_class", "selfattention_layer_type",
                        "positional_dropout_rate"):
                enc_conf.pop(key, None)
            enc_conf["sanm_shift"] = enc_conf.pop("sanm_shfit", enc_conf.get("sanm_shift", 0))
        elif int8_attn:
            raise ValueError("Paraformer: int8_attn is a SANMEncoder route")
        dec_conf = dict(decoder_conf or {})
        dec_conf.pop("positional_dropout_rate", None)
        if "sanm_shfit" in dec_conf:  # reference template spelling
            dec_conf["sanm_shift"] = dec_conf.pop("sanm_shfit")
        pred_conf = dict(predictor_conf or {})

        with torch.device(dev):
            if sanm:
                self.encoder = SANMEncoder(input_size=input_size, dtype=dtype,
                                           param_dtype=param_dtype, int8_attn=int8_attn,
                                           **enc_conf)
            else:
                cls = tables.get("encoder_classes", encoder_name)
                self.encoder = cls(input_size=input_size, dtype=dtype,
                                   param_dtype=param_dtype, **accepted_args(cls, enc_conf))
            d_model = self.encoder.output_size()
            self.decoder = self.make_decoder(vocab_size, d_model, dtype, param_dtype,
                                             dec_conf)
            pred_conf.setdefault("idim", d_model)
            self.predictor = self.make_predictor(dtype, pred_conf)
            if ctc_weight > 0.0:
                self.ctc = nn.Module()
                self.ctc.ctc_lo = PlainDense(d_model, vocab_size, dtype=dtype,
                                             param_dtype=param_dtype)
        if qmm:  # the QDense layers off the fused kernels (sanm.py Dense)
            for part in (self.encoder.encoders0 if sanm else self.encoder, self.decoder):
                for mod in part.modules():
                    if isinstance(mod, Dense):
                        mod.qmm = True
        self.eval()
        self.register_load_state_dict_post_hook(Paraformer._weights_changed)

    def make_decoder(self, vocab_size: int, d_model: int, dtype: torch.dtype,
                     param_dtype: Optional[torch.dtype], dec_conf: Dict[str, Any]) -> nn.Module:
        cls = (ParaformerSANMDecoder if self.decoder_name is None
               else tables.get("decoder_classes", self.decoder_name))
        return cls(vocab_size=vocab_size, encoder_output_size=d_model, dtype=dtype,
                   param_dtype=param_dtype, **accepted_args(cls, dec_conf))

    def make_predictor(self, dtype: torch.dtype, pred_conf: Dict[str, Any]) -> nn.Module:
        return CifPredictorV2(dtype=dtype, **pred_conf)

    @staticmethod
    def _weights_changed(module, incompatible_keys) -> None:
        module._int8_ready = False

    @torch.no_grad()
    def quantize_weights(self) -> "Paraformer":
        """Build the int8 weights and scales from the current float32
        parameters, once per model load (a ``quantize=True`` model only)."""
        if not self.quantize:
            raise RuntimeError("quantize_weights() needs Paraformer(quantize=True)")
        quantize_dense_layers(self)
        self._int8_ready = True
        return self

    def encode(self, speech: torch.Tensor, speech_lengths: torch.Tensor):
        if self.quantize and not self._int8_ready:
            raise RuntimeError("Paraformer(quantize=True): call quantize_weights() "
                               "after loading the weights")
        return self.encoder(speech, speech_lengths)

    def forward(self, speech: torch.Tensor, speech_lengths: torch.Tensor,
                text: torch.Tensor, text_lengths: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """Training forward -> ``(loss, stats)`` (reference model.py:168):
        speech (B, T, input_size) features, text (B, U) ids padded with
        ``ignore_id``.  ``stats`` holds 0-d device tensors: ``loss_att``,
        ``loss_pre``, ``acc``, ``loss_ctc`` (with ``ctc_weight > 0``),
        ``loss`` and ``batch_size``.  ``generator`` draws the sampler's noise
        (training mode, ``sampling_ratio > 0``); dropout draws from the
        device's default generator."""
        if type(self) is not Paraformer or self.encoder_name not in (None, "SANMEncoder") \
                or self.decoder_name not in (None, "ParaformerSANMDecoder"):
            raise NotImplementedError(
                f"{type(self).__name__} (encoder {self.encoder_name or 'SANMEncoder'}, "
                f"decoder {self.decoder_name or 'ParaformerSANMDecoder'}): training is "
                "ported for Paraformer with the SANM encoder and decoder only "
                "(ROADMAP.md, Queue 1: training of the other model classes)")
        if self._int8_ready and self.training:
            raise RuntimeError("Paraformer: the int8 weights of quantize_weights() are for "
                               "serving; train the float32 model and quantize it afterwards")
        B = speech.shape[0]
        enc, enc_lens = self.encode(speech, speech_lengths)
        if self.predictor_bias == 1:
            ys_pad, ys_lens = add_eos(text, text_lengths, self.eos, self.ignore_id)
        else:
            ys_pad, ys_lens = text, text_lengths
        U = ys_pad.shape[1]
        pred = self.predictor(enc, enc_lens, U, target_length=ys_lens.to(torch.float32))
        semantic, glat_logits = pred.acoustic_embeds, None
        if self.sampling_ratio > 0.0 and self.training:
            semantic, glat_logits = self._glm_sampler(
                enc, enc_lens, ys_pad, ys_lens, pred.acoustic_embeds, generator)
        logits = self.decoder(enc, enc_lens, semantic, ys_lens)

        loss_att = losses.label_smoothing_loss(logits, ys_pad, self.ignore_id,
                                               self.lsm_weight,
                                               self.length_normalized_loss)
        loss_pre = losses.mae_length_loss(ys_lens, pred.token_num,
                                          self.length_normalized_loss)
        acc = losses.th_accuracy(logits if glat_logits is None else glat_logits,
                                 ys_pad, self.ignore_id)
        stats = {"loss_att": loss_att, "loss_pre": loss_pre, "acc": acc}
        if self.ctc_weight > 0.0:
            # CTC trains on the raw targets, not the eos-augmented ys_pad
            # (reference model.py:199)
            loss_ctc = losses.ctc_loss(self.ctc.ctc_lo(enc), enc_lens, text,
                                       text_lengths, self.ignore_id, self.blank_id)
            loss = (self.ctc_weight * loss_ctc + (1.0 - self.ctc_weight) * loss_att
                    + self.predictor_weight * loss_pre)
            stats["loss_ctc"] = loss_ctc
        else:
            loss = loss_att + self.predictor_weight * loss_pre
        stats["loss"] = loss
        stats["batch_size"] = torch.full((), B, device=loss.device)
        return loss, stats

    def _glm_sampler(self, enc, enc_lens, ys_pad, ys_lens, acoustic_embeds,
                     generator: Optional[torch.Generator] = None):
        """Glancing-LM sampler (reference model.py:339 ``sampler``): decode
        the CIF embeddings without grad (dropout live, as the reference's
        ``torch.no_grad()`` in ``train()`` mode), count the wrong tokens, and
        give a random ``sampling_ratio * wrong`` of the positions their
        ground-truth embedding (:func:`glancing_swap` on uniform noise from
        ``generator``) -> (semantic embeddings, first-pass logits)."""
        U = ys_pad.shape[1]
        tgt_mask = sequence_mask(ys_lens, U)[:, :, None]
        nonpad = ys_pad != self.ignore_id
        ys_embed = self.decoder.embed_tokens(torch.where(nonpad, ys_pad, 0))
        with torch.no_grad():
            logits = self.decoder(enc, enc_lens, acoustic_embeds, ys_lens)
        pred = torch.argmax(logits, dim=-1)
        same = ((pred == ys_pad) & nonpad).sum(dim=-1)
        wrong = nonpad.sum(dim=-1) - same
        target_num = (wrong.to(torch.float32) * self.sampling_ratio).to(torch.int32)
        noise = torch.rand(ys_pad.shape, generator=generator, device=ys_pad.device)
        swap = glancing_swap(noise, nonpad, target_num)
        semantic = torch.where(swap[:, :, None], ys_embed.to(acoustic_embeds.dtype),
                               acoustic_embeds)
        return semantic * tgt_mask.to(semantic.dtype), logits

    def _infer_raw_logits(self, speech, speech_lengths, max_tokens: int = 128):
        enc, enc_lens = self.encode(speech, speech_lengths)
        pred = self.predictor(enc, enc_lens, max_tokens)
        token_lengths = torch.clamp(torch.round(pred.token_num).to(torch.int32),
                                    0, max_tokens)
        logits = self.decoder(enc, enc_lens, pred.acoustic_embeds, token_lengths)
        return logits, token_lengths, pred

    @torch.inference_mode()
    def inference_logits(self, speech: torch.Tensor,
                         speech_lengths: torch.Tensor, max_tokens: int = 128):
        """-> (log_probs (B, U, V) float32, token_lengths (B,), predictor
        outputs).  Greedy decode = argmax over log_probs within
        token_lengths."""
        logits, token_lengths, pred = self._infer_raw_logits(
            speech, speech_lengths, max_tokens)
        return (torch.log_softmax(logits.to(torch.float32), dim=-1),
                token_lengths, pred)

    @torch.inference_mode()
    def greedy_decode(self, speech: torch.Tensor, speech_lengths: torch.Tensor,
                      max_tokens: int = 128):
        """argmax decode (reference model.py:539-546) -> (tokens (B, U),
        token_lengths, scores); tokens past token_lengths are blank."""
        logits, token_lengths, _ = self._infer_raw_logits(
            speech, speech_lengths, max_tokens)
        tokens = torch.argmax(logits, dim=-1)
        lf = logits.to(torch.float32)
        tok_logp = lf.max(dim=-1).values - torch.logsumexp(lf, dim=-1)
        valid = sequence_mask(token_lengths, tokens.shape[1], torch.bool)
        tokens = torch.where(valid, tokens, torch.full_like(tokens, self.blank_id))
        scores = (tok_logp * valid.to(torch.float32)).sum(dim=-1)
        return tokens, token_lengths, scores


def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights, in place: LeCun-normal Linear/Conv weights
    (flax's default; a stride-equals-kernel ConvTranspose1d over its input
    channels), zero biases, unit/zero layer norms, N(0, 1)
    embeddings; BatchNorm (1-D and 2-D) with unit/zero affine, where it has
    one, and running statistics away
    from (0, 1): mean N(0, 0.1^2), var in [0.5, 1.5); any other parameter
    LeCun-normal over its last axis.  Draws on ``generator``'s device in
    float32."""
    def normal_(p: torch.Tensor, std: float):
        p.copy_(torch.randn(p.shape, generator=generator,
                            device=generator.device) * std)

    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                w = mod.weight
                normal_(w, 1.0 / math.sqrt(w[0].numel()))  # fan_in = Din * K
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.ConvTranspose1d):  # (in, out, K): fan_in = in
                normal_(mod.weight, 1.0 / math.sqrt(mod.weight.shape[0]))
                mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                normal_(mod.weight, 1.0)
            elif isinstance(mod, LayerNormF32):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
                if mod.affine:
                    mod.weight.fill_(1.0)
                    mod.bias.zero_()
                normal_(mod.running_mean, 0.1)
                mod.running_var.copy_(0.5 + torch.rand(
                    mod.num_features, generator=generator, device=generator.device))
            else:
                for p in mod.parameters(recurse=False):
                    normal_(p, 1.0 / math.sqrt(p.shape[-1]))
    return module

