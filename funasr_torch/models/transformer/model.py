"""CTC/attention hybrid ASR, inference path (port of
funasr_tpu/models/transformer/model.py:43-270; reference
funasr/models/transformer/model.py, funasr/models/conformer/model.py).

encoder -> ``ctc.ctc_lo`` log-probs and an autoregressive decoder, combined
by the joint CTC/attention beam search (``ops/beam_search.py``).  The
encoder is picked by registry name as the JAX ``make_encoder`` picks it:
the config's ``encoder`` (``encoder_name``), else the family's default
(``Transformer``: TransformerEncoder, ``Conformer``: ConformerEncoder,
``SANM``: SANMEncoder, which keeps its ``"pe"`` input layer; Branchformer
and E-Branchformer, ``models/branchformer.py``, always take their own).  The decoder is ``decoder`` from ``decoder_classes``:
``TransformerDecoder`` or ``TransformerRWKVDecoder``
(``models/transformer/decoder.py``).  As in the JAX package the beam
scores steps through the KV-cached scorer only when the decoder is exactly
a ``TransformerDecoder``; any other decoder re-runs the full prefix each
step.  ``decode_beam_align`` adds a CTC forced alignment of each returned
hypothesis to the encoder frames (``ops/ctc_align.py``: the emissions
gathered on the device, the Viterbi on the host), the frame spans of its
timestamps.  No training forward.

Not ported, raising ``NotImplementedError`` that names it: the ``CTC``
model class (ROADMAP.md Queue 1).

int8 serving, the JAX package's ``AutoModel(quantize=True)`` path: build
with ``quantize=True`` (parameters then stored in float32 whatever the
compute ``dtype``), load the weights, then call :meth:`quantize_weights`
once.  The projections the JAX package computes with QDense are
QDense-rule :class:`~funasr_torch.models.sanm.Dense` layers: int8 where the
``ops/quant.py`` gate passes (at the aishell widths the Conformer's and
E-Branchformer's FFN ``w_1``, and the full-prefix decoder's output layer),
the compute dtype elsewhere; the position-wise FFNs of the Transformer
encoder and the RWKV decoder run fused in int8, and the SANM hybrid's
encoder layers 1.. run the fused int8 SANM layer (``ops/sanm_layer.py``,
head size 64 at the aishell widths; the JAX package takes its XLA int8
path there: its Pallas layer gates on head sizes of 128); the JAX package's plain
``nn.Dense`` layers (``ctc.ctc_lo``, the cgMLP, the RWKV time mix) never
take int8.  The int8 self-attention KV cache is the separate ``int8_kv``
argument of :meth:`decode_beam`.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
from torch import nn

from funasr_torch.device import fetch_async, fetched, resolve_device
from funasr_torch.models import conformer  # noqa: F401  (registers ConformerEncoder)
from funasr_torch.models.sanm import PlainDense, quantize_dense_layers
from funasr_torch.models.transformer import encoder  # noqa: F401  (TransformerEncoder)
from funasr_torch.models.transformer.decoder import TransformerDecoder
from funasr_torch.ops.beam_search import BeamResult, beam_search, mask_ctc_frames
from funasr_torch.ops.cached_decoder import CachedTransformerDecoder, resize_state
from funasr_torch.ops.ctc_align import align_emissions, viterbi
from funasr_torch.registry import not_ported, tables

# training-only fields of funasr_tpu's hybrid models
_TRAINING_FIELDS = {"lsm_weight", "length_normalized_loss", "ignore_id"}
# reference encoder_conf keys that the JAX package drops (model.py:70-74)
_ENCODER_IGNORED = ("selfattention_layer_type", "pos_enc_class",
                    "positional_dropout_rate", "pos_enc_layer_type",
                    "rel_pos_type", "macaron_style", "use_cnn_module",
                    "activation_type", "normalize_before")


class AlignedBeam(NamedTuple):
    """:meth:`_HybridModel.decode_beam_align`'s result, on the host."""

    tokens: torch.Tensor   # (B, K, L) int64, best first
    lengths: torch.Tensor  # (B, K)
    scores: torch.Tensor   # (B, K) float32
    align: torch.Tensor    # (B, n, T) int64 frame labels of the first n hypotheses
    enc_lens: torch.Tensor  # (B,) encoder frames
    steps: int


class CTC(nn.Module):
    """The CTC head: ``ctc_lo``, a plain dense layer in the compute dtype."""

    def __init__(self, vocab_size: int, d: int, dtype: torch.dtype,
                 param_dtype: Optional[torch.dtype]):
        super().__init__()
        self.ctc_lo = PlainDense(d, vocab_size, dtype=dtype, param_dtype=param_dtype)


class _HybridModel(nn.Module):
    """Shared CTC/attention model body; subclasses pick the encoder.  Builds
    on ``device`` (default: the GPU, raising without one; ``"cpu"`` only
    when asked).  ``encoder_name`` overrides the family's encoder (the
    config's ``encoder`` key); ``decoder`` names the decoder class."""

    def __init__(self, vocab_size: int, input_size: int = 80,
                 encoder_conf: Optional[Dict[str, Any]] = None,
                 decoder_conf: Optional[Dict[str, Any]] = None,
                 ctc_weight: float = 0.3, blank_id: int = 0, sos: int = 1,
                 eos: int = 2, dtype: torch.dtype = torch.float32, device=None,
                 quantize: bool = False, encoder_name: Optional[str] = None,
                 decoder: str = "TransformerDecoder", **training_conf):
        unknown = set(training_conf) - _TRAINING_FIELDS
        if unknown:
            raise TypeError(f"{type(self).__name__}: unexpected arguments "
                            f"{sorted(unknown)}")
        super().__init__()
        self.vocab_size = vocab_size
        self.ctc_weight = ctc_weight
        self.blank_id = blank_id
        self.sos = sos
        self.eos = eos
        self.dtype = dtype
        self.quantize = quantize
        self._int8_ready = False
        self.encoder_name = encoder_name
        param_dtype = torch.float32 if quantize else None
        dev = resolve_device(device)
        dec_cls = tables.get("decoder_classes", decoder)
        with torch.device(dev):
            self.encoder = self.make_encoder(input_size, encoder_conf, dtype, param_dtype)
            d = self.encoder.output_size()
            self.decoder = dec_cls(vocab_size=vocab_size, encoder_output_size=d,
                                   dtype=dtype, param_dtype=param_dtype,
                                   **dict(decoder_conf or {}))
            self.ctc = CTC(vocab_size, d, dtype, param_dtype)
        self.eval()
        self.register_load_state_dict_post_hook(_HybridModel._weights_changed)

    def default_encoder(self) -> str:
        raise NotImplementedError

    def make_encoder(self, input_size: int, encoder_conf: Optional[Dict[str, Any]],
                     dtype: torch.dtype, param_dtype: Optional[torch.dtype]) -> nn.Module:
        """The encoder by registry name: ``encoder_name`` when set, else the
        family default, with the reference keys the JAX package drops
        removed and ``input_layer`` defaulting to conv2d."""
        name = self.encoder_name or self.default_encoder()
        conf = dict(encoder_conf or {})
        for key in _ENCODER_IGNORED:
            conf.pop(key, None)
        if name != "SANMEncoder":  # SANM takes "pe" / None, not conv2d
            conf.setdefault("input_layer", "conv2d")
        return tables.get("encoder_classes", name)(input_size=input_size, dtype=dtype,
                                                    param_dtype=param_dtype, **conf)

    @staticmethod
    def _weights_changed(module, incompatible_keys) -> None:
        module._int8_ready = False

    @torch.no_grad()
    def quantize_weights(self) -> "_HybridModel":
        """Build the int8 weights of the encoder and decoder projections from
        the current float32 parameters, once per model load (a
        ``quantize=True`` model only)."""
        if not self.quantize:
            raise RuntimeError("quantize_weights() needs quantize=True")
        quantize_dense_layers(self)
        self._int8_ready = True
        return self

    def encode(self, speech: torch.Tensor, speech_lengths: torch.Tensor):
        if self.quantize and not self._int8_ready:
            raise RuntimeError(f"{type(self).__name__}(quantize=True): call "
                               "quantize_weights() after loading the weights")
        return self.encoder(speech, speech_lengths)

    @torch.inference_mode()
    def decode_beam(self, speech: torch.Tensor, speech_lengths: torch.Tensor,
                    beam: int = 10, maxlen: int = 64,
                    decoding_ctc_weight: float = 0.3, use_cache: bool = True, cache_stages: int = 4,
                    int8_kv: bool = False) -> BeamResult:
        """Joint CTC/attention beam decode -> BeamResult (tokens (B, K, L),
        lengths, scores, steps).

        ``use_cache=True`` scores steps incrementally with the KV-cached
        scorer (``ops/cached_decoder.py``) when the decoder is exactly a
        ``TransformerDecoder``; ``use_cache=False``, or any other decoder
        (RWKV), re-runs the full prefix through the decoder each step.
        ``cache_stages`` splits a cached decode (maxlen >= 32) into that
        many stages with the cache
        grown at each boundary (exact numerics).  ``int8_kv`` stores the
        scorer's self- and cross-attention K/V as per-row int8."""
        return self._beam(speech, speech_lengths, beam, maxlen, decoding_ctc_weight, use_cache,
                          cache_stages, int8_kv)[0]

    def _beam(self, speech, speech_lengths, beam, maxlen, decoding_ctc_weight, use_cache,
              cache_stages, int8_kv):
        """:meth:`decode_beam` -> (BeamResult, the float32 CTC log-probs
        (B, T, V), padded frames masked, or None without CTC scoring,
        encoder lengths)."""
        enc, enc_lens = self.encode(speech, speech_lengths)
        B = enc.shape[0]
        decode_fn = step_score_fn = dec_state = reorder = None
        if use_cache and type(self.decoder) is TransformerDecoder:
            scorer = CachedTransformerDecoder(
                self.decoder, enc, enc_lens,
                n_head=self.decoder.attention_heads, maxlen=maxlen,
                dtype=self.dtype, beam=beam, int8_kv=int8_kv)
            step_score_fn = scorer.step
            dec_state = scorer.init_state()
            reorder = CachedTransformerDecoder.reorder_state
        else:
            enc_rep = enc.repeat_interleave(beam, dim=0)
            lens_rep = enc_lens.repeat_interleave(beam, dim=0)

            def decode_fn(ys, step):
                lens = torch.full((ys.shape[0],), ys.shape[1], device=ys.device)
                logits = self.decoder(enc_rep, lens_rep, ys, lens)
                return torch.log_softmax(logits.to(torch.float32), dim=-1)[:, step]

        ctc_logp = None
        if decoding_ctc_weight > 0.0 and self.ctc_weight > 0.0:
            ctc_logp = torch.log_softmax(self.ctc.ctc_lo(enc).to(torch.float32), dim=-1)
            ctc_logp = mask_ctc_frames(ctc_logp, enc_lens, self.blank_id)

        stage_bounds = state_grow_fn = None
        if step_score_fn is not None and cache_stages > 1 and maxlen >= 32:
            stage_bounds = [maxlen * (i + 1) // cache_stages for i in range(cache_stages)]
            state_grow_fn = resize_state
        res = beam_search(
            decode_fn, B, beam, self.vocab_size, self.sos, self.eos, maxlen,
            ctc_logp=ctc_logp, ctc_weight=decoding_ctc_weight, blank_id=self.blank_id,
            step_score_fn=step_score_fn, dec_state=dec_state,
            state_reorder_fn=reorder, cache_stages=stage_bounds,
            state_grow_fn=state_grow_fn, device=enc.device)
        if ctc_logp is None:
            ctc_logp = torch.log_softmax(self.ctc.ctc_lo(enc).to(torch.float32), dim=-1)
        return res, ctc_logp, enc_lens

    @torch.inference_mode()
    def decode_beam_align(self, speech: torch.Tensor, speech_lengths: torch.Tensor,
                          beam: int = 10, maxlen: int = 64, decoding_ctc_weight: float = 0.3,
                          use_cache: bool = True, cache_stages: int = 4, int8_kv: bool = False,
                          nbest: Optional[int] = None) -> AlignedBeam:
        """:meth:`decode_beam` plus the CTC forced alignment of each of the
        first ``nbest`` hypotheses (default all K) against the encoder frames
        (``models/transformer/model.py:197`` of the JAX package, which
        aligns all K): each hypothesis masked to its length with blank, its
        emissions gathered from the beam's own CTC log-probs on the device
        (the JAX package encodes a second time, to the same values), one
        read back of everything, the Viterbi on the host.  Rows are
        independent, so the first ``nbest`` equal JAX's first ``nbest``."""
        res, logp, enc_lens = self._beam(speech, speech_lengths, beam, maxlen,
                                         decoding_ctc_weight, use_cache, cache_stages, int8_kv)
        B, K, L = res.tokens.shape
        n = K if nbest is None else max(1, min(int(nbest), K))
        # a hypothesis gains at most one token a step: columns past the step
        # count are blank in every row, and the Viterbi never reaches them
        U = min(L, res.steps)
        lengths = res.lengths[:, :n]
        toks = res.tokens[:, :n, :U]
        toks = torch.where(torch.arange(U, device=toks.device) < lengths[..., None], toks,
                           self.blank_id)
        em = align_emissions(logp, toks, enc_lens, lengths, self.blank_id)  # (B, n, T, S)
        tokens, lens, scores, em, toks, enc_lens = fetched(*fetch_async(
            [res.tokens, res.lengths, res.scores, em, toks, enc_lens]))
        T, S = em.shape[2:]
        align = viterbi(em.reshape(B * n, T, S).numpy(), toks.reshape(B * n, U).numpy(),
                        enc_lens.repeat_interleave(n).numpy(), lens[:, :n].reshape(-1).numpy(),
                        self.blank_id)
        return AlignedBeam(tokens, lens, scores, torch.from_numpy(align.reshape(B, n, T)),
                           enc_lens, res.steps)


@tables.register("model_classes", "Transformer")
class Transformer(_HybridModel):
    """CTC/attention model over the TransformerEncoder (reference
    funasr/models/transformer/model.py)."""

    def default_encoder(self) -> str:
        return "TransformerEncoder"


@tables.register("model_classes", "Conformer")
class Conformer(_HybridModel):
    """CTC/attention model over the ConformerEncoder (reference
    funasr/models/conformer/model.py); with ``decoder=
    "TransformerRWKVDecoder"`` the reference's conformer_rwkv."""

    def default_encoder(self) -> str:
        return "ConformerEncoder"


@tables.register("model_classes", "SANM")
class SANM(_HybridModel):
    """The Transformer contract with the SANM encoder (reference
    funasr/models/sanm/model.py:14 ``SANM(Transformer)``)."""

    def default_encoder(self) -> str:
        return "SANMEncoder"


tables.register("model_classes", "CTC")(not_ported("model class", "CTC", "encoder + CTC head"))

