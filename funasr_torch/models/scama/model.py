"""SCAMA: the streaming chunk-aware multihead-attention model, inference path
(port of funasr_tpu/models/scama/model.py; reference funasr/models/scama/
model.py:40, arXiv:2006.01712).

An autoregressive model on the Paraformer's parts: a SANM encoder under a
chunkwise attention mask (:func:`~funasr_torch.ops.masks.chunk_attn_mask`,
``chunk_size`` frames a chunk, ``left_chunks`` chunks of look-back, every
one when -1), the CIF predictor, whose fire track synchronises decoding with
the chunks, and the chunk-aware ``FsmnDecoderSCAMAOpt``
(``models/scama/decoder.py``).  :meth:`SCAMA.decode_beam` runs the
predictor, builds the per-token cross mask over ``maxlen + 1`` rows and
decodes with the joint CTC/attention beam (``ops/beam_search.py``) over the
FSMN-cached step scorer; the CTC prefix step kernel joins only when
``decoding_ctc_weight > 0`` and the model has a CTC head (``ctc_weight >
0``).

Under the chunk mask every encoder layer runs the module path (the JAX
package gates its fused int8 SANM layer on ``attn_mask is None``,
sanm.py:510-516, and its attention kernel on no mask): with
``quantize=True`` the QDense projections take int8 through the row quantize
and int8 GEMM kernels where the gate passes, each FFN the fused int8 FFN
kernel, and the masked attention is the XLA code in plain PyTorch.  The
state dict keeps FunASR's keys, the Paraformer's layout
(funasr_tpu/convert.py:669 ``scama_from_torch``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from funasr_torch.models.paraformer.model import Paraformer
from funasr_torch.models.scama.decoder import CachedScamaDecoder, scama_cross_mask
from funasr_torch.ops.beam_search import BeamResult, beam_search, mask_ctc_frames
from funasr_torch.ops.masks import chunk_attn_mask
from funasr_torch.registry import tables


@tables.register("model_classes", "SCAMA")
class SCAMA(Paraformer):
    """Chunk-aware autoregressive streaming model (model.py:51 of the JAX
    package): the Paraformer's arguments, with ``FsmnDecoderSCAMAOpt`` as
    the default decoder and the chunk settings ``chunk_size`` (encoder
    frames a chunk), ``left_chunks`` and ``decoder_att_look_back_factor``."""

    def __init__(self, vocab_size: int, *args, chunk_size: int = 10, left_chunks: int = -1,
                 decoder_att_look_back_factor: int = 1,
                 decoder_name: Optional[str] = "FsmnDecoderSCAMAOpt",
                 encoder_name: Optional[str] = None, qmm: bool = False,
                 int8_attn: bool = False, **kwargs):
        if encoder_name not in (None, "SANMEncoder"):
            raise NotImplementedError(f"SCAMA: encoder {encoder_name!r} (its chunk mask "
                                      "needs the SANMEncoder)")
        if qmm or int8_attn:
            raise NotImplementedError("SCAMA: the qmm / int8_attn routes are not ported "
                                      "(its encoder runs the module path under the chunk "
                                      "mask)")
        super().__init__(vocab_size, *args, decoder_name=decoder_name,
                         encoder_name=encoder_name, **kwargs)
        self.chunk_size = chunk_size
        self.left_chunks = left_chunks
        self.decoder_att_look_back_factor = decoder_att_look_back_factor
        for layer in list(self.encoder.encoders0) + list(self.encoder.encoders):
            layer.fused_int8 = False  # every call passes the chunk mask

    def encode(self, speech: torch.Tensor, speech_lengths: torch.Tensor):
        """The encoder under the chunk mask (model.py:59 of the JAX package)."""
        if self.quantize and not self._int8_ready:
            raise RuntimeError("SCAMA(quantize=True): call quantize_weights() after "
                               "loading the weights")
        B, T = speech.shape[:2]
        am = chunk_attn_mask(T, self.chunk_size, self.left_chunks, speech.device)
        return self.encoder(speech, speech_lengths, attn_mask=am[None].expand(B, T, T))

    def cross_mask(self, enc: torch.Tensor, enc_lens: torch.Tensor, maxlen: int) -> torch.Tensor:
        """The predictor's fire track -> the (B, maxlen + 1, T) SCAMA cross
        mask, every row gated in (model.py:128-134 of the JAX package)."""
        B = enc.shape[0]
        pred = self.predictor(enc, enc_lens, maxlen + 1)
        rows = torch.full((B,), maxlen + 1, dtype=torch.int32, device=enc.device)
        return scama_cross_mask(pred.peaks, enc_lens, rows, maxlen + 1, self.chunk_size,
                                self.decoder_att_look_back_factor, n_frames=enc.shape[1])

    @torch.inference_mode()
    def decode_beam(self, speech: torch.Tensor, speech_lengths: torch.Tensor,
                    beam: int = 5, maxlen: int = 96, decoding_ctc_weight: float = 0.0,
                    int8_kv: bool = False, **ignored: Any) -> BeamResult:
        """Chunk-aware beam decode -> BeamResult (tokens (B, K, L), lengths,
        scores, steps) (model.py:119 of the JAX package).  Takes
        ``HybridEngine``'s keywords; ``int8_kv=True`` raises: SCAMA's step
        cache is the FSMN window, and the JAX package has no int8 form of
        it."""
        if int8_kv:
            raise ValueError("SCAMA: int8_kv has nothing to store in int8 (the step cache "
                             "is the FSMN window; the JAX package has no int8 form of it)")
        enc, enc_lens = self.encode(speech, speech_lengths)
        B = enc.shape[0]
        dec = self.decoder
        scorer = CachedScamaDecoder(dec, enc, enc_lens, n_head=dec.attention_heads,
                                    kernel_size=dec.kernel_size, dtype=self.dtype,
                                    cross_mask=self.cross_mask(enc, enc_lens, maxlen),
                                    beam=beam)
        ctc_logp = None
        if decoding_ctc_weight > 0.0 and self.ctc_weight > 0.0:
            ctc_logp = torch.log_softmax(self.ctc.ctc_lo(enc).to(torch.float32), dim=-1)
            ctc_logp = mask_ctc_frames(ctc_logp, enc_lens, self.blank_id)
        return beam_search(None, B, beam, self.vocab_size, self.sos, self.eos, maxlen,
                           ctc_logp=ctc_logp, ctc_weight=decoding_ctc_weight,
                           blank_id=self.blank_id, step_score_fn=scorer.step,
                           dec_state=scorer.init_state(),
                           state_reorder_fn=CachedScamaDecoder.reorder_state,
                           device=enc.device)

    def decode_beam_align(self, *args: Any, **kwargs: Any):
        """SCAMA has no CTC forced alignment: ``HybridEngine`` asks for one for
        timestamps (``with_timestamp=True``, the pipeline's default), and the
        JAX package fails there with ``AttributeError``.  Serve it with
        ``with_timestamp=False``."""
        raise NotImplementedError(
            "SCAMA has no timestamps: it has no decode_beam_align (the JAX HybridEngine "
            "fails here with AttributeError); call generate(..., with_timestamp=False)")

    @torch.inference_mode()
    def greedy_decode(self, speech: torch.Tensor, speech_lengths: torch.Tensor,
                      max_tokens: int = 128):
        """Greedy = beam 1 -> (tokens (B, L), lengths (B,))."""
        res = self.decode_beam(speech, speech_lengths, beam=1, maxlen=max_tokens)
        return res.tokens[:, 0], res.lengths[:, 0]
