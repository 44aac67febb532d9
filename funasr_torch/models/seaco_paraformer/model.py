"""SeACo-Paraformer: hotword customization on BiCif Paraformer (port of
funasr_tpu/models/seaco_paraformer/model.py; reference
funasr/models/seaco_paraformer/model.py:44 ``SeacoParaformer``).

Hotwords are token lists in a padded (H, Lh) grid whose last row is the
"no-bias" entry (``no_bias_id``).  The decoder's token embedding and a
2-layer LSTM (``bias_encoder``, float32) give one vector per hotword, the
LSTM's output at ``len - 1``.  A small SANM decoder (``seaco_decoder``, no
output layer) cross-attends from the CIF embeddings and, again, from the
main decoder's hiddens into that (B, H, D) memory; the two outputs, summed,
feed ``hotword_output_layer`` (a plain dense layer: never int8).  Where the
bias head's argmax is the no-bias class the main decoder's log-probs stand;
elsewhere they mix with the bias head's by ``seaco_weight``
(model.py:312 ``_merge_res``), in float32.

With ``quantize=True`` the SeACo decoder's full layers run through the int8
decoder-layer kernel like the main decoder's, its memory (the hotword
vectors) row-quantized once per pass; the timestamps come from the BiCif
upsampled fire track in the same pass.  Inference only: the training loss
(``seaco_loss``) and the ASF pre-selection of hotwords are not ported.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from funasr_torch.device import cudnn_float32
from funasr_torch.models.bicif_paraformer.model import BiCifParaformer
from funasr_torch.models.paraformer.decoder import ParaformerSANMDecoder
from funasr_torch.models.sanm import Dense, PlainDense
from funasr_torch.ops.masks import sequence_mask
from funasr_torch.registry import tables

# the JAX class's defaults for its bias decoder (model.py:62-67)
SEACO_DECODER_DEFAULTS = dict(attention_heads=4, linear_units=1024, num_blocks=3,
                              att_layer_num=3, kernel_size=11)


@tables.register("model_classes", "SeacoParaformer")
class SeacoParaformer(BiCifParaformer):
    """BiCifParaformer plus the SeACo bias branch; built, loaded and
    quantized as :class:`Paraformer`.  ``seaco_lsm_weight`` and ``nfilter``
    are training and ASF settings the inference path ignores."""

    def __init__(self, *args, inner_dim: int = 512,
                 seaco_decoder_conf: Optional[Dict[str, Any]] = None,
                 seaco_weight: float = 1.0, no_bias_id: int = 8377,
                 seaco_lsm_weight: float = 0.0, nfilter: int = 50, **kwargs):
        super().__init__(*args, **kwargs)
        self.inner_dim = inner_dim
        self.seaco_weight = seaco_weight
        self.no_bias_id = no_bias_id
        conf = dict(SEACO_DECODER_DEFAULTS, **(seaco_decoder_conf or {}))
        param_dtype = torch.float32 if self.quantize else None
        with torch.device(next(self.parameters()).device):
            self.bias_encoder = nn.LSTM(inner_dim, inner_dim, 2, batch_first=True)
            self.seaco_decoder = ParaformerSANMDecoder(
                vocab_size=self.vocab_size, encoder_output_size=inner_dim,
                dtype=self.dtype, param_dtype=param_dtype, use_output_layer=False,
                **conf)
            self.hotword_output_layer = PlainDense(inner_dim, self.vocab_size,
                                                   dtype=self.dtype, param_dtype=param_dtype)
        if kwargs.get("qmm"):
            for mod in self.seaco_decoder.modules():
                if isinstance(mod, Dense):
                    mod.qmm = True
        self.eval()

    # ------------------------------------------------------------- hotwords
    def hotword_representation(self, hotword_pad: torch.Tensor,
                               hotword_lengths: torch.Tensor) -> torch.Tensor:
        """(H, Lh) id grid and (H,) lengths -> (H, D) float32: the decoder's
        token embedding (in the compute dtype), the LSTM over every
        position (float32, TF32 off), its output at ``len - 1``
        (model.py:330, no packing)."""
        emb = self.decoder.embed[0](hotword_pad.to(torch.int64)).to(self.dtype)
        with cudnn_float32():
            out, _ = self.bias_encoder(emb.to(torch.float32))
        idx = torch.clamp(hotword_lengths.to(torch.int64) - 1, min=0)
        return torch.gather(out, 1, idx[:, None, None].expand(-1, 1, out.shape[-1]))[:, 0]

    def dha_logits(self, contextual: torch.Tensor, semantic: torch.Tensor,
                   dec_hidden: torch.Tensor, token_lengths: torch.Tensor) -> torch.Tensor:
        """Dual hotword attention (model.py:300-310): the SeACo decoder over
        the hotword memory from the CIF embeddings and from the decoder
        hiddens, summed, projected -> (B, U, vocab) in the compute dtype."""
        B = semantic.shape[0]
        H = contextual.shape[0]
        ctx = contextual[None].expand(B, H, contextual.shape[-1])
        ctx_lens = torch.full((B,), H, dtype=torch.int32, device=ctx.device)
        cif_att = self.seaco_decoder(ctx, ctx_lens, semantic, token_lengths)
        dec_att = self.seaco_decoder(ctx, ctx_lens, dec_hidden, token_lengths)
        return self.hotword_output_layer(cif_att + dec_att)

    def merge_logprobs(self, dec_logits: torch.Tensor,
                       dha_logits: torch.Tensor) -> torch.Tensor:
        """float32 ``where(argmax(dha) == no_bias, dec, (1 - w) dec + w dha)``
        over log-softmaxes (model.py:312 ``_merge_res``)."""
        dec_logp = torch.log_softmax(dec_logits.to(torch.float32), dim=-1)
        dha_logp = torch.log_softmax(dha_logits.to(torch.float32), dim=-1)
        use_dec = (torch.argmax(dha_logp, dim=-1) == self.no_bias_id)[..., None]
        lam = self.seaco_weight
        return torch.where(use_dec, dec_logp, (1 - lam) * dec_logp + lam * dha_logp)

    # ------------------------------------------------------------ inference
    @torch.inference_mode()
    def hotword_logprobs(self, speech: torch.Tensor, speech_lengths: torch.Tensor,
                         hotword_pad: torch.Tensor, hotword_lengths: torch.Tensor,
                         max_tokens: int = 128):
        """Merged (decoder and bias head) log-probs over the token grid
        (model.py:234 ``_seaco_decode_with_ASF``) -> (merged (B, U, V)
        float32, token_lengths (B,), predictor outputs)."""
        enc, enc_lens = self.encode(speech, speech_lengths)
        pred = self.predictor(enc, enc_lens, max_tokens)
        base = pred.base
        tok_lens = torch.clamp(torch.round(base.token_num).to(torch.int32), 0, max_tokens)
        dec_hidden = self.decoder(enc, enc_lens, base.acoustic_embeds, tok_lens,
                                  return_hidden=True)
        dec_logits = self.decoder.project(dec_hidden)
        contextual = self.hotword_representation(hotword_pad, hotword_lengths)
        dha = self.dha_logits(contextual, base.acoustic_embeds, dec_hidden, tok_lens)
        return self.merge_logprobs(dec_logits, dha), tok_lens, pred

    @torch.inference_mode()
    def decode_with_hotwords(self, speech: torch.Tensor, speech_lengths: torch.Tensor,
                             hotword_pad: torch.Tensor, hotword_lengths: torch.Tensor,
                             max_tokens: int = 128):
        """Greedy decode with the hotword merge -> (tokens (B, U), blank past
        token_lengths; token_lengths; us_alphas; us_peaks): the BiCif fire
        tracks give 20 ms timestamps from the same pass."""
        merged, tok_lens, pred = self.hotword_logprobs(
            speech, speech_lengths, hotword_pad, hotword_lengths, max_tokens)
        tokens = torch.argmax(merged, dim=-1)
        valid = sequence_mask(tok_lens, tokens.shape[1], torch.bool)
        tokens = torch.where(valid, tokens, torch.full_like(tokens, self.blank_id))
        return tokens, tok_lens, pred.us_alphas, pred.us_peaks
