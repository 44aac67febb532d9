"""ContextualParaformer: hotword biasing v1 (port of
funasr_tpu/models/contextual_paraformer/model.py; reference
funasr/models/contextual_paraformer/model.py:41).

Hotwords are token lists in a padded (H, Lh) grid, with no no-bias row
(SeACo's scheme, ``models/seaco_paraformer``, has one).  Their embeddings
(``bias_embed``, or the decoder's token embedding with
``use_decoder_embedding``) run through the 1-layer ``bias_encoder`` LSTM in
float32 (TF32 off); its output at ``len - 1`` is the hotword memory, one
vector a word, which the decoder's bias branch attends into
(``ContextualParaformerSANMDecoder``), scaled by ``clas_scale``.

Built, loaded and quantized as :class:`Paraformer`.  Inference only: the
training loss (``contextual_loss``) is not ported.
"""

from __future__ import annotations

import torch
from torch import nn

from funasr_torch.device import cudnn_float32
from funasr_torch.models.contextual_paraformer.decoder import ContextualParaformerSANMDecoder
from funasr_torch.models.paraformer.model import Paraformer
from funasr_torch.ops.masks import sequence_mask
from funasr_torch.registry import tables


@tables.register("model_classes", "ContextualParaformer")
class ContextualParaformer(Paraformer):
    """Paraformer with the contextual decoder, ``bias_embed`` and the
    ``bias_encoder`` LSTM.  ``inner_dim`` must equal the decoder's width
    (the bias attention's keys are hotword vectors)."""

    def __init__(self, *args, inner_dim: int = 512, use_decoder_embedding: bool = False,
                 clas_scale: float = 1.0, **kwargs):
        super().__init__(*args, **kwargs)
        d = self.encoder.output_size()
        if inner_dim != d:
            raise ValueError(f"ContextualParaformer: inner_dim {inner_dim} != the decoder's "
                             f"width {d}")
        self.inner_dim = inner_dim
        self.use_decoder_embedding = use_decoder_embedding
        self.clas_scale = clas_scale
        with torch.device(next(self.parameters()).device):
            self.bias_encoder = nn.LSTM(inner_dim, inner_dim, 1, batch_first=True)
            self.bias_embed = (None if use_decoder_embedding
                               else nn.Embedding(self.vocab_size, inner_dim))
        self.eval()

    def make_decoder(self, vocab_size: int, d_model: int, dtype: torch.dtype,
                     param_dtype, dec_conf) -> nn.Module:
        return ContextualParaformerSANMDecoder(vocab_size=vocab_size, encoder_output_size=d_model,
                                               dtype=dtype, param_dtype=param_dtype, **dec_conf)

    def hotword_memory(self, hotword_pad: torch.Tensor,
                       hotword_lengths: torch.Tensor) -> torch.Tensor:
        """(H, Lh) id grid and (H,) lengths -> (H, D) float32: the embedding
        in the compute dtype, the LSTM over every position (float32, TF32
        off), its output at ``len - 1`` (model.py:59-69, no packing)."""
        embed = self.decoder.embed[0] if self.use_decoder_embedding else self.bias_embed
        emb = embed(hotword_pad.to(torch.int64)).to(self.dtype)
        with cudnn_float32():
            out, _ = self.bias_encoder(emb.to(torch.float32))
        idx = torch.clamp(hotword_lengths.to(torch.int64) - 1, min=0)
        return torch.gather(out, 1, idx[:, None, None].expand(-1, 1, out.shape[-1]))[:, 0]

    @torch.inference_mode()
    def hotword_logprobs(self, speech: torch.Tensor, speech_lengths: torch.Tensor,
                         hotword_pad: torch.Tensor, hotword_lengths: torch.Tensor,
                         max_tokens: int = 128):
        """-> (log_probs (B, U, V) float32 of the biased decoder,
        token_lengths (B,), predictor outputs)."""
        enc, enc_lens = self.encode(speech, speech_lengths)
        pred = self.predictor(enc, enc_lens, max_tokens)
        tok_lens = torch.clamp(torch.round(pred.token_num).to(torch.int32), 0, max_tokens)
        memory = self.hotword_memory(hotword_pad, hotword_lengths)
        ctx = memory[None].expand(enc.shape[0], *memory.shape)
        logits = self.decoder(enc, enc_lens, pred.acoustic_embeds, tok_lens, contextual=ctx,
                              clas_scale=self.clas_scale)
        return torch.log_softmax(logits.to(torch.float32), dim=-1), tok_lens, pred

    @torch.inference_mode()
    def decode_with_hotwords(self, speech: torch.Tensor, speech_lengths: torch.Tensor,
                             hotword_pad: torch.Tensor, hotword_lengths: torch.Tensor,
                             max_tokens: int = 128):
        """Greedy decode with the hotword bias (model.py:71) -> (tokens (B, U),
        blank past token_lengths; token_lengths)."""
        logp, tok_lens, _ = self.hotword_logprobs(speech, speech_lengths, hotword_pad,
                                                  hotword_lengths, max_tokens)
        tokens = torch.argmax(logp, dim=-1)
        valid = sequence_mask(tok_lens, tokens.shape[1], torch.bool)
        return torch.where(valid, tokens, torch.full_like(tokens, self.blank_id)), tok_lens
