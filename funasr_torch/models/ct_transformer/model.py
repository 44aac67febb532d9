"""CT-Transformer punctuation (port of funasr_tpu/models/ct_transformer/model.py;
reference funasr/models/ct_transformer/model.py:34).

Network (:47): token embedding -> the port's ``SANMEncoder`` -> a
punctuation projection (classes like ``["<unk>", "_", "，", "。", "？",
"、"]``), FunASR's parameter names (``embed``, ``encoder.*``, ``decoder``).
Inference slides a window of ``split_size`` words, carrying the tail after
the last sentence end (。/？) into the next window and breaking at the last
comma once the carried text exceeds 200 tokens (model.py:247-320).

``CTTransformerModel.inference_batch`` scores window ``wi`` of every text in
one device call per round: the windows padded to a (B, W) grid, B a power
of two, W a multiple of 8.  The model never takes the int8 route (the JAX
package pins the float path, :133-144); its compute dtype is bf16 in
serving.  Its attention, head size ``att_unit / attention_heads`` (32 for
the published 256 / 8), runs through ``ops/attention.py``
``fused_attention``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from funasr_torch.device import resolve_device, upload
from funasr_torch.models.sanm import Dense, SANMEncoder
from funasr_torch.registry import tables

#  one CJK char | a run of non-CJK non-space chars (single-char class from
#  U+3001: U+3000 is whitespace)
_SPLIT_RE = re.compile("[一-鿿、-〿]|[^一-鿿　-〿\\s]+")

_DTYPES = {"float32": torch.float32, "fp32": torch.float32,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def split_words(text: str) -> List[str]:
    """CJK chars as single tokens, ascii words kept whole
    (reference funasr/models/ct_transformer/utils.py split_words)."""
    return _SPLIT_RE.findall(text)


def split_to_mini_sentence(words: List, word_limit: int = 20) -> List[List]:
    return [words[i: i + word_limit] for i in range(0, len(words), word_limit)]


class CTTransformer(nn.Module):
    """embed -> SANM encoder -> punctuation projection, computing in
    ``dtype`` (layer norms and softmax in float32)."""

    def __init__(self, vocab_size: int, punc_size: int = 6, embed_unit: int = 256,
                 att_unit: int = 256, encoder_conf: Optional[Dict] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        conf = dict(encoder_conf or {})
        conf.setdefault("output_size", att_unit)
        conf.setdefault("attention_heads", 8)
        conf.setdefault("linear_units", 1024)
        conf.setdefault("num_blocks", 4)
        conf.setdefault("kernel_size", 11)
        conf.pop("unroll_layers", None)  # a JAX compile option
        input_layer = conf.pop("input_layer", "pe")
        sanm_shift = conf.pop("sanm_shfit", conf.pop("sanm_shift", 0))
        self.dtype = dtype
        self.embed = nn.Embedding(vocab_size, embed_unit)
        self.encoder = SANMEncoder(input_size=embed_unit, input_layer=input_layer,
                                   sanm_shift=sanm_shift, dtype=dtype, **conf)
        self.decoder = Dense(att_unit, punc_size, dtype=dtype)

    def forward(self, text: torch.Tensor, text_lengths: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """text (B, W) token ids, text_lengths (B,) -> logits (B, W, punc_size)
        in ``dtype``.  ``attn_mask`` (B, W, W) restricts the attention further
        (the streaming model's ``vad_mask``), on the encoder's module path;
        without it the attention runs through the kernel."""
        h, _ = self.encoder(self.embed(text), text_lengths, attn_mask)
        return self.decoder(h)


@tables.register("model_classes", "CTTransformer")
class CTTransformerModel:
    """The punctuation model with the mini-sentence window loop: a
    :class:`CTTransformer` (``module``) on ``device`` (``None`` means the
    card) and the host loop."""

    def __init__(self, vocab_size: int,
                 punc_list: List[str] = ("<unk>", "_", "，", "。", "？", "、"),
                 embed_unit: int = 256, att_unit: int = 256, encoder: str = "SANMEncoder",
                 encoder_conf: Optional[Dict] = None, sentence_end_id: int = 3,
                 dtype: str = "float32", device=None, **kwargs):
        if encoder != "SANMEncoder":
            raise NotImplementedError(f"CTTransformer encoder {encoder!r} (SANMEncoder only)")
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.module = CTTransformer(vocab_size, len(punc_list), embed_unit, att_unit,
                                        encoder_conf, _DTYPES[str(dtype)]).eval()
        self.punc_list = list(punc_list)
        self.sentence_end_id = sentence_end_id
        self._end_ids = np.asarray(
            [i for i, p in enumerate(self.punc_list) if p in ("。", "？")])
        self._comma_ids = np.asarray(
            [i for i, p in enumerate(self.punc_list) if p == "，"])

    @torch.inference_mode()
    def _argmax(self, text: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """One device call: (B, W) ids and (B,) lengths -> (B, W) labels."""
        t, n = upload(text, self.device), upload(lens, self.device)
        return torch.argmax(self.module(t, n), dim=-1).cpu().numpy()

    def _punc_ids(self, token_ids: np.ndarray) -> np.ndarray:
        pad = 8 * ((len(token_ids) + 7) // 8)
        text = np.zeros((1, max(pad, 8)), np.int64)
        text[0, : len(token_ids)] = token_ids
        return self._argmax(text, np.asarray([len(token_ids)], np.int32))[0, : len(token_ids)]

    def _punc_ids_batch(self, id_lists: List[np.ndarray]) -> List[np.ndarray]:
        """Score N windows in one device call, padded to a (B, W) grid (B the
        next power of two, W a multiple of 8)."""
        n = len(id_lists)
        if n == 1:
            return [self._punc_ids(id_lists[0])]
        B = 1 << (n - 1).bit_length()
        W = max(8, 8 * ((max(len(x) for x in id_lists) + 7) // 8))
        text = np.zeros((B, W), np.int64)
        lens = np.zeros((B,), np.int32)
        for i, ids in enumerate(id_lists):
            text[i, : len(ids)] = ids
            lens[i] = len(ids)
        am = self._argmax(text, lens)
        return [am[i, : len(ids)] for i, ids in enumerate(id_lists)]

    def inference(self, text: str, tokenizer, split_size: int = 20,
                  cache_pop_trigger_limit: int = 200) -> Dict[str, Any]:
        """Returns {"text": punctuated text, "punc_array": per-token ids}."""
        return self.inference_batch([text], tokenizer, split_size,
                                    cache_pop_trigger_limit)[0]

    def inference_batch(self, texts: List[str], tokenizer,
                        split_size: int = 20,
                        cache_pop_trigger_limit: int = 200
                        ) -> List[Dict[str, Any]]:
        """Punctuate N texts with the SAME per-text semantics as the
        sequential reference loop, but window wi of every text scored in
        one batched device call per round — the long-audio pipeline's
        per-VAD-segment punc runs in ~max_windows device calls instead of
        sum(windows) (the r3 host bottleneck, BENCH_PIPELINE punc_host)."""
        states = []
        for text in texts:
            tokens = split_words(text)
            st = {"mini": split_to_mini_sentence(tokens, split_size)
                  if tokens else [],
                  "mini_ids": split_to_mini_sentence(
                      tokenizer.tokens2ids(tokens), split_size)
                  if tokens else [],
                  "cache_sent": [], "cache_ids": [],
                  "out_text": "", "punc_array": [], "wi": 0}
            states.append(st)

        while True:
            active = [st for st in states if st["wi"] < len(st["mini"])]
            if not active:
                break
            ids_list = [np.asarray(st["cache_ids"]
                                   + st["mini_ids"][st["wi"]], np.int32)
                        for st in active]
            puncs_list = self._punc_ids_batch(ids_list)
            end_ids = self._end_ids
            comma_ids = self._comma_ids
            for st, ids, puncs in zip(active, ids_list, puncs_list):
                wi = st["wi"]
                sent = st["cache_sent"] + st["mini"][wi]
                if wi < len(st["mini"]) - 1:
                    # carry the tail after the last sentence end as cache.
                    # (numpy max-index form of the reference's backward
                    # scan over positions [2, len-2]: the scan stopped at
                    # the FIRST 。/？ from the right, i.e. the max index,
                    # and last_comma — only consulted when no sentence end
                    # exists — is then simply the max comma index.)
                    sentence_end = -1
                    last_comma = -1
                    win = np.asarray(puncs[2:-1])
                    if win.size:
                        # tiny id sets: chained == beats np.isin's set
                        # machinery by ~15 us/window (r5 bench regression)
                        hit = np.zeros(win.shape, bool)
                        for e in end_ids:
                            hit |= win == e
                        idx = np.flatnonzero(hit)
                        if idx.size:
                            sentence_end = int(idx[-1]) + 2
                        else:
                            hit[:] = False
                            for e in comma_ids:
                                hit |= win == e
                            idx = np.flatnonzero(hit)
                            if idx.size:
                                last_comma = int(idx[-1]) + 2
                    if (sentence_end < 0
                            and len(sent) > cache_pop_trigger_limit
                            and last_comma >= 0):
                        sentence_end = last_comma
                        puncs[sentence_end] = self.sentence_end_id
                    st["cache_sent"] = sent[sentence_end + 1:]
                    st["cache_ids"] = list(ids[sentence_end + 1:])
                    sent = sent[: sentence_end + 1]
                    puncs = puncs[: sentence_end + 1]
                puncs_l = puncs.tolist() if hasattr(puncs, "tolist") \
                    else list(puncs)
                st["out_text"] += self._assemble(sent, puncs_l)
                st["punc_array"].extend(puncs_l)
                st["wi"] = wi + 1

        results = []
        for st in states:
            out_text, punc_array = st["out_text"], st["punc_array"]
            # final sentence-end normalization (model.py:357-389)
            if out_text:
                last = out_text[-1]
                if last in ("，", "、"):
                    out_text = out_text[:-1] + "。"
                    punc_array[-1] = self.sentence_end_id
                elif last == ",":
                    out_text = out_text[:-1] + "."
                    punc_array[-1] = self.sentence_end_id
                elif last not in ("。", "？", ".", "?"):
                    is_ascii = len(last.encode()) == 1
                    out_text += "." if is_ascii else "。"
                    if punc_array:
                        punc_array[-1] = self.sentence_end_id
            results.append({"text": out_text,
                            "punc_array": np.asarray(punc_array,
                                                     np.int64)})
        return results

    def _assemble(self, words: List[str], puncs) -> str:
        """Join words + predicted puncs with CJK/ascii spacing rules
        (model.py:326-353).  ``puncs`` should be a plain list (per-element
        numpy indexing costs ~100 ns x 2 per word — r5 host profile)."""
        if hasattr(puncs, "tolist"):
            puncs = puncs.tolist()
        parts: List[str] = []
        for i, w in enumerate(words):
            ascii_w = w[0] < "\x80"  # == len(w[0].encode()) == 1
            # reference model.py:330 capitalizes the window's FIRST ascii
            # word too, not only words after sentence-final punctuation
            if ascii_w and (i == 0
                            or self.punc_list[puncs[i - 1]] in ("。", "？")):
                w = w.capitalize()
            if ascii_w and (i == 0 or words[i - 1][0] < "\x80"):
                w = " " + w
            parts.append(w)
            p = self.punc_list[puncs[i]]
            if p != "_" and puncs[i] > 1:
                if ascii_w:
                    p = {"，": ",", "。": ".", "？": "?"}.get(p, p)
                parts.append(p)
        return "".join(parts)

