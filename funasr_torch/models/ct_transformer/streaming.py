"""Streaming (VAD-aware realtime) CT-Transformer punctuation (port of
funasr_tpu/models/ct_transformer/streaming.py; reference
funasr/models/ct_transformer_streaming/model.py:28).

The offline network, called incrementally: each call takes newly recognized
words plus a cache of words not yet committed, and the attention is limited
by a controllable time-delay mask (:func:`vad_mask`): the cached prefix may
not attend to the words that arrived after the VAD point, so the
punctuation it commits stays stable from call to call, while the new words
see the whole window.  Everything up to the window's last sentence end
(。/？) is committed; the tail stays in the cache for the next call.

The masked forward runs the SANM encoder's module path (the JAX package's
XLA path: its attention kernel takes no per-query mask); ``inference``, the
offline call, keeps the attention kernel.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from funasr_torch.device import upload
from funasr_torch.models.ct_transformer.model import CTTransformerModel, split_words
from funasr_torch.registry import tables


def vad_mask(size: int, vad_pos: int, dtype=np.float32) -> np.ndarray:
    """(size, size) attention mask (reference ct_transformer_streaming/
    utils.py ``vad_mask``): ones but for the block above the VAD point,
    where rows ``< vad_pos - 1`` may not see columns ``>= vad_pos``."""
    m = np.ones((size, size), dtype)
    if 0 < vad_pos < size:
        m[: vad_pos - 1, vad_pos:] = 0.0
    return m


@tables.register("model_classes", "CTTransformerStreaming")
class CTTransformerStreamingModel(CTTransformerModel):
    """Realtime punctuation with caches across calls:
    ``punctuate_streaming(text, cache, is_final)`` consumes newly decoded
    words, returns the words committed this call with their punctuation and
    updates ``cache`` in place; ``is_final=True`` flushes the tail.  Words
    become ids through the tokenizer of :meth:`set_tokenizer`."""

    @torch.inference_mode()
    def _punc_ids_masked(self, token_ids: np.ndarray, vad_pos: int) -> np.ndarray:
        """One device call: the window padded to a multiple of 8, the
        ``vad_mask`` over its words (ones elsewhere) -> the argmax labels."""
        n = len(token_ids)
        pad = max(8, 8 * ((n + 7) // 8))
        text = np.zeros((1, pad), np.int64)
        text[0, :n] = token_ids
        am = np.ones((1, pad, pad), np.float32)
        am[0, :n, :n] = vad_mask(n, vad_pos)
        logits = self.module(upload(text, self.device),
                             upload(np.asarray([n], np.int32), self.device),
                             upload(am, self.device))
        return torch.argmax(logits[0, :n], dim=-1).cpu().numpy()

    def punctuate_streaming(self, text: str, cache: Optional[Dict] = None,
                            is_final: bool = False) -> Dict[str, Any]:
        """The reference's window loop (model.py:78-140): the new words in
        windows of 20, each run as [carried tail + window]; everything up to
        the window's last 。/？ commits; past 200 words with no sentence end
        the window breaks at its last comma (made 。); ``is_final`` commits
        the last window whole.  -> ``{"text", "punc_array", "cache"}``."""
        cache = cache if cache is not None else {}
        prev_words: List[str] = cache.get("words", [])
        prev_ids: List[int] = list(cache.get("ids", []))

        new_words = split_words(text)
        new_ids = self.tokens2ids(new_words)
        split_size = 20
        cache_pop_trigger_limit = 200
        windows = [(new_words[i: i + split_size], new_ids[i: i + split_size])
                   for i in range(0, len(new_words), split_size)]
        if not windows:
            if not (is_final and prev_words):
                return {"text": "", "punc_array": np.zeros((0,), np.int64), "cache": cache}
            windows = [([], [])]  # the final flush of the carried tail

        out_words: List[str] = []
        out_puncs: List[int] = []
        sentence_ends = ("。", "？", ".", "?")
        for wi, (mw, mi) in enumerate(windows):
            words = prev_words + mw
            ids = prev_ids + list(mi)
            if not words:
                continue
            puncs = np.array(self._punc_ids_masked(np.asarray(ids, np.int32),
                                                   vad_pos=len(prev_words)))
            if is_final and wi == len(windows) - 1:
                commit = len(words)
            else:
                sentence_end, last_comma = -1, -1
                for i in range(len(puncs) - 2, 1, -1):
                    p = self.punc_list[puncs[i]]
                    if p in sentence_ends:
                        sentence_end = i
                        break
                    if last_comma < 0 and p in ("，", ","):
                        last_comma = i
                if (sentence_end < 0 and len(words) > cache_pop_trigger_limit
                        and last_comma >= 0):
                    # too long with no sentence end: break at the comma
                    sentence_end = last_comma
                    puncs[sentence_end] = self.sentence_end_id
                commit = sentence_end + 1
            out_words += words[:commit]
            out_puncs += puncs[:commit].tolist()
            prev_words = words[commit:]
            prev_ids = ids[commit:]

        cache["words"] = prev_words
        cache["ids"] = prev_ids
        out_puncs = np.asarray(out_puncs, np.int64)
        out_text = self._assemble(out_words, out_puncs) if out_words else ""
        if is_final and out_text and out_text[-1] not in sentence_ends:
            ascii_last = len(out_text[-1].encode()) == 1
            if out_text[-1] in ("，", "、"):
                out_text = out_text[:-1] + "。"
            elif out_text[-1] == ",":
                out_text = out_text[:-1] + "."
            else:
                out_text += "." if ascii_last else "。"
            if len(out_puncs):
                out_puncs[-1] = self.sentence_end_id
        return {"text": out_text, "punc_array": np.asarray(out_puncs, np.int64),
                "cache": cache}

    def tokens2ids(self, words: List[str]) -> List[int]:
        tok = getattr(self, "_tokenizer", None)
        if tok is None:
            raise RuntimeError("attach a tokenizer via set_tokenizer() first")
        return tok.tokens2ids(words)

    def set_tokenizer(self, tokenizer) -> "CTTransformerStreamingModel":
        self._tokenizer = tokenizer
        return self
