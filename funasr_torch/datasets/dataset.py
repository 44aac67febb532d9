"""Audio dataset and collator (copy of funasr_tpu/datasets/dataset.py
``AudioDataset``; reference funasr/datasets/audio_datasets/datasets.py:10).

The host dataset only loads waveforms and tokenizes targets; fbank, LFR and
CMVN run on the device (``auto/engines.py`` ``FrontendConfig.featurize``, the
fbank kernel on the card), so the collator pads raw waveforms to the
sampler's quantized shape.  The other datasets of the JAX package
(SenseVoice, KWS, hotword, LLM) are not ported (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from funasr_torch.registry import tables
from funasr_torch.utils.audio import load_audio


@tables.register("dataset_classes", "AudioDataset")
class AudioDataset:
    def __init__(self, index_ds, tokenizer=None, fs: int = 16000,
                 data_type: str = "sound", **kwargs):
        self.index_ds = index_ds
        self.tokenizer = tokenizer
        self.fs = fs
        self.data_type = data_type

    def __len__(self):
        return len(self.index_ds)

    def source_lens(self) -> List[int]:
        return [rec["source_len"] for rec in self.index_ds.contents]

    def target_lens(self) -> List[int]:
        return [rec["target_len"] for rec in self.index_ds.contents]

    def __getitem__(self, i: int) -> Dict[str, Any]:
        rec = self.index_ds[i]
        wav = load_audio(rec["source"], fs=self.fs)
        item = {"key": rec["key"], "speech": wav, "speech_length": len(wav)}
        if self.tokenizer is not None and rec.get("target"):
            ids = self.tokenizer.encode(rec["target"])
            item["text"] = np.asarray(ids, np.int32)
            item["text_length"] = len(ids)
        return item

    def collate(self, items: List[Dict[str, Any]], pad_speech_len: Optional[int] = None,
                pad_text_len: Optional[int] = None, ignore_id: int = -1) -> Dict[str, Any]:
        """Pad a list of items to (quantized) batch shapes."""
        B = len(items)
        true_s = max(it["speech_length"] for it in items)
        s_len = pad_speech_len or true_s
        if s_len < true_s:
            raise ValueError(
                f"pad_speech_len={s_len} is below the longest item "
                f"({true_s} samples) — the sampler's length grid must cover "
                "the dataset max (silent truncation would corrupt training)")
        speech = np.zeros((B, s_len), np.float32)
        speech_lengths = np.zeros((B,), np.int32)
        for b, it in enumerate(items):
            n = min(it["speech_length"], s_len)
            speech[b, :n] = it["speech"][:n]
            speech_lengths[b] = n
        batch = {"speech": speech, "speech_lengths": speech_lengths,
                 "keys": [it["key"] for it in items]}
        if "text" in items[0]:
            true_t = max(it["text_length"] for it in items)
            t_len = pad_text_len or true_t
            if t_len < true_t:
                raise ValueError(
                    f"pad_text_len={t_len} is below the longest target "
                    f"({true_t} tokens) — widen the sampler's target grid")
            text = np.full((B, t_len), ignore_id, np.int32)
            text_lengths = np.zeros((B,), np.int32)
            for b, it in enumerate(items):
                n = min(it["text_length"], t_len)
                text[b, :n] = it["text"][:n]
                text_lengths[b] = n
            batch["text"] = text
            batch["text_lengths"] = text_lengths
        return batch
