"""SenseVoice tokenizer builder (copy of
funasr_tpu/tokenizer/sensevoice_tokenizer.py; reference
funasr/tokenizer/whisper_tokenizer.py:25 ``SenseVoiceTokenizer``).

The reference builds a whisper-style tiktoken BPE from ``vocab_path`` (the
multilingual rich-tag vocabulary); the shipped SenseVoiceSmall hub model
instead uses a SentencePiece bpe model.  This builder accepts either: a
``.model``/``.bpe.model`` path goes to SentencepiecesTokenizer, anything
else is loaded as a tiktoken ranks file with whisper-style special tokens
appended (<|startoftranscript|>, language tags, task/emotion/event tags,
<|endoftext|>).
"""

from __future__ import annotations

import base64
from typing import Iterable, List, Optional

from funasr_torch.registry import tables

# rich-tag specials of SenseVoice (reference sense_voice/model.py:856-879
# prompt tokens + rich_transcription_postprocess tag set)
SPECIAL_TOKENS = (
    ["<|endoftext|>", "<|startoftranscript|>"]
    + [f"<|{lang}|>" for lang in
       ("zh", "en", "yue", "ja", "ko", "nospeech", "auto")]
    + ["<|ASR|>", "<|AED|>", "<|SER|>", "<|transcribe|>", "<|translate|>",
       "<|HAPPY|>", "<|SAD|>", "<|ANGRY|>", "<|NEUTRAL|>", "<|FEARFUL|>",
       "<|DISGUSTED|>", "<|SURPRISED|>", "<|EMO_UNKNOWN|>",
       "<|Speech|>", "<|BGM|>", "<|Applause|>", "<|Laughter|>", "<|Cry|>",
       "<|Sneeze|>", "<|Breath|>", "<|Cough|>", "<|Event_UNK|>",
       "<|withitn|>", "<|woitn|>", "<|nospeech|>"]
)


class TiktokenTokenizer:
    """Whisper-style BPE over a tiktoken ranks file."""

    def __init__(self, vocab_path: str, **kwargs):
        import tiktoken

        ranks = {}
        with open(vocab_path, "rb") as f:
            for line in f:
                if not line.strip():
                    continue
                tok, rank = line.split()
                ranks[base64.b64decode(tok)] = int(rank)
        n = len(ranks)
        specials = {t: n + i for i, t in enumerate(SPECIAL_TOKENS)}
        self._enc = tiktoken.Encoding(
            name="sensevoice",
            explicit_n_vocab=n + len(specials),
            pat_str=(r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"""
                     r"""| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""),
            mergeable_ranks=ranks,
            special_tokens=specials,
        )

    def get_vocab_size(self) -> int:
        return self._enc.n_vocab

    def encode(self, text: str, allowed_special="all") -> List[int]:
        return self._enc.encode(text, allowed_special=allowed_special)

    def decode(self, ids: Iterable[int]) -> str:
        return self._enc.decode(list(map(int, ids)))

    def ids2tokens(self, ids: Iterable[int]) -> List[str]:
        return [self._enc.decode([int(i)]) for i in ids]


@tables.register("tokenizer_classes", "SenseVoiceTokenizer")
def SenseVoiceTokenizer(vocab_path: str = None, bpemodel: str = None,
                        **kwargs):
    path = vocab_path or bpemodel
    if path is None:
        raise ValueError("SenseVoiceTokenizer needs vocab_path or bpemodel")
    if path.endswith(".model"):
        from funasr_torch.tokenizer.sentencepiece_tokenizer import (
            SentencepiecesTokenizer,
        )

        return SentencepiecesTokenizer(bpemodel=path, **kwargs)
    return TiktokenTokenizer(path, **kwargs)


# Chinese numerals, and English number words as a SentencePiece piece
# decodes (a leading space): text the ITN rewrites ("三十五" -> "35")
NUMBER_WORDS = tuple("零一二三四五六七八九十百千万亿点") + tuple(
    " " + w for w in ("zero", "one", "two", "three", "four", "five", "six", "seven",
                      "eight", "nine", "ten", "twenty", "thirty", "hundred", "thousand",
                      "percent"))


def generated_token_list(vocab_size: int = 25055) -> List[str]:
    """A stand-in SenseVoice vocabulary for seeded random weights (the
    released SentencePiece model is not in the repo): ``<unk>`` at the
    blank id 0, the rich tags, ``NUMBER_WORDS``, then CJK characters.  At
    the released size (25055) the language and text-norm tags sit at the
    ids ``LID_INT_DICT`` and ``TEXTNORM_INT_DICT`` name (reference
    sense_voice/model.py:643,645) and the other tags from 24993 up; a
    smaller list holds every tag right after id 0.  Entries are unique."""
    from funasr_torch.models.sense_voice.model import (
        LID_DICT, LID_INT_DICT, TEXTNORM_DICT, TEXTNORM_INT_DICT)
    from funasr_torch.utils.postprocess import EMOJI_DICT

    by_query = {v: k for k, v in {**LID_DICT, **TEXTNORM_DICT}.items()}
    pinned = {tok: f"<|{by_query[q]}|>"
              for tok, q in {**LID_INT_DICT, **TEXTNORM_INT_DICT}.items()}
    tags = list(pinned.values()) + [t for t in EMOJI_DICT
                                    if t.count("<|") == 1 and t not in pinned.values()]
    out: List[Optional[str]] = [None] * vocab_size
    out[0] = "<unk>"
    if vocab_size > max(pinned):
        for tok, tag in pinned.items():
            out[tok] = tag
        free = (i for i in range(24993, vocab_size) if out[i] is None)
        for tag in tags[len(pinned):]:
            out[next(free)] = tag
        head = list(NUMBER_WORDS)
    else:
        head = tags + list(NUMBER_WORDS)
    used = set(t for t in out if t is not None)
    fill = iter([t for t in head if t not in used] + [
        chr(c) for c in (*range(0x4E00, 0xA000), *range(0x3400, 0x4DC0))
        if chr(c) not in NUMBER_WORDS])
    return [t if t is not None else next(fill) for t in out]
