"""Character tokenizer (copy of funasr_tpu/tokenizer/char_tokenizer.py;
reference funasr/tokenizer/char_tokenizer.py:13).

Token list maps id -> token; ``seg_dict`` optionally re-segments English
words into subword pieces (funasr/tokenizer/funtoken.py seg_tokenize).
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Union

from funasr_torch.registry import tables


def _read_text_auto(path: str) -> str:
    """Read a vocab-style text file, transparently converting legacy GBK
    files to unicode (reference runtime encode_converter.cpp
    X_GBK2UTF8: the C++ runtime ships GBK-encoded lexicons/vocabs for
    some zh models; files that fail strict UTF-8 are retried as GBK/
    GB18030, which is a superset covering GBK and GB2312)."""
    with open(path, "rb") as f:
        raw = f.read()
    try:
        return raw.decode("utf-8")
    except UnicodeDecodeError:
        return raw.decode("gb18030")


def load_token_list(path: str) -> List[str]:
    toks = []
    for line in _read_text_auto(path).split("\n"):
        t = line.rstrip("\n").split()
        if t:
            toks.append(t[0])
    return toks


def load_seg_dict(path: str) -> Dict[str, str]:
    seg = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split(" ", 1)
            if len(parts) == 2:
                seg[parts[0]] = parts[1]
    return seg


@tables.register("tokenizer_classes", "CharTokenizer")
class CharTokenizer:
    def __init__(
        self,
        token_list: Union[str, List[str], None] = None,
        unk_symbol: str = "<unk>",
        space_symbol: str = "<space>",
        split_with_space: bool = False,
        seg_dict: Optional[str] = None,
        **kwargs,
    ):
        if isinstance(token_list, str):
            token_list = load_token_list(token_list)
        self.token_list = list(token_list or [])
        self.token2id = {t: i for i, t in enumerate(self.token_list)}
        self.unk_symbol = unk_symbol
        self.unk_id = self.token2id.get(unk_symbol, 0)
        self.space_symbol = space_symbol
        self.split_with_space = split_with_space
        self.seg_dict = load_seg_dict(seg_dict) if seg_dict else None

    def get_vocab_size(self) -> int:
        return len(self.token_list)

    # -- text -> tokens -----------------------------------------------------
    def text2tokens(self, text: str) -> List[str]:
        if self.split_with_space:
            tokens = []
            for word in text.strip().split():
                if self.seg_dict is not None:
                    word_l = word.lower()
                    if word_l in self.seg_dict:
                        tokens.extend(self.seg_dict[word_l].split())
                    elif all(ord(c) < 128 for c in word):
                        tokens.append(self.unk_symbol)
                    else:
                        tokens.extend(list(word))
                else:
                    tokens.append(word)
            return tokens
        # char mode: spaces are dropped, not tokenized (reference
        # char_tokenizer.py:67-71 skips " " instead of emitting <unk>)
        return [c for c in text if c != " "]

    def tokens2text(self, tokens: Iterable[str]) -> str:
        return "".join(t if t != self.space_symbol else " " for t in tokens)

    # -- tokens <-> ids -----------------------------------------------------
    def tokens2ids(self, tokens: Iterable[str]) -> List[int]:
        return [self.token2id.get(t, self.unk_id) for t in tokens]

    def ids2tokens(self, ids: Iterable[int]) -> List[str]:
        n = len(self.token_list)
        return [self.token_list[i] for i in ids if 0 <= i < n]

    def encode(self, text: str) -> List[int]:
        return self.tokens2ids(self.text2tokens(text))

    def decode(self, ids: Iterable[int]) -> str:
        return self.tokens2text(self.ids2tokens(ids))
