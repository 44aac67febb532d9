"""SentencePiece tokenizer (copy of
funasr_tpu/tokenizer/sentencepiece_tokenizer.py; reference
funasr/tokenizer/sentencepiece_tokenizer.py:13).  The ``sentencepiece``
package is optional in this environment; construction raises a clear error
when it is missing."""

from __future__ import annotations

from typing import Iterable, List

from funasr_torch.registry import tables


@tables.register("tokenizer_classes", "SentencepiecesTokenizer")
class SentencepiecesTokenizer:
    def __init__(self, bpemodel: str, **kwargs):
        try:
            import sentencepiece as spm
        except ImportError as e:  # pragma: no cover
            raise ImportError(
                "SentencepiecesTokenizer requires the 'sentencepiece' package"
            ) from e
        self.bpemodel = bpemodel
        self.sp = spm.SentencePieceProcessor()
        self.sp.load(bpemodel)

    def get_vocab_size(self) -> int:
        return self.sp.get_piece_size()

    def text2tokens(self, text: str) -> List[str]:
        return self.sp.encode_as_pieces(text)

    def tokens2text(self, tokens: Iterable[str]) -> str:
        return self.sp.decode_pieces(list(tokens))

    def tokens2ids(self, tokens: Iterable[str]) -> List[int]:
        return [self.sp.piece_to_id(t) for t in tokens]

    def ids2tokens(self, ids: Iterable[int]) -> List[str]:
        return [self.sp.id_to_piece(int(i)) for i in ids]

    def encode(self, text: str) -> List[int]:
        return self.sp.encode_as_ids(text)

    def decode(self, ids: Iterable[int]) -> str:
        return self.sp.decode_ids(list(map(int, ids)))
