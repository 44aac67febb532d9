"""Tokenizers (registers ``CharTokenizer``)."""

from funasr_torch.tokenizer.char_tokenizer import CharTokenizer  # noqa: F401
