"""Tokenizers (registers ``CharTokenizer``, ``SentencepiecesTokenizer`` and
``SenseVoiceTokenizer``; ``sentencepiece`` and ``tiktoken`` are imported
only when one of the latter two is built)."""

import funasr_torch.tokenizer.sensevoice_tokenizer  # noqa: F401
import funasr_torch.tokenizer.sentencepiece_tokenizer  # noqa: F401
from funasr_torch.tokenizer.char_tokenizer import CharTokenizer  # noqa: F401
