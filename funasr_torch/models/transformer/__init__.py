"""The CTC/attention hybrid models (Transformer, Conformer) with their
Transformer encoder and Transformer / RWKV decoders."""

from funasr_torch.models.transformer.model import Conformer, Transformer  # noqa: F401
