"""The CTC/attention hybrid models (Transformer, Conformer, SANM) with their
Transformer encoder and Transformer / RWKV decoders."""

from funasr_torch.models.transformer.model import SANM, Conformer, Transformer  # noqa: F401
