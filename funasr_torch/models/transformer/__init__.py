"""Transformer decoder and the CTC/attention hybrid models (Conformer)."""

from funasr_torch.models.transformer.model import Conformer  # noqa: F401
