"""Paraformer (offline NAR ASR)."""

from funasr_torch.models.paraformer.model import Paraformer  # noqa: F401
