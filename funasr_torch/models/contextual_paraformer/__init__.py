"""ContextualParaformer (Paraformer with the hotword bias in its decoder)."""

from funasr_torch.models.contextual_paraformer.model import ContextualParaformer  # noqa: F401
