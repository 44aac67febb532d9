"""BiCifParaformer (Paraformer with 20 ms timestamps)."""

from funasr_torch.models.bicif_paraformer.model import BiCifParaformer  # noqa: F401
