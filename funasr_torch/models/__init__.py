"""Model families of the port (importing registers them)."""

from funasr_torch.models import bicif_paraformer, conformer, paraformer, transformer  # noqa: F401
