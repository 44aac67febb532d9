"""Model families of the port (importing registers them)."""

from funasr_torch.models import conformer, paraformer, transformer  # noqa: F401
