"""Model families of the port (importing registers them)."""

from funasr_torch.models import paraformer  # noqa: F401
