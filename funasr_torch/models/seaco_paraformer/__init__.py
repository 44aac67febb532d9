"""SeacoParaformer (BiCif Paraformer with a hotword bias head)."""

from funasr_torch.models.seaco_paraformer.model import SeacoParaformer  # noqa: F401
