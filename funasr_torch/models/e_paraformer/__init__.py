"""E-Paraformer (offline NAR ASR with the PIF predictor)."""

from funasr_torch.models.e_paraformer.model import EParaformer  # noqa: F401
