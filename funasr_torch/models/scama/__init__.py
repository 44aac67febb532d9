"""SCAMA, the chunk-aware autoregressive streaming model (``model.py``) and
its chunk-masked FSMN decoder with the step scorer (``decoder.py``)."""

from funasr_torch.models.scama.model import SCAMA  # noqa: F401
