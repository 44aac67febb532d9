"""CAM++ speaker embeddings and the diarization backend."""

from funasr_torch.models.campplus.model import CAMPPlus  # noqa: F401
