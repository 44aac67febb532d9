"""FSMN-VAD: the FSMN scorer and the endpoint state machine."""

from funasr_torch.models.fsmn_vad.encoder import FSMN  # noqa: F401
from funasr_torch.models.fsmn_vad.model import FsmnVADStreaming, VadStateMachine  # noqa: F401
