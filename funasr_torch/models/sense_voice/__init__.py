"""SenseVoiceSmall (SANM encoder with a CTC head and rich-tag prompts)."""

from funasr_torch.models.sense_voice.model import SenseVoiceSmall  # noqa: F401
