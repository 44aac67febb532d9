"""Whisper and WhisperLID (openai-whisper's graph and parameter names)."""

from funasr_torch.models.whisper.model import WhisperLID, WhisperWrap  # noqa: F401
