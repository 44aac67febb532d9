"""Frontends of the port that keep state across calls."""

from funasr_torch.frontends.streaming import StreamingFrontend  # noqa: F401
