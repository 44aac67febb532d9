import funasr_torch.models.paraformer_streaming.model  # noqa: F401

from funasr_torch.models.paraformer_streaming.model import ParaformerStreaming  # noqa: F401
