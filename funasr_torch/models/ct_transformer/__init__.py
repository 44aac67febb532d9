"""CT-Transformer punctuation, offline and streaming."""

from funasr_torch.models.ct_transformer.model import (  # noqa: F401
    CTTransformer,
    CTTransformerModel,
)
from funasr_torch.models.ct_transformer.streaming import CTTransformerStreamingModel  # noqa: F401
