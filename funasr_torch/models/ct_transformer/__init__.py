"""CT-Transformer punctuation."""

from funasr_torch.models.ct_transformer.model import (  # noqa: F401
    CTTransformer,
    CTTransformerModel,
)
