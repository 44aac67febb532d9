"""emotion2vec speech emotion recognition (registers ``Emotion2vec``)."""

from funasr_torch.models.emotion2vec.model import Emotion2vec  # noqa: F401
