"""The Transducer (RNN-T) family: ``Transducer`` here, ``RWKVBAT``/``BAT``
in ``models/rwkv.py``."""

from funasr_torch.models.transducer.model import Transducer  # noqa: F401
