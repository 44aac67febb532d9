"""E-Paraformer, inference path (port of
funasr_tpu/models/e_paraformer/model.py; reference
funasr/models/e_paraformer/model.py:31): the Paraformer body with the PIF
predictor (``predictor.py``).  Its training settings (``predictor_bias``
2, ``use_1st_decoder_loss``) are accepted and unused at inference; the CTC
head ``ctc.ctc_lo`` is built (``ctc_weight`` 0.5 by default) so that a
checkpoint loads, and never runs.  Served through ``ParaformerEngine``,
which filters sos/eos by id; with ``with_timestamp`` its stamps come from
the predictor's empty fire track, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from funasr_torch.models.e_paraformer.predictor import PifPredictor
from funasr_torch.models.paraformer.model import Paraformer
from funasr_torch.registry import tables


@tables.register("model_classes", "EParaformer")
class EParaformer(Paraformer):
    """Built, loaded and quantized as :class:`Paraformer`, with the JAX
    class's defaults (``ctc_weight`` 0.5, ``predictor_bias`` 2)."""

    def __init__(self, *args, ctc_weight: float = 0.5, predictor_bias: int = 2, **kwargs):
        super().__init__(*args, ctc_weight=ctc_weight, predictor_bias=predictor_bias,
                         **kwargs)

    def make_predictor(self, dtype: torch.dtype, pred_conf: Dict[str, Any]) -> nn.Module:
        conf = dict(pred_conf)
        conf.pop("tail_threshold", None)
        return PifPredictor(dtype=dtype, **conf)
