"""Device resolution for the port's entry points.

The port runs on CUDA.  ``resolve_device(None)`` means the card and raises
when there is none; the CPU is used only when the caller asks for it
(``device="cpu"``, as the tests do).  Nothing falls back silently.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None``/``"cuda"``/``"cuda:N"`` -> that CUDA device (raises without
    a GPU); ``"cpu"`` -> the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "funasr_torch runs on CUDA and no GPU is visible; pass "
                "device='cpu' to run the plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
