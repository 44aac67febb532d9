"""Device resolution for the port's entry points.

The port runs on CUDA.  ``resolve_device(None)`` means the card and raises
when there is none; the CPU is used only when the caller asks for it
(``device="cpu"``, as the tests do).  Nothing falls back silently.
``upload`` moves a host array onto a device without waiting for the
device's queued work; ``fetch_async`` and ``fetched`` bring device tensors
back the same way, through pinned memory behind one event.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
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


def upload(arr: np.ndarray, device) -> torch.Tensor:
    """A host array onto ``device``: on the card through pinned memory and a
    non-blocking copy, so the host does not wait for the stream's queued
    work (a copy from pageable memory synchronizes the stream)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    device = torch.device("cpu" if device is None else device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def fetch_async(tensors: Sequence[torch.Tensor]):
    """Start copying device tensors to the host: ``(host tensors, event)``.
    On the card each goes into pinned memory by a non-blocking copy and the
    event is recorded after the copies; wait on it (:func:`fetched`) before
    reading them.  CPU tensors come back as they are, with no event."""
    if not tensors or tensors[0].device.type != "cuda":
        return list(tensors), None
    host = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        host.append(h)
    event = torch.cuda.Event()
    event.record()
    return host, event


def fetched(host, event):
    """The host tensors of :func:`fetch_async`, once their copies are done."""
    if event is not None:
        event.synchronize()
    return host


def cudnn_float32():
    """A context in which cuDNN convolutions and RNNs compute in full float32
    (TF32 off; cuDNN's default is on), every other cuDNN setting kept."""
    c = torch.backends.cudnn
    return c.flags(enabled=c.enabled, benchmark=c.benchmark,
                   benchmark_limit=c.benchmark_limit, deterministic=c.deterministic,
                   allow_tf32=False)
