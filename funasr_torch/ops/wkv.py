"""The RWKV-4 WKV recurrence: the CUDA kernel's wrapper and its plain twin.

:func:`wkv` launches ``csrc/wkv.cu`` for CUDA tensors and counts each launch
in ``wkv.launches``; for CPU tensors it runs :func:`wkv_ref`.  There is no
other path.  The kernel replaces no TPU kernel: the JAX package runs the
recurrence as a ``lax.scan`` (funasr_tpu/models/rwkv.py:32 ``wkv_scan``),
one XLA loop; its plain PyTorch form here is a loop of about fifteen
elementwise launches a position.

:func:`wkv_ref` is that loop in float32 with a running log-sum-exp state
per channel, the JAX scan step by step: ``pp`` starts at -1e30, the decay
``w`` is ``exp(time_decay)``, and the max-exponent updates come in the JAX
order.  It is causal, so positions after a prefix cannot reach it.  On the
card kernel and twin agree bit for bit: the kernel does the twin's IEEE
operations in the twin's order, with PyTorch's float32 ``exp`` (``expf``).
"""

from __future__ import annotations

import ctypes

import torch

from funasr_torch.ops import cuda_build


def wkv_ref(k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
            u: torch.Tensor) -> torch.Tensor:
    """Plain twin: same inputs and output as :func:`wkv`."""
    B, T, C = k.shape
    aa = torch.zeros((B, C), dtype=torch.float32, device=k.device)
    bb = torch.zeros_like(aa)
    pp = torch.full_like(aa, -1e30)
    out = []
    for t in range(T):
        kt, vt = k[:, t], v[:, t]
        ww = u + kt
        p = torch.maximum(pp, ww)
        e1 = torch.exp(pp - p)
        e2 = torch.exp(ww - p)
        out.append((e1 * aa + e2 * vt) / (e1 * bb + e2))
        ww2 = pp - w
        p2 = torch.maximum(ww2, kt)
        e1 = torch.exp(ww2 - p2)
        e2 = torch.exp(kt - p2)
        aa, bb, pp = e1 * aa + e2 * vt, e1 * bb + e2, p2
    return torch.stack(out, dim=1)


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def wkv(k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """RWKV WKV recurrence: k, v (B, T, C) float32; w (C,) the decay (> 0);
    u (C,) the bonus of the current token -> (B, T, C) float32."""
    cuda_build.refuse_autograd("wkv", k, v, w, u)
    if k.device.type == "cpu":
        return wkv_ref(k, v, w, u)
    if k.device.type != "cuda":
        raise ValueError(f"wkv: unsupported device {k.device}")
    if k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"wkv: k {tuple(k.shape)} and v {tuple(v.shape)} must be the "
                         "same (B, T, C)")
    B, T, C = k.shape
    if w.shape != (C,) or u.shape != (C,):
        raise ValueError(f"wkv: w {tuple(w.shape)} and u {tuple(u.shape)} must be ({C},)")
    if any(t.dtype != torch.float32 for t in (k, v, w, u)):
        raise ValueError("wkv: inputs must be float32")
    if not all(t.device == k.device for t in (v, w, u)):
        raise ValueError("wkv: inputs on different devices")
    k, v, w, u = k.contiguous(), v.contiguous(), w.contiguous(), u.contiguous()
    out = torch.empty((B, T, C), dtype=torch.float32, device=k.device)
    fn = cuda_build.function("wkv", "wkv_forward", _ARGTYPES)
    status = fn(k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), out.data_ptr(),
                B, T, C, torch.cuda.current_stream(k.device).cuda_stream)
    cuda_build.check(status, "wkv kernel launch")
    wkv.launches += 1
    return out


wkv.launches = 0
