"""Per-row layer norm and int8 quantization: the CUDA kernel's wrapper and
its plain twin.

Contract for each row x of width W (``csrc/rowquant.cu``)::

    y     = x, or ((x - mean) * (1 / sqrt(var + eps))) * w + b
    scale = max(max|y|, 1e-8) * f32(1/127)   form "mul" (quant.py rowquant_kernel)
    scale = max(max|y|, 1e-8) / 127          form "div" (quant.py quantize_rows)
    q     = clip(round_half_even(y / scale), -127, 127)

The mean and the variance are summed in float64 and rounded once to
float32, so they do not depend on the order of the sum; the JAX kernels sum
in float32, which differs from this in the last bit of a statistic.

- :func:`rowquant` launches ``csrc/rowquant.cu`` for CUDA tensors and
  counts the launch in ``rowquant.launches``; for CPU tensors it runs
  :func:`rowquant_ref`.  There is no other path.
- :func:`rowquant_ref` is the plain PyTorch version; it gets the same bits.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from funasr_torch.ops import cuda_build

FORMS = {"mul": 0, "div": 1}
LN_EPS = 1e-12
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INV127 = 1.0 / 127.0  # a Python float: multiplies a float32 tensor as f32(1/127)


def div127(x: torch.Tensor) -> torch.Tensor:
    """``x / 127`` as an IEEE float32 division.  (PyTorch on CUDA turns a
    division by a Python scalar into a multiply by its reciprocal, which is
    the other quantize form.)"""
    return x / torch.full_like(x, 127.0)


def layer_norm_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   eps: float = LN_EPS) -> torch.Tensor:
    """Float32 layer norm over the last axis, statistics summed in float64."""
    x = x.to(torch.float32)
    xd = x.to(torch.float64)
    mean = xd.mean(-1, keepdim=True)
    var = ((xd - mean) ** 2).mean(-1, keepdim=True)
    inv = 1.0 / torch.sqrt(var.to(torch.float32) + eps)
    return (x - mean.to(torch.float32)) * inv * w + b


def quantize_ref(y: torch.Tensor, form: str = "mul"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 of float32 ``y`` (..., W) -> (q int8, scale (...,))."""
    amax = torch.clamp(y.abs().amax(-1, keepdim=True), min=1e-8)
    scale = amax * _INV127 if form == "mul" else div127(amax)
    q = torch.clamp(torch.round(y / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def rowquant_ref(x: torch.Tensor, ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 form: str = "mul", quantize: bool = True):
    """Plain twin: same inputs and outputs as :func:`rowquant`."""
    y = x.to(torch.float32)
    if ln is not None:
        y = layer_norm_ref(y, ln[0], ln[1])
    return quantize_ref(y, form) if quantize else y


_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
             + [ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 4)


def rowquant(x: torch.Tensor, ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
             form: str = "mul", quantize: bool = True):
    """x (M, W) float32 or bf16, contiguous.  Returns ``(q (M, W) int8,
    scale (M,) float32)``; with ``quantize=False`` the float32 ``y`` alone.
    ``ln``: float32 (weight, bias) of width W, or None for no norm."""
    cuda_build.refuse_autograd("rowquant", x, ln)
    if x.device.type == "cpu":
        return rowquant_ref(x, ln, form, quantize)
    if x.device.type != "cuda":
        raise ValueError(f"rowquant: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"rowquant: need a contiguous (M, W) float32/bf16 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if form not in FORMS:
        raise ValueError(f"rowquant: unknown form {form!r}")
    M, W = x.shape
    if ln is not None:
        w, b = (t.contiguous() for t in ln)
        if any(t.shape != (W,) or t.dtype != torch.float32 or t.device != x.device
               for t in (w, b)):
            raise ValueError("rowquant: layer-norm parameters must be float32 (W,)")
    q = scale = y = None
    if quantize:
        q = torch.empty((M, W), dtype=torch.int8, device=x.device)
        scale = torch.empty((M,), dtype=torch.float32, device=x.device)
    else:
        y = torch.empty((M, W), dtype=torch.float32, device=x.device)
    fn = cuda_build.function("rowquant", "rowquant_forward", _ARGTYPES)
    status = fn(x.data_ptr(), _DTYPES[x.dtype], M, W,
                None if ln is None else w.data_ptr(),
                None if ln is None else b.data_ptr(), LN_EPS, FORMS[form],
                None if q is None else q.data_ptr(),
                None if scale is None else scale.data_ptr(),
                None if y is None else y.data_ptr(),
                torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(status, "rowquant kernel launch")
    rowquant.launches += 1
    return (q, scale) if quantize else y


rowquant.launches = 0
