"""Position-wise FFNs: the int8 FFN (port of funasr_tpu/ops/ffn_pallas.py
``_ffn_call_int8``, body ``_ffn_kernel_int8`` :51-61) and the bf16/float32
FFN (port of ``_ffn_call``, body ``_ffn_kernel`` :39-45).

Contract, x (M, K) in bf16 or float32, weights pre-quantized per output
channel (:func:`funasr_torch.ops.quant.quantize_weight` of the float32
weights), biases float32::

    q, s   = rowquant(x)                          per row, * f32(1/127)
    h      = relu((acc(q, w1) * s) * s1 + b1)     float32 (M, H)
    q2, s2 = rowquant(h)
    out    = (acc(q2, w2) * s2) * s2w + b2        cast to x's dtype

On the card this is four launches: ``csrc/rowquant.cu`` and
``csrc/int8_gemm.cu`` twice each.  The TPU kernel keeps the (M, H) hidden
tile in VMEM; here it goes through device memory in float32 (the row
quantize of h needs the whole 2048-wide row, which spans GEMM tiles).
Quantizing the rows in the GEMM's A producer instead of a rowquant launch
measured slower at both contractions on an H100 (PERF.md section 6).

- :func:`fused_ffn_int8` runs the kernels for CUDA tensors and counts one
  launch per call in ``fused_ffn_int8.launches``; for CPU tensors it runs
  :func:`ffn_int8_ref`.  There is no other path.
- :func:`ffn_int8_ref` is the plain PyTorch version, built from the
  building blocks' twins.

The bf16/float32 FFN, x (M, K) and the ``nn.Linear`` weights cast to x's
dtype, float32 biases::

    h   = cast(relu(x w1^T + b1))        float32 accumulation
    out = cast(h w2^T + b2)              float32 accumulation

- :func:`fused_ffn` launches ``csrc/ffn.cu`` (one kernel; the hidden tile
  stays in shared memory) for CUDA tensors and counts the launch in
  ``fused_ffn.launches``; for CPU tensors it runs :func:`ffn_ref`.  There
  is no other path.  No model routes it: the JAX package's modules take
  the fused FFN only in int8 (sanm.py:329-344), and so does the port.
- :func:`ffn_ref` is the plain PyTorch version.  It sums in another order
  than the kernel, which can move a bf16 rounding of h: the two agree to a
  stated tolerance, not bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from funasr_torch.ops import cuda_build
from funasr_torch.ops import int8_gemm as G
from funasr_torch.ops import rowquant as RQ
from funasr_torch.ops.quant import quantize_weight


class FfnInt8Weights(NamedTuple):
    w1: torch.Tensor  # (H, K) int8
    s1: torch.Tensor  # (H,) float32
    b1: torch.Tensor  # (H,) float32
    w2: torch.Tensor  # (N, H) int8
    s2: torch.Tensor  # (N,) float32
    b2: torch.Tensor  # (N,) float32


def quantize_ffn(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor) -> FfnInt8Weights:
    """float32 ``nn.Linear`` weights (H, K), (N, H) -> int8 FFN weights."""
    w18, s1 = quantize_weight(w1.to(torch.float32))
    w28, s2 = quantize_weight(w2.to(torch.float32))
    return FfnInt8Weights(w18, s1, b1.to(torch.float32), w28, s2,
                          b2.to(torch.float32))


def _ffn(x: torch.Tensor, w: FfnInt8Weights, rowquant, gemm) -> torch.Tensor:
    lead, K = x.shape[:-1], x.shape[-1]
    q, s = rowquant(x.reshape(-1, K))
    h = gemm(q, s, w.w1, w.s1, bias=w.b1, relu=True)
    q2, s2 = rowquant(h)
    out = gemm(q2, s2, w.w2, w.s2, bias=w.b2, out_dtype=x.dtype)
    return out.reshape(*lead, w.w2.shape[0])


def ffn_int8_ref(x: torch.Tensor, w: FfnInt8Weights) -> torch.Tensor:
    """Plain twin: same inputs and output as :func:`fused_ffn_int8`."""
    return _ffn(x, w, RQ.rowquant_ref, G.int8_gemm_ref)


def fused_ffn_int8(x: torch.Tensor, w: FfnInt8Weights) -> torch.Tensor:
    """x (..., K) -> (..., N) in x's dtype."""
    if x.device.type == "cpu":
        return ffn_int8_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ffn_int8: unsupported device {x.device}")
    out = _ffn(x.contiguous(), w, RQ.rowquant, G.int8_gemm)
    fused_ffn_int8.launches += 1
    return out


fused_ffn_int8.launches = 0


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def ffn_ref(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
            b2: torch.Tensor) -> torch.Tensor:
    """Plain twin: same inputs and output as :func:`fused_ffn`."""
    dt, f32 = x.dtype, torch.float32
    h = torch.relu(x.to(f32) @ w1.to(dt).to(f32).T + b1.to(f32)).to(dt)
    return (h.to(f32) @ w2.to(dt).to(f32).T + b2.to(f32)).to(dt)


def fused_ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor) -> torch.Tensor:
    """x (..., K) bf16 or float32, w1 (H, K), b1 (H,), w2 (N, H), b2 (N,)
    -> (..., N) in x's dtype.  On the card K and H must be multiples of 32."""
    if x.device.type == "cpu":
        return ffn_ref(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ffn: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"fused_ffn: x must be bf16 or float32, got {x.dtype}")
    lead, K = x.shape[:-1], x.shape[-1]
    H, N = w1.shape[0], w2.shape[0]
    if w1.shape != (H, K) or w2.shape != (N, H) or b1.shape != (H,) or b2.shape != (N,):
        raise ValueError(f"fused_ffn: shapes x {tuple(x.shape)} w1 {tuple(w1.shape)} "
                         f"b1 {tuple(b1.shape)} w2 {tuple(w2.shape)} b2 {tuple(b2.shape)}")
    if K % 32 or H % 32:
        raise ValueError(f"fused_ffn: K={K} and H={H} must be multiples of 32")
    if not all(t.device == x.device for t in (w1, b1, w2, b2)):
        raise ValueError("fused_ffn: inputs on different devices")
    x2 = x.reshape(-1, K).contiguous()
    w1, w2 = w1.to(x.dtype).contiguous(), w2.to(x.dtype).contiguous()
    b1, b2 = b1.to(torch.float32).contiguous(), b2.to(torch.float32).contiguous()
    if any(t.data_ptr() % 16 for t in (x2, w1, w2)):
        raise ValueError("fused_ffn: x, w1 and w2 must be 16-byte aligned")
    out = torch.empty((x2.shape[0], N), dtype=x.dtype, device=x.device)
    fn = cuda_build.function("ffn", "ffn_forward", _ARGTYPES)
    status = fn(x2.data_ptr(), _DTYPES[x.dtype], w1.data_ptr(), b1.data_ptr(),
                w2.data_ptr(), b2.data_ptr(), out.data_ptr(), x2.shape[0], K, H, N,
                torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(status, "FFN kernel launch")
    fused_ffn.launches += 1
    return out.reshape(*lead, N)


fused_ffn.launches = 0
