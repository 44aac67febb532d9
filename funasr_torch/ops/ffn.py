"""int8 position-wise FFN (port of funasr_tpu/ops/ffn_pallas.py
``_ffn_call_int8``, body ``_ffn_kernel_int8`` :51-61).

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
Fusing it away is later work.

- :func:`fused_ffn_int8` runs the kernels for CUDA tensors and counts one
  launch per call in ``fused_ffn_int8.launches``; for CPU tensors it runs
  :func:`ffn_int8_ref`.  There is no other path.
- :func:`ffn_int8_ref` is the plain PyTorch version, built from the
  building blocks' twins.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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
