"""Dynamic int8 quantization (port of funasr_tpu/ops/quant.py).

The recipe of the JAX package's ``quantize=True`` serving path: int8 x int8
-> int32 contractions with per-row activation scales computed on the fly
and per-output-channel weight scales.  Two quantize forms, as in the JAX
package, which can differ in the last bit of a scale, each with one plain
version in ``ops/rowquant.py`` (``quantize_ref``):

- "div", :func:`quantize_rows` here, divides the absmax by 127
  (quant.py:55-64): weights, and the activations of the QDense int8 linear;
- "mul" multiplies it by f32(1/127) (quant.py:150-157 ``rowquant_kernel``):
  the activations inside the fused layer kernels.

``MIN_M`` / ``MIN_N`` are the gate of the XLA int8 dot (quant.py:69-70,108):
a QDense contraction is quantized only when it has at least ``MIN_M`` rows
and ``MIN_N`` output columns; otherwise it runs in the compute dtype.  They
are module constants that a test may set (to 0 to force int8).  The fused
layer kernels quantize every contraction, whatever the gate.

:func:`int8_linear` is QDense's int8 contraction: on CUDA tensors the
rowquant kernel ("div" form) and the int8 GEMM kernel, on CPU tensors their
plain twins.  Unlike the JAX package's process-global switch (quant.py:31),
quantization is a per-model setting (``Paraformer(quantize=True)``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from funasr_torch.ops import cuda_build
from funasr_torch.ops import int8_gemm as G
from funasr_torch.ops import rowquant as RQ

MIN_M = 1024
MIN_N = 1024


def quantize_rows(x: torch.Tensor, dim: int = -1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with one scale per slice along ``dim`` (absmax / 127,
    half-to-even rounding, clipped to [-127, 127]).  Returns ``(q, scale)``
    with ``scale`` keeping ``dim`` as size 1; all-zero slices get scale
    1e-8 / 127 and q = 0."""
    q, scale = RQ.quantize_ref(x.to(torch.float32).movedim(dim, -1), "div")
    return q.movedim(-1, dim), scale[..., None].movedim(-1, dim)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``nn.Linear`` weight (N, K) -> (int8 (N, K), float32 (N,)): one scale
    per output channel, the :func:`quantize_rows` form over K (JAX
    ``quantize_rows(kernel, axis=0)`` on the transposed (K, N) kernel)."""
    q, scale = quantize_rows(w, dim=1)
    return q.contiguous(), scale[:, 0].contiguous()


def gate(m: int, n: int) -> bool:
    """Whether a QDense contraction of m rows and n outputs takes int8."""
    return m >= MIN_M and n >= MIN_N


def int8_linear(x: torch.Tensor, w8: torch.Tensor, sw: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """QDense's int8 contraction (``int8_dot_general`` followed by flax's
    bias add): x (..., K) in the compute dtype, w8 (N, K) int8, sw (N,)
    float32, bias (N,) float32 holding compute-dtype values.

    out = cast(acc * sx * sw) + bias, the cast and the add in x's dtype.
    """
    cuda_build.refuse_autograd("int8_linear", x, w8, sw, bias)
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    if x.device.type == "cuda":
        x2 = x2.contiguous()
    q, sx = RQ.rowquant(x2, form="div")
    out = G.int8_gemm(q, sx, w8, sw, bias=bias,
                      round_bf16=x.dtype == torch.bfloat16, out_dtype=x.dtype)
    return out.reshape(*lead, w8.shape[0])
