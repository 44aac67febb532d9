"""Fused dynamic-int8 matmul: the CUDA kernel's wrapper and its plain twin
(port of funasr_tpu/ops/quant_pallas.py ``_qmm``, body ``_qmm_kernel`` :37).

The opt-in QDense route of the JAX package (``FUNASR_TPU_PALLAS_QMM=1``,
quant.py:118-122): a ``Dense`` built with ``qmm=True`` (``models/sanm.py``)
whose contraction passes the ``ops/quant.py`` m/n gate calls
:func:`quant_matmul` instead of ``quant.int8_linear``.  Contract, x (..., K)
in bf16 or float32, w8 (N, K) int8 and sw (N,) float32 from
``quant.quantize_weight`` of the compute-dtype weight::

    q, s_x = rowquant(x)                    "mul" form: absmax * f32(1/127)
    out    = cast((float32(acc(q, w8)) * s_x) * sw) + bias

the cast to x's dtype and the bias add in that dtype, as flax adds it after
the dot.  The XLA route (``quant.int8_linear``) quantizes x with the "div"
form, so the two can differ in the last bit of a row scale.

The port copies the recipe's m/n gate only, not the TPU's alignment and
VMEM gates (``quant_pallas.supported``: K % 128 == 0, the tiles fit): so
``encoders0``'s K = 560 projection takes this kernel in the port, where the
JAX package sends it to its XLA "div" form.

- :func:`quant_matmul` launches ``csrc/qmm.cu`` (one kernel: the rows are
  quantized in its prologue) for CUDA tensors and counts the launch in
  ``quant_matmul.launches``; for CPU tensors it runs
  :func:`quant_matmul_ref`.  There is no other path.
- :func:`quant_matmul_ref` is the plain PyTorch version: ``rowquant_ref``
  ("mul") followed by ``int8_gemm_ref``, bit-equal to the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from funasr_torch.ops import cuda_build
from funasr_torch.ops import int8_gemm as G
from funasr_torch.ops import rowquant as RQ

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_K = 3072  # the kernel keeps (64, K) int8 rows in shared memory


def quant_matmul_ref(x: torch.Tensor, w8: torch.Tensor, sw: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin: same inputs and output as :func:`quant_matmul`."""
    lead, K = x.shape[:-1], x.shape[-1]
    q, sx = RQ.rowquant_ref(x.reshape(-1, K), form="mul")
    out = G.int8_gemm_ref(q, sx, w8, sw, bias=bias,
                          round_bf16=x.dtype == torch.bfloat16, out_dtype=x.dtype)
    return out.reshape(*lead, w8.shape[0])


_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
             + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def quant_matmul(x: torch.Tensor, w8: torch.Tensor, sw: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., K) bf16 or float32, w8 (N, K) int8, sw (N,) float32, bias
    (N,) float32 holding x-dtype values or None -> (..., N) in x's dtype.
    On the card K must be a multiple of 16 and at most ``MAX_K``."""
    if x.device.type == "cpu":
        return quant_matmul_ref(x, w8, sw, bias)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: unsupported device {x.device}")
    lead, K = x.shape[:-1], x.shape[-1]
    N = w8.shape[0]
    if x.dtype not in _DTYPES:
        raise ValueError(f"quant_matmul: x must be bf16 or float32, got {x.dtype}")
    if w8.dtype != torch.int8 or w8.shape != (N, K) or not w8.is_contiguous():
        raise ValueError(f"quant_matmul: need contiguous int8 (N, {K}) weights, got "
                         f"{w8.dtype} {tuple(w8.shape)}")
    if K % 16 or K > MAX_K:
        raise ValueError(f"quant_matmul: K={K} must be a multiple of 16 and <= {MAX_K}")
    if sw.shape != (N,) or sw.dtype != torch.float32:
        raise ValueError("quant_matmul: sw must be float32 (N,)")
    if bias is not None and (bias.shape != (N,) or bias.dtype != torch.float32):
        raise ValueError("quant_matmul: bias must be float32 (N,)")
    if not all(t.device == x.device for t in (w8, sw, bias) if t is not None):
        raise ValueError("quant_matmul: inputs on different devices")
    x2 = x.reshape(-1, K).contiguous()
    if x2.data_ptr() % 16 or w8.data_ptr() % 16:
        raise ValueError("quant_matmul: x and w8 must be 16-byte aligned")
    sw = sw.contiguous()
    bias = None if bias is None else bias.contiguous()
    out = torch.empty((x2.shape[0], N), dtype=x.dtype, device=x.device)
    fn = cuda_build.function("qmm", "qmm_forward", _ARGTYPES)
    status = fn(x2.data_ptr(), _DTYPES[x.dtype], w8.data_ptr(), sw.data_ptr(),
                None if bias is None else bias.data_ptr(), out.data_ptr(),
                x2.shape[0], N, K, torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(status, "qmm kernel launch")
    quant_matmul.launches += 1
    return out.reshape(*lead, N)


quant_matmul.launches = 0
