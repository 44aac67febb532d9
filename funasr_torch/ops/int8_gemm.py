"""int8 GEMM with a dequantize epilogue: the CUDA kernel's wrapper and its
plain twin.

The building block of the port's int8 layers (``ops/ffn.py``,
``ops/sanm_layer.py``, ``ops/decoder_layer.py``) and of the QDense int8
linear (``ops/quant.py``).  Contract, with A int8 (M, K) and one float32
scale per row, B int8 (N, K) (the ``nn.Linear`` layout) and one float32
scale per output column::

    acc = A @ B^T                                    int32, exact
    v   = (float32(acc) * sa[:, None]) * sb[None]    float32
    v   = res + v            (res: optional (M, N), float32 or bf16)
    v   = bf16(v)            (round_bf16: QDense rounds before its bias)
    v   = v + bias           (optional (N,) float32)
    v   = relu(v)            (optional)
    v   = v + add            (optional (M, N) float32)
    out = v                  float32 or bf16

- :func:`int8_gemm` launches ``csrc/int8_gemm.cu`` for CUDA tensors and
  counts the launch in ``int8_gemm.launches``; for CPU tensors it runs
  :func:`int8_gemm_ref`.  There is no other path.
- :func:`int8_gemm_ref` is the plain PyTorch version.  It forms ``acc`` in
  float64, which is exact (|acc| <= 127^2 K < 2^53), converts it to
  float32 as the kernel's ``cvt.rn`` does, and applies the same float32
  steps in the same order, so kernel and twin agree bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from funasr_torch.ops import cuda_build

_OUT = {torch.float32: 0, torch.bfloat16: 1}


def int8_gemm_ref(a: torch.Tensor, sa: torch.Tensor, b: torch.Tensor,
                  sb: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  relu: bool = False, res: Optional[torch.Tensor] = None,
                  add: Optional[torch.Tensor] = None, round_bf16: bool = False,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain twin: same inputs and output as :func:`int8_gemm`."""
    acc = (a.to(torch.float64) @ b.to(torch.float64).T).to(torch.float32)
    v = acc * sa.reshape(-1, 1).to(torch.float32) * sb.reshape(1, -1).to(torch.float32)
    if res is not None:
        v = res.to(torch.float32) + v
    if round_bf16:
        v = v.to(torch.bfloat16).to(torch.float32)
    if bias is not None:
        v = v + bias.to(torch.float32)
    if relu:
        v = torch.relu(v)
    if add is not None:
        v = v + add.to(torch.float32)
    return v.to(out_dtype)


_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]
             + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_void_p])


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def int8_gemm(a: torch.Tensor, sa: torch.Tensor, b: torch.Tensor,
              sb: torch.Tensor, bias: Optional[torch.Tensor] = None,
              relu: bool = False, res: Optional[torch.Tensor] = None,
              add: Optional[torch.Tensor] = None, round_bf16: bool = False,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """a int8 (M, K), sa (M,) float32, b int8 (N, K), sb (N,) float32 ->
    (M, N) in ``out_dtype``.  res and add are (M, N) with a unit column
    stride; K must be a multiple of 16 on the card."""
    if a.device.type == "cpu":
        return int8_gemm_ref(a, sa, b, sb, bias, relu, res, add, round_bf16,
                             out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"int8_gemm: unsupported device {a.device}")
    M, K = a.shape
    N = b.shape[0]
    if a.dtype != torch.int8 or b.dtype != torch.int8 or b.shape[1] != K:
        raise ValueError(f"int8_gemm: need int8 (M, K) x (N, K), got {a.dtype} "
                         f"{tuple(a.shape)} x {b.dtype} {tuple(b.shape)}")
    if K % 16 or not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"int8_gemm: K={K} must be a multiple of 16 and a, b "
                         "contiguous")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("int8_gemm: a and b must be 16-byte aligned")
    if out_dtype not in _OUT:
        raise ValueError(f"int8_gemm: unsupported output dtype {out_dtype}")
    if sa.shape != (M,) or sb.shape != (N,) or sa.dtype != torch.float32 \
            or sb.dtype != torch.float32:
        raise ValueError("int8_gemm: scales must be float32 (M,) and (N,)")
    if bias is not None and (bias.shape != (N,) or bias.dtype != torch.float32):
        raise ValueError("int8_gemm: bias must be float32 (N,)")
    for name, t, dtypes in (("res", res, (torch.float32, torch.bfloat16)),
                            ("add", add, (torch.float32,))):
        if t is not None and (t.shape != (M, N) or t.dtype not in dtypes
                              or t.stride(1) != 1):
            raise ValueError(f"int8_gemm: {name} must be (M, N) {dtypes} with a "
                             "unit column stride")
    tensors = [t for t in (sa, b, sb, bias, res, add) if t is not None]
    if not all(t.device == a.device for t in tensors):
        raise ValueError("int8_gemm: inputs on different devices")
    sa, sb = sa.contiguous(), sb.contiguous()
    bias = None if bias is None else bias.contiguous()
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    fn = cuda_build.function("int8_gemm", "int8_gemm_forward", _ARGTYPES)
    status = fn(a.data_ptr(), b.data_ptr(), M, N, K, sa.data_ptr(), sb.data_ptr(),
                _ptr(bias), _ptr(res), 0 if res is None else res.stride(0),
                int(res is not None and res.dtype == torch.bfloat16), _ptr(add),
                0 if add is None else add.stride(0), int(relu), int(round_bf16),
                out.data_ptr(), N, _OUT[out_dtype],
                torch.cuda.current_stream(a.device).cuda_stream)
    cuda_build.check(status, "int8 GEMM kernel launch")
    int8_gemm.launches += 1
    return out


int8_gemm.launches = 0
