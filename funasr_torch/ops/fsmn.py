"""Depthwise FSMN memory of the int8 layers: the CUDA kernel's wrapper and
its plain twin.

Contract (``csrc/fsmn.cu``; sanm_layer_pallas.py:93-101,
decoder_layer_pallas.py:76-88), float32, per batch row b with
``valid[t] = t < lengths[b]`` and ``vm = v * valid``::

    mem[t] = (vm[t] + sum_{j=0..K-1} taps[j] * vm[t + j - left]) * valid[t]
    out    = res + mem        (res optional, (B, T, D) float32 or bf16)

with ``vm`` zero outside [0, T).  v may be a column slice of a wider
tensor (the v third of the QKV projection).

- :func:`fsmn` launches ``csrc/fsmn.cu`` for CUDA tensors and counts the
  launch in ``fsmn.launches``; for CPU tensors it runs :func:`fsmn_ref`.
  There is no other path.
- :func:`fsmn_ref` is the plain PyTorch version: the same multiplies and
  adds in the same order, so it agrees with the kernel bit for bit.

The served layers compute this memory inside other launches: the SANM
layer in its wout GEMM's epilogue (``ops/int8_gemm.py`` ``int8_gemm_rq``),
the decoder layer with its layer norm in front::

    out = res + FSMN(LN(h))      LN as ops/rowquant.py (float64 statistics)

- :func:`fsmn_ln` launches ``csrc/fsmn.cu`` ``fsmn_ln_forward`` (one
  launch for what was a layer-norm-only rowquant and this FSMN) for CUDA
  tensors and counts the launch in ``fsmn_ln.launches``; for CPU tensors
  it runs :func:`fsmn_ln_ref`.  There is no other path.
- :func:`fsmn_ln_ref` is ``rowquant_ref(h, ln, quantize=False)`` followed
  by :func:`fsmn_ref`: the building blocks' twins.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from funasr_torch.ops import cuda_build
from funasr_torch.ops import rowquant as RQ
from funasr_torch.ops.masks import sequence_mask


def fsmn_ref(v: torch.Tensor, lengths: torch.Tensor, taps: torch.Tensor,
             left: int, res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin: same inputs and output as :func:`fsmn`."""
    B, T, D = v.shape
    valid = sequence_mask(lengths, T)[:, :, None]
    vm = v.to(torch.float32) * valid
    padded = torch.nn.functional.pad(vm, (0, 0, left, taps.shape[0] - 1 - left))
    mem = vm
    for j in range(taps.shape[0]):
        mem = mem + taps[j] * padded[:, j:j + T]
    mem = mem * valid
    return mem if res is None else res.to(torch.float32) + mem


_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
             + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
             + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])


def fsmn(v: torch.Tensor, lengths: torch.Tensor, taps: torch.Tensor, left: int,
         res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """v (B, T, D) float32 with a unit column stride; lengths (B,) int;
    taps (K, D) float32; res None or (B, T, D) -> (B, T, D) float32."""
    cuda_build.refuse_autograd("fsmn", v, lengths, taps, res)
    if v.device.type == "cpu":
        return fsmn_ref(v, lengths, taps, left, res)
    if v.device.type != "cuda":
        raise ValueError(f"fsmn: unsupported device {v.device}")
    B, T, D = v.shape
    K = taps.shape[0]
    if v.dtype != torch.float32 or v.stride(2) != 1:
        raise ValueError(f"fsmn: v must be float32 with a unit column stride, got "
                         f"{v.dtype} strides {v.stride()}")
    if taps.shape != (K, D) or taps.dtype != torch.float32 or not 0 <= left < K:
        raise ValueError(f"fsmn: taps must be float32 (K, {D}) with 0 <= left < K")
    if res is not None and (res.shape != (B, T, D) or not res.is_contiguous()
                            or res.dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError("fsmn: res must be a contiguous (B, T, D) float32/bf16 tensor")
    if lengths.shape != (B,):
        raise ValueError(f"fsmn: lengths must be ({B},)")
    if not all(t.device == v.device for t in (lengths, taps) + ((res,) if res is not None else ())):
        raise ValueError("fsmn: inputs on different devices")
    lens = lengths.to(torch.int32).contiguous()
    taps = taps.contiguous()
    out = torch.empty((B, T, D), dtype=torch.float32, device=v.device)
    fn = cuda_build.function("fsmn", "fsmn_forward", _ARGTYPES)
    status = fn(v.data_ptr(), v.stride(0), v.stride(1), lens.data_ptr(),
                taps.data_ptr(), B, T, D, K, left,
                None if res is None else res.data_ptr(),
                int(res is not None and res.dtype == torch.bfloat16), out.data_ptr(),
                torch.cuda.current_stream(v.device).cuda_stream)
    cuda_build.check(status, "FSMN kernel launch")
    fsmn.launches += 1
    return out


fsmn.launches = 0


def fsmn_ln_ref(h: torch.Tensor, ln: Tuple[torch.Tensor, torch.Tensor],
                lengths: torch.Tensor, taps: torch.Tensor, left: int,
                res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin: same inputs and output as :func:`fsmn_ln`."""
    B, T, D = h.shape
    y = RQ.rowquant_ref(h.reshape(B * T, D), ln, quantize=False)
    return fsmn_ref(y.view(B, T, D), lengths, taps, left, res)


_LN_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_float] + [ctypes.c_void_p] * 2
                + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                        ctypes.c_void_p])


def fsmn_ln(h: torch.Tensor, ln: Tuple[torch.Tensor, torch.Tensor], lengths: torch.Tensor,
            taps: torch.Tensor, left: int, res: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """h (B, T, D) float32, ``ln`` its float32 (weight, bias) of width D,
    lengths (B,), taps (K, D) float32, res None or (B, T, D) float32/bf16
    -> res + FSMN(LN(h)), (B, T, D) float32."""
    cuda_build.refuse_autograd("fsmn_ln", h, ln, lengths, taps, res)
    if h.device.type == "cpu":
        return fsmn_ln_ref(h, ln, lengths, taps, left, res)
    if h.device.type != "cuda":
        raise ValueError(f"fsmn_ln: unsupported device {h.device}")
    B, T, D = h.shape
    K = taps.shape[0]
    if h.dtype != torch.float32 or not h.is_contiguous() or h.data_ptr() % 16 \
            or D % 4 or D > 1024:
        raise ValueError(f"fsmn_ln: h must be contiguous, 16-byte aligned float32 with D a "
                         f"multiple of 4 and at most 1024, got {h.dtype} {tuple(h.shape)}")
    if taps.shape != (K, D) or taps.dtype != torch.float32 or not 0 <= left < K:
        raise ValueError(f"fsmn_ln: taps must be float32 (K, {D}) with 0 <= left < K")
    w, b = (t.contiguous() for t in ln)
    if any(t.shape != (D,) or t.dtype != torch.float32 or t.data_ptr() % 16 for t in (w, b)):
        raise ValueError("fsmn_ln: layer-norm parameters must be 16-byte aligned float32 (D,)")
    if res is not None and (res.shape != (B, T, D) or not res.is_contiguous()
                            or res.dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError("fsmn_ln: res must be a contiguous (B, T, D) float32/bf16 tensor")
    if lengths.shape != (B,):
        raise ValueError(f"fsmn_ln: lengths must be ({B},)")
    if not all(t.device == h.device for t in (lengths, taps, w, b)
               + ((res,) if res is not None else ())):
        raise ValueError("fsmn_ln: inputs on different devices")
    lens = lengths.to(torch.int32).contiguous()
    taps = taps.contiguous()
    out = torch.empty((B, T, D), dtype=torch.float32, device=h.device)
    fn = cuda_build.function("fsmn", "fsmn_ln_forward", _LN_ARGTYPES)
    status = fn(h.data_ptr(), w.data_ptr(), b.data_ptr(), RQ.LN_EPS, lens.data_ptr(),
                taps.data_ptr(), B, T, D, K, left,
                None if res is None else res.data_ptr(),
                int(res is not None and res.dtype == torch.bfloat16), out.data_ptr(),
                torch._C._cuda_getCurrentRawStream(h.get_device()))
    cuda_build.check(status, "LN + FSMN kernel launch")
    fsmn_ln.launches += 1
    return out


fsmn_ln.launches = 0
