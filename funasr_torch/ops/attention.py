"""Masked-softmax attention: the CUDA kernel's wrapper and its plain twin.

Replaces the TPU kernel funasr_tpu/ops/attention_pallas.py
``_attn_kernel``.  Contract (attention_pallas.py:37-60, sanm.py:162-163)::

    out[b, :, h, :] = softmax(q[b, :, h, :] @ k[b, :, h, :]^T + key_bias[b]) @ v

- q (B, U, H*d), k/v (B, T, H*d), bf16 or float32, in their natural
  layout; the ``d**-0.5`` scale is already applied to q in its dtype;
- key_bias (B, T) float32 additive row: 0 for valid keys, -1e30 padding;
- scores and softmax in float32; ``p`` is normalised, THEN cast to v's
  dtype before the ``p v`` product (float32 accumulation), and the result
  is cast to q's dtype.

A row whose keys are all masked gets uniform weights in the kernel (the
XLA path of the JAX package gives zeros there).  The serving path never
builds such a row: every packed utterance has at least 400 samples.

- :func:`fused_attention` launches ``csrc/attention.cu`` for CUDA tensors
  (head size 128; another raises) and counts the launch in
  ``fused_attention.launches``; for CPU tensors it runs
  :func:`attention_ref`.  There is no other path.
- :func:`attention_ref` is the plain PyTorch version of the same function.
"""

from __future__ import annotations

import ctypes

import torch

from funasr_torch.ops import cuda_build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_SIZE = 128  # the only head size of the models on the ported path


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  key_bias: torch.Tensor, n_head: int) -> torch.Tensor:
    """Plain twin: same inputs and output as :func:`fused_attention`."""
    B, U, D = q.shape
    T = k.shape[1]
    d = D // n_head
    qf = q.reshape(B, U, n_head, d).transpose(1, 2).to(torch.float32)
    kf = k.reshape(B, T, n_head, d).transpose(1, 2).to(torch.float32)
    s = qf @ kf.transpose(-1, -2) + key_bias[:, None, None, :].to(torch.float32)
    p = torch.softmax(s, dim=-1).to(v.dtype).to(torch.float32)
    vf = v.reshape(B, T, n_head, d).transpose(1, 2).to(torch.float32)
    out = (p @ vf).transpose(1, 2).reshape(B, U, D)
    return out.to(q.dtype)


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_bias: torch.Tensor, n_head: int) -> torch.Tensor:
    """q (B, U, H*d), k/v (B, T, H*d), key_bias (B, T) float32 -> (B, U, H*d)
    in q's dtype.  k and v may be column slices of one tensor (any row
    stride, unit column stride)."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, key_bias, n_head)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    B, U, D = q.shape
    T = k.shape[1]
    d = D // n_head
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"fused_attention: q/k/v must share bf16 or float32, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if d != HEAD_SIZE or d * n_head != D:
        raise ValueError(f"fused_attention: head size {D}/{n_head}, the kernel "
                         f"has {HEAD_SIZE}")
    if k.shape != (B, T, D) or v.shape != (B, T, D) or key_bias.shape != (B, T):
        raise ValueError("fused_attention: shape mismatch "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)} "
                         f"{tuple(key_bias.shape)}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("fused_attention: q/k/v need a unit column stride")
    if not all(t.device == q.device for t in (k, v, key_bias)):
        raise ValueError("fused_attention: inputs on different devices")
    bias = key_bias.to(torch.float32).contiguous()
    out = torch.empty((B, U, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 8)(q.stride(0), q.stride(1), k.stride(0),
                                      k.stride(1), v.stride(0), v.stride(1),
                                      out.stride(0), out.stride(1))
    fn = cuda_build.function("attention", "attention_forward", _ARGTYPES)
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                out.data_ptr(), B, U, T, n_head, d, _DTYPES[q.dtype], strides,
                torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(status, "attention kernel launch")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
