"""Masked-softmax attention: the CUDA kernels' wrappers and their plain twins.

Three kernels in ``csrc/attention.cu``, one function each here, every one
with a plain PyTorch twin that the wrapper takes for CPU tensors (and only
there) and a launch counter.

:func:`fused_attention` replaces the TPU kernel
funasr_tpu/ops/attention_pallas.py ``_attn_kernel``.  Contract
(attention_pallas.py:37-60, sanm.py:162-163)::

    out[b, :, h, :] = softmax(q[b, :, h, :] @ k[b, :, h, :]^T + key_bias[b]) @ v

- q (B, U, H*d), k/v (B, T, H*d), bf16 or float32, in their natural
  layout; the ``d**-0.5`` scale is already applied to q in its dtype; the
  kernel has instances at head sizes d = 128 (Paraformer-large), d = 64
  (the 256-wide aishell encoders and the SAN decoder, 4 heads) and d = 32
  (CT-Transformer punctuation, D = 256 with 8 heads), ``HEAD_SIZES``;
- key_bias (B, T) float32 additive row: 0 for valid keys, -1e30 padding;
- scores and softmax in float32; ``p`` is normalised, THEN cast to v's
  dtype before the ``p v`` product (float32 accumulation), and the result
  is cast to q's dtype.

With ``alibi_slopes`` (H,) and ``extra`` the float32 instance at d = 64
adds emotion2vec's symmetric ALiBi term to the scores after the key bias,
``-(slope[h] * |u - j|)`` with u, j the query and key positions, zero on
the first ``extra`` rows and columns (funasr_tpu/models/emotion2vec/model.py
:136 ``AltAttention`` with ``symmetric_alibi`` :62 padded for the extra
tokens; XLA there, not a TPU kernel).  The kernel computes the term from
(h, u, j); the twin adds :func:`alibi_bias`.  Its launches count in
``fused_attention.launches_alibi`` alone.

A row whose keys are all masked gets uniform weights in the kernel (the
XLA path of the JAX package gives zeros there).  The serving path never
builds such a row: every packed utterance has at least 400 samples.  On
the H100 the bf16 function is bound by its bytes (about 19 us at the
encoder's B=64 x 15 s shape); the bf16 kernel runs both products on the
tensor cores (mma.sync m16n8k16, q in registers, K and V through a cp.async
ring, p in registers between the two products), so it holds the twin to
the bf16 tolerance, not bit for bit.  The float32 kernel is bound by its
operations: it runs both products on the tensor cores too, as three tf32
products of split operands (x = tf32(x) + tf32(x - tf32(x)); hi hi + hi lo
+ lo hi in float32), which keeps float32 accuracy where one tf32 product
would miss the float32 bar, in one pass over the keys (online softmax, p in
registers); it stops at the last key whose bias is above -1e30, since the
keys past it add exact zeros.  q, k and v rows must be 16-byte aligned at
both dtypes (``ValueError`` otherwise).  Launches count in
``fused_attention.launches`` (and by head size in
``fused_attention.launches_by_head``).

The int8 layers' attention (sanm_layer_pallas.py:118-129,
decoder_layer_pallas.py:101-115) is :func:`attention_f32ctx` with its twin
:func:`attention_f32ctx_ref`: float32 q, k, v (column slices of an int8
projection's output) rounded to bf16 as they are used -- q after the
``q_scale`` multiply in float32, v after its rows past ``v_lengths`` are
zeroed -- bf16 p, and a float32 context.  Its scores, softmax sum and p v
are summed in float64 and its exp is taken in float64, each rounded once to
float32, so the result does not depend on the order of the sums and kernel
and twin agree bit for bit, at each head size of ``EXACT_HEAD_SIZES`` (128,
and 64 for the 256-wide SANM layers).  (The TPU kernel takes bf16 operands with
float32 accumulation; the float64 sums are the port's choice, so that the
card's int8 model can be held to its twins.)  A product of two bf16 values
is exact in float64, so the kernel takes the sums to the float64 tensor
cores (mma.sync m16n8k8 .f64), each value widened once.  The block's
scores stay in shared memory up to ``EXACT_ONCHIP_MAX_T`` keys (at both
head sizes); past it they go to a float32 (rows, H, U, ld) scratch in device
memory, launched on as many batch rows at a time as keep it within
``F32CTX_SCRATCH_BYTES`` (one row at least): :func:`exact_attention_plan`
holds that rule.  Its launches count in ``attention_f32ctx.launches``, and
by head size in ``attention_f32ctx.launches_by_head``.

The SANM layer's attention with int8 scores (sanm_layer_pallas.py:112-117,
``int8_attn``) is :func:`attention_i8qk` with its twin
:func:`attention_i8qk_ref`.  Per head, q times ``q_scale`` and k are
row-quantized ("mul" form, quant.py ``rowquant_kernel``; k is not masked)
inside the kernel, and the scores are ``(float32(q8 k8^T) * qs) * ks^T +
key_bias``, the int8 dot exact (mma.sync m16n8k32 .s8); the softmax and p v
are those of :func:`attention_f32ctx` (float64 exp and sums, bf16 p, bf16 v
zero past ``v_lengths``), so kernel and twin agree bit for bit.  It shares
the scores rule; its launches count in ``attention_i8qk.launches`` (by
head size in ``attention_i8qk.launches_by_head``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from funasr_torch.ops import cuda_build
from funasr_torch.ops import rowquant as RQ

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_SIZES = (32, 64, 128)  # fused_attention's instances (attention.cu launch_forward<D>)
EXACT_HEAD_SIZES = (64, 128)  # the int8 layers' attention (attention.cu launch_exact<HD>)
# The int8 layers' attention keeps a block's 64 rows of float32 scores in
# shared memory for up to this many keys (attention.cu EXACT_ONCHIP_MAX_T);
# past it they go to a device scratch capped at F32CTX_SCRATCH_BYTES a launch.
EXACT_ONCHIP_MAX_T = 704
F32CTX_SCRATCH_BYTES = 1 << 28  # 256 MiB


def exact_scores_ld(T: int) -> int:
    """Row stride of the int8 layers' attention scores: T padded to the
    32-key tile, plus 8 (attention.cu ``scores_ld``)."""
    return -(-T // 32) * 32 + 8


def exact_attention_plan(B: int, H: int, U: int, T: int):
    """How :func:`attention_f32ctx` and :func:`attention_i8qk` launch on B
    batch rows: ``(rows per launch, launches, scratch shape or None)``.  Up
    to ``EXACT_ONCHIP_MAX_T`` keys the scores stay on chip: one launch, no
    scratch.  Past it each launch takes as many rows as keep the float32
    (rows, H, U, ld) scratch within ``F32CTX_SCRATCH_BYTES``, one at least."""
    if T <= EXACT_ONCHIP_MAX_T:
        return B, 1, None
    ld = exact_scores_ld(T)
    rows = min(B, max(1, F32CTX_SCRATCH_BYTES // (4 * H * U * ld)))
    return rows, -(-B // rows), (rows, H, U, ld)


def alibi_bias(slopes: torch.Tensor, U: int, T: int, extra: int = 0) -> torch.Tensor:
    """The (H, U, T) float32 symmetric ALiBi term of the kernel:
    ``-(slopes[h] * |u - j|)``, zero where ``u < extra`` or ``j < extra``."""
    u = torch.arange(U, device=slopes.device)[:, None]
    j = torch.arange(T, device=slopes.device)[None, :]
    dist = (u - j).abs().to(torch.float32)
    term = -(slopes.to(torch.float32)[:, None, None] * dist)
    return torch.where((u >= extra) & (j >= extra), term, torch.zeros_like(term))


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  key_bias: torch.Tensor, n_head: int,
                  alibi_slopes: Optional[torch.Tensor] = None, extra: int = 0) -> torch.Tensor:
    """Plain twin: same inputs and output as :func:`fused_attention`."""
    B, U, D = q.shape
    T = k.shape[1]
    d = D // n_head
    qf = q.reshape(B, U, n_head, d).transpose(1, 2).to(torch.float32)
    kf = k.reshape(B, T, n_head, d).transpose(1, 2).to(torch.float32)
    s = qf @ kf.transpose(-1, -2) + key_bias[:, None, None, :].to(torch.float32)
    if alibi_slopes is not None:
        s = s + alibi_bias(alibi_slopes, U, T, extra)
    p = torch.softmax(s, dim=-1).to(v.dtype).to(torch.float32)
    vf = v.reshape(B, T, n_head, d).transpose(1, 2).to(torch.float32)
    out = (p @ vf).transpose(1, 2).reshape(B, U, D)
    return out.to(q.dtype)


def _exact_softmax_pv(s: torch.Tensor, v: torch.Tensor, n_head: int,
                      v_lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """The int8 layers' softmax and p v on float32 scores s (B, H, U, T):
    exp in float64, the sum and p v in float64, bf16 p and bf16 v (zero past
    ``v_lengths``), float32 (B, U, H*d) out."""
    B, T, D = v.shape
    d, f64 = D // n_head, torch.float64
    if v_lengths is not None:
        v = v * (torch.arange(T, device=v.device)[None, :, None]
                 < v_lengths.to(torch.int64)[:, None, None])
    vb = v.to(torch.bfloat16).reshape(B, T, n_head, d).transpose(1, 2).to(f64)
    e = torch.exp((s - s.amax(-1, keepdim=True)).to(f64)).to(torch.float32)
    p = (e / e.to(f64).sum(-1, keepdim=True).to(torch.float32)).to(torch.bfloat16)
    out = (p.to(f64) @ vb).to(torch.float32)
    return out.transpose(1, 2).reshape(B, s.shape[2], D)


def _heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    B, n, D = x.shape
    return x.reshape(B, n, n_head, D // n_head).transpose(1, 2)


def attention_f32ctx_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         key_bias: torch.Tensor, n_head: int, q_scale: float,
                         v_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin: same inputs and output as :func:`attention_f32ctx`."""
    f64, bf = torch.float64, torch.bfloat16
    qb = _heads((q.to(torch.float32) * q_scale).to(bf), n_head).to(f64)
    kb = _heads(k.to(bf), n_head).to(f64)
    s = (qb @ kb.transpose(-1, -2)).to(torch.float32) + key_bias[:, None, None, :]
    return _exact_softmax_pv(s, v, n_head, v_lengths)


def attention_i8qk_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       key_bias: torch.Tensor, n_head: int, q_scale: float,
                       v_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin: same inputs and output as :func:`attention_i8qk`."""
    q8, qs = RQ.quantize_ref(_heads(q.to(torch.float32) * q_scale, n_head), "mul")
    k8, ks = RQ.quantize_ref(_heads(k.to(torch.float32), n_head), "mul")
    acc = (q8.to(torch.float64) @ k8.to(torch.float64).transpose(-1, -2)).to(torch.float32)
    s = acc * qs[..., None] * ks[..., None, :] + key_bias[:, None, None, :]
    return _exact_softmax_pv(s, v, n_head, v_lengths)


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
_ARGTYPES_ALIBI = ([ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2)
_ARGTYPES_F32CTX = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                    + [ctypes.c_float] + [ctypes.c_void_p] * 2)


def _check_qkv(fn: str, q, k, v, key_bias, n_head, head_sizes):
    B, U, D = q.shape
    T = k.shape[1]
    if D % n_head or D // n_head not in head_sizes:
        raise ValueError(f"{fn}: head size {D}/{n_head}, the kernel has "
                         f"{' and '.join(map(str, head_sizes))}")
    if k.shape != (B, T, D) or v.shape != (B, T, D) or key_bias.shape != (B, T):
        raise ValueError(f"{fn}: shape mismatch {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)} {tuple(key_bias.shape)}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{fn}: q/k/v need a unit column stride")
    if not all(t.device == q.device for t in (k, v, key_bias)):
        raise ValueError(f"{fn}: inputs on different devices")
    return B, U, T, D


def _check_aligned(fn: str, *tensors) -> None:
    """The kernels load 16-byte rows: each tensor's start and its batch and
    row strides (where that dimension has more than one entry) must keep
    every head's row 16-byte aligned."""
    for t in tensors:
        per = 16 // t.element_size()
        (b, n), (sb, sn) = t.shape[:2], t.stride()[:2]
        if t.data_ptr() % 16 or (b > 1 and sb % per) or (n > 1 and sn % per):
            raise ValueError(f"{fn}: q/k/v rows must be 16-byte aligned (strides "
                             f"{tuple(t.stride())}, dtype {t.dtype})")


def _launch_exact(fn_name: str, symbol: str, q, k, v, key_bias, n_head, q_scale,
                  v_lengths) -> torch.Tensor:
    """Launch one of the int8 layers' attention kernels as
    :func:`exact_attention_plan` says; returns the output and the launch
    count."""
    if any(t.dtype != torch.float32 for t in (q, k, v)):
        raise ValueError(f"{fn_name}: q/k/v must be float32")
    B, U, T, D = _check_qkv(fn_name, q, k, v, key_bias, n_head, EXACT_HEAD_SIZES)
    _check_aligned(fn_name, q, k, v)
    bias = key_bias.to(torch.float32).contiguous()
    vlen = None
    if v_lengths is not None:
        if v_lengths.shape != (B,) or v_lengths.device != q.device:
            raise ValueError(f"{fn_name}: v_lengths must be (B,) on q's device")
        vlen = v_lengths.to(torch.int32).contiguous()
    out = torch.empty((B, U, D), dtype=torch.float32, device=q.device)
    rows, launches, scratch_shape = exact_attention_plan(B, n_head, U, T)
    scratch = (None if scratch_shape is None else
               torch.empty(scratch_shape, dtype=torch.float32, device=q.device))
    strides = (ctypes.c_longlong * 8)(q.stride(0), q.stride(1), k.stride(0),
                                      k.stride(1), v.stride(0), v.stride(1),
                                      out.stride(0), out.stride(1))
    fn = cuda_build.function("attention", symbol, _ARGTYPES_F32CTX)
    for b0 in range(0, B, rows):
        b1 = min(B, b0 + rows)
        status = fn(q[b0].data_ptr(), k[b0].data_ptr(), v[b0].data_ptr(),
                    bias[b0].data_ptr(), None if vlen is None else vlen[b0:].data_ptr(),
                    None if scratch is None else scratch.data_ptr(), out[b0].data_ptr(),
                    b1 - b0, U, T, n_head, D // n_head, q_scale, strides,
                    torch.cuda.current_stream(q.device).cuda_stream)
        cuda_build.check(status, f"{fn_name} kernel launch")
    return out, launches


def attention_f32ctx(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     key_bias: torch.Tensor, n_head: int, q_scale: float,
                     v_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """float32 q (B, U, H*d), k/v (B, T, H*d) (any row stride, unit column
    stride), key_bias (B, T) float32, v_lengths None or (B,) -> float32
    (B, U, H*d)."""
    cuda_build.refuse_autograd("attention_f32ctx", q, k, v, key_bias, v_lengths)
    if q.device.type == "cpu":
        return attention_f32ctx_ref(q, k, v, key_bias, n_head, q_scale, v_lengths)
    if q.device.type != "cuda":
        raise ValueError(f"attention_f32ctx: unsupported device {q.device}")
    out, n = _launch_exact("attention_f32ctx", "attention_forward_f32ctx", q, k, v,
                           key_bias, n_head, q_scale, v_lengths)
    attention_f32ctx.launches += n
    attention_f32ctx.launches_by_head[q.shape[-1] // n_head] += n
    return out


attention_f32ctx.launches = 0
attention_f32ctx.launches_by_head = dict.fromkeys(EXACT_HEAD_SIZES, 0)


def attention_i8qk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   key_bias: torch.Tensor, n_head: int, q_scale: float,
                   v_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The arguments and output of :func:`attention_f32ctx`, with int8 q.k
    scores (the SANM layer's ``int8_attn``)."""
    cuda_build.refuse_autograd("attention_i8qk", q, k, v, key_bias, v_lengths)
    if q.device.type == "cpu":
        return attention_i8qk_ref(q, k, v, key_bias, n_head, q_scale, v_lengths)
    if q.device.type != "cuda":
        raise ValueError(f"attention_i8qk: unsupported device {q.device}")
    out, n = _launch_exact("attention_i8qk", "attention_forward_i8qk", q, k, v,
                           key_bias, n_head, q_scale, v_lengths)
    attention_i8qk.launches += n
    attention_i8qk.launches_by_head[q.shape[-1] // n_head] += n
    return out


attention_i8qk.launches = 0
attention_i8qk.launches_by_head = dict.fromkeys(EXACT_HEAD_SIZES, 0)


def _check_alibi(q, n_head, alibi_slopes, extra) -> None:
    if q.dtype != torch.float32 or q.shape[-1] != 64 * n_head:
        raise ValueError(f"fused_attention: ALiBi runs in float32 at head size 64 only, "
                         f"got {q.dtype} at d = {q.shape[-1] / n_head:g}")
    if alibi_slopes.shape != (n_head,) or alibi_slopes.dtype != torch.float32:
        raise ValueError(f"fused_attention: alibi_slopes must be ({n_head},) float32, got "
                         f"{tuple(alibi_slopes.shape)} {alibi_slopes.dtype}")
    if alibi_slopes.device != q.device or extra < 0:
        raise ValueError("fused_attention: alibi_slopes on q's device and extra >= 0")


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_bias: torch.Tensor, n_head: int,
                    alibi_slopes: Optional[torch.Tensor] = None, extra: int = 0) -> torch.Tensor:
    """q (B, U, H*d), k/v (B, T, H*d), key_bias (B, T) float32 -> (B, U, H*d)
    in q's dtype.  k and v may be column slices of one tensor (unit column
    stride; on the card start and row stride 16-byte aligned, ``ValueError``
    otherwise).  ``alibi_slopes`` (H,) float32 adds the symmetric ALiBi term
    ``-(slope[h] |u - j|)`` to every score but those of the first ``extra``
    rows and columns (emotion2vec's AltAttention; float32 at head size 64
    only, ``ValueError`` otherwise, on every device)."""
    cuda_build.refuse_autograd("fused_attention", q, k, v, key_bias, alibi_slopes)
    if alibi_slopes is not None:
        _check_alibi(q, n_head, alibi_slopes, extra)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, key_bias, n_head, alibi_slopes, extra)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"fused_attention: q/k/v must share bf16 or float32, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    B, U, T, D = _check_qkv("fused_attention", q, k, v, key_bias, n_head, HEAD_SIZES)
    _check_aligned("fused_attention", q, k, v)
    bias = key_bias.to(torch.float32).contiguous()
    out = torch.empty((B, U, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 8)(q.stride(0), q.stride(1), k.stride(0),
                                      k.stride(1), v.stride(0), v.stride(1),
                                      out.stride(0), out.stride(1))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if alibi_slopes is not None:
        fn = cuda_build.function("attention", "attention_forward_alibi", _ARGTYPES_ALIBI)
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                    alibi_slopes.contiguous().data_ptr(), int(extra), out.data_ptr(), B, U, T,
                    n_head, D // n_head, strides, stream)
        cuda_build.check(status, "attention (ALiBi) kernel launch")
        fused_attention.launches_alibi += 1
        return out
    fn = cuda_build.function("attention", "attention_forward", _ARGTYPES)
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                out.data_ptr(), B, U, T, n_head, D // n_head, _DTYPES[q.dtype], strides,
                stream)
    cuda_build.check(status, "attention kernel launch")
    fused_attention.launches += 1
    fused_attention.launches_by_head[D // n_head] += 1
    return out


fused_attention.launches = 0
fused_attention.launches_by_head = dict.fromkeys(HEAD_SIZES, 0)  # the same launches by d
fused_attention.launches_alibi = 0  # the ALiBi instance's launches (not in the two above)
