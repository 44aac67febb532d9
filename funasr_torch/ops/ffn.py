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

- :func:`fused_ffn` launches ``csrc/ffn.cu`` (one kernel; the hidden
  activations stay on chip, chunk by chunk) for CUDA tensors with the plan
  of :func:`ffn_plan` and counts the launch in ``fused_ffn.launches``; for
  CPU tensors it runs :func:`ffn_ref`.  There is no other path.  No model
  routes it: the JAX package's modules take the fused FFN only in int8
  (sanm.py:329-344), and so does the port.
- :func:`ffn_plan` (band rows, hidden chunk, ring depth, persistent grid,
  shared bytes), :func:`unit_schedule`, :func:`hidden_chunks` and
  :func:`ffn_operands` (the operands' checks) are plain Python, so the CPU
  tests hold them.
  bf16 runs on wgmma: a persistent grid of 64-row bands, the band of x in
  shared memory, 128 hidden columns at a time through shared memory, the
  out accumulators in registers; float32 on the CUDA cores, 16-row blocks,
  256 hidden columns at a time.
- :func:`ffn_ref` is the plain PyTorch version.  It sums in another order
  than the kernel, which can move a bf16 rounding of h: the two agree to a
  stated tolerance, not bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Tuple

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
    cuda_build.refuse_autograd("fused_ffn_int8", x, w)
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
             + [ctypes.c_int] * 7 + [ctypes.c_void_p])

MAX_SMEM = 232448  # dynamic shared memory an H100 block can have
_ALIGN = 1024  # slack for aligning the 128B-swizzled tiles
BK = 128  # bytes of K a TMA box row: one 128-byte swizzle row (64 bf16)
BAND, CHUNK, N_GROUP = 64, 128, 512  # bf16: band rows, hidden chunk, columns a unit
SLOT = 128 * BK  # a ring slot: 128 weight rows
H_BUFS = 3  # h chunk buffers of 64 rows x CHUNK bf16
MIN_STAGES, MAX_STAGES = 4, 12  # ring slots: a warpgroup holds one while it waits 3 on
F32_BAND, F32_CHUNK, F32_N_GROUP = 16, 256, 512  # float32: block rows, chunk, columns
F32_WSTAGE = 128 * 80  # a cp.async weight stage: 128 rows of 64 bytes, padded


class FfnPlan(NamedTuple):
    """How ``csrc/ffn.cu`` runs one (M, K, H, N): units of ``band`` rows of
    x and ``n_group`` output columns, ``chunk`` hidden columns at a time.
    bf16: a persistent grid of ``grid`` blocks walks the ``units``
    (:func:`unit_schedule`), weights stream through a ring of ``stages``
    slots; float32: one block a unit, two cp.async stages.
    ``smem`` is the block's dynamic shared bytes, which the C entry point
    recomputes and checks."""
    band: int
    chunk: int
    n_group: int
    stages: int
    bands: int
    groups: int
    units: int
    grid: int
    smem: int


def bf16_smem(K: int, stages: int) -> int:
    """Shared bytes of the bf16 kernel: the band of x (64 rows x K, in
    128-byte k-blocks), the h buffers, the ring with a full and an empty
    barrier a slot, the band's two barriers and each h buffer's b1."""
    nk = -(-2 * K // BK)
    return (_ALIGN + nk * BAND * BK + H_BUFS * 2 * BAND * BK + stages * (SLOT + 16) + 16
            + H_BUFS * CHUNK * 4)


def f32_smem(K: int) -> int:
    """Shared bytes of the float32 kernel: the block's rows of x and a
    hidden chunk (rows padded by 16 bytes), the out sums, two weight
    stages."""
    return (F32_BAND * (4 * K + 16) + F32_BAND * (4 * F32_CHUNK + 16)
            + F32_BAND * F32_N_GROUP * 4 + 2 * F32_WSTAGE)


@functools.lru_cache(maxsize=256)
def ffn_plan(M: int, K: int, H: int, N: int, dtype: torch.dtype, sms: int) -> FfnPlan:
    """The plan on a card of ``sms`` SMs (an H100 SXM: 132).  bf16: one
    block an SM (its shared memory takes the SM's), at most one a unit.
    The ring takes as many slots (at most 12) as the shared memory holds
    beside the band, the h buffers and the b1 slices: 7 at K = 512.  Raises
    ValueError for a K whose rows do not fit (bf16: K above 896; float32:
    above 2528)."""
    if dtype == torch.float32:
        smem = f32_smem(K)
        if smem > MAX_SMEM:
            raise ValueError(f"fused_ffn: K={K} float32 rows do not fit shared memory")
        bands, groups = -(-M // F32_BAND), -(-N // F32_N_GROUP)
        return FfnPlan(F32_BAND, F32_CHUNK, F32_N_GROUP, 2, bands, groups,
                       bands * groups, bands * groups, smem)
    if dtype != torch.bfloat16:
        raise ValueError(f"fused_ffn: x must be bf16 or float32, got {dtype}")
    stages = min(MAX_STAGES, (MAX_SMEM - bf16_smem(K, 0)) // (SLOT + 16))
    if stages < MIN_STAGES:
        raise ValueError(f"fused_ffn: K={K} bf16 band does not fit shared memory")
    bands, groups = -(-M // BAND), -(-N // N_GROUP)
    units = bands * groups
    return FfnPlan(BAND, CHUNK, N_GROUP, stages, bands, groups, units, min(sms, units),
                   bf16_smem(K, stages))


def unit_schedule(plan: FfnPlan, block: int) -> List[Tuple[int, int]]:
    """The (m0, n0) units that block ``block`` computes, in order: units
    block, block + grid, ...; unit u is band u // groups, column group
    u % groups."""
    return [(u // plan.groups * plan.band, u % plan.groups * plan.n_group)
            for u in range(block, plan.units, plan.grid)]


def hidden_chunks(plan: FfnPlan, H: int) -> List[Tuple[int, int]]:
    """(first hidden column, columns) of each chunk a unit computes, in
    order; the kernel reads zeros past H."""
    return [(h0, min(plan.chunk, H - h0)) for h0 in range(0, H, plan.chunk)]


def ffn_ref(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
            b2: torch.Tensor) -> torch.Tensor:
    """Plain twin: same inputs and output as :func:`fused_ffn`."""
    dt, f32 = x.dtype, torch.float32
    h = torch.relu(x.to(f32) @ w1.to(dt).to(f32).T + b1.to(f32)).to(dt)
    return (h.to(f32) @ w2.to(dt).to(f32).T + b2.to(f32)).to(dt)


def ffn_operands(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The kernel's operands: x as (M, K) rows, the weights in x's dtype,
    the biases float32, all contiguous; b1, which the kernel copies chunk
    by chunk in 16-byte pieces, copied again when its view does not start
    on 16 bytes.  Raises ValueError for a dtype, shapes or devices the
    kernel does not take, K or H not a multiple of 32, or x, w1 or w2 not
    16-byte aligned."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"fused_ffn: x must be bf16 or float32, got {x.dtype}")
    K = x.shape[-1]
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
    if b1.data_ptr() % 16:
        b1 = b1.clone()
    return x2, w1, b1, w2, b2


def fused_ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor) -> torch.Tensor:
    """x (..., K) bf16 or float32, w1 (H, K), b1 (H,), w2 (N, H), b2 (N,)
    -> (..., N) in x's dtype.  On the card the operands must pass
    :func:`ffn_operands`; the plan is :func:`ffn_plan`'s for the card."""
    cuda_build.refuse_autograd("fused_ffn", x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return ffn_ref(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ffn: unsupported device {x.device}")
    x2, w1, b1, w2, b2 = ffn_operands(x, w1, b1, w2, b2)
    (M, K), H, N, index = x2.shape, w1.shape[0], w2.shape[0], x.device.index
    plan = ffn_plan(M, K, H, N, x.dtype, G.sm_count(index))
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    fn = cuda_build.function("ffn", "ffn_forward", _ARGTYPES)
    status = fn(x2.data_ptr(), _DTYPES[x.dtype], w1.data_ptr(), b1.data_ptr(),
                w2.data_ptr(), b2.data_ptr(), out.data_ptr(), M, K, H, N, plan.stages,
                plan.grid, plan.smem, G.stream(index))
    cuda_build.check(status, "FFN kernel launch")
    fused_ffn.launches += 1
    return out.reshape(*x.shape[:-1], N)


fused_ffn.launches = 0
