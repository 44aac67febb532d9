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
  quantized in its prologue, the product runs on the wgmma mainloop of
  ``csrc/int8_wgmma.cuh``) for CUDA tensors, with the plan of
  :func:`qmm_plan`, and counts the launch in ``quant_matmul.launches``;
  for CPU tensors it runs :func:`quant_matmul_ref`.  There is no other path.
- :func:`qmm_plan` and :func:`check_args` are plain Python, so the CPU
  tests hold them.
- :func:`quant_matmul_ref` is the plain PyTorch version: ``rowquant_ref``
  ("mul") followed by ``int8_gemm_ref``, bit-equal to the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from funasr_torch.ops import cuda_build
from funasr_torch.ops import int8_gemm as G
from funasr_torch.ops import rowquant as RQ

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_K = 3072  # the kernel keeps a (64, K) int8 band in shared memory


def quant_matmul_ref(x: torch.Tensor, w8: torch.Tensor, sw: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin: same inputs and output as :func:`quant_matmul`."""
    lead, K = x.shape[:-1], x.shape[-1]
    q, sx = RQ.rowquant_ref(x.reshape(-1, K), form="mul")
    out = G.int8_gemm_ref(q, sx, w8, sw, bias=bias,
                          round_bf16=x.dtype == torch.bfloat16, out_dtype=x.dtype)
    return out.reshape(*lead, w8.shape[0])


class QmmPlan(NamedTuple):
    """How ``csrc/qmm.cu`` runs one (M, N, K).  A unit is a band of ``bm``
    rows of x (64 per consumer warpgroup, quantized into shared memory) and
    a run of at most ``per_split`` of the ``bn``-wide N tiles; ``splits``
    runs cover the N tiles.  A persistent grid of ``grid`` blocks (at most
    one per SM) walks the units in the order of :func:`unit_schedule`.
    ``stages`` weight stages of ``G.BK`` bytes of K ride in the ring;
    ``box_w`` is the weights' TMA box (bytes of K, rows); ``smem`` the
    block's dynamic shared bytes, which the C entry point recomputes."""
    bm: int
    bn: int
    stages: int
    bands: int
    tiles_n: int
    splits: int
    per_split: int
    grid: int
    smem: int
    box_w: Tuple[int, int]

    @property
    def units(self) -> int:
        return self.bands * self.splits


def _smem(bm: int, bn: int, stages: int, K: int) -> int:
    """The band (K padded with zeros to whole stages), the weight ring and
    its barriers, the row scales, and each consumer warpgroup's staged
    column scales and bias and its four warps' staging buffers."""
    kp = -(-K // G.BK) * G.BK
    return (1024 + bm * kp + stages * (bn * G.BK + 16) + 4 * bm
            + bm // 64 * (2 * bn * 4 + 4 * G.STAGE_WARP_BYTES))


@functools.lru_cache(maxsize=256)
def qmm_plan(M: int, N: int, K: int, sms: int) -> QmmPlan:
    """qmm's plan on a card with ``sms`` SMs.  The band is 128 rows where
    it leaves room for two weight stages of 128 rows, else 64 rows (up to
    ``MAX_K``).  The weight tiles are 256 rows where the units then still
    fill the card and two stages fit, else 128, or 64 where only those fit
    beside a 64-row band (K = 3072: a 192 KB band).  A short M splits the N
    tiles over units until the card is full."""
    for bm in (128, 64):
        if _smem(bm, 128, 2, K) <= G.MAX_SMEM:
            break
    bands = -(-M // bm)
    fits = [n for n in (256, 128, 64) if _smem(bm, n, 2, K) <= G.MAX_SMEM
            and (n >= 128 or bm == 64)]
    bn = 256 if 256 in fits and bands * -(-N // 256) >= sms else next(
        n for n in fits if n <= 128)
    stages = 2
    while stages < 8 and _smem(bm, bn, stages + 1, K) <= G.MAX_SMEM:
        stages += 1
    tiles_n = -(-N // bn)
    splits = min(tiles_n, max(1, sms // bands))
    per_split = -(-tiles_n // splits)
    splits = -(-tiles_n // per_split)
    return QmmPlan(bm, bn, stages, bands, tiles_n, splits, per_split,
                   min(sms, bands * splits), _smem(bm, bn, stages, K), (G.BK, bn))


def unit_schedule(plan: QmmPlan, block: int) -> List[Tuple[int, List[int]]]:
    """(m0, [n0, ...]) of the units that block ``block`` runs, in order:
    units ``block, block + grid, ...`` (the kernel's loop)."""
    out = []
    for u in range(block, plan.units, plan.grid):
        t0 = u % plan.splits * plan.per_split
        out.append((u // plan.splits * plan.bm,
                    [t * plan.bn for t in range(t0, min(t0 + plan.per_split,
                                                        plan.tiles_n))]))
    return out


def check_args(x: torch.Tensor, w8: torch.Tensor, sw: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> None:
    """Raise ValueError for arguments the kernel does not take; runs on
    tensors of any device (the CPU tests call it directly).  x is the
    (M, K) matrix the kernel reads."""
    K = x.shape[-1]
    N = w8.shape[0]
    if x.dtype not in _DTYPES:
        raise ValueError(f"quant_matmul: x must be bf16 or float32, got {x.dtype}")
    if w8.dtype != torch.int8 or w8.shape != (N, K) or not w8.is_contiguous():
        raise ValueError(f"quant_matmul: need contiguous int8 (N, {K}) weights, got "
                         f"{w8.dtype} {tuple(w8.shape)}")
    if K <= 0 or K % 16 or K > MAX_K:
        raise ValueError(f"quant_matmul: K={K} must be a positive multiple of 16 "
                         f"and <= {MAX_K}")
    if not x.is_contiguous():
        raise ValueError("quant_matmul: x must be contiguous")
    if x.data_ptr() % 16 or w8.data_ptr() % 16:
        raise ValueError("quant_matmul: x and w8 must be 16-byte aligned")
    if sw.shape != (N,) or sw.dtype != torch.float32:
        raise ValueError("quant_matmul: sw must be float32 (N,)")
    if bias is not None and (bias.shape != (N,) or bias.dtype != torch.float32):
        raise ValueError("quant_matmul: bias must be float32 (N,)")
    if not all(t.device == x.device for t in (w8, sw, bias) if t is not None):
        raise ValueError("quant_matmul: inputs on different devices")


_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
             + [ctypes.c_int] * 10 + [ctypes.c_void_p])


def quant_matmul(x: torch.Tensor, w8: torch.Tensor, sw: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., K) bf16 or float32, w8 (N, K) int8, sw (N,) float32, bias
    (N,) float32 holding x-dtype values or None -> (..., N) in x's dtype.
    On the card K must be a multiple of 16 and at most ``MAX_K``."""
    cuda_build.refuse_autograd("quant_matmul", x, w8, sw, bias)
    if x.device.type == "cpu":
        return quant_matmul_ref(x, w8, sw, bias)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: unsupported device {x.device}")
    lead, K = x.shape[:-1], x.shape[-1]
    N = w8.shape[0]
    x2 = x.reshape(-1, K).contiguous()
    check_args(x2, w8, sw, bias)
    sw = sw.contiguous()
    bias = None if bias is None else bias.contiguous()
    M, dev = x2.shape[0], x.get_device()
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    p = qmm_plan(M, N, K, G.sm_count(dev))
    fn = cuda_build.function("qmm", "qmm_forward", _ARGTYPES)
    status = fn(x2.data_ptr(), _DTYPES[x.dtype], w8.data_ptr(), sw.data_ptr(),
                None if bias is None else bias.data_ptr(), out.data_ptr(), M, N, K,
                p.bm, p.bn, p.stages, p.splits, p.per_split, p.grid, p.smem,
                G.stream(dev))
    cuda_build.check(status, "qmm kernel launch")
    quant_matmul.launches += 1
    return out.reshape(*lead, N)


quant_matmul.launches = 0
