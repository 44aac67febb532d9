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

- :func:`int8_gemm` launches ``csrc/int8_gemm.cu`` (the wgmma mainloop of
  ``csrc/int8_wgmma.cuh``) for CUDA tensors, with the plan of
  :func:`gemm_plan`, and counts the launch in ``int8_gemm.launches``; for
  CPU tensors it runs :func:`int8_gemm_ref`.  There is no other path.
- :func:`gemm_plan` (tile width, ring depth, persistent grid, shared bytes)
  and :func:`check_args` are plain Python, so the CPU tests hold them.
- :func:`int8_gemm_ref` is the plain PyTorch version.  It forms ``acc`` in
  float64, which is exact (|acc| <= 127^2 K < 2^53), converts it to
  float32 as the kernel's ``cvt.rn`` does, and applies the same float32
  steps in the same order, so kernel and twin agree bit for bit.

The row-quantizing entry is the SANM layer's ctx -> wout contraction in
one launch: ``int8_gemm_rq(x, w8, sw, Fsmn(v, lengths, taps, left), bias,
res)`` takes the float32 rows x and quantizes them in the kernel's A
producer (``csrc/int8_wgmma.cuh`` ``quantize_rows``, as ``rowquant(x,
form="mul")``), and computes the layer's FSMN memory of v in the epilogue,
where ``add`` would take it (``ops/fsmn.py`` ``fsmn_ref``'s contract).

- :func:`int8_gemm_rq` launches ``csrc/int8_gemm.cu``
  ``int8_gemm_rq_forward`` for CUDA tensors with the plan of
  :func:`rq_plan` and counts the launch in ``int8_gemm_rq.launches``; for
  CPU tensors it runs :func:`int8_gemm_rq_ref`.  There is no other path.
- :func:`rq_plan` (ring depth, N splits, persistent grid, shared bytes),
  :func:`rq_schedule` and :func:`check_rq_args` are plain Python.
- :func:`int8_gemm_rq_ref` is ``rowquant_ref`` ("mul"), ``fsmn_ref`` for
  the memory, then :func:`int8_gemm_ref`: the building blocks' twins.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import List, NamedTuple, Optional, Tuple

import torch

from funasr_torch.ops import cuda_build
from funasr_torch.ops import fsmn as FS
from funasr_torch.ops import rowquant as RQ

_OUT = {torch.float32: 0, torch.bfloat16: 1}
_I8, _F32, _BF16 = torch.int8, torch.float32, torch.bfloat16


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


MAX_SMEM = 232448  # dynamic shared memory an H100 block can have
BK = 128  # bytes of K per stage: one 128-byte swizzle row
STAGE_WARP_BYTES = 16 * 40 * 4  # a consumer warp's epilogue staging buffer
_ALIGN = 1024  # slack for aligning the ring to the 128B swizzle


class GemmPlan(NamedTuple):
    """How ``csrc/int8_gemm.cu`` runs one (M, N, K): 128 x ``bn`` output
    tiles, a ring of ``stages`` K stages of ``BK`` bytes, and a persistent
    grid of ``grid`` blocks (at most one per SM) walking the ``tiles`` in
    the order of :func:`tile_schedule`.  ``box_a`` and ``box_b`` are the
    TMA boxes (bytes of K, rows); ``smem`` the block's dynamic shared
    bytes, which the C entry point recomputes and checks."""
    bm: int
    bn: int
    stages: int
    tiles_m: int
    tiles_n: int
    grid: int
    smem: int
    box_a: Tuple[int, int]
    box_b: Tuple[int, int]

    @property
    def tiles(self) -> int:
        return self.tiles_m * self.tiles_n


@functools.lru_cache(maxsize=256)
def gemm_plan(M: int, N: int, K: int, sms: int) -> GemmPlan:
    """The int8 GEMM's plan on a card with ``sms`` SMs.  BN = 256 halves
    the A traffic per output and the tile count; BN = 128 where 256-wide
    tiles would leave SMs idle.  The ring takes as many stages (at most
    8) as the shared memory holds beside the epilogue's staging (column
    scales and bias, a 2.5 KB buffer per consumer warp): 4 of 48 KB at
    BN = 256, 6 of 32 KB at BN = 128."""
    bm = 128
    tiles_m = -(-M // bm)
    bn = 256 if tiles_m * -(-N // 256) >= sms else 128
    stage = (bm + bn) * BK + 16  # A and B tiles and the stage's two barriers
    # each consumer warpgroup's column scales and bias, each warp's staging
    cols = 2 * (2 * bn * 4 + 4 * STAGE_WARP_BYTES)
    stages = min(8, (MAX_SMEM - _ALIGN - cols) // stage)
    tiles_n = -(-N // bn)
    return GemmPlan(bm, bn, stages, tiles_m, tiles_n, min(sms, tiles_m * tiles_n),
                    _ALIGN + stages * stage + cols, (BK, bm), (BK, bn))


def tile_schedule(plan: GemmPlan, block: int) -> List[Tuple[int, int]]:
    """The (m0, n0) output tiles that block ``block`` of the persistent grid
    computes, in order: tiles ``block, block + grid, ...``, N fastest inside
    each band of ``bm`` rows (the kernel's loop)."""
    return [(t // plan.tiles_n * plan.bm, t % plan.tiles_n * plan.bn)
            for t in range(block, plan.tiles, plan.grid)]


def stream(device: int) -> int:
    """The raw handle of device ``device``'s current PyTorch stream (one C
    call: at small shapes the wrappers' host time is on the critical
    path)."""
    return torch._C._cuda_getCurrentRawStream(device)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """SMs of CUDA device ``index``, read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_args(a: torch.Tensor, sa: torch.Tensor, b: torch.Tensor,
               sb: torch.Tensor, bias: Optional[torch.Tensor] = None,
               res: Optional[torch.Tensor] = None,
               add: Optional[torch.Tensor] = None,
               out_dtype: torch.dtype = torch.float32) -> Tuple[int, int, int, int]:
    """Raise ValueError for arguments the kernel does not take; runs on
    tensors of any device (the CPU tests call it directly).  TMA's rules
    for the int8 operands: (M, K) and (N, K), K a multiple of 16 (the
    16-byte row stride), contiguous, 16-byte aligned bases.  Returns (M, N,
    K) and a's device index.  Kept lean: the wrapper runs it at every
    launch, and at the decoder's shapes its host time sets the pace."""
    if a.dtype != _I8 or b.dtype != _I8 or a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"int8_gemm: need int8 (M, K) x (N, K), got {a.dtype} "
                         f"{tuple(a.shape)} x {b.dtype} {tuple(b.shape)}")
    M, K = a.shape
    N, Kb = b.shape
    if Kb != K or K <= 0 or K % 16:
        raise ValueError(f"int8_gemm: K={K} (b: {Kb}) must be a positive multiple of 16")
    if not (a.is_contiguous() and b.is_contiguous()) or (a.data_ptr() | b.data_ptr()) % 16:
        raise ValueError("int8_gemm: a and b must be contiguous and 16-byte aligned")
    if out_dtype not in _OUT:
        raise ValueError(f"int8_gemm: unsupported output dtype {out_dtype}")
    if sa.dtype != _F32 or sb.dtype != _F32 or sa.shape != (M,) or sb.shape != (N,):
        raise ValueError("int8_gemm: scales must be float32 (M,) and (N,)")
    dev = a.get_device()
    same = sa.get_device() == dev and b.get_device() == dev and sb.get_device() == dev
    if bias is not None:
        if bias.dtype != _F32 or bias.shape != (N,):
            raise ValueError("int8_gemm: bias must be float32 (N,)")
        same = same and bias.get_device() == dev
    if res is not None:
        if res.dtype not in _OUT or res.shape != (M, N) or res.stride(1) != 1:
            raise ValueError("int8_gemm: res must be float32 or bf16 (M, N) with a unit "
                             "column stride")
        same = same and res.get_device() == dev
    if add is not None:
        if add.dtype != _F32 or add.shape != (M, N) or add.stride(1) != 1:
            raise ValueError("int8_gemm: add must be float32 (M, N) with a unit column "
                             "stride")
        same = same and add.get_device() == dev
    if not same:
        raise ValueError("int8_gemm: inputs on different devices")
    return M, N, K, dev


# int8_gemm_forward's 23 arguments packed as int64 in its order, null
# pointers as 0: one bytes argument for ctypes to convert instead of 23
_PACK = struct.Struct("23q").pack
_ARGTYPES = [ctypes.c_char_p]


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def int8_gemm(a: torch.Tensor, sa: torch.Tensor, b: torch.Tensor,
              sb: torch.Tensor, bias: Optional[torch.Tensor] = None,
              relu: bool = False, res: Optional[torch.Tensor] = None,
              add: Optional[torch.Tensor] = None, round_bf16: bool = False,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """a int8 (M, K), sa (M,) float32, b int8 (N, K), sb (N,) float32 ->
    (M, N) in ``out_dtype``.  res and add are (M, N) with a unit column
    stride; on the card K must be a multiple of 16 and a, b contiguous and
    16-byte aligned (:func:`check_args`).  On the card, where N is not a
    multiple of 4 the result is a view of rows padded to one, so that the
    epilogue keeps its 4-wide stores (at an odd row stride every store is
    scalar: SenseVoice's ``ctc_lo``, N = 25055).

    At the decoder's shapes a launch takes about as long on the host as on
    the card, so the card's path does each step once: one check that also
    returns the shape, no copy of a contiguous vector, and no view where N
    is a multiple of 4."""
    cuda_build.refuse_autograd("int8_gemm", a, sa, b, sb, bias, res, add)
    if not a.is_cuda:
        if a.device.type == "cpu":
            return int8_gemm_ref(a, sa, b, sb, bias, relu, res, add, round_bf16,
                                 out_dtype)
        raise ValueError(f"int8_gemm: unsupported device {a.device}")
    M, N, K, dev = check_args(a, sa, b, sb, bias, res, add, out_dtype)
    if sa.stride(0) != 1:
        sa = sa.contiguous()
    if sb.stride(0) != 1:
        sb = sb.contiguous()
    if bias is not None and bias.stride(0) != 1:
        bias = bias.contiguous()
    if N % 4:
        ld = N + 4 - N % 4
        out = a.new_empty((M, ld), dtype=out_dtype)[:, :N]
    else:
        ld = N
        out = a.new_empty((M, N), dtype=out_dtype)
    plan = gemm_plan(M, N, K, sm_count(dev))
    fn = _FORWARD or _bind()
    status = fn(_PACK(a.data_ptr(), b.data_ptr(), M, N, K, sa.data_ptr(), sb.data_ptr(),
                      0 if bias is None else bias.data_ptr(),
                      0 if res is None else res.data_ptr(),
                      0 if res is None else res.stride(0),
                      0 if res is None else int(res.dtype == _BF16),
                      0 if add is None else add.data_ptr(),
                      0 if add is None else add.stride(0), int(relu), int(round_bf16),
                      out.data_ptr(), ld, _OUT[out_dtype], plan.bn, plan.stages, plan.grid,
                      plan.smem, stream(dev)))
    if status:
        cuda_build.check(status, "int8 GEMM kernel launch")
    int8_gemm.launches += 1
    return out


_FORWARD = None


def _bind():
    """int8_gemm_forward, bound once (the library is built on first use)."""
    global _FORWARD
    _FORWARD = cuda_build.function("int8_gemm", "int8_gemm_forward", _ARGTYPES)
    return _FORWARD


int8_gemm.launches = 0


# ------------------------------------------------ the row-quantizing entry

RQ_BM = RQ_BN = 128  # the band's rows (64 a consumer warpgroup) and the N tile
MAX_TAPS = 17  # FSMN taps: the halo rows staged beside an epilogue's tile
RQ_MAX_K = 640  # the widest band that fits beside two stages and the staged v


class Fsmn(NamedTuple):
    """The SANM layer's FSMN memory as the epilogue's addend: ``v`` (B, T,
    N) float32 with a unit column stride (the v third of the QKV output),
    ``lengths`` (B,) valid frames, ``taps`` (K, N) float32, ``left`` the
    padding before the frame (``ops/fsmn.py``)."""
    v: torch.Tensor
    lengths: torch.Tensor
    taps: torch.Tensor
    left: int


def int8_gemm_rq_ref(x: torch.Tensor, w8: torch.Tensor, sw: torch.Tensor, fsmn: Fsmn,
                     bias: Optional[torch.Tensor] = None,
                     res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin: same inputs and output as :func:`int8_gemm_rq`."""
    q, sx = RQ.rowquant_ref(x, form="mul")
    mem = FS.fsmn_ref(fsmn.v, fsmn.lengths, fsmn.taps, fsmn.left).reshape(x.shape[0], -1)
    return int8_gemm_ref(q, sx, w8, sw, bias, res=res, add=mem)


class RqPlan(NamedTuple):
    """How ``int8_gemm_rq_forward`` runs one (M, N, K).  A unit is a band
    of ``RQ_BM`` rows of x (quantized into shared memory) and a run of at
    most ``per_split`` of the ``RQ_BN``-wide N tiles; ``splits`` runs cover
    the N tiles.  A persistent grid of ``grid`` blocks (at most one per SM)
    walks the units in the order of :func:`rq_schedule`.  ``stages``
    weight stages of ``BK`` bytes of K ride in the ring; ``smem`` is the
    block's dynamic shared bytes, which the C entry point recomputes."""
    stages: int
    bands: int
    tiles_n: int
    splits: int
    per_split: int
    grid: int
    smem: int

    @property
    def units(self) -> int:
        return self.bands * self.splits


def rq_smem(stages: int, K: int) -> int:
    """The band (K padded with zeros to whole stages), the weight ring and
    its barriers, the row scales, and each consumer warpgroup's staged
    column scales and bias, its four warps' staging buffers and its tile of
    v with the halo (64 + MAX_TAPS - 1 rows)."""
    kp = -(-K // BK) * BK
    per_wg = 2 * RQ_BN * 4 + 4 * STAGE_WARP_BYTES + (64 + MAX_TAPS - 1) * RQ_BN * 4
    return _ALIGN + RQ_BM * kp + stages * (RQ_BN * BK + 16) + 4 * RQ_BM + 2 * per_wg


@functools.lru_cache(maxsize=256)
def rq_plan(M: int, N: int, K: int, sms: int) -> RqPlan:
    """The row-quantizing entry's plan on a card with ``sms`` SMs (K at
    most ``RQ_MAX_K``): as many ring stages (at most 8) as fit beside the
    band; a short M splits the N tiles over units until the card is
    full."""
    stages = 2
    while stages < 8 and rq_smem(stages + 1, K) <= MAX_SMEM:
        stages += 1
    bands, tiles_n = -(-M // RQ_BM), -(-N // RQ_BN)
    splits = min(tiles_n, max(1, sms // bands))
    per_split = -(-tiles_n // splits)
    splits = -(-tiles_n // per_split)
    return RqPlan(stages, bands, tiles_n, splits, per_split, min(sms, bands * splits),
                  rq_smem(stages, K))


def rq_schedule(plan: RqPlan, block: int) -> List[Tuple[int, List[int]]]:
    """(m0, [n0, ...]) of the units that block ``block`` runs, in the
    kernel's order: units ``block, block + grid, ...``, unit u starting at
    its tile u mod its count (so the SMs do not all write the same columns
    at once)."""
    out = []
    for u in range(block, plan.units, plan.grid):
        t0 = u % plan.splits * plan.per_split
        nt = min(t0 + plan.per_split, plan.tiles_n) - t0
        out.append((u // plan.splits * RQ_BM,
                    [(t0 + (i + u) % nt) * RQ_BN for i in range(nt)]))
    return out


def fsmn_rows(T: int, left: int, n_taps: int, m0: int, rows: int = 64,
              M: Optional[int] = None) -> List[List[Tuple[int, int, int]]]:
    """The FSMN epilogue's row mapping, as ``csrc/int8_gemm.cu``
    ``fsmn_stage`` / ``fsmn_mem`` address a warpgroup's tile of ``rows``
    output rows from ``m0``: for each output row m < M, the (staged row,
    source row m', t') it adds for j = 0 .. n_taps - 1 (m' = m + j - left,
    t' its frame), the taps whose frame t' lies inside the utterance only.
    The staged tile holds v rows m0 - left .. m0 + rows - 1 + n_taps - 1 -
    left, so staged row r is global row m0 - left + r."""
    out = []
    for m in range(m0, m0 + rows):
        if M is not None and m >= M:
            break
        b, t = divmod(m, T)
        taps = []
        for j in range(n_taps):
            s = t + j - left
            if 0 <= s < T:
                taps.append((m - m0 + j, b * T + s, s))
        out.append(taps)
    return out


def check_rq_args(x: torch.Tensor, w8: torch.Tensor, sw: torch.Tensor, fsmn: Fsmn,
                  bias: Optional[torch.Tensor] = None,
                  res: Optional[torch.Tensor] = None) -> None:
    """Raise ValueError for arguments the row-quantizing entry does not
    take; runs on tensors of any device (the CPU tests call it).  x is
    float32 (M, K), K a positive multiple of 16 and at most ``RQ_MAX_K``,
    with 16-byte aligned rows of a unit column stride; w8 int8 (N, K)
    contiguous and 16-byte aligned; bias and res as :func:`check_args`;
    the FSMN's v float32 (B, T, N) with B * T = M, 16-byte aligned rows of
    one stride, at most ``MAX_TAPS`` taps."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"int8_gemm_rq: x must be float32 (M, K), got {x.dtype} "
                         f"{tuple(x.shape)}")
    (M, K), N = x.shape, w8.shape[0]
    if K <= 0 or K % 16 or K > RQ_MAX_K:
        raise ValueError(f"int8_gemm_rq: K={K} must be a positive multiple of 16 and "
                         f"<= {RQ_MAX_K}")
    if x.stride(1) != 1 or x.data_ptr() % 16 or x.stride(0) % 4:
        raise ValueError("int8_gemm_rq: x needs a unit column stride and 16-byte aligned rows")
    if w8.dtype != torch.int8 or w8.shape != (N, K) or not w8.is_contiguous() \
            or w8.data_ptr() % 16:
        raise ValueError(f"int8_gemm_rq: need contiguous 16-byte aligned int8 (N, {K}) "
                         f"weights, got {w8.dtype} {tuple(w8.shape)}")
    if sw.dtype != torch.float32 or sw.shape != (N,):
        raise ValueError("int8_gemm_rq: sw must be float32 (N,)")
    if bias is not None and (bias.dtype != torch.float32 or bias.shape != (N,)):
        raise ValueError("int8_gemm_rq: bias must be float32 (N,)")
    if res is not None and (res.dtype not in _OUT or res.shape != (M, N)
                            or res.stride(1) != 1):
        raise ValueError("int8_gemm_rq: res must be float32 or bf16 (M, N) with a unit "
                         "column stride")
    v, lengths, taps, left = fsmn
    n_taps = taps.shape[0]
    if v.dim() != 3 or v.dtype != torch.float32 or v.shape[2] != N \
            or v.shape[0] * v.shape[1] != M or v.stride(2) != 1 \
            or v.stride(0) != v.shape[1] * v.stride(1):
        raise ValueError(f"int8_gemm_rq: FSMN v must be float32 (B, T, {N}), B * T = "
                         f"{M}, rows of one stride, got {tuple(v.shape)} {v.stride()}")
    if taps.dtype != torch.float32 or taps.shape != (n_taps, N) \
            or not 1 <= n_taps <= MAX_TAPS or not 0 <= left < n_taps:
        raise ValueError(f"int8_gemm_rq: FSMN taps must be float32 (K, {N}), "
                         f"K <= {MAX_TAPS}, 0 <= left < K")
    if lengths.shape != (v.shape[0],):
        raise ValueError(f"int8_gemm_rq: FSMN lengths must be ({v.shape[0]},)")
    if N % 4 or v.stride(1) % 4 or v.data_ptr() % 16:
        raise ValueError("int8_gemm_rq: the FSMN epilogue copies v in 16-byte pieces: "
                         "N and v's row stride multiples of 4, v 16-byte aligned")
    dev = x.get_device()
    for t in (w8, sw, bias, res, v, lengths, taps):
        if t is not None and t.get_device() != dev:
            raise ValueError("int8_gemm_rq: inputs on different devices")


_RQ_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p] + [ctypes.c_int] * 3
                + [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                                           ctypes.c_longlong] + [ctypes.c_void_p] * 2
                + [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_longlong]
                + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def int8_gemm_rq(x: torch.Tensor, w8: torch.Tensor, sw: torch.Tensor, fsmn: Fsmn,
                 bias: Optional[torch.Tensor] = None,
                 res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x float32 (M, K), w8 int8 (N, K), sw (N,) float32 -> (M, N) float32:
    the rows of x quantized in the "mul" form, then :func:`int8_gemm`'s
    epilogue with ``res``, ``bias`` and the FSMN memory of ``fsmn`` where
    ``add`` would be.  On the card: :func:`check_rq_args`."""
    cuda_build.refuse_autograd("int8_gemm_rq", x, w8, sw, fsmn, bias, res)
    if x.device.type == "cpu":
        return int8_gemm_rq_ref(x, w8, sw, fsmn, bias, res)
    if x.device.type != "cuda":
        raise ValueError(f"int8_gemm_rq: unsupported device {x.device}")
    check_rq_args(x, w8, sw, fsmn, bias, res)
    (M, K), N = x.shape, w8.shape[0]
    dev = x.get_device()
    plan = rq_plan(M, N, K, sm_count(dev))
    sw = sw.contiguous()
    bias = None if bias is None else bias.contiguous()
    lens = fsmn.lengths.to(torch.int32).contiguous()
    taps = fsmn.taps.contiguous()
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    fn = cuda_build.function("int8_gemm", "int8_gemm_rq_forward", _RQ_ARGTYPES)
    status = fn(x.data_ptr(), x.stride(0), w8.data_ptr(), M, N, K, sw.data_ptr(), _ptr(bias),
                _ptr(res), 0 if res is None else res.stride(0),
                int(res is not None and res.dtype == torch.bfloat16), fsmn.v.data_ptr(),
                fsmn.v.stride(1), lens.data_ptr(), taps.data_ptr(), fsmn.v.shape[1],
                taps.shape[0], fsmn.left, out.data_ptr(), N, plan.stages, plan.splits,
                plan.per_split, plan.grid, plan.smem, stream(dev))
    cuda_build.check(status, "row-quantizing int8 GEMM kernel launch")
    int8_gemm_rq.launches += 1
    return out


int8_gemm_rq.launches = 0
