"""The plans and argument rules of the int8 GEMM and qmm kernels
(``funasr_torch/ops/int8_gemm.py`` ``gemm_plan``, ``ops/qmm.py``
``qmm_plan``), on the CPU.

The kernels (``csrc/int8_gemm.cu``, ``csrc/qmm.cu`` on the mainloop of
``csrc/int8_wgmma.cuh``) run only on the card; what they are launched with
is plain Python and is held here: the persistent schedule computes every
output tile exactly once, the grid is at most one block per SM, the block's
shared memory fits the H100's 227 KB, and the TMA boxes are 128-byte rows
of at most 256 rows.  The shapes are those ``chip_smoke.py`` runs on the
card, a tiny one, and random ones from ``hypothesis``.  The wrappers'
argument checks run on CPU tensors and raise on what TMA cannot take.
"""

import pytest
import torch
from hypothesis import given, settings, strategies as st

from funasr_torch.ops import int8_gemm as G
from funasr_torch.ops import qmm as QM
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

SMS = 132  # the H100 SXM
# (M, K, N): chip_smoke.py's GEMM_SHAPES and QMM_SHAPES, and a tiny one
GEMM_SHAPES = [(16384, 560, 1536), (16384, 512, 1536), (16384, 512, 512),
               (16384, 512, 2048), (16384, 2048, 512), (8192, 512, 2048),
               (8192, 2048, 512), (8192, 512, 512), (16384, 512, 1024),
               (8192, 512, 8404), (12256, 256, 2048), (37, 560, 100),
               (1000, 512, 1536), (8192, 16, 512), (300, 512, 512), (37, 16, 8)]
QMM_SHAPES = [(16384, 560, 1536), (8192, 512, 2048), (8192, 512, 8404),
              (1000, 560, 1536), (12256, 256, 2048), (37, 512, 8404),
              (256, 3072, 512), (37, 16, 8), (4096, 3072, 2048), (512, 1280, 512),
              (512, 1296, 512), (512, 2816, 512)]


def _gemm_covers(M, N, K, sms=SMS):
    p = G.gemm_plan(M, N, K, sms)
    seen = [t for b in range(p.grid) for t in G.tile_schedule(p, b)]
    want = {(m, n) for m in range(0, M, p.bm) for n in range(0, N, p.bn)}
    assert len(seen) == len(set(seen)) == p.tiles
    assert set(seen) == want
    assert 1 <= p.grid <= sms
    assert p.smem <= G.MAX_SMEM
    assert p.smem == 1024 + p.stages * ((p.bm + p.bn) * G.BK + 16) + 2 * (8 * p.bn + 10240)
    assert 2 <= p.stages <= 8 and p.bn in (128, 256) and p.bm == 128
    for inner, rows in (p.box_a, p.box_b):
        assert inner == 128 and rows <= 256
    return p


def _qmm_covers(M, N, K, sms=SMS):
    p = QM.qmm_plan(M, N, K, sms)
    seen = [(m0, n0) for b in range(p.grid) for m0, ns in QM.unit_schedule(p, b)
            for n0 in ns]
    want = {(m, n) for m in range(0, M, p.bm) for n in range(0, N, p.bn)}
    assert len(seen) == len(set(seen)) and set(seen) == want
    assert 1 <= p.grid <= sms and p.grid <= p.units
    assert p.smem <= G.MAX_SMEM
    kp = -(-K // 128) * 128
    assert p.smem == (1024 + p.bm * kp + p.stages * (p.bn * 128 + 16) + 4 * p.bm
                      + p.bm // 64 * (8 * p.bn + 10240))
    assert 2 <= p.stages <= 8 and p.bm in (64, 128)
    assert p.bn in (128, 256) or (p.bn == 64 and p.bm == 64)
    assert p.splits * p.per_split >= p.tiles_n
    inner, rows = p.box_w
    assert inner == 128 and rows <= 256
    return p


@pytest.mark.parametrize("M,K,N", GEMM_SHAPES)
def test_gemm_plan_covers_every_tile_once(M, K, N):
    p = _gemm_covers(M, N, K)
    if p.tiles >= SMS:
        assert p.grid == SMS  # the card is full


@pytest.mark.parametrize("M,K,N", QMM_SHAPES)
def test_qmm_plan_covers_every_tile_once(M, K, N):
    p = _qmm_covers(M, N, K)
    assert p.bm == (128 if K <= 1280 else 64)


@settings(max_examples=60, deadline=None)
@given(M=st.integers(1, 40000), N=st.integers(1, 9000), k16=st.integers(1, 192),
       sms=st.sampled_from([1, 7, 114, 132]))
def test_plans_random_shapes(M, N, k16, sms):
    _gemm_covers(M, N, 16 * k16, sms)
    _qmm_covers(M, N, 16 * k16, sms)


def test_qmm_plan_splits_short_m():
    """37 rows: the N tiles spread over the card rather than one block."""
    p = QM.qmm_plan(37, 8404, 512, SMS)
    assert p.bands == 1 and p.grid == p.splits == p.tiles_n > 32


def _gemm_args(M=64, K=32, N=48, **kw):
    a = torch.zeros((M, K), dtype=torch.int8)
    b = torch.zeros((N, K), dtype=torch.int8)
    args = dict(a=a, sa=torch.ones(M), b=b, sb=torch.ones(N))
    args.update(kw)
    return args


def _offset(shape, dtype=torch.int8):
    """A contiguous tensor whose base is one element past an aligned one."""
    n = 1
    for s in shape:
        n *= s
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


def test_gemm_check_args_accepts_served_operands():
    G.check_args(**_gemm_args())
    G.check_args(**_gemm_args(res=torch.zeros(64, 48, dtype=torch.bfloat16),
                              add=torch.zeros(64, 48), bias=torch.zeros(48)),
                 out_dtype=torch.bfloat16)


def test_gemm_check_args_returns_the_shape():
    """The wrapper takes (M, N, K) and the device from the check it runs
    anyway, instead of reading them again."""
    assert G.check_args(**_gemm_args()) == (64, 48, 32, -1)
    assert G.check_args(**_gemm_args(M=37, K=560, N=100, bias=torch.zeros(100))) \
        == (37, 100, 560, -1)


@pytest.mark.parametrize("bad", ["k_not_16", "misaligned_a", "misaligned_b",
                                 "non_contiguous", "wrong_dtype", "res_shape",
                                 "out_dtype"])
def test_gemm_check_args_raises(bad):
    kw = {"k_not_16": dict(a=torch.zeros(64, 40, dtype=torch.int8),
                           b=torch.zeros(48, 40, dtype=torch.int8)),
          "misaligned_a": dict(a=_offset((64, 32))),
          "misaligned_b": dict(b=_offset((48, 32))),
          "non_contiguous": dict(a=torch.zeros(32, 64, dtype=torch.int8).T),
          "wrong_dtype": dict(a=torch.zeros(64, 32, dtype=torch.uint8)),
          "res_shape": dict(res=torch.zeros(64, 47))}.get(bad, {})
    out = torch.float16 if bad == "out_dtype" else torch.float32
    with pytest.raises(ValueError):
        G.check_args(**_gemm_args(**kw), out_dtype=out)


def test_qmm_check_args_accepts_served_operands():
    QM.check_args(torch.zeros(37, 560, dtype=torch.bfloat16),
                  torch.zeros(100, 560, dtype=torch.int8), torch.ones(100),
                  torch.zeros(100))
    QM.check_args(torch.zeros(8, QM.MAX_K), torch.zeros(16, QM.MAX_K, dtype=torch.int8),
                  torch.ones(16))


@pytest.mark.parametrize("bad", ["k_not_16", "k_over_max", "misaligned_x",
                                 "misaligned_w", "non_contiguous", "x_dtype"])
def test_qmm_check_args_raises(bad):
    K = {"k_not_16": 40, "k_over_max": QM.MAX_K + 16}.get(bad, 64)
    x = torch.zeros(8, K, dtype=torch.bfloat16)
    w = torch.zeros(16, K, dtype=torch.int8)
    if bad == "misaligned_x":
        x = _offset((8, K), torch.bfloat16)
    elif bad == "misaligned_w":
        w = _offset((16, K))
    elif bad == "non_contiguous":
        x = torch.zeros(K, 8, dtype=torch.bfloat16).T
    elif bad == "x_dtype":
        x = x.to(torch.float16)
    with pytest.raises(ValueError):
        QM.check_args(x, w, torch.ones(16))
