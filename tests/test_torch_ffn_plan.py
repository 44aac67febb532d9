"""The launch plan of the bf16/float32 FFN kernel (``funasr_torch/ops/ffn.py``
``ffn_plan``, ``unit_schedule``, ``hidden_chunks``), the checks of its
operands (``ffn_operands``) and the summation order of ``csrc/ffn.cu``, on
the CPU.

The kernel runs only on the card; what it is launched with is plain Python
and is held here, at the encoder FFN's shape, at ragged shapes (M = 1, 37,
65; H = 544, not a multiple of the 128-column chunk; N = 100 and 1100) and
at H = 8192, which the kernel this one replaced could not launch (its
hidden tile had to fit shared memory): the block's shared memory fits the
H100's 227 KB, the persistent grid computes every output row and column
exactly once and the hidden chunks cover H exactly once.  The operands the
kernel cannot take raise ValueError; a b1 view that does not start on 16
bytes (the kernel copies b1 in 16-byte pieces) is copied to one that does.

A numpy model of the kernel's summation order (bf16: K in one float32 sum
per hidden element, h rounded to bf16, then the out sums taken chunk by
chunk of 128 hidden columns; float32: chunks of 256) sits within
``chip_smoke.FFN_TOL`` times max|twin| of the plain twin ``ffn_ref`` at the
same shapes (the main shape with 2048 of its 16384 rows: the order does not
depend on M).
"""

import numpy as np
import pytest
import torch

from chip_smoke import FFN_TOL
from funasr_torch.ops import ffn as FF
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

SMS = 132  # the H100 SXM
BF16, F32 = torch.bfloat16, torch.float32
# (M, K, H, N): the encoder FFN, ragged M, H and N, and H = 8192
SHAPES = [(16384, 512, 2048, 512), (1, 512, 2048, 512), (37, 256, 512, 100),
          (65, 512, 2048, 512), (65, 512, 544, 512), (300, 512, 8192, 512),
          (130, 256, 512, 1100)]


def _covers(M, K, H, N, dtype):
    p = FF.ffn_plan(M, K, H, N, dtype, SMS)
    assert p.smem <= FF.MAX_SMEM
    assert p.grid >= 1
    count = np.zeros((M, N), np.int32)
    for b in range(p.grid):
        for m0, n0 in FF.unit_schedule(p, b):
            count[m0:m0 + p.band, n0:n0 + p.n_group] += 1
    assert (count == 1).all()
    hidden = np.zeros(H, np.int32)
    for h0, width in FF.hidden_chunks(p, H):
        assert 0 < width <= p.chunk
        hidden[h0:h0 + width] += 1
    assert (hidden == 1).all()
    return p


@pytest.mark.parametrize("M,K,H,N", SHAPES)
def test_bf16_plan_covers_every_output_once(M, K, H, N):
    p = _covers(M, K, H, N, BF16)
    assert (p.band, p.chunk, p.n_group) == (64, 128, 512)
    assert p.grid == min(SMS, p.units)  # persistent: one block an SM, the card full
    assert p.units == -(-M // 64) * -(-N // 512)
    assert FF.MIN_STAGES <= p.stages <= FF.MAX_STAGES
    assert p.smem == FF.bf16_smem(K, p.stages)
    assert p.smem + FF.SLOT + 16 > FF.MAX_SMEM or p.stages == FF.MAX_STAGES  # as deep as fits


@pytest.mark.parametrize("M,K,H,N", SHAPES)
def test_float32_plan_covers_every_output_once(M, K, H, N):
    p = _covers(M, K, H, N, F32)
    assert (p.band, p.chunk, p.n_group, p.stages) == (16, 256, 512, 2)
    assert p.grid == p.units == -(-M // 16) * -(-N // 512)
    assert p.smem == FF.f32_smem(K)


def test_plan_does_not_depend_on_h():
    """The hidden dimension streams through shared memory."""
    main = FF.ffn_plan(16384, 512, 2048, 512, BF16, SMS)
    assert FF.ffn_plan(16384, 512, 8192, 512, BF16, SMS) == main
    assert main.grid == SMS and main.units == 256 and main.stages == 7


def test_plan_refuses_rows_that_do_not_fit():
    with pytest.raises(ValueError, match="does not fit"):
        FF.ffn_plan(64, 4096, 2048, 512, BF16, SMS)
    with pytest.raises(ValueError, match="do not fit"):
        FF.ffn_plan(64, 4096, 2048, 512, F32, SMS)
    with pytest.raises(ValueError, match="bf16 or float32"):
        FF.ffn_plan(64, 512, 2048, 512, torch.float16, SMS)
    assert FF.ffn_plan(64, 896, 2048, 512, BF16, SMS).stages == FF.MIN_STAGES
    with pytest.raises(ValueError, match="does not fit"):
        FF.ffn_plan(64, 928, 2048, 512, BF16, SMS)
    assert FF.ffn_plan(64, 2528, 2048, 512, F32, SMS).smem <= FF.MAX_SMEM
    with pytest.raises(ValueError, match="do not fit"):
        FF.ffn_plan(64, 2560, 2048, 512, F32, SMS)


def _operands(dtype, M=3, K=64, H=96, N=40):
    g = torch.Generator().manual_seed(0)
    return (torch.randn((M, K), generator=g).to(dtype), torch.randn((H, K), generator=g),
            torch.randn(H, generator=g), torch.randn((N, H), generator=g),
            torch.randn(N, generator=g))


def _off(t, dtype=None):
    """t as a view one element into a buffer (2 or 4 bytes off its start)."""
    dtype = dtype or t.dtype
    return torch.empty(t.numel() + 1, dtype=dtype)[1:].view(t.shape).copy_(t)


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_operands_copy_b1_that_does_not_start_on_16_bytes(dtype, offset):
    x, w1, b1, w2, b2 = _operands(dtype)
    b1v = torch.empty(b1.numel() + offset)[offset:].copy_(b1)
    assert b1v.data_ptr() % 16
    x2, w1k, b1k, w2k, b2k = FF.ffn_operands(x, w1, b1v, w2, b2)
    assert all(t.data_ptr() % 16 == 0 for t in (x2, w1k, b1k, w2k))
    assert torch.equal(b1k, b1) and b1k.is_contiguous()
    assert w1k.dtype == w2k.dtype == dtype and b1k.dtype == b2k.dtype == F32
    aligned = FF.ffn_operands(x, w1, b1, w2, b2)[2]
    assert aligned.data_ptr() == b1.data_ptr()  # an aligned b1 is not copied


@pytest.mark.parametrize("bad,match", [
    ("x off 16 bytes", "aligned"),
    ("w1 off 16 bytes", "aligned"),
    ("w2 off 16 bytes", "aligned"),
    ("K not a multiple of 32", "multiples of 32"),
    ("H not a multiple of 32", "multiples of 32"),
    ("float16", "bf16 or float32"),
    ("b2 of another length", "shapes"),
])
def test_operands_refuse_what_the_kernel_cannot_take(bad, match):
    x, w1, b1, w2, b2 = _operands(BF16)
    if bad == "x off 16 bytes":
        x = _off(x)
    elif bad == "w1 off 16 bytes":
        w1 = _off(w1, BF16)
    elif bad == "w2 off 16 bytes":
        w2 = _off(w2, BF16)
    elif bad == "K not a multiple of 32":
        x, w1, b1, w2, b2 = _operands(BF16, K=48)
    elif bad == "H not a multiple of 32":
        x, w1, b1, w2, b2 = _operands(BF16, H=80)
    elif bad == "float16":
        x = x.to(torch.float16)
    else:
        b2 = b2[:-1]
    with pytest.raises(ValueError, match=match):
        FF.ffn_operands(x, w1, b1, w2, b2)


def _bf16(a):
    """float32 -> nearest bf16 (ties to even), as float32."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + (0x7FFF + ((u >> 16) & 1))) & 0xFFFF0000).view(np.float32)


def _kernel_order(x, w1, b1, w2, b2, dtype, chunk):
    """out of the kernel's summation order, in float32 numpy."""
    rnd = _bf16 if dtype == BF16 else (lambda a: a)
    h = rnd(np.maximum(x @ w1.T + b1, np.float32(0)))
    acc = np.zeros((x.shape[0], w2.shape[0]), np.float32)
    for h0 in range(0, h.shape[1], chunk):
        acc += h[:, h0:h0 + chunk] @ w2[:, h0:h0 + chunk].T
    return rnd(acc + b2)


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("M,K,H,N", SHAPES)
def test_kernel_summation_order_within_tolerance(M, K, H, N, dtype):
    M = min(M, 2048)
    rng = np.random.default_rng(M + H + N)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w1 = (rng.standard_normal((H, K)) * K ** -0.5).astype(np.float32)
    w2 = (rng.standard_normal((N, H)) * H ** -0.5).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(H)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(N)).astype(np.float32)
    if dtype == BF16:
        x, w1, w2 = _bf16(x), _bf16(w1), _bf16(w2)
    t = torch.from_numpy
    want = FF.ffn_ref(t(x).to(dtype), t(w1), t(b1), t(w2), t(b2)).float().numpy()
    chunk = FF.ffn_plan(M, K, H, N, dtype, SMS).chunk
    got = _kernel_order(x, w1, b1, w2, b2, dtype, chunk)
    tol = FFN_TOL["bfloat16" if dtype == BF16 else "float32"] * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
