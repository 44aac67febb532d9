"""The int8 layers' exact-sum attention (funasr_torch/ops/attention.py).

The CUDA kernels sum their scores and p v on the float64 tensor cores in
another order than the plain twins, and are held bit-equal to them on the
card.  That rests on the sums not depending on their order: a product of two
bf16 values is exact in float64, so permuting the keys, or the head-dim
columns of q and k together, must leave the twins' output bit-equal.  The
rule that decides where the scores live (shared memory, or a row-chunked
device scratch past ``EXACT_ONCHIP_MAX_T`` keys) is checked as a pure
function against hand-worked cases.
"""

import numpy as np
import pytest
import torch

from funasr_torch.ops import attention as A
from funasr_torch.ops.masks import key_bias
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

B, H, d = 2, 2, 128
REFS = {"f32ctx": A.attention_f32ctx_ref, "i8qk": A.attention_i8qk_ref}


def _inputs(seed, U, T, lengths):
    """float32 q, k, v as the int8 layers hand them over, v zero past the
    lengths (the v mask is positional, so it is applied here)."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, n, H * d)).astype(np.float32))
               for n in (U, T, T))
    lens = torch.tensor(lengths)
    v = v * (torch.arange(T)[None, :, None] < lens[:, None, None])
    return q, k, v, key_bias(lens, T)


@pytest.mark.parametrize("name", sorted(REFS))
@pytest.mark.parametrize("U,T,lengths", [(48, 48, [48, 31]), (16, 40, [40, 1])])
def test_key_order_does_not_change_a_bit(name, U, T, lengths):
    ref = REFS[name]
    q, k, v, bias = _inputs(U * T, U, T, lengths)
    perm = torch.from_numpy(np.random.default_rng(T).permutation(T))
    want = ref(q, k, v, bias, H, d ** -0.5)
    got = ref(q, k[:, perm], v[:, perm], bias[:, perm], H, d ** -0.5)
    assert torch.isfinite(want).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", sorted(REFS))
def test_head_dim_order_of_q_and_k_does_not_change_a_bit(name):
    ref = REFS[name]
    U, T = 40, 48
    q, k, v, bias = _inputs(7, U, T, [48, 20])
    perm = np.random.default_rng(1).permutation(d)
    cols = torch.from_numpy(np.concatenate([h * d + perm for h in range(H)]))
    want = ref(q, k, v, bias, H, d ** -0.5)
    got = ref(q[..., cols], k[..., cols], v, bias, H, d ** -0.5)
    assert torch.equal(got, want)


@pytest.mark.parametrize("T,ld", [(1, 40), (32, 40), (33, 72), (250, 264), (256, 264),
                                  (704, 712), (1000, 1032)])
def test_scores_row_stride(T, ld):
    assert A.exact_scores_ld(T) == ld


@pytest.mark.parametrize("Bn,Hn,U,T,want", [
    # scores on chip up to EXACT_ONCHIP_MAX_T keys: one launch, no scratch
    (64, 4, 256, 256, (64, 1, None)),
    (64, 4, 128, 256, (64, 1, None)),
    (2, 4, 704, 704, (2, 1, None)),
    # past it: 256 MiB // (4 H U ld) rows a launch, one at least
    (2, 4, 705, 705, (2, 1, (2, 4, 705, 744))),            # 8,392,320 B a row
    (64, 4, 1000, 1000, (16, 4, (16, 4, 1000, 1032))),     # 16,512,000 B a row
    (3, 4, 3000, 3000, (1, 3, (1, 4, 3000, 3016))),        # 144,768,000 B a row
    (2, 4, 10000, 10000, (1, 2, (1, 4, 10000, 10024))),    # one row is over the cap
])
def test_exact_attention_plan(Bn, Hn, U, T, want):
    assert A.exact_attention_plan(Bn, Hn, U, T) == want


def test_exact_attention_plan_follows_the_scratch_cap(monkeypatch):
    monkeypatch.setattr(A, "F32CTX_SCRATCH_BYTES", 4 * 4 * 40 * 1032)  # one row
    assert A.exact_attention_plan(3, 4, 40, 1000) == (1, 3, (1, 4, 40, 1032))
    assert A.exact_attention_plan(3, 4, 40, 700) == (3, 1, None)  # on chip: no cap


def test_misaligned_rows_are_refused():
    x = torch.zeros((2, 8, 3 * 256))
    A._check_aligned("t", x[..., 256:512], x[..., 512:])  # column slices at 16 B
    with pytest.raises(ValueError):
        A._check_aligned("t", x[..., 1:257])
    with pytest.raises(ValueError):
        A._check_aligned("t", torch.zeros((2, 8, 258))[..., :256])  # row stride 258


def test_cpu_wrappers_are_the_twins_and_launch_nothing():
    q, k, v, bias = _inputs(3, 16, 40, [40, 9])
    lens = torch.tensor([40, 9])
    for name, ref in REFS.items():
        fn = getattr(A, "attention_" + name)
        before = fn.launches
        assert torch.equal(fn(q, k, v, bias, H, d ** -0.5, lens),
                           ref(q, k, v, bias, H, d ** -0.5, lens))
        assert fn.launches == before
