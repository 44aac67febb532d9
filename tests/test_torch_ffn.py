"""The bf16/float32 FFN's twin (``funasr_torch/ops/ffn.py`` ``ffn_ref``)
against the TPU kernel ``ffn_pallas.fused_ffn`` (``_ffn_call``) run in
interpret mode on the CPU.

Same float32 weights from a numpy seed; the JAX function takes them in the
flax (K, H) layout, the port in the ``nn.Linear`` (H, K) layout.  float32:
atol 2e-5, the JAX kernel test's bar against its XLA formulation (the sums
run in another order).  bf16: both take bf16 operands with float32
accumulation, but a sum in another order can move the bf16 rounding of a
hidden value and then of an output, so the bar is two bf16 ulps of the
output's magnitude (atol 2^-7 * max|out|) on at most 1 % of the elements.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from funasr_tpu.ops import ffn_pallas as FP
from funasr_torch.ops import ffn as FF
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _case(lead, K, H, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(lead + (K,)).astype(np.float32)
    w1 = (rng.standard_normal((K, H)) * 0.05).astype(np.float32)
    b1 = (rng.standard_normal(H) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((H, N)) * 0.05).astype(np.float32)
    b2 = (rng.standard_normal(N) * 0.1).astype(np.float32)
    return x, w1, b1, w2, b2


def _run(x, w1, b1, w2, b2, dtype):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    j = jnp.asarray
    want = FP.fused_ffn(j(x).astype(jdt), j(w1), j(b1), j(w2), j(b2), interpret=True)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    launches = FF.fused_ffn.launches
    got = FF.fused_ffn(t(x).to(dtype), t(w1.T), t(b1), t(w2.T), t(b2))
    assert FF.fused_ffn.launches == launches  # a CPU tensor takes the twin
    assert got.dtype == dtype and got.shape == x.shape[:-1] + (w2.shape[1],)
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


def test_ffn_float32_matches_pallas_interpret():
    got, want = _run(*_case((2, 128), 512, 1024, 512, seed=2), torch.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("lead,K,H,N", [((256,), 512, 2048, 512), ((2, 64), 256, 512, 384)])
def test_ffn_bf16_matches_pallas_interpret(lead, K, H, N):
    got, want = _run(*_case(lead, K, H, N, seed=K + H), torch.bfloat16)
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -7 * np.abs(want).max())
    assert (got != want).mean() <= 0.01


def test_ffn_ref_is_the_stated_function():
    """float32: relu(x w1^T + b1), then h w2^T + b2, against float64 numpy
    (float32 sums: rtol and atol 1e-5)."""
    x, w1, b1, w2, b2 = _case((64,), 128, 256, 96, seed=4)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got = FF.ffn_ref(t(x), t(w1.T), t(b1), t(w2.T), t(b2)).numpy()
    h = np.maximum(x.astype(np.float64) @ w1 + b1, 0.0)
    want = h @ w2 + b2
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
