"""``ffn_int8_ref`` (funasr_torch/ops/ffn.py) against the TPU kernel
``ffn_pallas._ffn_call_int8`` run in interpret mode on the CPU.

Same float32 weights from a numpy seed on both sides; the port's int8
weights and scales are bit-exact against the JAX ``quantize_rows``.  The
activation quantize, the int32 accumulators and the epilogues are the same
float32 operations, so the bf16 outputs agree bit for bit except where
XLA fuses an epilogue multiply-add differently: at most one bf16 ulp of the
output's magnitude (atol 2^-7 * max|out|) on at most 1 % of the elements.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from funasr_tpu.ops import ffn_pallas as FP
from funasr_tpu.ops.quant import quantize_rows
from funasr_torch.ops import ffn as FF
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _case(M, K, H, N, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((M, K)) * 2).astype(np.float32)
    x[5] = 0.0  # a padding row
    w1 = (rng.standard_normal((K, H)) / np.sqrt(K)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(H)).astype(np.float32)
    w2 = (rng.standard_normal((H, N)) / np.sqrt(H)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(N)).astype(np.float32)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("M,K,H,N", [(256, 256, 512, 256), (128, 128, 256, 384)])
def test_ffn_int8_ref_matches_pallas_interpret(M, K, H, N):
    x, w1, b1, w2, b2 = _case(M, K, H, N, seed=M + H)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    w1q, s1 = quantize_rows(jnp.asarray(w1), axis=0)
    w2q, s2 = quantize_rows(jnp.asarray(w2), axis=0)
    want = FP._ffn_call_int8(xb, w1q, s1, jnp.asarray(b1)[None], w2q, s2,
                             jnp.asarray(b2)[None], interpret=True)
    want = np.asarray(want.astype(jnp.float32))

    t = torch.from_numpy
    w = FF.quantize_ffn(t(w1.T.copy()), t(b1), t(w2.T.copy()), t(b2))
    np.testing.assert_array_equal(w.w1.numpy(), np.asarray(w1q).T)
    np.testing.assert_array_equal(w.s1.numpy(), np.asarray(s1)[0])
    np.testing.assert_array_equal(w.w2.numpy(), np.asarray(w2q).T)
    np.testing.assert_array_equal(w.s2.numpy(), np.asarray(s2)[0])
    got = FF.fused_ffn_int8(t(x).to(torch.bfloat16), w)  # CPU: the twin
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    got = got.float().numpy()
    tol = 2.0 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert (got != want).mean() <= 0.01


def test_ffn_int8_keeps_leading_axes_and_dtype():
    x, w1, b1, w2, b2 = _case(2 * 24, 64, 128, 64, seed=9)
    t = torch.from_numpy
    w = FF.quantize_ffn(t(w1.T.copy()), t(b1), t(w2.T.copy()), t(b2))
    x3 = t(x).reshape(2, 24, 64)
    out = FF.fused_ffn_int8(x3, w)
    assert out.shape == (2, 24, 64) and out.dtype == torch.float32
    torch.testing.assert_close(out.reshape(48, 64), FF.ffn_int8_ref(t(x), w),
                               rtol=0, atol=0)
