"""Port attention (funasr_torch/ops/attention.py) against the JAX package's
Pallas kernel in interpret mode on the CPU.

Tolerances: float32 1e-5 and bf16 3e-2 max abs error, the bars of the JAX
package's own kernel test (tests/test_attention_pallas.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from funasr_tpu.ops.attention_pallas import fused_attention as pallas_attention
from funasr_torch.ops import attention as A
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(rng, B, U, T, H, d, lens):
    q = rng.standard_normal((B, U, H * d)).astype(np.float32) * d ** -0.5
    k = rng.standard_normal((B, T, H * d)).astype(np.float32)
    v = rng.standard_normal((B, T, H * d)).astype(np.float32)
    bias = np.where(np.arange(T)[None] < np.asarray(lens)[:, None], 0.0,
                    -1e30).astype(np.float32)
    return q, k, v, bias


def _both(q, k, v, bias, H, dtype):
    jq, jk, jv = (jnp.asarray(x, _JDT[dtype]) for x in (q, k, v))
    want = pallas_attention(jq, jk, jv, jnp.asarray(bias), H, interpret=True)
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    got = A.attention_ref(tq, tk, tv, torch.from_numpy(bias), H)
    return (got.to(torch.float32).numpy(),
            np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("U,T", [(48, 48), (16, 40)])  # self, cross
def test_attention_ref_matches_pallas_interpret(rng, dtype, tol, U, T):
    B, H, d = 2, 2, 128
    q, k, v, bias = _inputs(rng, B, U, T, H, d, [T, T - 13])
    got, want = _both(q, k, v, bias, H, dtype)
    assert got.shape == (B, U, H * d)
    assert np.abs(got - want).max() < tol


def test_fully_masked_row_gives_uniform_weights_like_the_kernel(rng):
    B, U, T, H, d = 1, 8, 16, 1, 128
    q, k, v, bias = _inputs(rng, B, U, T, H, d, [0])
    got, want = _both(q, k, v, bias, H, torch.float32)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got[0, 0], v[0].mean(axis=0), atol=1e-5)


def test_wrapper_on_cpu_is_the_twin_and_takes_column_slices(rng):
    """k and v may be column slices of one fused projection (row stride
    2D), as in the decoder's linear_k_v output."""
    B, U, T, H, d = 2, 8, 24, 2, 128
    q, _, _, bias = _inputs(rng, B, U, T, H, d, [24, 9])
    kv = torch.from_numpy(rng.standard_normal((B, T, 2 * H * d)).astype(np.float32))
    k, v = kv.split(H * d, dim=-1)
    before = A.fused_attention.launches
    got = A.fused_attention(torch.from_numpy(q), k, v, torch.from_numpy(bias), H)
    want = A.attention_ref(torch.from_numpy(q), k.contiguous(), v.contiguous(),
                           torch.from_numpy(bias), H)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert A.fused_attention.launches == before  # no kernel on the CPU


def test_padded_keys_are_ignored(rng):
    B, U, T, H, d = 1, 12, 32, 2, 128
    q, k, v, bias = _inputs(rng, B, U, T, H, d, [20])
    args = [torch.from_numpy(x) for x in (q, k, v, bias)]
    out1 = A.attention_ref(*args, H)
    k2, v2 = args[1].clone(), args[2].clone()
    k2[:, 20:] = 99.0
    v2[:, 20:] = -99.0
    out2 = A.attention_ref(args[0], k2, v2, args[3], H)
    torch.testing.assert_close(out1, out2, rtol=0, atol=1e-6)


def test_wrapper_rejects_other_devices():
    """No fallback: a tensor that is neither on the CPU nor on CUDA raises."""
    q = torch.empty((1, 4, 128), device="meta")
    with pytest.raises(ValueError):
        A.fused_attention(q, q, q, torch.empty((1, 4), device="meta"), 1)
