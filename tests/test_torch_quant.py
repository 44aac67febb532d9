"""The port's int8 recipe (``funasr_torch/ops/quant.py``, ``rowquant.py``,
``int8_gemm.py``) against funasr_tpu/ops/quant.py on the CPU.

Inputs come from numpy with a seed.  Both quantize forms are bit-exact
against the JAX functions, all-zero rows and exact .5 ties included.  The
QDense int8 linear is bit-exact against ``int8_dot_general`` plus flax's
bf16 bias add when the gate passes (the int32 accumulator is exact on both
sides); below the gate both run a bf16 dot, which may round the last bit
differently (rtol 1e-2, two bf16 ulps).  The int8 GEMM twin's accumulator
is exact against an int64 numpy product, and its epilogue is the stated
float32 sequence, bit for bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from funasr_tpu.ops import quant as JQ
from funasr_torch.ops import int8_gemm as G
from funasr_torch.ops import quant as Q
from funasr_torch.ops import rowquant as RQ
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _inputs(dtype=np.float32):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((9, 40)) * 3).astype(np.float32)
    x[2] = 0.0                                    # all-zero row
    x[4] = np.arange(40) - 19.5                   # absmax 20.5
    x[5, :] = np.linspace(-127, 127, 40)          # scale 1: exact .5 ties
    x[5, 1::4] = x[5, 1::4].round() + 0.5
    x[6] = 1e-12                                  # below the 1e-8 floor
    return x.astype(dtype)


@pytest.mark.parametrize("axis", [-1, 0])
def test_quantize_rows_bit_exact(axis):
    x = _inputs()
    wq, ws = JQ.quantize_rows(jnp.asarray(x), axis=axis)
    gq, gs = Q.quantize_rows(torch.from_numpy(x), dim=axis)
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    assert (gq.numpy()[2] == 0).all() if axis == -1 else True


def test_quantize_rows_bf16_input_bit_exact():
    x = _inputs()
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    wq, ws = JQ.quantize_rows(xb, axis=-1)
    gq, gs = Q.quantize_rows(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


def test_rowquant_bit_exact():
    x = _inputs()
    wq, ws = JQ.rowquant_kernel(jnp.asarray(x))
    gq, gs = RQ.quantize_ref(torch.from_numpy(x), "mul")
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws)[:, 0])
    # the twin of the rowquant kernel, both forms
    for form, (fq, fs) in (("mul", (wq, ws)),
                           ("div", JQ.quantize_rows(jnp.asarray(x), axis=-1))):
        q, s = RQ.rowquant(torch.from_numpy(x), form=form)
        np.testing.assert_array_equal(q.numpy(), np.asarray(fq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(fs)[:, 0])


def test_the_two_forms_differ_somewhere():
    """The forms are not interchangeable: some absmax gives a scale that
    differs in the last bit (why each port function keeps its JAX form)."""
    a = torch.arange(1, 20000, dtype=torch.float32) / 7.0
    assert not torch.equal(a * (1.0 / 127.0), RQ.div127(a))


def test_rowquant_layer_norm_matches_jax_kernel_norm():
    """LN + quantize (the fused kernels' prologue) against sanm_layer_pallas
    ``_ln`` + ``rowquant_kernel``: the port sums the statistics in float64,
    so a value within a float32 ulp of a rounding tie may land one level
    apart (at most 1 in 1000 here) and the norm agrees to 1e-5."""
    from funasr_tpu.ops.sanm_layer_pallas import _ln

    rng = np.random.default_rng(1)
    x = (rng.standard_normal((64, 256)) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    b = (0.1 * rng.standard_normal(256)).astype(np.float32)
    y = _ln(jnp.asarray(x), jnp.asarray(w)[None], jnp.asarray(b)[None])
    wq, ws = JQ.rowquant_kernel(y)
    ln = (torch.from_numpy(w), torch.from_numpy(b))
    gq, gs = RQ.rowquant(torch.from_numpy(x), ln)
    gy = RQ.rowquant(torch.from_numpy(x), ln, quantize=False)
    np.testing.assert_allclose(gy.numpy(), np.asarray(y), atol=1e-5)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws)[:, 0], rtol=1e-6)
    diff = np.abs(gq.numpy().astype(int) - np.asarray(wq).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("gate", ["default", "zero"])
@pytest.mark.parametrize("bias", [True, False])
def test_int8_linear_matches_qdense(monkeypatch, gate, bias):
    """The port's Dense after quantize_weights() against the JAX QDense
    under quant.quantized(True), bf16 compute, float32 parameters."""
    from funasr_torch.models.sanm import Dense

    rng = np.random.default_rng(2)
    B, T, K, N = 2, 24, 80, 48
    x = rng.standard_normal((B, T, K)).astype(np.float32)
    kern = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    b = (0.1 * rng.standard_normal(N)).astype(np.float32)
    if gate == "zero":
        monkeypatch.setattr(JQ, "_MIN_M", 0)
        monkeypatch.setattr(JQ, "_MIN_N", 0)
        monkeypatch.setattr(Q, "MIN_M", 0)
        monkeypatch.setattr(Q, "MIN_N", 0)
    dense = JQ.QDense(N, use_bias=bias, dtype=jnp.bfloat16, param_dtype=jnp.float32)
    params = {"params": {"kernel": jnp.asarray(kern)}}
    if bias:
        params["params"]["bias"] = jnp.asarray(b)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    with JQ.quantized(True):
        want = np.asarray(dense.apply(params, xb).astype(jnp.float32))

    tm = Dense(K, N, bias=bias, dtype=torch.bfloat16, param_dtype=torch.float32)
    sd = {"weight": torch.from_numpy(kern.T.copy())}
    if bias:
        sd["bias"] = torch.from_numpy(b)
    tm.load_state_dict(sd)
    tm.quantize_weights()
    with torch.no_grad():
        got = tm(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    assert Q.gate(B * T, N) == (gate == "zero")
    if gate == "zero":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)


def test_int8_gemm_twin_accumulator_exact():
    rng = np.random.default_rng(3)
    M, K, N = 37, 560, 53
    a = rng.integers(-127, 128, (M, K), dtype=np.int8)
    b = rng.integers(-127, 128, (N, K), dtype=np.int8)
    a[0] = 127
    b[0] = 127  # the largest |acc|, 127^2 K
    acc = a.astype(np.int64) @ b.astype(np.int64).T
    ones = lambda n: torch.ones(n)
    got = G.int8_gemm(torch.from_numpy(a), ones(M), torch.from_numpy(b), ones(N))
    np.testing.assert_array_equal(got.numpy(), acc.astype(np.float32))
    assert got.numpy()[0, 0] == 127 * 127 * K


def test_int8_gemm_twin_epilogue():
    rng = np.random.default_rng(4)
    M, K, N = 16, 48, 24
    a = rng.integers(-127, 128, (M, K), dtype=np.int8)
    b = rng.integers(-127, 128, (N, K), dtype=np.int8)
    sa = rng.uniform(0.01, 0.1, M).astype(np.float32)
    sb = rng.uniform(0.01, 0.1, N).astype(np.float32)
    bias = rng.standard_normal(N).astype(np.float32)
    res = rng.standard_normal((M, N)).astype(np.float32)
    add = rng.standard_normal((M, N)).astype(np.float32)
    t = torch.from_numpy
    acc = (a.astype(np.int64) @ b.astype(np.int64).T).astype(np.float32)
    v = acc * sa[:, None] * sb[None]
    want = np.maximum((res + v) + bias, 0) + add
    got = G.int8_gemm(t(a), t(sa), t(b), t(sb), bias=t(bias), relu=True,
                      res=t(res), add=t(add))
    np.testing.assert_array_equal(got.numpy(), want)
    # QDense: round to bf16 before the bias, output bf16
    got = G.int8_gemm(t(a), t(sa), t(b), t(sb), bias=t(bias), round_bf16=True,
                      out_dtype=torch.bfloat16)
    ref = (torch.from_numpy(v).to(torch.bfloat16).float() + t(bias)).to(torch.bfloat16)
    assert torch.equal(got, ref)
