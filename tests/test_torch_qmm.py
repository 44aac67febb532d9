"""The fused int8 matmul's twin (``funasr_torch/ops/qmm.py``
``quant_matmul_ref``) against the TPU kernel ``quant_pallas.quant_matmul``
run in interpret mode on the CPU, and the ``Dense(qmm=True)`` route against
the JAX package's QDense with ``FUNASR_TPU_PALLAS_QMM`` on.

Both sides quantize the weights per channel with the "div" form (bit-exact,
``test_torch_quant.py``) and the rows with the "mul" form, sum in exact
int32 and apply the same float32 steps, so the bar is JAX's own against its
XLA recipe (relative 1e-5, ``tests/test_quant_pallas.py``); in practice the
outputs are equal.  K = 560 (``encoders0``'s projection of Paraformer-large)
fails the TPU's alignment gate, so the JAX package's QDense sends it to its
XLA "div" form, while the port, which copies only the m/n gate, takes the
fused kernel: the last test holds the port there against the Pallas kernel
itself, which computes any K in interpret mode.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from funasr_tpu.ops import quant as JQ
from funasr_tpu.ops import quant_pallas as QP
from funasr_torch.models.sanm import Dense
from funasr_torch.ops import qmm as QM
from funasr_torch.ops import quant as Q
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

REL = 1e-5


def _xw(M, K, N, seed, lead=()):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(lead + (M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    return x, w


def _port(x, w, bias=None):
    w8, sw = Q.quantize_weight(torch.from_numpy(w.T.copy()))
    return QM.quant_matmul(torch.from_numpy(x), w8, sw, bias)


def _rel_err(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("M,K,N", [(256, 512, 2048), (384, 512, 8404)])
def test_qmm_ref_matches_pallas_interpret(M, K, N):
    x, w = _xw(M, K, N, seed=M + N)
    want = np.asarray(QP.quant_matmul(jnp.asarray(x), jnp.asarray(w), interpret=True))
    launches = QM.quant_matmul.launches
    got = _port(x, w)
    assert QM.quant_matmul.launches == launches  # a CPU tensor takes the twin
    assert got.dtype == torch.float32 and got.shape == (M, N)
    assert _rel_err(got.numpy(), want) < REL


def test_qmm_leading_dims():
    x, w = _xw(64, 512, 256, seed=1, lead=(2,))
    want = np.asarray(QP.quant_matmul(jnp.asarray(x), jnp.asarray(w), interpret=True))
    got = _port(x, w)
    assert got.shape == (2, 64, 256)
    assert _rel_err(got.numpy(), want) < REL


def test_qmm_twin_is_rowquant_mul_then_int8_gemm():
    """The "mul" row quantize, not QDense's "div" one: on rows where the two
    scales differ in the last bit, the XLA route and qmm differ."""
    from funasr_torch.ops import int8_gemm as G
    from funasr_torch.ops import rowquant as RQ

    x, w = _xw(200, 64, 48, seed=3)
    xt = torch.from_numpy(x)
    w8, sw = Q.quantize_weight(torch.from_numpy(w.T.copy()))
    q, sx = RQ.rowquant_ref(xt, form="mul")
    np.testing.assert_array_equal(QM.quant_matmul_ref(xt, w8, sw).numpy(),
                                  G.int8_gemm_ref(q, sx, w8, sw).numpy())
    _, sx_div = RQ.rowquant_ref(xt, form="div")
    assert (sx != sx_div).any()


def _jax_dense(x, w, b, monkeypatch):
    """flax QDense in bf16 under quant.quantized(True) with the fused kernel
    forced on (interpret mode); returns the output and the _qmm call count."""
    import flax.linen as nn

    calls = []
    monkeypatch.setattr(QP, "enabled", lambda: True)
    monkeypatch.setattr(QP, "_qmm", lambda *a, f=QP._qmm, **k: calls.append(1) or f(*a, **k))
    dense = JQ.QDense(w.shape[1], dtype=jnp.bfloat16)
    params = {"params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}}
    with JQ.quantized(True), pltpu.force_tpu_interpret_mode():
        out = dense.apply(params, jnp.asarray(x).astype(jnp.bfloat16))
    assert isinstance(dense, nn.Dense)
    return np.asarray(out.astype(jnp.float32)), len(calls)


def _port_dense(x, w, b, qmm):
    K, N = w.shape
    d = Dense(K, N, dtype=torch.bfloat16, param_dtype=torch.float32, qmm=qmm)
    with torch.no_grad():
        d.weight.copy_(torch.from_numpy(w.T.copy()))
        d.bias.copy_(torch.from_numpy(b))
    d.quantize_weights()
    with torch.no_grad():
        return d(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()


def test_dense_qmm_route_matches_jax_qdense(monkeypatch):
    """bf16 Dense with the qmm route: the cast to bf16, then flax's bf16 bias
    add, as the JAX QDense with its fused kernel gives them."""
    x, w = _xw(512, 512, 1024, seed=5, lead=(2,))
    b = (0.1 * np.random.default_rng(6).standard_normal(1024)).astype(np.float32)
    assert QP.supported(1024, 512, 1024) and Q.gate(1024, 1024)
    want, n_calls = _jax_dense(x, w, b, monkeypatch)
    assert n_calls == 1
    spy = []
    monkeypatch.setattr(QM, "quant_matmul",
                        lambda *a, f=QM.quant_matmul: spy.append(1) or f(*a))
    got = _port_dense(x, w, b, qmm=True)
    assert spy == [1]
    assert _rel_err(got, want) < REL


def test_k560_takes_qmm_in_the_port_only(monkeypatch):
    """encoders0's K = 560: the JAX package's gate refuses its fused kernel
    (K % 128), the port's does not; the port matches the Pallas kernel."""
    assert not QP.supported(16384, 560, 1536) and Q.gate(16384, 1536)
    x, w = _xw(1024, 560, 1024, seed=7)
    b = np.zeros(1024, np.float32)
    spy = []
    monkeypatch.setattr(QM, "quant_matmul",
                        lambda *a, f=QM.quant_matmul: spy.append(1) or f(*a))
    got = _port_dense(x, w, b, qmm=True)
    assert spy == [1]
    with pltpu.force_tpu_interpret_mode():
        want = QP.quant_matmul(jnp.asarray(x).astype(jnp.bfloat16),
                               jnp.asarray(w).astype(jnp.bfloat16), interpret=True)
    want = np.asarray(jax.device_get(want).astype(jnp.float32))
    assert _rel_err(got, want) < REL
    _port_dense(x, w, b, qmm=False)  # without qmm: QDense's XLA "div" route
    assert spy == [1]
