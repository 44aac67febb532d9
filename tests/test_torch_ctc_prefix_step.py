"""The port's CTC prefix step (``ops/ctc_prefix.py`` ``ctc_prefix_step``, one
kernel launch on the card) against the JAX package's ``ctc_prefix_step``.

On the CPU the wrapper runs its plain twin ``ctc_prefix_step_ref``; the JAX
step runs once through its ``lax.scan`` recurrence and once through the
Pallas kernel in interpret mode (``ctc_prefix_pallas.enabled`` forced on in
the test only).  Cases: step 0 with the stride-0 broadcast state, candidates
that repeat the last token or are blank or eos, a candidate token and a
hypothesis with no mass at all (NEG_INF throughout), masked frames, T = 1,
T = 13 (not a multiple of 4), W = 1.  Bar: rtol 1e-5, atol 1e-5, for the ulps
by which XLA's and ATen's CPU exp/log differ.
"""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from funasr_tpu.ops import beam_search as JB
from funasr_tpu.ops import ctc_prefix_pallas as JCP
from funasr_torch.ops import ctc_prefix as CP
from funasr_torch.ops import cuda_build
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)

# (B, K, W, T, V, step 0)
CASES = [
    (2, 3, 5, 13, 9, True),    # the stride-0 state of step 0
    (2, 3, 6, 13, 9, False),   # repeats, blank, eos, dead rows, masked frames
    (2, 2, 3, 1, 7, False),    # one frame
    (3, 2, 1, 13, 6, False),   # W = 1
]


def _inputs(B, K, W, T, V, step0, seed):
    """Torch inputs of the step as the beam makes them: masked log-probs
    (blank 0, eos V - 1), time-minor."""
    rng = np.random.default_rng(seed)
    logp = np.log(rng.dirichlet(np.ones(V), (B, T))).astype(np.float32)
    lens = np.maximum(1, T - np.arange(B) * (T // 3 + 1))  # masked tails
    x = np.asarray(JB.mask_ctc_frames(jnp.asarray(logp), jnp.asarray(lens), 0))
    x = x.copy()
    x[:, :, V - 2] = CP.NEG_INF  # a token with no mass: its rows NEG_INF throughout
    x_t = torch.from_numpy(np.ascontiguousarray(np.swapaxes(x, 1, 2)))
    r0, _ = JB.ctc_init_state(jnp.asarray(x), 0)
    r0 = torch.from_numpy(np.array(r0))
    if step0:
        r_prev = r0[:, None].expand(B, K, T, 2)  # stride 0 over K
    else:
        r_prev = torch.from_numpy(
            (np.log(rng.random((B, K, T, 2))) * 2.0 - 4.0).astype(np.float32))
        r_prev[:, K - 1] = CP.NEG_INF  # a hypothesis with no mass
    last = torch.from_numpy(rng.integers(1, V - 1, (B, K)))
    cand = torch.from_numpy(rng.integers(1, V, (B, K, W)))
    cand[..., 0] = last  # cand == last
    for w, tok in enumerate((0, V - 1, V - 2)[:W - 1]):  # blank, eos, the dead token
        cand[..., w + 1] = tok
    return x_t, r_prev, last, cand


def _jax_step(x_t, r_prev, last, cand, step0):
    B, K = last.shape
    return jax.jit(JB.ctc_prefix_step, static_argnums=5)(
        jnp.asarray(x_t.numpy()), jnp.asarray(r_prev.contiguous().numpy()),
        jnp.asarray(last.numpy(), jnp.int32), jnp.asarray(cand.numpy(), jnp.int32),
        jnp.full((B, K), step0), 0)


@pytest.mark.parametrize("route", ["scan", "pallas"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_step_twin_matches_jax(case, route, monkeypatch):
    B, K, W, T, V, step0 = CASES[case]
    x_t, r_prev, last, cand = _inputs(B, K, W, T, V, step0, seed=case)
    sigma, r_new = CP.ctc_prefix_step(x_t, r_prev, last, cand, step0, 0)
    assert sigma.shape == (B, K, W) and r_new.shape == (B, K, W, T, 2)
    if route == "pallas":
        calls = []
        kernel = JCP.ctc_recurrence
        monkeypatch.setattr(JCP, "enabled", lambda: True)
        monkeypatch.setattr(JCP, "ctc_recurrence",
                            lambda *a, **k: calls.append(1) or kernel(*a, **k))
        with pltpu.force_tpu_interpret_mode():
            w_sigma, w_r = _jax_step(x_t, r_prev, last, cand, step0)
        assert calls == [1]  # the JAX step went through the Pallas kernel
    else:
        w_sigma, w_r = _jax_step(x_t, r_prev, last, cand, step0)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(w_sigma), **TOL)
    np.testing.assert_allclose(r_new.numpy(), np.asarray(w_r), **TOL)
    assert np.isfinite(r_new.numpy()).all() and np.isfinite(sigma.numpy()).all()


def test_wrapper_takes_the_twin_on_cpu():
    x_t, r_prev, last, cand = _inputs(2, 3, 4, 9, 8, False, seed=9)
    before = CP.ctc_prefix_step.launches
    got = CP.ctc_prefix_step(x_t, r_prev, last, cand, False, 0)
    want = CP.ctc_prefix_step_ref(x_t, r_prev, last, cand, False, 0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert CP.ctc_prefix_step.launches == before  # the twin is no launch


def _recorded_launch(monkeypatch, *args):
    """Run ``_launch_step`` on CPU tensors with the bound C entry replaced by
    a recorder: (sigma, r_new, the entry's arguments)."""
    calls = []
    monkeypatch.setattr(cuda_build, "function", lambda name, symbol, argtypes: (
        lambda *a: calls.append((symbol, len(argtypes), a)) or 0))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(CP.ctc_prefix_step, "launches", 0)
    sigma, r_new = CP._launch_step(*args)
    [(symbol, nargs, a)] = calls
    assert symbol == "ctc_prefix_step_forward" and nargs == len(a)
    assert CP.ctc_prefix_step.launches == 1
    return sigma, r_new, a


def test_step_launch_takes_strides_as_they_are(monkeypatch):
    """The step-0 broadcast state and strided last/cand reach the kernel
    without a copy; a state whose frames are not (t, 2) pairs is copied."""
    B, K, W, T, V = 2, 3, 4, 7, 8
    x_t, r_prev, last, cand = _inputs(B, K, W, T, V, True, seed=3)
    cand_s = torch.zeros((B, K, W + 2), dtype=torch.int64)[..., :W]
    cand_s.copy_(cand)
    last_s = torch.zeros((B, K, 5), dtype=torch.int64)[..., 1]
    last_s.copy_(last)
    sigma, r_new, args = _recorded_launch(monkeypatch, x_t, r_prev, last_s, cand_s, True, 0)
    assert args[:4] == (x_t.data_ptr(), B, V, T)
    assert args[4] == r_prev.data_ptr() and args[5:7] == (T * 2, 0)  # sB, sK = 0
    assert args[7] == last_s.data_ptr() and args[8:10] == (K * 5, 5)
    assert args[10] == cand_s.data_ptr() and args[11:14] == (K * (W + 2), W + 2, 1)
    assert args[14:18] == (K, W, 1, 0)
    assert args[18:] == (r_new.data_ptr(), sigma.data_ptr(), 0)
    assert r_new.shape == (B, K, W, T, 2) and sigma.shape == (B, K, W)
    swapped = torch.from_numpy(r_prev.numpy().copy()).transpose(2, 3).contiguous()
    _, _, args = _recorded_launch(monkeypatch, x_t, swapped.transpose(2, 3), last, cand,
                                  False, 0)
    assert args[4] != swapped.data_ptr() and args[5:7] == (K * T * 2, T * 2)


def _bad_args():
    x_t, r_prev, last, cand = _inputs(2, 3, 4, 9, 8, False, seed=5)
    meta = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")
    return [
        ("float32", (x_t.double(), r_prev, last, cand)),
        ("float32", (x_t, r_prev.half(), last, cand)),
        ("int64", (x_t, r_prev, last.int(), cand)),
        ("int64", (x_t, r_prev, last, cand.int())),
        ("must be", (x_t[0], r_prev, last, cand)),
        ("does not match", (x_t, r_prev[:, :, :5], last, cand)),
        ("must be", (x_t, r_prev, last[:, :2], cand)),
        ("must be", (x_t, r_prev, last, cand[..., 0])),
        ("different devices", (x_t, meta(r_prev), last, cand)),
        ("different devices", (x_t, r_prev, last, meta(cand))),
    ]


@pytest.mark.parametrize("case", range(10))
def test_argument_checks_raise(case):
    match, args = _bad_args()[case]
    with pytest.raises(ValueError, match=match):
        CP._launch_step(*args, False, 0)


def test_blank_and_device_checks_raise():
    x_t, r_prev, last, cand = _inputs(2, 3, 4, 9, 8, False, seed=6)
    with pytest.raises(ValueError, match="outside"):
        CP._launch_step(x_t, r_prev, last, cand, False, 8)
    meta = torch.empty(x_t.shape, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        CP.ctc_prefix_step(meta, r_prev, last, cand, False, 0)


def test_kernel_path_raises_without_the_kernel(monkeypatch, tmp_path):
    """The CUDA launch path builds and calls the kernel or raises: on a
    machine without nvcc it raises, it never falls back to the twin."""
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(cuda_build, "_bound", {})
    x_t, r_prev, last, cand = _inputs(1, 2, 3, 4, 6, True, seed=1)
    before = CP.ctc_prefix_step.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        CP._launch_step(x_t, r_prev, last, cand, True, 0)
    assert CP.ctc_prefix_step.launches == before
