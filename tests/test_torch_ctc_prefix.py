"""Port CTC prefix scoring against the JAX package.

``ctc_recurrence_ref`` (the CUDA kernel's plain twin) against the JAX
``lax.scan`` recurrence and against the Pallas kernel in interpret mode, on
``tests/test_ctc_prefix_pallas.py``'s shapes (with its NEG_INF column and
its row-tiling case) plus T=1 and rows that are NEG_INF throughout.  Bar:
rtol 1e-5, atol 1e-5 (XLA's and ATen's CPU exp/log differ by ulps).
``ctc_prefix_step`` and ``ctc_init_state`` against JAX at the same bar.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from funasr_tpu.ops import beam_search as JB
from funasr_tpu.ops import ctc_prefix_pallas as JCP
from funasr_torch.ops import beam_search as TB
from funasr_torch.ops import ctc_prefix as CP
from funasr_torch.ops import cuda_build
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)

# (B, K, W, T, neg_col, neg_rows, pallas kwargs)
CASES = [
    (2, 3, 5, 45, True, False, dict(block_t=16)),
    (4, 8, 9, 20, False, False, dict(block_t=8, block_r=128)),  # R = 288 > 128
    (2, 2, 3, 1, True, False, dict(block_t=8)),  # one frame
    (3, 2, 4, 13, True, True, dict(block_t=8)),  # rows NEG_INF throughout
]


def _inputs(B, K, W, T, neg_col, neg_rows, seed):
    rng = np.random.default_rng(seed)
    xg = (rng.standard_normal((B, K, W, T)) * 2.0).astype(np.float32)
    phi = (rng.standard_normal((B, K, W, T)) * 2.0).astype(np.float32)
    xb = rng.standard_normal((B, T)).astype(np.float32)
    if neg_col:
        phi[..., 0] = CP.NEG_INF
    if neg_rows:
        xg[1] = CP.NEG_INF
        phi[1] = CP.NEG_INF
    return xg, xb, phi


@pytest.mark.parametrize("case", range(len(CASES)))
def test_recurrence_twin_matches_jax_scan_and_pallas(case):
    B, K, W, T, neg_col, neg_rows, kw = CASES[case]
    xg, xb, phi = _inputs(B, K, W, T, neg_col, neg_rows, seed=case)
    got = CP.ctc_recurrence_ref(*map(torch.from_numpy, (xg, xb, phi))).numpy()
    assert got.shape == (B, K, W, T, 2)
    want_scan = JB._ctc_recurrence(*map(jnp.asarray, (xg, xb, phi)))
    with pltpu.force_tpu_interpret_mode():
        want_pallas = JCP.ctc_recurrence(*map(jnp.asarray, (xg, xb, phi)), **kw)
    for want in (want_scan, want_pallas):
        np.testing.assert_allclose(got[..., 0], np.asarray(want[0]), **TOL)
        np.testing.assert_allclose(got[..., 1], np.asarray(want[1]), **TOL)
    assert np.isfinite(got).all()


def test_wrapper_takes_the_twin_on_cpu():
    xg, xb, phi = map(torch.from_numpy, _inputs(2, 3, 4, 9, True, False, seed=9))
    before = CP.ctc_recurrence.launches
    assert torch.equal(CP.ctc_recurrence(xg, xb, phi), CP.ctc_recurrence_ref(xg, xb, phi))
    assert CP.ctc_recurrence.launches == before  # the twin is no launch


def test_kernel_path_raises_without_the_kernel(monkeypatch, tmp_path):
    """The CUDA launch path builds and calls the kernel or raises: on a
    machine without nvcc it raises, it never falls back to the twin."""
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(cuda_build, "_bound", {})
    xg, xb, phi = map(torch.from_numpy, _inputs(1, 2, 3, 4, True, False, seed=1))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        CP._launch(xg, xb, phi)
    with pytest.raises(ValueError, match="must be float32"):
        CP._launch(xg.double(), xb, phi)


def test_ctc_init_state_matches_jax():
    rng = np.random.default_rng(2)
    x = np.log(rng.dirichlet(np.ones(6), (3, 17))).astype(np.float32)
    r0, s0 = TB.ctc_init_state(torch.from_numpy(x), blank_id=0)
    wr0, ws0 = JB.ctc_init_state(jnp.asarray(x), 0)
    np.testing.assert_allclose(r0.numpy(), np.asarray(wr0), **TOL)
    np.testing.assert_allclose(s0.numpy(), np.asarray(ws0), **TOL)


def test_mask_ctc_frames_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 8, 5)).astype(np.float32)
    lens = np.array([8, 3, 0], np.int32)
    got = TB.mask_ctc_frames(torch.from_numpy(x), torch.from_numpy(lens), 0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        JB.mask_ctc_frames(jnp.asarray(x), jnp.asarray(lens), 0)))


@pytest.mark.parametrize("step0", [True, False])
def test_ctc_prefix_step_matches_jax(step0):
    """Candidates that repeat the last token, eos-free, with masked frames."""
    rng = np.random.default_rng(8)
    B, K, W, T, V = 2, 3, 4, 11, 7
    logp = np.log(rng.dirichlet(np.ones(V), (B, T))).astype(np.float32)
    lens = np.array([T, 6], np.int32)
    x = np.asarray(JB.mask_ctc_frames(jnp.asarray(logp), jnp.asarray(lens), 0))
    x_t = np.ascontiguousarray(np.swapaxes(x, 1, 2))
    r0, _ = JB.ctc_init_state(jnp.asarray(x), 0)
    r_prev = np.broadcast_to(np.asarray(r0)[:, None], (B, K, T, 2)).copy()
    if not step0:  # a prefix state that is not all-blank
        r_prev[..., 0] = np.log(rng.random((B, K, T))).astype(np.float32) - 3.0
    last = rng.integers(1, V, (B, K))
    cand = rng.integers(1, V, (B, K, W))
    cand[:, :, 0] = last  # the repeat case
    sigma, r_new = TB.ctc_prefix_step(torch.from_numpy(x_t), torch.from_numpy(r_prev),
                                      torch.from_numpy(last), torch.from_numpy(cand),
                                      step0, 0)
    w_sigma, w_r = JB.ctc_prefix_step(
        jnp.asarray(x_t), jnp.asarray(r_prev), jnp.asarray(last, jnp.int32),
        jnp.asarray(cand, jnp.int32), jnp.full((B, K), step0), 0)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(w_sigma), **TOL)
    np.testing.assert_allclose(r_new.numpy(), np.asarray(w_r), **TOL)
