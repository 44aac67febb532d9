"""The port's RWKV decoder (``models/rwkv.py``, ``TransformerRWKVDecoder``)
against the JAX package on the CPU, float32, inputs from numpy seeds.

- ``wkv_scan`` (incl. keys far above and below the running max exponent,
  where the -1e30 start and the max-exponent order matter) and ``TimeMix``
  within 1e-5; the token shift exact;
- the decoder's full-prefix forward within 1e-5, causal: logits at a
  position do not move when later tokens change;
- the Conformer + RWKV hybrid (the aishell conformer_rwkv recipe, tiny) of
  ``tests/test_torch_transformer_hybrid.py``: its full-prefix
  ``decode_beam`` with CTC weight 0.3 and 0.0, tokens and lengths equal,
  scores within 1e-4.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from funasr_tpu.models import rwkv as JR
from funasr_torch.models import rwkv as TR
from tests.test_torch_transformer_hybrid import assert_same_beam, family, jax_beam, speech
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5


@pytest.mark.parametrize("scale", [0.5, 3.0, 40.0])
def test_wkv_scan_matches_jax(scale):
    rng = np.random.default_rng(int(scale * 10))
    B, T, C = 2, 13, 8
    k = (scale * rng.standard_normal((B, T, C))).astype(np.float32)
    v = rng.standard_normal((B, T, C)).astype(np.float32)
    w = np.exp(rng.standard_normal(C)).astype(np.float32)
    u = (scale * rng.standard_normal(C)).astype(np.float32)
    want = np.asarray(JR.wkv_scan(*map(jnp.asarray, (k, v, w, u))))
    got = TR.wkv_scan(*map(torch.from_numpy, (k, v, w, u))).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_token_shift_exact():
    x = np.random.default_rng(1).standard_normal((2, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(TR.token_shift(torch.from_numpy(x)).numpy(),
                                  np.asarray(JR._token_shift(jnp.asarray(x))))


def test_time_mix_matches_jax():
    _, variables, tm = family("conformer_rwkv", "conv2d")
    node = jax.tree_util.tree_map(lambda a: a[0], variables["params"]["decoder"]["decoders"])
    jt = JR.TimeMix(16)
    x = np.random.default_rng(2).standard_normal((3, 7, 16)).astype(np.float32)
    want = np.asarray(jt.apply({"params": node["self_attn"]}, jnp.asarray(x)))
    with torch.no_grad():
        got = tm.decoder.decoders[0].self_attn(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_decoder_forward_matches_jax_and_is_causal():
    jm, variables, tm = family("conformer_rwkv", "conv2d")
    rng = np.random.default_rng(6)
    B, T, U = 2, 9, 6
    mem = rng.standard_normal((B, T, 16)).astype(np.float32)
    mlens = np.array([T, 5], np.int32)
    ys = rng.integers(0, 32, (B, U)).astype(np.int32)
    ylens = np.array([U, 4], np.int32)
    dec = jm.bind(variables).decoder_module
    want = np.asarray(dec(jnp.asarray(mem), jnp.asarray(mlens), jnp.asarray(ys),
                          jnp.asarray(ylens)))
    args = (torch.from_numpy(mem), torch.from_numpy(mlens))
    with torch.no_grad():
        got = tm.decoder(*args, torch.from_numpy(ys).long(), torch.from_numpy(ylens)).numpy()
        ys2 = ys.copy()
        ys2[:, 3:] = (ys2[:, 3:] + 7) % 32
        moved = tm.decoder(*args, torch.from_numpy(ys2).long(),
                           torch.from_numpy(ylens)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_array_equal(moved[:, :3], got[:, :3])
    assert np.abs(moved[:, 3:] - got[:, 3:]).max() > 1e-3


@pytest.mark.parametrize("ctc_weight", [0.3, 0.0])
def test_full_prefix_decode_beam_matches_jax(ctc_weight):
    jm, variables, tm = family("conformer_rwkv", "conv2d")
    x, lens = speech()
    kw = dict(beam=4, maxlen=8, decoding_ctc_weight=ctc_weight)
    want = jax_beam(jm, variables, x, lens, **kw)
    calls = []
    real = tm.decoder.forward
    tm.decoder.forward = lambda *a: calls.append(a[2].shape) or real(*a)
    try:
        got = tm.decode_beam(torch.from_numpy(x), torch.from_numpy(lens), **kw)
    finally:
        del tm.decoder.forward
    assert_same_beam(got, want)
    # the full-prefix scorer: the whole (B K, maxlen + 1) grid every step
    assert len(calls) >= got.steps >= 1 and set(calls) == {(3 * 4, 9)}
