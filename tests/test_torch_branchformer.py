"""The port's Branchformer and E-Branchformer against the JAX package on
the CPU: the tiny hybrids of ``tests/test_torch_transformer_hybrid.py``
(its ``family`` and bars).

- the encoders, per input layer, in float32 and bf16; the Branchformer's
  cached ``decode_beam``; the E-Branchformer's ``decode_beam_align`` (its
  beam's tokens, lengths and scores, and every hypothesis's alignment
  frame for frame);
- ``ops/dwconv.py`` ``depthwise_conv1d`` against ``funasr_tpu/ops/dwconv.py``
  with same padding, as ``branchformer.py`` calls it: float32 within 1e-6,
  bf16 within one bf16 ulp of |x| < 4 (0.0156: the sums round once);
- the unmasked convolutions: with the pad frames of one row changed, the
  valid frames of both packages' encoders move (the CSGU and merge
  convolutions see the pad frames, as the reference's do), and the port
  still equals JAX on the new batch within 1e-5.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from funasr_tpu.ops.dwconv import conv1d_grouped
from funasr_torch.ops.dwconv import depthwise_conv1d
from tests.test_torch_transformer_hybrid import (assert_same_beam, check_cached_beam,
                                                 check_encoder, family, jax_beam, jax_encode,
                                                 speech)
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("input_layer", ["conv2d", "linear"])
@pytest.mark.parametrize("name", ["branchformer", "ebranchformer"])
def test_encoder_matches_jax(name, input_layer, dtype):
    check_encoder(name, input_layer, dtype)


def test_cached_decode_beam_matches_jax():
    check_cached_beam("branchformer")


def test_decode_beam_align_matches_jax():
    """E-Branchformer: its beam as JAX's, every hypothesis's CTC alignment
    equal to JAX's."""
    jm, variables, tm = family("ebranchformer", "conv2d")
    x, lens = speech(seed=8, T=60)
    kw = dict(beam=4, maxlen=12, decoding_ctc_weight=0.3)
    w_tok, w_len, w_score, w_align, w_el = jax_beam(jm, variables, x, lens,
                                                    method="decode_beam_align", **kw)
    got = tm.decode_beam_align(torch.from_numpy(x), torch.from_numpy(lens), **kw)
    assert_same_beam(got, (w_tok, w_len, w_score))
    np.testing.assert_array_equal(got.enc_lens.numpy(), w_el)
    np.testing.assert_array_equal(got.align.numpy(), w_align)
    assert (w_align != 0).sum() >= 5  # labels placed on frames


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", [3, 7])
def test_depthwise_conv1d_matches_jax(K, dtype):
    rng = np.random.default_rng(K)
    B, T, C = 2, 11, 6
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    kernel = rng.standard_normal((K, 1, C)).astype(np.float32)  # flax (K, 1, C)
    bias = rng.standard_normal(C).astype(np.float32)
    jdt = getattr(jnp, dtype)
    pad = (K - 1) // 2
    want = conv1d_grouped(jnp.asarray(x, jdt), jnp.asarray(kernel), pad, pad, C)
    want = np.asarray((want + jnp.asarray(bias).astype(jdt)).astype(jnp.float32))
    got = depthwise_conv1d(torch.from_numpy(x).to(getattr(torch, dtype)),
                           torch.from_numpy(kernel.transpose(2, 1, 0).copy()),
                           torch.from_numpy(bias))
    assert got.shape == (B, T, C) and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=1e-6 if dtype == "float32" else 2.0 ** -6)


@pytest.mark.parametrize("name", ["branchformer", "ebranchformer"])
def test_pad_frames_reach_valid_frames_as_in_jax(name):
    _, variables, tm = family(name, "linear")
    x, lens = speech(seed=11)
    x2 = x.copy()
    x2[2, lens[2]:] = 5.0  # row 2's pad frames only
    enc = jax_encode(name, "linear")
    outs = []
    for inp in (x, x2):
        want = np.asarray(enc(variables, jnp.asarray(inp), jnp.asarray(lens))[0])
        with torch.no_grad():
            got = tm.encode(torch.from_numpy(inp), torch.from_numpy(lens))[0].numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        outs.append((got, want))
    n = lens[2]
    for k in (0, 1):  # port, JAX: the valid frames near row 2's end moved
        assert np.abs(outs[1][k][2, :n] - outs[0][k][2, :n]).max() > 1e-3
        np.testing.assert_array_equal(outs[1][k][:2], outs[0][k][:2])
