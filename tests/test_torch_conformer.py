"""Port Conformer encoder and Transformer decoder against the JAX package.

A tiny hybrid Conformer (V=16, D=16, 2 heads, 2 blocks, conv kernel 7) is
initialised in JAX, its BatchNorm statistics moved away from (mean 0,
var 1) so that a BatchNorm fault cannot hide, and carried into the port by
``hybrid_from_jax``.  Inputs come from numpy with a seed; both run
in float32.  Encoder and decoder outputs agree to atol 1e-4 (different
float32 summation orders); lengths, position encodings and the relative
shift are exact.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from funasr_tpu.convert import conformer_from_torch
from funasr_tpu.models import conformer as JC
from funasr_tpu.models.transformer.model import Conformer as JaxConformer
from funasr_tpu.ops.posenc import transformer_encoding as jax_transformer_encoding
from funasr_torch.convert import hybrid_from_jax
from funasr_torch.models import conformer as TC
from funasr_torch.models.transformer.model import Conformer
from funasr_torch.ops.posenc import transformer_encoding
from tests.test_torch_vad import built_once
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

CONF = dict(
    vocab_size=16, input_size=20,
    encoder_conf=dict(output_size=16, attention_heads=2, linear_units=32,
                      num_blocks=2, cnn_module_kernel=7, dropout_rate=0.0,
                      input_layer="conv2d"),
    decoder_conf=dict(attention_heads=2, linear_units=32, num_blocks=2,
                      dropout_rate=0.0),
    ctc_weight=0.3,
)
TOL = 1e-4  # float32, different summation orders


def perturb_batch_stats(variables, seed=7):
    """BatchNorm running mean N(0, 0.5^2), var in [0.5, 2): away from the
    (0, 1) init, where a BatchNorm that ignored its statistics would pass."""
    rng = np.random.default_rng(seed)
    bn = variables["batch_stats"]["encoder"]["encoders"]["conv_module"]["norm"]
    bn["mean"] = (0.5 * rng.standard_normal(bn["mean"].shape)).astype(np.float32)
    bn["var"] = (0.5 + 1.5 * rng.random(bn["var"].shape)).astype(np.float32)
    return variables


def jax_variables(seed=0):
    return built_once(("jax_variables", seed),
                      lambda: _jax_variables_uncached(seed))


def _jax_variables_uncached(seed=0):
    jm = JaxConformer(**CONF)
    rng = np.random.default_rng(seed)
    B, T, U = 2, 40, 5
    variables = jax.jit(lambda k: jm.init(
        {"params": k, "dropout": k},
        jnp.asarray(rng.standard_normal((B, T, 20)), jnp.float32), jnp.array([T, T - 8]),
        jnp.asarray(rng.integers(3, 16, (B, U)), jnp.int32), jnp.array([U, U - 1]),
        deterministic=True))(jax.random.PRNGKey(seed))
    return jm, perturb_batch_stats(jax.tree_util.tree_map(np.array, variables))


@pytest.fixture(scope="module")
def models():
    jm, variables = jax_variables()
    tm = Conformer(**CONF, device="cpu")
    tm.load_state_dict(hybrid_from_jax(variables), strict=True)
    return jm, variables, tm


def test_rel_positional_encoding_exact():
    for T, d in ((1, 4), (7, 16), (95, 256)):
        want = np.asarray(JC.rel_positional_encoding(T, d))
        np.testing.assert_array_equal(TC.rel_positional_encoding(T, d).numpy(), want)


def test_transformer_encoding_exact():
    for T, d in ((1, 4), (97, 256)):
        np.testing.assert_array_equal(transformer_encoding(T, d).numpy(),
                                      np.asarray(jax_transformer_encoding(T, d)))


def test_rel_shift_exact():
    rng = np.random.default_rng(3)
    for B, H, T in ((2, 3, 5), (1, 2, 1), (1, 1, 17)):
        x = rng.standard_normal((B, H, T, 2 * T - 1)).astype(np.float32)
        np.testing.assert_array_equal(TC.rel_shift(torch.from_numpy(x)).numpy(),
                                      np.asarray(JC.rel_shift(jnp.asarray(x))))


def test_encoder_matches_jax(models):
    jm, variables, tm = models
    rng = np.random.default_rng(5)
    B, T = 3, 44
    speech = rng.standard_normal((B, T, 20)).astype(np.float32)
    lens = np.array([T, T - 9, T - 21], np.int32)
    want, want_lens = jm.apply(variables, jnp.asarray(speech), jnp.asarray(lens),
                               method=jm.encode)
    got, got_lens = tm.encode(torch.from_numpy(speech), torch.from_numpy(lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert got.shape == want.shape == (B, 10, 16)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("T", [7, 16, 29])
def test_subsampling_lengths_ragged(T):
    """olens = min((L + 3) // 4, T') for every L from 0 to T, T' the conv
    output length, as in the JAX package (conformer.py:232-237)."""
    lens = np.arange(0, T + 1, dtype=np.int32)
    sub = TC.Conv2dSubsampling(20, 8)
    _, got = sub(torch.zeros((len(lens), T, 20)), torch.from_numpy(lens))
    js = JC.Conv2dSubsampling(8)
    x = jnp.zeros((len(lens), T, 20))
    _, want = js.apply(js.init(jax.random.PRNGKey(0), x, jnp.asarray(lens)),
                       x, jnp.asarray(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    t2 = ((T - 3) // 2 + 1 - 3) // 2 + 1
    np.testing.assert_array_equal(got.numpy(), np.minimum((lens + 3) // 4, t2))


def test_decoder_full_prefix_matches_jax(models):
    jm, variables, tm = models
    rng = np.random.default_rng(6)
    B, T, U = 2, 9, 6
    mem = rng.standard_normal((B, T, 16)).astype(np.float32)
    mlens = np.array([T, 5], np.int32)
    ys = rng.integers(0, 16, (B, U)).astype(np.int32)
    ylens = np.array([U, 4], np.int32)
    dec = jm.bind(variables).decoder_module
    want = dec(jnp.asarray(mem), jnp.asarray(mlens), jnp.asarray(ys), jnp.asarray(ylens))
    got = tm.decoder(torch.from_numpy(mem), torch.from_numpy(mlens),
                     torch.from_numpy(ys).long(), torch.from_numpy(ylens))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_encoder_state_dict_round_trips_through_jax_converter(models):
    """The port's encoder state dict, through funasr_tpu.convert's
    ``conformer_from_torch``, gives back the JAX params and batch stats."""
    _, variables, tm = models
    sd = {k[len("encoder."):]: v.numpy() for k, v in tm.state_dict().items()
          if k.startswith("encoder.")}
    f2 = ((20 - 1) // 2 - 1) // 2
    back = conformer_from_torch(sd, f2)
    for coll in ("params", "batch_stats"):
        want = jax.tree_util.tree_leaves_with_path(variables[coll]["encoder"])
        got = dict(jax.tree_util.tree_leaves_with_path(back[coll]))
        assert len(got) == len(want)
        for path, leaf in want:
            np.testing.assert_array_equal(np.asarray(got[path]), leaf, err_msg=str(path))
