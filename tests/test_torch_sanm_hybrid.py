"""The port's SANM CTC/attention hybrid (model class ``SANM``: the SANM
encoder, which keeps its ``"pe"`` input layer, under the Transformer
decoder and the joint CTC/attention beam) against the JAX package on the
CPU.

A tiny SANM hybrid with the aishell head size (D = 128, 2 heads: d = 64;
2 encoder and 2 decoder layers, 80 input features, vocabulary 20) is
initialised in JAX (jitted, once) and carried into the port by
``convert.hybrid_from_jax``; inputs from numpy seeds.

- the encoder, float32 within 1e-5 (``tests/test_torch_transformer_hybrid.py``'s
  bar), output lengths equal;
- cached ``decode_beam_align`` with ``nbest``: tokens and lengths equal,
  scores within 1e-4, every hypothesis's alignment equal frame for frame;
- int8 (``quantize=True``): the encoder's layers 1.. take the fused int8
  SANM layer (``quantize_weights`` builds it), its ``encoders0`` the QDense
  rule, and the model serves the beam;
- ``AutoModel`` from the aishell Transformer recipe's YAML with ``model:
  SANM``, ``encoder: SANMEncoder`` and E-Paraformer's ``encoder_conf``
  (widths overridden), without and with FSMN-VAD and CT-Transformer:
  records (text, timestamps, ``sentence_info``) equal to the JAX
  ``AutoModel``'s, scores within ``tests/test_torch_beam.py``'s engine bar
  (1e-3: the two frontends agree to 1e-3).
"""

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from funasr_tpu.models.transformer import model as JTM
from funasr_torch import convert as C
from funasr_torch.auto import engines as TE
from funasr_torch.models.sanm import SANMEncoder
from funasr_torch.models.transformer import model as TTM
from funasr_torch.ops import sanm_layer as SL
from tests.test_torch_e_paraformer import REPO, automodel_pair
from tests.test_torch_transformer_hybrid import TOKENS
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

YAML = os.path.join(REPO, "examples/aishell/transformer/conf/transformer_12e_6d_2048_256.yaml")
V, IN, D, NH = len(TOKENS), 80, 128, 2
ENC = dict(output_size=D, attention_heads=NH, linear_units=128, num_blocks=2,
           kernel_size=11, dropout_rate=0.0)
DEC = dict(attention_heads=NH, linear_units=128, num_blocks=2, dropout_rate=0.0)
CONF = dict(vocab_size=V, input_size=IN, encoder_conf=ENC, decoder_conf=DEC, ctc_weight=0.3)
F32_TOL = 1e-5
SCORE_TOL = 1e-4
ENGINE_SCORE_TOL = 1e-3  # test_torch_beam.py's engine bar
BEAM = dict(beam=4, maxlen=10, decoding_ctc_weight=0.3)


@functools.lru_cache(maxsize=None)
def jax_model():
    jm = JTM.SANM(**CONF)
    B, T, U = 2, 40, 5
    variables = jax.jit(lambda k: jm.init(
        {"params": k, "dropout": k}, jnp.zeros((B, T, IN)), jnp.array([T, T - 8]),
        jnp.zeros((B, U), jnp.int32), jnp.array([U, U - 1]), deterministic=True)
    )(jax.random.PRNGKey(0))
    return jm, jax.tree_util.tree_map(np.array, variables)


def port_model(variables, **kw):
    tm = TTM.SANM(**CONF, device="cpu", **kw)
    tm.load_state_dict(C.hybrid_from_jax(variables), strict=True)
    return tm.quantize_weights() if kw.get("quantize") else tm


def speech(seed=5, B=3, T=44):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, IN)).astype(np.float32)
    return x, np.array([T, T - 9, T - 21][:B], np.int32)


def test_encoder_matches_jax():
    jm, variables = jax_model()
    tm = port_model(variables)
    assert type(tm.encoder) is SANMEncoder and tm.encoder.input_layer == "pe"
    x, lens = speech()
    want, want_lens = jax.jit(lambda v, a, b: jm.apply(v, a, b, method=jm.encode))(
        variables, jnp.asarray(x), jnp.asarray(lens))
    with torch.no_grad():
        got, got_lens = tm.encode(torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    valid = np.arange(x.shape[1])[None, :, None] < lens[:, None, None]
    np.testing.assert_allclose(got.numpy() * valid, np.asarray(want) * valid, atol=F32_TOL,
                               rtol=0)


def test_decode_beam_align_matches_jax():
    jm, variables = jax_model()
    tm = port_model(variables)
    x, lens = speech()
    run = jax.jit(functools.partial(jm.apply, method=jm.decode_beam_align, **BEAM))
    w_tok, w_len, w_score, w_align, w_el = map(np.asarray, run(
        variables, jnp.asarray(x), jnp.asarray(lens)))
    got = tm.decode_beam_align(torch.from_numpy(x), torch.from_numpy(lens), nbest=3, **BEAM)
    np.testing.assert_array_equal(got.tokens.numpy(), w_tok)
    np.testing.assert_array_equal(got.lengths.numpy(), w_len)
    np.testing.assert_allclose(got.scores.numpy(), w_score, rtol=0, atol=SCORE_TOL)
    np.testing.assert_array_equal(got.enc_lens.numpy(), w_el)
    np.testing.assert_array_equal(got.align.numpy(), w_align[:, :3])
    assert w_len.max() >= 2 and (w_align != 0).sum() >= 3 and got.steps >= 2


def test_int8_serves_through_fused_sanm_layers(monkeypatch):
    _, variables = jax_model()
    calls = []
    monkeypatch.setattr(SL, "sanm_layer_ref",
                        lambda *a, f=SL.sanm_layer_ref, **k: calls.append(1) or f(*a, **k))
    tm = port_model(variables, dtype=torch.bfloat16, quantize=True)
    assert tm.encoder.encoders[0].int8 is not None and tm.encoder.encoders0[0].int8 is None
    assert tm.encoder.encoders0[0].feed_forward.int8 is not None
    x, lens = speech()
    got = tm.decode_beam(torch.from_numpy(x), torch.from_numpy(lens), **BEAM)
    assert len(calls) == ENC["num_blocks"] - 1
    assert np.isfinite(got.scores.numpy()).all() and got.lengths.min() >= 1


@pytest.mark.parametrize("with_vad", [False, True], ids=["plain", "vad_punc"])
def test_automodel_sanm_from_recipe_matches_jax(tmp_path, with_vad):
    from tests.test_torch_e_paraformer import wavs
    from tests.test_torch_vad import recording

    _, variables = jax_model()
    override = dict(model="SANM", encoder="SANMEncoder", encoder_conf=ENC, decoder_conf=DEC,
                    decoding_conf=dict(beam_size=3, maxlenratio_tokens=8))
    jam, am = automodel_pair(tmp_path, YAML, override, variables, C.hybrid_from_jax,
                             with_vad, TOKENS)
    assert isinstance(am.engine, TE.HybridEngine) and type(am.engine.module) is TTM.SANM
    assert type(am.engine.module.encoder) is SANMEncoder
    inputs = recording(0) if with_vad else wavs()[:2]
    keys = ["a"] if with_vad else ["a", "b"]
    want = jam.generate(inputs, key=keys)
    got = am.generate(inputs, key=keys)
    strip = lambda r: {k: v for k, v in r.items() if k != "score"}
    assert [strip(r) for r in got] == [strip(r) for r in want]
    np.testing.assert_allclose([r.get("score", 0.0) for r in got],
                               [r.get("score", 0.0) for r in want], atol=ENGINE_SCORE_TOL)
    assert all(isinstance(r["text"], str) for r in got)
    if with_vad:
        assert got[0]["text"] and got[0]["sentence_info"] and got[0]["timestamp"]
