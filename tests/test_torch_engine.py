"""Port ``ParaformerEngine.transcribe(device="cpu")`` against the JAX
``ParaformerEngine`` on the same waveforms and weights.

A tiny Paraformer (V=32, D=32) initialised in JAX, its params carried over
by ``paraformer_from_jax``; waveforms from numpy with a seed.  Tokens,
token lengths, CIF peaks and texts must be identical; features agree to
atol 1e-3 (the port's CPU frontend is the fused-operator twin, the JAX
package's is its plain XLA fbank: the fbank kernel test's bar).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from funasr_tpu.auto import engines as JE
from funasr_tpu.models.paraformer.model import Paraformer as JaxParaformer
from funasr_tpu.tokenizer.char_tokenizer import CharTokenizer as JaxTokenizer
from funasr_torch.auto import engines as TE
from funasr_torch.convert import paraformer_from_jax
from funasr_torch.models.paraformer.model import Paraformer
from funasr_torch.tokenizer.char_tokenizer import CharTokenizer
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

V, D = 32, 32
CONF = dict(
    vocab_size=V, input_size=560,
    encoder_conf=dict(output_size=D, attention_heads=2, linear_units=48,
                      num_blocks=2, kernel_size=5),
    decoder_conf=dict(attention_heads=2, linear_units=48, num_blocks=2,
                      att_layer_num=2, kernel_size=5),
    predictor_conf=dict(idim=D, threshold=1.0, l_order=1, r_order=1,
                        tail_threshold=0.45),
)
TOKENS = ["<blank>", "<s>", "</s>"] + [chr(0x4E00 + i) for i in range(V - 4)] \
    + ["<unk>"]


@pytest.fixture(scope="module")
def engines():
    jm = JaxParaformer(**CONF)
    params = jax.jit(lambda key: jm.init(
        {"params": key}, jnp.zeros((1, 16, 560)), jnp.array([16]),
        max_tokens=8, method=jm.greedy_decode))(jax.random.PRNGKey(1))
    params = jax.tree_util.tree_map(np.asarray, params)
    jax_engine = JE.ParaformerEngine(jm, params, JE.FrontendConfig(),
                                     JaxTokenizer(TOKENS))
    tm = Paraformer(**CONF, device="cpu")
    tm.load_state_dict(paraformer_from_jax(params), strict=True)
    port_engine = TE.ParaformerEngine(tm, TE.FrontendConfig(),
                                      CharTokenizer(TOKENS), device="cpu")
    return jax_engine, port_engine


@pytest.fixture(scope="module")
def wavs():
    rng = np.random.default_rng(11)
    n = [24000, 9000, 15500]
    t = [np.arange(m) / 16000.0 for m in n]
    return [(0.1 * np.sin(2 * np.pi * (200 + 150 * i) * ti)
             + 0.05 * rng.standard_normal(len(ti))).astype(np.float32)
            for i, ti in enumerate(t)]


def test_pack_and_token_budget_match_jax(engines, wavs):
    jax_engine, port_engine = engines
    jw, jl = jax_engine._pack(wavs)
    tw, tl = port_engine._pack(wavs)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    for n in (4000, 64000, 240000, 1000000):
        assert TE.quantize(n) == JE.quantize(n)
        assert port_engine._max_tokens(n) == jax_engine._max_tokens(n)


def test_device_features_match_jax(engines, wavs):
    jax_engine, port_engine = engines
    jw, jl = jax_engine._pack(wavs)
    want, want_lens = jax_engine.frontend.device_features(jw, jl)
    got, got_lens = port_engine.frontend.device_features(
        *port_engine._pack(wavs))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert got.shape == want.shape and got.shape[1] % 128 == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-3)


def test_device_program_matches_jax(engines, wavs):
    jax_engine, port_engine = engines
    jw, jl = jax_engine._pack(wavs)
    max_tokens = jax_engine._max_tokens(jw.shape[1])
    want = jax_engine._run(jax_engine.params, jw, jl, max_tokens)
    got = port_engine.run(*port_engine._pack(wavs), max_tokens)
    n = np.asarray(want[1])
    np.testing.assert_array_equal(got[1].numpy(), n)
    for i, m in enumerate(n):
        np.testing.assert_array_equal(got[0].numpy()[i, :m],
                                      np.asarray(want[0])[i, :m])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_transcribe_matches_jax(engines, wavs):
    jax_engine, port_engine = engines
    want = jax_engine.transcribe(wavs)
    got = port_engine.transcribe(wavs)
    assert got == want
    assert any(r["text"] for r in got)
    assert port_engine.transcribe([]) == []
