"""Port joint CTC/attention beam search against the JAX package.

The tiny hybrid Conformer of ``test_torch_conformer.py`` (V=16, D=16,
BatchNorm statistics perturbed) decodes numpy inputs in float32 in both
packages.  Each JAX beam is jitted once per configuration.  Bars:

- float32 ``decode_beam``, CTC weight 0.3 and 0.0, cached and full-prefix
  scoring, maxlen 8 and the staged-cache maxlen 32: tokens and lengths
  equal, scores atol 1e-4;
- the int8 KV cache (``int8_kv=True`` against JAX with
  ``FUNASR_TPU_INT8_KV=1``): top-1 tokens equal, scores atol 0.1 (per-row
  int8 rounding);
- forced ties: the same tokens and order as ``lax.top_k``/``argsort``;
- ``HybridEngine.transcribe(device="cpu")`` against the JAX
  ``HybridEngine``: texts and n-best token lists equal, scores atol 1e-3
  (the frontends agree to 1e-3), n-best sorted; with timestamps the same
  texts, a stamp a token.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from funasr_tpu.auto import engines as JE
from funasr_tpu.models.transformer.model import Conformer as JaxConformer
from funasr_tpu.ops import beam_search as JB
from funasr_tpu.tokenizer.char_tokenizer import CharTokenizer as JaxTokenizer
from funasr_torch.auto import engines as TE
from funasr_torch.convert import hybrid_from_jax
from funasr_torch.models.transformer.model import Conformer
from funasr_torch.ops import beam_search as TB
from funasr_torch.ops import quant as Q
from funasr_torch.tokenizer.char_tokenizer import CharTokenizer
from tests.test_torch_conformer import CONF, jax_variables, perturb_batch_stats
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

SCORE_TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jm, variables = jax_variables()
    tm = Conformer(**CONF, device="cpu")
    tm.load_state_dict(hybrid_from_jax(variables), strict=True)
    rng = np.random.default_rng(5)
    B, T = 3, 44
    speech = rng.standard_normal((B, T, 20)).astype(np.float32)
    lens = np.array([T, T - 8, T - 16], np.int32)
    return jm, variables, tm, speech, lens


def jax_beam(jm, variables, speech, lens, **kw):
    run = jax.jit(functools.partial(jm.apply, method=jm.decode_beam, **kw))
    return [np.asarray(a) for a in run(variables, jnp.asarray(speech), jnp.asarray(lens))]


def assert_same_beam(got, want, score_tol=SCORE_TOL):
    np.testing.assert_array_equal(got.tokens.numpy(), want[0])
    np.testing.assert_array_equal(got.lengths.numpy(), want[1])
    np.testing.assert_allclose(got.scores.numpy(), want[2], atol=score_tol, rtol=0)


@pytest.mark.parametrize("ctc_weight", [0.3, 0.0])
@pytest.mark.parametrize("use_cache", [True, False])
def test_decode_beam_matches_jax(models, ctc_weight, use_cache):
    jm, variables, tm, speech, lens = models
    kw = dict(beam=4, maxlen=8, decoding_ctc_weight=ctc_weight, use_cache=use_cache)
    want = jax_beam(jm, variables, speech, lens, **kw)
    got = tm.decode_beam(torch.from_numpy(speech), torch.from_numpy(lens), **kw)
    assert_same_beam(got, want)
    assert 1 <= got.steps <= 8
    assert (np.diff(got.scores.numpy(), axis=1) <= 0).all()


@pytest.mark.parametrize("ctc_weight", [0.3, 0.0])
def test_staged_cache_maxlen32_matches_jax(models, ctc_weight):
    """maxlen >= 32 engages the four-stage cache growth (8/16/24/32) in both
    packages; a single-stage port decode gives the same beam (scores to
    1e-5, as tests/test_beam_search.py holds the JAX stages)."""
    jm, variables, tm, speech, lens = models
    kw = dict(beam=3, maxlen=32, decoding_ctc_weight=ctc_weight)
    want = jax_beam(jm, variables, speech, lens, **kw)
    args = (torch.from_numpy(speech), torch.from_numpy(lens))
    got = tm.decode_beam(*args, **kw)
    assert_same_beam(got, want)
    one = tm.decode_beam(*args, cache_stages=1, **kw)
    assert torch.equal(one.tokens, got.tokens) and torch.equal(one.lengths, got.lengths)
    # masked cache rows add exact zeros, but a longer buffer sums in another order
    np.testing.assert_allclose(one.scores.numpy(), got.scores.numpy(), atol=1e-5, rtol=0)


def test_int8_kv_cache_matches_jax(models, monkeypatch):
    jm, variables, tm, speech, lens = models
    kw = dict(beam=4, maxlen=8, decoding_ctc_weight=0.3)
    monkeypatch.setenv("FUNASR_TPU_INT8_KV", "1")  # read when the JAX beam is traced
    want = jax_beam(jm, variables, speech, lens, **kw)
    got = tm.decode_beam(torch.from_numpy(speech), torch.from_numpy(lens),
                         int8_kv=True, **kw)
    np.testing.assert_array_equal(got.tokens.numpy()[:, 0], want[0][:, 0])
    np.testing.assert_allclose(got.scores.numpy(), want[2], atol=0.1, rtol=0)
    fp = tm.decode_beam(torch.from_numpy(speech), torch.from_numpy(lens), **kw)
    assert not torch.equal(fp.scores, got.scores)  # the int8 cache was used


@pytest.mark.parametrize("ctc", [False, True])
def test_forced_ties_follow_jax_order(ctc):
    """A decoder whose log-probs tie across tokens (and, with CTC, uniform
    frame posteriors): every selection meets equal scores, at step 0 also
    the NEG_INF rows of the empty beam.  Tokens, lengths and order must be
    JAX's: equal values lowest index first."""
    V, K, maxlen, sos, eos, B, T = 7, 4, 5, 1, 2, 2, 6
    table = np.full((maxlen + 1, V), np.log(1.0 / V), np.float32)
    table[:, eos] = -3.0
    table[:, 5] = -1.0  # one distinct token
    kw = dict(ctc_weight=0.5 if ctc else 0.0)
    ctc_logp = np.full((B, T, V), np.log(1.0 / V), np.float32)

    def j_decode(ys, step):
        return jnp.broadcast_to(jnp.asarray(table)[step][None], (ys.shape[0], V))

    def t_decode(ys, step):
        return torch.from_numpy(table)[step][None].expand(ys.shape[0], V)

    want = JB.beam_search(j_decode, B, K, V, sos, eos, maxlen,
                          ctc_logp=jnp.asarray(ctc_logp) if ctc else None, **kw)
    got = TB.beam_search(t_decode, B, K, V, sos, eos, maxlen,
                         ctc_logp=torch.from_numpy(ctc_logp) if ctc else None, **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-5)
    assert (np.diff(got.scores.numpy(), axis=1) == 0).any()  # tied hypotheses


def test_topk_stable_breaks_ties_by_index():
    x = torch.tensor([[0.0, 1.0, 1.0, -2.0, 1.0, 0.0]])
    v, i = TB.topk_stable(x, 4)
    assert i.tolist() == [[1, 2, 4, 0]] and v.tolist() == [[1.0, 1.0, 1.0, 0.0]]


ENGINE_CONF = dict(
    vocab_size=20, input_size=80,
    encoder_conf=dict(output_size=16, attention_heads=2, linear_units=32,
                      num_blocks=1, cnn_module_kernel=5, dropout_rate=0.0),
    decoder_conf=dict(attention_heads=2, linear_units=32, num_blocks=1,
                      dropout_rate=0.0),
    ctc_weight=0.3,
)
TOKENS = ["<blank>", "<s>", "</s>"] + [chr(0x4E00 + i) for i in range(16)] + ["<unk>"]


@pytest.fixture(scope="module")
def engines():
    jm = JaxConformer(**ENGINE_CONF)
    variables = jax.jit(lambda k: jm.init(
        {"params": k, "dropout": k}, jnp.zeros((1, 32, 80)), jnp.array([32]),
        jnp.zeros((1, 4), jnp.int32), jnp.array([4]), deterministic=True)
    )(jax.random.PRNGKey(3))
    variables = perturb_batch_stats(jax.tree_util.tree_map(np.array, variables))
    kw = dict(beam=3, maxlen=8, decoding_ctc_weight=0.3)
    jax_engine = JE.HybridEngine(jm, variables, JE.FrontendConfig(lfr_m=1, lfr_n=1),
                                 JaxTokenizer(TOKENS), **kw)
    tm = Conformer(**ENGINE_CONF, device="cpu")
    tm.load_state_dict(hybrid_from_jax(variables), strict=True)
    port_engine = TE.HybridEngine(tm, TE.FrontendConfig(lfr_m=1, lfr_n=1),
                                  CharTokenizer(TOKENS), device="cpu", **kw)
    return jax_engine, port_engine, variables


@pytest.fixture(scope="module")
def wavs():
    rng = np.random.default_rng(12)
    return [(0.1 * np.sin(2 * np.pi * (180 + 120 * i) * np.arange(n) / 16000.0)
             + 0.05 * rng.standard_normal(n)).astype(np.float32)
            for i, n in enumerate((9000, 16500, 6400))]


def test_transcribe_matches_jax(engines, wavs):
    jax_engine, port_engine, _ = engines
    want = jax_engine.transcribe(wavs, nbest=3)
    steps = port_engine.steps
    got = port_engine.transcribe(wavs, nbest=3)
    assert port_engine.steps > steps
    assert [r["text"] for r in got] == [r["text"] for r in want]
    for g, w in zip(got, want):
        assert g["raw_tokens"] == w["raw_tokens"]
        assert [h["tokens"] for h in g["nbest"]] == [h["tokens"] for h in w["nbest"]]
        np.testing.assert_allclose([h["score"] for h in g["nbest"]],
                                   [h["score"] for h in w["nbest"]], atol=1e-3)
        scores = [h["score"] for h in g["nbest"]]
        assert len(scores) == 3 and scores == sorted(scores, reverse=True)
        assert g["score"] == scores[0] and g["text"] == g["nbest"][0]["text"]
    assert port_engine.transcribe([]) == []
    # with timestamps (parity: tests/test_torch_hybrid_align.py): the same
    # hypotheses, each token stamped
    stamped = port_engine.transcribe(wavs, with_timestamp=True)
    assert [r["text"] for r in stamped] == [r["text"] for r in got]
    assert all(len(r["timestamp"]) == len(r["raw_tokens"]) for r in stamped)


def test_quantized_int8_kv_engine_serves_on_cpu(engines, wavs, monkeypatch):
    """``quantize=True`` in bfloat16 with the int8 KV cache, the serving
    configuration, on the CPU: the gate forced open so every QDense-rule
    projection takes the int8 linear; results are sorted and finite."""
    _, _, variables = engines
    calls = []
    monkeypatch.setattr(Q, "MIN_M", 0)
    monkeypatch.setattr(Q, "MIN_N", 0)
    real = Q.int8_linear
    monkeypatch.setattr(Q, "int8_linear", lambda *a, **k: calls.append(1) or real(*a, **k))
    tm = Conformer(**ENGINE_CONF, device="cpu", dtype=torch.bfloat16, quantize=True)
    tm.load_state_dict(hybrid_from_jax(variables), strict=True)
    with pytest.raises(RuntimeError, match="quantize_weights"):
        tm.decode_beam(torch.zeros((1, 64, 80)), torch.tensor([64]))
    tm.quantize_weights()
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    engine = TE.HybridEngine(tm, TE.FrontendConfig(lfr_m=1, lfr_n=1),
                             CharTokenizer(TOKENS), beam=3, maxlen=8, int8_kv=True,
                             device="cpu")
    res = engine.transcribe(wavs, nbest=3)
    assert calls and len(res) == len(wavs)
    for r in res:
        scores = [h["score"] for h in r["nbest"]]
        assert np.isfinite(scores).all() and scores == sorted(scores, reverse=True)
