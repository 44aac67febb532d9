"""SenseVoiceSmall of the port (``funasr_torch/models/sense_voice``,
``ops/ctc_decode.py``, ``ops/ctc_align.py``, ``SenseVoiceEngine``) against
the JAX package on the CPU.

- ``ctc_greedy_decode``: equal to JAX's, ties (first maximum) included.
- The CTC forced alignment, ``align_emissions`` then ``viterbi`` (the
  composition the engines serve): equal to JAX's ``ctc_forced_align``,
  frame for frame, over repeated labels, an empty target, ragged lengths,
  equal scores everywhere, one frame, and probability-domain scores as
  ``tests/test_ctc_align.py`` has them.  The port gathers the emissions in
  torch and runs the Viterbi in numpy; the JAX package runs two
  ``lax.scan``s.
- The model, tiny (``tests/test_sensevoice.py``'s widths: D = 16, 3 + 2
  layers; input 560 so the engine's frontend feeds it; the generated
  vocabulary of 40 entries, rich tags and numerals inside), initialised in
  JAX and loaded through ``convert.sense_voice_from_jax``: float32 encoder
  output and log-probs within the float32 Paraformer bar (atol 1e-4),
  tokens, token lengths and alignments (``decode_for_alignment``, then
  ``viterbi``) equal; the state dict converts back
  to the JAX tree (``funasr_tpu.convert.sense_voice_from_torch``).
- int8 (``quantize=True``, bf16 activations) against the JAX package's int8
  module path (``quant.quantized(True)``; the QDense gate at its defaults,
  and at 0 on both sides so every projection, ``ctc_lo`` included, is
  int8): lengths equal, log-probs within 0.15, and the frames' argmax
  agree on >= 0.99 of the frames where JAX's top-2 margin exceeds 0.3 and
  on >= 0.9 of all, the bars of ``tests/test_torch_paraformer_int8.py``;
  on every frame the port's argmax is one JAX's log-probs put within 0.3
  of its best.
  The port runs its fused int8 layers' function, the JAX package on the
  CPU its module path (its Pallas layer needs T % 8 == 0, and T + 4 never
  is in serving); the two agree to the int8 noise floor, and in JAX's own
  bf16 logits 2-4 of these 82 frames are exact or near ties (measured), so
  the collapsed token sequences can differ in length by one.
- ``SenseVoiceEngine.transcribe`` with and without timestamps, for each
  language and ``use_itn``: records equal to the JAX engine's.
"""

import itertools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from funasr_tpu.auto import engines as JE
from funasr_tpu.models.sense_voice.model import SenseVoiceSmall as JaxSenseVoice
from funasr_tpu.ops import quant as JQ
from funasr_tpu.ops.ctc_align import ctc_forced_align as jax_align
from funasr_tpu.ops.ctc_decode import ctc_greedy_decode as jax_greedy
from funasr_tpu.tokenizer.char_tokenizer import CharTokenizer as JaxCharTokenizer
from funasr_torch import convert as C
from funasr_torch.auto import engines as TE
from funasr_torch.models.sense_voice.model import (LID_DICT, N_PROMPT, SenseVoiceSmall,
                                                   lid_id, textnorm_id)
from funasr_torch.ops import quant as Q
from funasr_torch.ops.ctc_align import align_emissions, viterbi
from funasr_torch.ops.ctc_decode import ctc_greedy_decode
from funasr_torch.tokenizer.char_tokenizer import CharTokenizer
from funasr_torch.tokenizer.sensevoice_tokenizer import generated_token_list
from tests.test_torch_vad import built_once
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

V = 40
TOKENS = generated_token_list(V)
CONF = dict(vocab_size=V, input_size=560,
            encoder_conf=dict(output_size=16, attention_heads=2, linear_units=32,
                              num_blocks=3, tp_blocks=2, kernel_size=5))
F32_ATOL = 1e-4  # the float32 Paraformer test's bar
# int8: the int8 Paraformer test's bars (tests/test_torch_paraformer_int8.py):
# frames' argmax agree where JAX's top-2 margin exceeds twice the log-prob
# bar; elsewhere the bf16 logits sit on near or exact ties either side breaks
INT8_LOGP_ATOL = 0.15
INT8_MIN_AGREE = 0.99
INT8_MIN_AGREE_ALL = 0.9


def init_sense_voice(conf=CONF, seed=0):
    """A jitted JAX init (eager flax init is slow) -> (module, numpy tree)."""
    return built_once(("init_sense_voice", repr(conf), seed),
                      lambda: _init_sense_voice_uncached(conf, seed))


def _init_sense_voice_uncached(conf=CONF, seed=0):
    jm = JaxSenseVoice(**conf)
    n = conf["input_size"]
    z = jnp.zeros((1,), jnp.int32)
    p = jax.jit(lambda key: jm.init({"params": key}, jnp.zeros((1, 8, n)), jnp.array([8]),
                                    z, z, method=jm.greedy_decode))(jax.random.PRNGKey(seed))
    return jm, jax.tree_util.tree_map(np.asarray, p)


def port_model(params, conf=CONF, **kw):
    tm = SenseVoiceSmall(**conf, device="cpu", **kw)
    tm.load_state_dict(C.sense_voice_from_jax(params), strict=True)
    return tm.quantize_weights() if kw.get("quantize") else tm


@pytest.fixture(scope="module")
def models():
    jm, p = init_sense_voice()
    return jm, p, port_model(p)


def _speech(seed=3, B=3, T=37):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, CONF["input_size"])).astype(np.float32)
    return x, np.array([T, T - 9, 5][:B], np.int32)


def _prompts(B, language="zh", use_itn=False):
    return (np.full((B,), lid_id(language), np.int32),
            np.full((B,), textnorm_id(use_itn), np.int32))


# ------------------------------------------------------------ greedy decode
def _greedy_cases():
    rng = np.random.default_rng(0)
    path = np.array([[1, 1, 0, 2, 2, 3]])
    one_hot = np.eye(4, dtype=np.float32)[path] * 10.0
    ties = np.zeros((2, 7, 5), np.float32)  # every frame a 5-way tie: blank wins
    ties[1, 2:5, 3] = 1.0
    ties[1, 3, 4] = 1.0  # a 2-way tie at frame 3: 3 (the first) wins
    rand = rng.standard_normal((4, 30, 6)).astype(np.float32)
    rand[:, ::3] = np.round(rand[:, ::3])  # rounded rows: ties between labels
    return [("one_hot", one_hot, [6]), ("one_hot_len3", one_hot, [3]),
            ("ties", ties, [7, 6]), ("random", rand, [30, 17, 1, 0])]


@pytest.mark.parametrize("case", range(4), ids=[c[0] for c in _greedy_cases()])
def test_ctc_greedy_decode_matches_jax(case):
    _, lp, lens = _greedy_cases()[case]
    want_t, want_l = jax_greedy(jnp.asarray(lp), jnp.asarray(lens))
    got_t, got_l = ctc_greedy_decode(torch.from_numpy(lp), torch.tensor(lens))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


# ------------------------------------------------------------ forced alignment
def _align_cases():
    rng = np.random.default_rng(4)
    cases = []
    for seed in (0, 1, 2):  # tests/test_ctc_align.py's brute-force inputs
        r = np.random.default_rng(seed)
        cases.append((f"log_seed{seed}", np.log(r.dirichlet(np.ones(4), size=(1, 6))),
                      [[1, 2]], [6], [2]))
    rep = np.full((1, 5, 3), np.log(0.1))
    rep[..., 1] = np.log(0.8)
    cases.append(("repeated_labels", rep, [[1, 1]], [5], [2]))
    cases.append(("repeated_run", np.log(rng.dirichlet(np.ones(3), size=(1, 12))),
                  [[2, 2, 1, 1, 2]], [12], [5]))
    cases.append(("empty_target", np.log(rng.dirichlet(np.ones(4), size=(2, 6))),
                  [[0, 0], [3, 0]], [6, 4], [0, 1]))
    cases.append(("ragged", np.log(rng.dirichlet(np.ones(5), size=(2, 8))),
                  [[1, 2, 3], [4, 1, 0]], [8, 5], [3, 2]))
    cases.append(("probabilities", rng.dirichlet(np.ones(4), size=(1, 7)), [[2, 3]], [7], [2]))
    probs = rng.dirichlet(np.ones(6), size=(3, 20))
    probs[..., 0] = np.where(probs.argmax(-1) == 0, 0.0, probs[..., 0])  # SenseVoice's quirk
    cases.append(("probabilities_batch", probs, [[1, 2, 3, 4, 5], [5, 5, 1, 0, 0], [2, 0, 0, 0, 0]],
                  [20, 13, 3], [5, 3, 1]))
    cases.append(("equal_scores", np.zeros((2, 9, 4)), [[1, 2, 2], [3, 1, 0]], [9, 7], [3, 2]))
    cases.append(("one_frame", np.log(rng.dirichlet(np.ones(3), size=(2, 1))), [[1], [2]],
                  [1, 1], [1, 0]))
    return cases


@pytest.mark.parametrize("case", range(11), ids=[c[0] for c in _align_cases()])
def test_ctc_forced_align_matches_jax(case):
    _, scores, targets, ilens, tlens = _align_cases()[case]
    scores = np.asarray(scores, np.float32)
    targets, ilens, tlens = (np.asarray(a, np.int32) for a in (targets, ilens, tlens))
    want = np.asarray(jax_align(jnp.asarray(scores), jnp.asarray(targets),
                                jnp.asarray(ilens), jnp.asarray(tlens)))
    em = align_emissions(torch.from_numpy(scores), torch.from_numpy(targets),
                         torch.from_numpy(ilens), torch.from_numpy(tlens))
    got = viterbi(em.numpy(), targets, ilens, tlens)
    np.testing.assert_array_equal(got, want)
    for row, n, u, tgt in zip(got, ilens, tlens, targets):  # collapses to the target
        lab = [k for k, _ in itertools.groupby(row[:n].tolist()) if k != 0]
        assert lab == tgt[:u].tolist()


# ------------------------------------------------------------ the model
def test_state_dict_converts_both_ways(models):
    from funasr_tpu.convert import sense_voice_from_torch

    _, p, tm = models
    back = sense_voice_from_torch({k: v.numpy() for k, v in tm.state_dict().items()})
    flat = jax.tree_util.tree_leaves_with_path(back["params"])
    want = dict(jax.tree_util.tree_leaves_with_path(p["params"]))
    assert len(flat) == len(want) and "encoder.tp_norm.weight" in tm.state_dict()
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(leaf), want[path])


@pytest.mark.parametrize("language,use_itn", [("zh", False), ("auto", True)])
def test_float32_matches_jax(models, language, use_itn):
    jm, p, tm = models
    x, lens = _speech()
    lid, tn = _prompts(len(lens), language, use_itn)
    j_args = (jnp.asarray(x), jnp.asarray(lens), jnp.asarray(lid), jnp.asarray(tn))
    t_args = tuple(torch.from_numpy(a) for a in (x, lens, lid, tn))
    want_enc, want_el = jm.apply(p, *j_args, method=jm.encode)
    with torch.no_grad():
        got_enc, got_el = tm.encode(*t_args)
        got_lp, _ = tm.log_probs(*t_args)
    want_lp = jax.nn.log_softmax(jm.apply(p, np.asarray(want_enc),
                                          method=lambda m, e: m.ctc_lo(e)), axis=-1)
    np.testing.assert_array_equal(got_el.numpy(), np.asarray(want_el))
    valid = np.arange(x.shape[1] + 4)[None] < np.asarray(want_el)[:, None]
    np.testing.assert_allclose(got_enc.numpy()[valid], np.asarray(want_enc)[valid],
                               atol=F32_ATOL, rtol=F32_ATOL)
    np.testing.assert_allclose(got_lp.numpy()[valid], np.asarray(want_lp)[valid],
                               atol=F32_ATOL, rtol=F32_ATOL)
    wt, wl, wa = jm.apply(p, *j_args, method=jm.greedy_decode_with_alignment)
    gt, gl, em, in_lens, tgt_lens = tm.decode_for_alignment(*t_args)
    ga = viterbi(em.numpy(), gt[:, N_PROMPT:].numpy(), in_lens.numpy(), tgt_lens.numpy())
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_array_equal(ga, np.asarray(wa))
    gt2, gl2 = tm.greedy_decode(*t_args)
    assert torch.equal(gt2, gt) and torch.equal(gl2, gl)


@pytest.mark.parametrize("gate_zero", [False, True], ids=["gate", "gate0"])
def test_int8_matches_jax_module_path(monkeypatch, models, gate_zero):
    jm, p, _ = models
    if gate_zero:
        for mod, m, n in ((JQ, "_MIN_M", "_MIN_N"), (Q, "MIN_M", "MIN_N")):
            monkeypatch.setattr(mod, m, 0)
            monkeypatch.setattr(mod, n, 0)
    tm = port_model(p, dtype=torch.bfloat16, quantize=True)
    assert tm.ctc.ctc_lo.w8 is not None and tm.encoder.tp_encoders[0].int8 is not None
    x, lens = _speech(seed=11)
    args = (x, lens, *_prompts(len(lens)))
    jq = JaxSenseVoice(**CONF, dtype=jnp.bfloat16)

    def jax_log_probs(*a):
        enc, el = jq.apply(p, *a, method=jq.encode)
        logits = jq.apply(p, enc, method=lambda m, e: m.ctc_lo(e))
        return jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1), el

    with JQ.quantized(True):
        want, want_el = jax.jit(jax_log_probs)(*(jnp.asarray(a) for a in args))
    with torch.no_grad():
        got, got_el = tm.log_probs(*(torch.from_numpy(a) for a in args))
    want, got = np.asarray(want), got.numpy()
    np.testing.assert_array_equal(got_el.numpy(), np.asarray(want_el))
    valid = np.arange(got.shape[1])[None] < got_el.numpy()[:, None]
    np.testing.assert_allclose(got[valid], want[valid], rtol=0, atol=INT8_LOGP_ATOL)
    same = (got.argmax(-1) == want.argmax(-1))[valid]
    top2 = np.sort(want, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0])[valid] > 2 * INT8_LOGP_ATOL
    assert clear.sum() >= 8 and same[clear].mean() >= INT8_MIN_AGREE, same[clear].mean()
    assert same.mean() >= INT8_MIN_AGREE_ALL, same.mean()
    # every frame: the port's argmax is JAX's, or a token JAX's own
    # log-probs put within the near-tie band of its best, so the collapsed
    # tokens are JAX's with its near ties broken the port's way (every row
    # here has near-tie frames, so no row is compared whole)
    pick = np.take_along_axis(want, got.argmax(-1)[..., None], -1)[..., 0]
    slack = (want.max(-1) - pick)[valid]
    assert slack.max() <= 2 * INT8_LOGP_ATOL, slack.max()


def test_quantized_model_needs_quantize_weights(models):
    _, p, _ = models
    tm = SenseVoiceSmall(**CONF, device="cpu", quantize=True)
    tm.load_state_dict(C.sense_voice_from_jax(p), strict=True)
    x, lens = _speech(B=1)
    args = tuple(torch.from_numpy(a) for a in (x, lens, *_prompts(1)))
    with pytest.raises(RuntimeError, match="quantize_weights"):
        tm.greedy_decode(*args)
    tm.quantize_weights()
    assert tm.greedy_decode(*args)[1].shape == (1,)
    with pytest.raises(TypeError):
        SenseVoiceSmall(**CONF, device="cpu", lsm_weigth=0.1)


# ------------------------------------------------------------ the engine
def _wavs():
    from tests.test_torch_vad import tone

    rng = np.random.default_rng(2)
    return [tone(rng, 1.3, 260.0), tone(rng, 0.7, 180.0), tone(rng, 2.1, 330.0)]


def feature_cmvn(wavs):
    """A (2, 560) [shift; scale] CMVN that makes the LFR features of
    ``wavs`` zero-mean and unit-variance, as a trained model's ``am.mvn``
    does for speech: without one, the tiny random model reads every frame
    alike and emits one tag throughout."""
    from funasr_torch.ops import fbank as F

    fe = TE.FrontendConfig()
    lens = torch.tensor([len(w) for w in wavs])
    wav = torch.zeros((len(wavs), int(lens.max())))
    for i, w in enumerate(wavs):
        wav[i, : len(w)] = torch.from_numpy(w)
    feats, flens = F.apply_lfr(*fe.raw_fbank(wav, lens), fe.lfr_m, fe.lfr_n)
    v = torch.cat([feats[i, : int(n)] for i, n in enumerate(flens)]).numpy()
    return np.stack([-v.mean(0), 1.0 / (v.std(0) + 1e-5)]).astype(np.float32)


def write_cmvn(path, cmvn):
    """``cmvn`` as a kaldi-nnet ``am.mvn`` file (what ``cmvn_file`` loads)."""
    row = lambda v: "<LearnRateCoef> 0 [ " + " ".join(f"{x:.8g}" for x in v) + " ]"
    n = cmvn.shape[1]
    path.write_text("\n".join(["<Nnet>", f"<AddShift> {n} {n}", row(cmvn[0]),
                                f"<Rescale> {n} {n}", row(cmvn[1]), "</Nnet>", ""]))
    return str(path)


@pytest.fixture(scope="module")
def engines(models):
    jm, p, tm = models
    cmvn = feature_cmvn(_wavs())
    je = JE.SenseVoiceEngine(jm, p, JE.FrontendConfig(cmvn=cmvn), JaxCharTokenizer(TOKENS))
    return je, TE.SenseVoiceEngine(tm, TE.FrontendConfig(cmvn=cmvn), CharTokenizer(TOKENS),
                                   device="cpu")


@pytest.mark.parametrize("language", sorted(LID_DICT))
@pytest.mark.parametrize("use_itn", [False, True])
def test_engine_transcribe_matches_jax(engines, language, use_itn):
    je, te = engines
    wavs = _wavs()
    for kw in ({}, {"with_timestamp": True, "vad_offsets": [0, 130, 2410]},
               {"rich_text": False, "merge_vad": True}):
        want = je.transcribe(wavs, language=language, use_itn=use_itn, **kw)
        got = te.transcribe(wavs, language=language, use_itn=use_itn, **kw)
        assert got == want, kw
    assert all("timestamp" not in r for r in got)


def test_engine_async_and_timestamps(engines):
    je, te = engines
    wavs = _wavs()
    fin = te.transcribe_async(wavs, with_timestamp=True, vad_offsets=[100, 0, 50])
    got = fin()
    assert got == je.transcribe(wavs, with_timestamp=True, vad_offsets=[100, 0, 50])
    assert te.transcribe_async([])() == [] and te.transcribe([]) == []
    for r, off in zip(got, (100, 0, 50)):
        assert r["raw_text"] and len(r["timestamp"]) == len(r["raw_tokens"]) > 0
        assert all(off <= s <= e for s, e in r["timestamp"])
    assert te.handles_itn
