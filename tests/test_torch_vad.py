"""The port's FSMN-VAD (``funasr_torch/models/fsmn_vad``, ``VadEngine``)
against the JAX package on the CPU.

A tiny scorer as ``bench_pipeline.py --tiny`` builds it (2 FSMN layers,
linear 32, proj 16; the published 80 mels x LFR 5 input, lorder 20 and 248
outputs), initialised in JAX and carried over by ``convert.fsmn_vad_from_jax``.

- FSMN posteriors: float32, atol 1e-5 (sums in another order), the
  streaming cache too; the state dict round-trips through the JAX
  package's ``fsmn_vad_from_torch``.
- ``frame_decibel_device`` against the JAX host ``compute_decibel``
  (float64): atol 1e-4 dB.
- The state machine: the same segments from the port's and the JAX
  package's ``VadStateMachine`` on the same posteriors and decibels, offline
  and streaming (partials ``[beg, -1]`` / ``[-1, end]``), with the
  max-single-segment split, single-utterance mode, and decibels under the
  threshold (the double window update) among the option sets.
- ``VadEngine.segments`` and ``segments_shared`` equal to the JAX
  ``VadEngine``'s.  For the engines to have segments to find, the random
  scorer's last layer is set so that its silence posterior separates the
  test's tone from its silence (:func:`calibrated_params`); both packages
  run the same weights.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from funasr_tpu.auto import engines as JE
from funasr_tpu.models.fsmn_vad import model as JM
from funasr_tpu.models.fsmn_vad.encoder import FSMN as JaxFSMN
from funasr_torch.auto import engines as TE
from funasr_torch.convert import fsmn_vad_from_jax
from funasr_torch.models.fsmn_vad import model as TM
from funasr_torch.models.fsmn_vad.encoder import FSMN
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

_BUILT = {}


def built_once(key, build):
    """``build()`` once a process for ``key``, so a jitted JAX init compiles
    once for every test (of any port test file) that asks; each caller gets
    its own copy of the numpy leaves."""
    if key not in _BUILT:
        _BUILT[key] = build()
    return jax.tree_util.tree_map(
        lambda a: np.array(a) if isinstance(a, np.ndarray) else a, _BUILT[key])


CONF = dict(input_dim=400, input_affine_dim=32, fsmn_layers=2, linear_dim=32, proj_dim=16,
            lorder=20, rorder=0, lstride=1, rstride=1, output_affine_dim=32, output_dim=248)
POST_ATOL = 1e-5
DB_ATOL = 1e-4


def tone(rng, secs, f0=220.0):
    n = int(16000 * secs)
    return (0.3 * np.sin(2 * np.pi * f0 * np.arange(n) / 16000)
            + 0.01 * rng.standard_normal(n)).astype(np.float32)


def recording(seed=0):
    """tests/test_auto_model.py:74's recording: silence, 2 s of tone,
    silence, 1.5 s of tone, silence."""
    rng = np.random.default_rng(seed)
    return np.concatenate([np.zeros(8000, np.float32), tone(rng, 2.0),
                           np.zeros(12000, np.float32), tone(rng, 1.5),
                           np.zeros(8000, np.float32)])


def init_params(conf=CONF, seed=0):
    return built_once(("init_params", repr(conf), seed),
                      lambda: _init_params_uncached(conf, seed))


def _init_params_uncached(conf=CONF, seed=0):
    jm = JaxFSMN(**conf)
    x = jnp.zeros((1, 8, conf["input_dim"]))
    p = jax.jit(lambda key: jm.init(key, x))(jax.random.PRNGKey(seed))
    return jm, jax.tree_util.tree_map(np.asarray, p)


def calibrated_params(params, conf, frontend, seed=0):
    """``params`` with ``out_linear2`` replaced so that the silence posterior
    (pdf 0) is near 1 on silence and near 0 on a tone: its logit is a linear
    read-out of ``out_linear1``'s output that is +15 on a silent frame and
    -15 on a tone frame, every other logit 0.  The read-out direction comes
    from the port's scorer on the same weights."""
    model = FSMN(**conf)
    model.load_state_dict(fsmn_vad_from_jax(params), strict=True)
    seen = []
    model.out_linear1.register_forward_hook(lambda m, i, o: seen.append(o[0, -1]))
    rng = np.random.default_rng(seed)
    for clip in (np.zeros(16000, np.float32), tone(rng, 1.0)):
        wav = torch.from_numpy(clip)[None]
        feats, _ = frontend.device_features(wav, torch.tensor([len(clip)]))
        n = -(-((len(clip) - 400) // 160 + 1) // frontend.lfr_n)
        with torch.no_grad():
            model(feats[:, :n])
    h_sil, h_tone = (x.double().numpy() for x in seen)
    w = h_sil - h_tone
    a = 30.0 / float(w @ w)
    tree = jax.tree_util.tree_map(np.array, params)
    head = tree["params"]["out_linear2"]
    head["kernel"][:] = 0.0
    head["bias"][:] = 0.0
    head["kernel"][:, 0] = (a * w).astype(np.float32)
    head["bias"][0] = np.float32(-a * float(w @ (h_sil + h_tone)) / 2)
    return tree


def port_vad(params, conf=CONF, **opts):
    model = TM.FsmnVADStreaming(encoder_conf=conf, device="cpu", **opts)
    model.scorer.load_state_dict(fsmn_vad_from_jax(params), strict=True)
    return model


def jax_vad(params, conf=CONF, **opts):
    model = JM.FsmnVADStreaming(encoder_conf=conf, **opts)
    model.params = params
    return model


def test_fsmn_posteriors_match_jax():
    jm, p = init_params()
    x = np.random.default_rng(1).standard_normal((2, 70, 400)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(p, jnp.asarray(x)))
    tm = port_vad(p)
    got = tm.score(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 70, 248)
    np.testing.assert_allclose(got, want, rtol=0, atol=POST_ATOL)
    # streaming: chunks with the cache give the full-utterance posteriors
    cache, parts = tm.scorer.init_cache(2), []
    for a, b in ((0, 23), (23, 24), (24, 70)):
        out, cache = tm.score(torch.from_numpy(x[:, a:b]), cache)
        parts.append(out.numpy())
    np.testing.assert_allclose(np.concatenate(parts, 1), want, rtol=0, atol=POST_ATOL)
    jc = [jnp.zeros((2, 19, 16))] * 2
    w1, jc = jm.apply(p, jnp.asarray(x[:, :23]), jc)
    np.testing.assert_allclose(parts[0], np.asarray(w1), rtol=0, atol=POST_ATOL)


def test_fsmn_right_context_and_stride_match_jax():
    conf = dict(CONF, rorder=3, lstride=2, rstride=2)
    jm, p = init_params(conf, seed=3)
    x = np.random.default_rng(2).standard_normal((1, 41, 400)).astype(np.float32)
    want = np.asarray(jm.apply(p, jnp.asarray(x)))
    got = port_vad(p, conf).score(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=POST_ATOL)


def test_convert_round_trips_through_jax_converter():
    from funasr_tpu.convert import fsmn_vad_from_torch

    _, p = init_params(dict(CONF, rorder=2))
    sd = fsmn_vad_from_jax(p)
    assert sd["fsmn.0.fsmn_block.conv_left.weight"].shape == (16, 1, 20, 1)
    assert set(sd) == set(FSMN(**dict(CONF, rorder=2)).state_dict())
    back = fsmn_vad_from_torch({k: v.numpy() for k, v in sd.items()})
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    want, got = flat(p["params"]), flat(back["params"])
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize("n", [0, 399, 400, 16000 + 123])
def test_frame_decibel_matches_compute_decibel(n):
    w = (0.2 * np.random.default_rng(n).standard_normal(n)).astype(np.float32)
    if n > 1000:
        w[2000:5000] = 0.0  # silent frames: the 1e-6 floor
    want = JM.compute_decibel(w)
    got = TM.frame_decibel_device(torch.from_numpy(w)[None])[0].numpy()
    assert got.shape == want.shape == (max(0, (n - 400) // 160 + 1),)
    np.testing.assert_allclose(got, want, rtol=0, atol=DB_ATOL)
    np.testing.assert_allclose(TM.compute_decibel(w), want, rtol=0, atol=0)
    jd = np.asarray(JM.frame_decibel_device(jnp.asarray(w)[None]))[0]
    np.testing.assert_allclose(got, jd, rtol=0, atol=DB_ATOL)


def _frames(seed, n=900):
    """Silence posteriors in runs of speech and silence (with noise), and
    decibels around 0 dB."""
    rng = np.random.default_rng(seed)
    sil, t = np.empty(n), 0
    while t < n:
        run = int(rng.integers(3, 80))
        sil[t: t + run] = rng.uniform(0.0, 0.3) if rng.random() < 0.5 else rng.uniform(0.7, 1)
        t += run
    sil = np.clip(sil + 0.1 * rng.standard_normal(n), 0.0, 1.0)
    db = rng.uniform(-15.0, 20.0, n)
    return sil, db


OPTION_SETS = [
    {},
    {"max_single_segment_time": 1500},  # the max-single-segment split
    {"detect_mode": 0, "max_start_silence_time": 500},  # single utterance
    {"do_extend": 0, "max_end_silence_time": 300, "window_size_ms": 100},
    {"decibel_thres": 0.0},  # frames under it: the double window update
    {"snr_thres": 5.0, "speech_noise_thres": 0.3},
]


@pytest.mark.parametrize("opts", range(len(OPTION_SETS)))
def test_state_machine_matches_jax(opts):
    kw = OPTION_SETS[opts]
    for seed in range(3):
        sil, db = _frames(10 * opts + seed)
        machines = [M.VadStateMachine(M.VADXOptions(**kw)) for M in (JM, TM)]
        out = []
        for sm in machines:
            sm.feed(sil, db, is_final=True)
            out.append(sm.pop_segments(streaming=False))
        assert out[0] == out[1]
        assert [vars(s) for s in machines[0].state.segments] == \
            [vars(s) for s in machines[1].state.segments]
        if not kw:
            assert len(out[0]) >= 2
        # streaming: chunks of 37 frames, partials popped after each
        streams = []
        for M in (JM, TM):
            sm, got = M.VadStateMachine(M.VADXOptions(**kw)), []
            for a in range(0, len(sil), 37):
                sm.feed(sil[a: a + 37], db[a: a + 37], is_final=a + 37 >= len(sil))
                got.append(sm.pop_segments(streaming=True))
            streams.append(got)
        assert streams[0] == streams[1]
        if not kw:
            flat = [s for part in streams[1] for s in part]
            assert any(s[1] == -1 for s in flat) and any(s[0] == -1 for s in flat)


def test_state_machine_quirks():
    """Frames under the decibel threshold advance the window twice: with the
    threshold above every frame the machine sees only silence and, at the
    final frame with no segment found, makes its one fake start and end
    (no segment is emitted)."""
    sil, db = _frames(5)
    sm = TM.VadStateMachine(TM.VADXOptions(decibel_thres=100.0))
    calls = []
    real = sm._detect_one_frame
    sm._detect_one_frame = lambda *a: (calls.append(a), real(*a))[1]
    sm.feed(sil, db, is_final=True)
    assert len(calls) == 2 * len(sil)
    assert sm.pop_segments(streaming=False) == [] and sm.state.number_end_detected == 1


@pytest.fixture(scope="module")
def engines():
    jm, p = init_params(seed=4)
    fe = TE.FrontendConfig(n_mels=80, lfr_m=5, lfr_n=1)
    p = calibrated_params(p, CONF, fe)
    port = TE.VadEngine(port_vad(p), fe)
    ref = JE.VadEngine(jax_vad(p), JE.FrontendConfig(n_mels=80, lfr_m=5, lfr_n=1))
    return port, ref


@pytest.mark.parametrize("seed", [0, 1])
def test_vad_engine_segments_match_jax(engines, seed):
    port, ref = engines
    wav = recording(seed)
    if seed:  # a longer recording: more segments, a short burst, a long pause
        rng = np.random.default_rng(seed)
        wav = np.concatenate([wav, tone(rng, 0.4, 310.0), np.zeros(30000, np.float32),
                              tone(rng, 3.0, 180.0), np.zeros(4000, np.float32)])
    want = ref.segments(wav)
    got = port.segments(wav)
    assert got == want and len(got) >= 2
    segs, raw, total = port.segments_shared(wav)
    w_segs, w_raw, w_total = ref.segments_shared(wav)
    assert segs == w_segs == want
    assert total == w_total == (len(wav) - 400) // 160 + 1
    np.testing.assert_allclose(raw.numpy()[:total], np.asarray(w_raw)[:total], rtol=1e-4,
                               atol=1e-3)
    assert port.transcribe([wav]) == [{"text": "", "value": want}]


def test_vad_engine_silence_and_short_input(engines):
    port, ref = engines
    for wav in (np.zeros(16000, np.float32), np.zeros(300, np.float32)):
        assert port.segments(wav) == ref.segments(wav) == []
