"""The port's BiCifParaformer, ``CifPredictorV3`` and ``BiCifEngine`` against
the JAX package on the CPU.

Tiny models initialised in JAX, their params carried over by
``convert.bicif_paraformer_from_jax``; inputs from numpy seeds.

- float32 ("cnn" and "cnn_blstm" heads): the upsampled alphas agree to
  float32 rounding (atol 1e-5: the einsum, the LSTM and the rescale sum in
  another order), and every fire decision (``us_peaks``, the base CIF
  ``peaks``), the token lengths, tokens, texts and timestamp lists are
  equal, through ``BiCifEngine.transcribe`` as through the model, but for
  one fault of the JAX program at frame 0.  Jitted on the CPU, XLA
  contracts ``P = S - a2`` with the rescale ``a2 = a * scale`` into one
  fused multiply-add, so the exclusive prefix sum at frame 0 comes out
  +-1e-9 instead of 0, and a negative one fires frame 0 (a token starting
  at -30 ms; the reference fires there only when the alpha reaches the
  threshold).  The port computes P exactly; the tests correct the JAX
  fires at frame 0 (``_jax_fires``) and hold every other frame equal.
- int8 with both opt-in routes (``qmm``, ``int8_attn``; the JAX package's
  ``FUNASR_TPU_PALLAS_QMM`` and ``FUNASR_TPU_INT8_ATTN`` forced on, its
  kernels in interpret mode, spies on ``quant_pallas._qmm`` and the SANM
  ``_call`` with ``int8_attn=True``): the int8 noise floor.  The whole
  model at the default QDense gate, under which the tiny model's
  contractions stay in bf16 (the int8 scores are the route taken): token
  lengths equal, fires equal in number and within one frame (the int8
  scores spread a moved rounding tie to every query, which moves a fire
  that sits on an integer of cumulative alpha).  The decoder with the gate
  at 128 on the JAX encoder output and embeddings, where ``decoders3``'s
  w_1 and w_2 and the output layer take the fused int8 matmul on both
  sides: the log-prob and agreement bars of ``test_torch_paraformer_int8.py``
  (atol 0.15, agreement >= 0.99 where the JAX margin is clear).  With the gate lowered the encoder is
  not compared end to end: its K = 560 projection takes the port's qmm
  ("mul" row quantize) and the JAX package's XLA "div" form
  (``test_torch_qmm.py``), and that noise moves fires.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from funasr_tpu.auto import engines as JE
from funasr_tpu.models.bicif_paraformer.model import BiCifParaformer as JaxBiCif
from funasr_tpu.tokenizer.char_tokenizer import CharTokenizer as JaxTokenizer
from funasr_torch.auto import engines as TE
from funasr_torch.convert import bicif_paraformer_from_jax
from funasr_torch.models.bicif_paraformer.model import BiCifParaformer
from funasr_torch.tokenizer.char_tokenizer import CharTokenizer
from tests.test_torch_paraformer_int8 import LOGP_ATOL, MIN_AGREE
from tests.test_torch_vad import built_once
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

V = 32
TOKENS = ["<blank>", "<s>", "</s>"] + [chr(0x4E00 + i) for i in range(V - 4)] + ["<unk>"]
US_ATOL = 1e-5


def _conf(D, heads, units, enc_layers, dec_layers, upsample_type="cnn", vocab_size=V):
    return dict(
        vocab_size=vocab_size, input_size=560,
        encoder_conf=dict(output_size=D, attention_heads=heads, linear_units=units,
                          num_blocks=enc_layers, kernel_size=5 if D < 128 else 11),
        decoder_conf=dict(attention_heads=heads, linear_units=units,
                          num_blocks=dec_layers, att_layer_num=dec_layers,
                          kernel_size=5 if D < 128 else 11),
        predictor_conf=dict(idim=D, threshold=1.0, l_order=1, r_order=1,
                            tail_threshold=0.45, upsample_type=upsample_type))


def _init(conf, seed):
    return built_once(("_init", repr(conf), seed),
                      lambda: _init_uncached(conf, seed))


def _init_uncached(conf, seed):
    jm = JaxBiCif(**conf)
    p = jax.jit(lambda key: jm.init(
        {"params": key}, jnp.zeros((1, 16, 560)), jnp.array([16]), max_tokens=8,
        method=jm.timestamps))(jax.random.PRNGKey(seed))
    return jm, jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module", params=["cnn", "cnn_blstm"])
def f32_models(request):
    conf = _conf(32, 2, 48, 2, 2, request.param)
    jm, p = _init(conf, 1)
    tm = BiCifParaformer(**conf, device="cpu")
    tm.load_state_dict(bicif_paraformer_from_jax(p), strict=True)
    return conf, jm, p, tm


def _wavs(lengths=(24000, 9000, 15500), seed=11):
    rng = np.random.default_rng(seed)
    return [(0.1 * np.sin(2 * np.pi * (200 + 150 * i) * np.arange(n) / 16000.0)
             + 0.05 * rng.standard_normal(n)).astype(np.float32)
            for i, n in enumerate(lengths)]


def _jax_fires(us_peaks, us_alphas):
    """JAX's upsampled fires with frame 0 as exact arithmetic decides it
    (the alpha reaches the threshold); every other frame as JAX gives it."""
    fixed = np.array(us_peaks, copy=True)
    fixed[:, 0] = np.asarray(us_alphas)[:, 0] >= np.float32(1.0 - 1e-4)
    return fixed


def test_predictor_v3_matches_jax(f32_models):
    _, jm, p, tm = f32_models
    rng = np.random.default_rng(5)
    h = rng.standard_normal((2, 40, 32)).astype(np.float32)
    lens = np.array([40, 27], np.int32)
    want = jax.jit(lambda p, h, l: jm.apply(
        p, h, l, 24, method=lambda m, *a: m.predictor(*a)))(p, jnp.asarray(h), jnp.asarray(lens))
    want = jax.tree_util.tree_map(np.asarray, want)
    with torch.no_grad():
        got = tm.predictor(torch.from_numpy(h), torch.from_numpy(lens), 24)
    assert got.us_alphas.shape == (2, 120) and got.us_peaks.dtype == torch.bool
    np.testing.assert_allclose(got.us_alphas.numpy(), want.us_alphas, rtol=0, atol=US_ATOL)
    np.testing.assert_array_equal(got.us_peaks.numpy(),
                                  _jax_fires(want.us_peaks, want.us_alphas))
    assert got.us_peaks.numpy().sum() > 10
    np.testing.assert_array_equal(got.base.peaks.numpy(), want.base.peaks)
    np.testing.assert_array_equal(got.base.token_num.numpy(), want.base.token_num)
    np.testing.assert_allclose(got.token_num2.numpy(), want.token_num2, rtol=1e-5)
    np.testing.assert_allclose(got.base.acoustic_embeds.numpy(), want.base.acoustic_embeds,
                               rtol=1e-4, atol=1e-5)


def test_convert_round_trips_through_jax_converter(f32_models):
    from funasr_tpu.convert import bicif_paraformer_from_torch

    _, _, p, tm = f32_models
    back = bicif_paraformer_from_torch({k: v.numpy() for k, v in tm.state_dict().items()})
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    want, got = flat(p["params"]), flat(back["params"])
    # the inference tree has no training embedding; the port keeps zeros for it
    assert set(got) - set(want) == {"['decoder']['embed']['embedding']"}
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    assert ("['predictor']['blstm_fwd']['ii']['kernel']" in want) == (tm.predictor.blstm is not None)


def test_transcribe_matches_jax_engine(f32_models):
    _, jm, p, tm = f32_models
    wavs, offsets = _wavs(), [0, 120, 5000]
    jax_engine = JE.BiCifEngine(jm, p, JE.FrontendConfig(), JaxTokenizer(TOKENS))
    port = TE.BiCifEngine(tm, TE.FrontendConfig(), CharTokenizer(TOKENS), device="cpu")
    # the device program: tokens, lengths and the upsampled fires
    jw, jl = jax_engine._pack(wavs)
    mt = jax_engine._max_tokens(jw.shape[1])
    w_tok, w_len, w_alphas, w_peaks = jax.tree_util.tree_map(
        np.asarray, jax_engine._run_ts(p, jw, jl, mt))
    g_tok, g_len, g_alphas, g_peaks = port.run_ts(*port._pack(wavs), mt)
    np.testing.assert_array_equal(g_len.numpy(), w_len)
    np.testing.assert_allclose(g_alphas.numpy(), w_alphas, rtol=0, atol=US_ATOL)
    fires = _jax_fires(w_peaks, w_alphas)
    np.testing.assert_array_equal(g_peaks.numpy(), fires)
    for i, n in enumerate(w_len):
        np.testing.assert_array_equal(g_tok.numpy()[i, :n], w_tok[i, :n])
    # the served records: JAX's host pass on the corrected fires
    us_lens = jax_engine._us_lens([len(w) for w in wavs])
    want = jax_engine._ts_results(wavs, w_tok, w_len, w_alphas, fires, offsets,
                                  us_lens=us_lens)
    got = port.transcribe(wavs, vad_offsets=offsets)
    assert got == want
    assert all(r["text"] and len(r["timestamp"]) == len(r["raw_tokens"]) for r in got)
    for r, off in zip(got, offsets):
        starts = [b for b, _ in r["timestamp"]]
        assert starts == sorted(starts) and starts[0] >= off
        assert all(b <= e for b, e in r["timestamp"])
    assert port.transcribe([]) == []
    # without stamps: the base CIF path of ParaformerEngine, the same texts
    assert [r["text"] for r in port.transcribe(wavs, with_timestamp=False)] == \
        [r["text"] for r in got]


def test_paraformer_engine_timestamps_match_jax():
    """``ParaformerEngine.transcribe(with_timestamp=True)``: 60 ms stamps
    from the base CIF fire track of a plain Paraformer."""
    from funasr_tpu.models.paraformer.model import Paraformer as JaxParaformer
    from funasr_torch.convert import paraformer_from_jax
    from funasr_torch.models.paraformer.model import Paraformer

    conf = _conf(32, 2, 48, 2, 2)
    conf["predictor_conf"].pop("upsample_type")
    jm = JaxParaformer(**conf)
    p = jax.tree_util.tree_map(np.asarray, jax.jit(lambda key: jm.init(
        {"params": key}, jnp.zeros((1, 16, 560)), jnp.array([16]), max_tokens=8,
        method=jm.greedy_decode))(jax.random.PRNGKey(2)))
    tm = Paraformer(**conf, device="cpu")
    tm.load_state_dict(paraformer_from_jax(p), strict=True)
    wavs = _wavs((20000, 7000))
    want = JE.ParaformerEngine(jm, p, JE.FrontendConfig(), JaxTokenizer(TOKENS)).transcribe(
        wavs, with_timestamp=True, vad_offsets=[10, 20])
    got = TE.ParaformerEngine(tm, TE.FrontendConfig(), CharTokenizer(TOKENS),
                              device="cpu").transcribe(wavs, with_timestamp=True,
                                                       vad_offsets=[10, 20])
    assert got == want and all(r["timestamp"] for r in got)


def test_transcribe_from_fbank_equals_sliced_waveforms(f32_models):
    _, _, _, tm = f32_models
    engine = TE.BiCifEngine(tm, TE.FrontendConfig(), CharTokenizer(TOKENS), device="cpu")
    wav = _wavs((6 * 16000,), seed=3)[0]
    segments = [[0, 1500], [1230, 3100], [2500, 4410], [4000, 5990]]  # 10 ms starts
    raw, nframes = engine.frontend.raw_fbank(torch.from_numpy(wav)[None],
                                             torch.tensor([len(wav)]))
    total = int(nframes[0])
    offsets = [s for s, _ in segments]
    got = engine.transcribe_from_fbank(raw[0], segments, vad_offsets=offsets,
                                       total_frames=total)
    want = engine.transcribe([wav[s * 16:e * 16] for s, e in segments], vad_offsets=offsets)
    assert got == want and all(r["text"] for r in got)
    starts, n = engine.pack_segments_frames(segments, total)
    assert starts.tolist() == [0, 123, 250, 400] and n[0] == (1500 * 16 - 400) // 160 + 1
    assert engine.transcribe_from_fbank(raw[0], []) == []


# ---------------------------------------------------------------- int8 routes
INT8_V = 160  # an output layer of >= 128 columns passes the TPU's qmm gate
INT8_CONF = _conf(256, 2, 256, 3, 2, vocab_size=INT8_V)


@pytest.fixture(scope="module")
def int8_params():
    return _init(INT8_CONF, 0)


def _routes_on(monkeypatch, gate=None):
    """The JAX package's fused int8 path with both opt-in routes (and the
    QDense gate at ``gate`` rows and columns on both sides, when given);
    returns the JAX spy counts."""
    from funasr_tpu.ops import decoder_layer_pallas as JDL
    from funasr_tpu.ops import ffn_pallas as JFP
    from funasr_tpu.ops import quant as JQ
    from funasr_tpu.ops import quant_pallas as JQP
    from funasr_tpu.ops import sanm_layer_pallas as JSL
    from funasr_torch.ops import quant as Q

    calls = {"qmm": 0, "sanm_int8_attn": 0}

    def sanm_spy(*a, f=JSL._call, **k):
        calls["sanm_int8_attn"] += bool(k.get("int8_attn"))
        return f(*a, **k)

    def qmm_spy(*a, f=JQP._qmm, **k):
        calls["qmm"] += 1
        return f(*a, **k)

    for mod in (JSL, JDL, JFP, JQP):
        monkeypatch.setattr(mod, "enabled", lambda: True)
    monkeypatch.setattr(JSL, "_call", sanm_spy)
    monkeypatch.setattr(JQP, "_qmm", qmm_spy)
    monkeypatch.setenv("FUNASR_TPU_INT8_ATTN", "1")
    if gate is not None:
        for mod, m, n in ((JQ, "_MIN_M", "_MIN_N"), (Q, "MIN_M", "MIN_N")):
            monkeypatch.setattr(mod, m, gate)
            monkeypatch.setattr(mod, n, gate)
    return calls


def _port_spies(monkeypatch):
    from funasr_torch.ops import attention as A
    from funasr_torch.ops import qmm as QM

    spies = {"qmm": 0, "i8qk": 0}

    def count(key, fn):
        def wrapped(*a):
            spies[key] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(QM, "quant_matmul", count("qmm", QM.quant_matmul))
    monkeypatch.setattr(A, "attention_i8qk_ref", count("i8qk", A.attention_i8qk_ref))
    return spies


def _int8_port(p):
    tm = BiCifParaformer(**INT8_CONF, device="cpu", dtype=torch.bfloat16, quantize=True,
                         qmm=True, int8_attn=True)
    tm.load_state_dict(bicif_paraformer_from_jax(p), strict=True)
    return tm.quantize_weights()


def _speech():
    rng = np.random.default_rng(7)
    return (rng.standard_normal((2, 64, 560)).astype(np.float32),
            np.array([64, 41], np.int32))


def _fires_within_one_frame(got, want):
    for g, w in zip(got, want):
        g, w = np.nonzero(g)[0], np.nonzero(w)[0]
        assert len(g) == len(w) and (len(g) == 0 or np.abs(g - w).max() <= 1), (g, w)


def test_int8_attn_model_matches_jax(monkeypatch, int8_params):
    """The whole model with both routes at the default gate: the tiny
    model's contractions are under it, so int8 scores are the route taken.
    Token lengths equal; the int8 noise of the encoder moves a fire whose
    cumulative alpha sits within it of an integer by one frame, so the
    fires are held equal in number and within one frame (random weights
    give alphas near 0.5 and many such fires)."""
    from funasr_tpu.ops import quant as JQ

    _, p = int8_params
    calls = _routes_on(monkeypatch)
    x, lens = _speech()
    jmb = JaxBiCif(**INT8_CONF, dtype=jnp.bfloat16)
    with JQ.quantized(True), pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda p, x, l: jmb.apply(
            p, x, l, max_tokens=32, method=jmb.inference_logits))(
                p, jnp.asarray(x), jnp.asarray(lens))
    assert calls["sanm_int8_attn"], calls
    _, want_tl, want_pred = jax.tree_util.tree_map(np.asarray, want)

    spies = _port_spies(monkeypatch)
    tm = _int8_port(p)
    _, tl, pred = tm.inference_logits(torch.from_numpy(x), torch.from_numpy(lens),
                                      max_tokens=32)
    assert spies == {"qmm": 0, "i8qk": 2}, spies  # encoder layers 1 and 2
    np.testing.assert_array_equal(tl.numpy(), want_tl)
    assert (tl.numpy() < 32).any()
    _fires_within_one_frame(pred.base.peaks.numpy(), want_pred.base.peaks)
    _fires_within_one_frame(pred.us_peaks.numpy(),
                            _jax_fires(want_pred.us_peaks, want_pred.us_alphas))


def test_int8_qmm_decoder_matches_jax(monkeypatch, int8_params):
    """The gate at 128: ``decoders3``'s w_1 and w_2 and the output layer (128 rows
    of 2 x 64 tokens) take the fused int8 matmul on both sides.  Both
    decoders read the JAX encoder output and acoustic embeddings, as in
    ``test_torch_paraformer_int8.py`` with the gate at 0: a fire that the
    int8 noise of the encoder moves would change the decoder's input."""
    from funasr_tpu.ops import quant as JQ

    _, p = int8_params
    U = 64
    calls = _routes_on(monkeypatch, gate=128)
    x, lens = _speech()
    jmb = JaxBiCif(**INT8_CONF, dtype=jnp.bfloat16)
    with JQ.quantized(True), pltpu.force_tpu_interpret_mode():
        enc, enc_lens = jax.jit(lambda p, x, l: jmb.apply(
            p, x, l, method=jmb.encode))(p, jnp.asarray(x), jnp.asarray(lens))
        pred = jax.jit(lambda p, e, l: jmb.apply(
            p, e, l, U, method=lambda m, *a: m.predictor(*a)))(p, enc, enc_lens)
        tl = jnp.clip(jnp.round(pred.base.token_num).astype(jnp.int32), 0, U)
        calls["qmm"] = 0
        logits = jax.jit(lambda p, *a: jmb.apply(
            p, *a, method=lambda m, *b: m.decoder(*b)))(
                p, enc, enc_lens, pred.base.acoustic_embeds, tl)
    assert calls["qmm"] == 3, calls  # decoders3 w_1, w_2 and the output layer
    want_lp = np.asarray(jax.nn.log_softmax(logits.astype(jnp.float32), -1))

    spies = _port_spies(monkeypatch)
    tm = _int8_port(p)
    t = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32)
                                            if a.dtype == jnp.bfloat16 else a))
    with torch.no_grad():
        got = tm.decoder(t(enc).to(torch.bfloat16), t(enc_lens),
                         t(pred.base.acoustic_embeds), t(tl))
    assert spies["qmm"] == 3, spies
    lp = torch.log_softmax(got.float(), -1).numpy()
    valid = np.arange(U)[None] < np.asarray(tl)[:, None]
    np.testing.assert_allclose(lp[valid], want_lp[valid], rtol=0, atol=LOGP_ATOL)
    same = (lp.argmax(-1) == want_lp.argmax(-1))[valid]
    top2 = np.sort(want_lp, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0])[valid] > 2 * LOGP_ATOL
    assert clear.sum() >= 8 and same[clear].mean() >= MIN_AGREE, same[clear].mean()


def test_int8_routes_need_quantize():
    for flags in (dict(qmm=True), dict(int8_attn=True)):
        with pytest.raises(ValueError, match="quantize=True"):
            BiCifParaformer(**INT8_CONF, device="cpu", **flags)
    tm = BiCifParaformer(**INT8_CONF, device="cpu", quantize=True, qmm=True)
    dense = [m for m in tm.modules() if getattr(m, "qmm", False)]
    assert tm.encoder.encoders0[0].self_attn.linear_q_k_v in dense
    assert tm.decoder.output_layer in dense
    assert tm.encoder.encoders[0].self_attn.linear_q_k_v not in dense  # fused layers
