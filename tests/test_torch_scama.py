"""The port's SCAMA (``models/scama``: the chunk-masked SANM encoder, the
``FsmnDecoderSCAMAOpt`` decoder, its step scorer ``CachedScamaDecoder``, the
beam and the ``AutoModel`` route) against the JAX package on the CPU, and
the CMVN held on the engine's device from its build.

A tiny SCAMA (vocabulary 32, D = 16 with 2 heads, 2 encoder blocks; the
decoder 2 full layers and one FSMN-only layer, kernel 5, causal; chunks of
10 frames) initialised in JAX once for the module (``family``) and carried
into the port by ``convert.scama_from_jax``; inputs from numpy seeds.  Bars:

- ``chunk_attn_mask`` and ``scama_cross_mask``: equal, over ragged lengths,
  the CIF tail frame dropped or frames padded (``n_frames``), tokens that
  never fire and ``look_back`` -1 and 0;
- the encoder under the chunk mask: float32 within ``F32_TOL`` (sums in
  another order); bf16 within ``BF16_ULPS`` bf16 ulps of the largest
  output; int8 (``quantize=True``, the int8 gate lowered to 0 rows in both
  packages so every projection and FFN takes int8) within
  ``INT8_TOL`` of the float32 output's scale: the int8 noise floor;
- the decoder's logits, teacher-forced under the cross mask, within
  ``F32_TOL``; the step scorer against the port's teacher-forced forward and
  against the JAX step within ``F32_TOL``, ``reorder_state`` a gather;
- ``decode_beam`` (beam 1 and 5, CTC weight 0 and 0.5 on a model with a CTC
  head): tokens and lengths equal, scores within ``SCORE_TOL``;
- ``AutoModel.generate`` records equal, without a VAD and behind FSMN-VAD and
  CT-Transformer with ``with_timestamp=False``; with timestamps JAX fails
  (``AttributeError``: SCAMA has no ``decode_beam_align``) and the port
  raises an error that names the cause;
- the state dict converts back to the JAX tree through
  ``funasr_tpu.convert.scama_from_torch``.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from funasr_tpu.auto.auto_model import AutoModel as JaxAutoModel
from funasr_tpu.convert import scama_from_torch
from funasr_tpu.models.scama import decoder as JD
from funasr_tpu.models.scama.model import SCAMA as JaxSCAMA
from funasr_tpu.models.uniasr.model import chunk_attn_mask as jax_chunk_attn_mask
from funasr_tpu.ops import quant as JQ
from funasr_torch import convert as C
from funasr_torch.auto import engines as TE
from funasr_torch.auto.auto_model import AutoModel
from funasr_torch.models.scama import decoder as TD
from funasr_torch.models.scama.model import SCAMA
from funasr_torch.ops import attention as A
from funasr_torch.ops import masks as M
from funasr_torch.ops import quant as Q
from tests.test_torch_bicif import TOKENS
from tests.test_torch_e_paraformer import wavs
from tests.test_torch_pipeline import (PUNC_CFG, VAD_CFG, _save, _save_flax, long_recording,
                                       punc_params, vad_params)
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

V, IN, D = len(TOKENS), 560, 16
CONF = dict(vocab_size=V, input_size=IN,
            encoder_conf=dict(output_size=D, attention_heads=2, linear_units=32,
                              num_blocks=2, kernel_size=5),
            decoder_conf=dict(attention_heads=2, linear_units=32, num_blocks=3,
                              att_layer_num=2, kernel_size=5),
            predictor_conf=dict(idim=D, threshold=1.0, l_order=1, r_order=1,
                                tail_threshold=0.45),
            model_conf=dict(ctc_weight=0.3))
F32_TOL = 1e-5
BF16_ULPS = 4
INT8_TOL = 0.05  # x the largest |float32 output|: the int8 noise floor
SCORE_TOL = 1e-4


@pytest.fixture(autouse=True)
def no_grad():
    with torch.inference_mode():
        yield


def model_kw(dtype=None):
    kw = {k: CONF[k] for k in ("vocab_size", "input_size", "encoder_conf", "decoder_conf",
                               "predictor_conf")}
    kw.update(CONF["model_conf"])
    return kw if dtype is None else dict(kw, dtype=dtype)


@functools.lru_cache(maxsize=None)
def family():
    """(JAX SCAMA, its float32 variables as numpy, the port's float32 SCAMA
    on the CPU with those weights)."""
    jm = JaxSCAMA(**model_kw())
    T = 32
    variables = jax.jit(lambda k: jm.init(
        {"params": k, "dropout": k}, jnp.zeros((1, T, IN)), jnp.array([T]),
        jnp.zeros((1, 4), jnp.int32), jnp.array([4]), deterministic=True)
    )(jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map(np.array, variables)
    tm = SCAMA(**model_kw(), device="cpu")
    tm.load_state_dict(C.scama_from_jax(variables), strict=True)
    return jm, variables, tm


def speech(seed=5, B=3, T=37):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, IN)).astype(np.float32)
    return x, np.array([T, T - 12, T - 26][:B], np.int32)


@functools.lru_cache(maxsize=None)
def _jax_fn(name, **static):
    jm = family()[0] if "dtype" not in static else JaxSCAMA(**model_kw(static.pop("dtype")))
    method = getattr(jm, name)
    return jax.jit(lambda v, *a: jm.apply(v, *a, method=method, **static))


# ---------------------------------------------------------------- masks
@pytest.mark.parametrize("T,chunk,left", [(37, 10, -1), (37, 10, 0), (40, 10, 2), (5, 10, -1)])
def test_chunk_attn_mask_matches_jax(T, chunk, left):
    want = np.asarray(jax_chunk_attn_mask(T, chunk, left))
    got = M.chunk_attn_mask(T, chunk, left)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


CROSS_CASES = {
    # ragged lengths, the CIF tail frame dropped by n_frames
    "ragged_tail": dict(T=31, n_frames=30, U=14, look_back=1, chunk=10, p=0.3),
    # frames padded up to n_frames; tokens past the fires never fire
    "padded_never_fire": dict(T=24, n_frames=30, U=14, look_back=1, chunk=10, p=0.2),
    "look_back_all": dict(T=41, n_frames=40, U=16, look_back=-1, chunk=10, p=0.25),
    "look_back_0": dict(T=33, n_frames=None, U=14, look_back=0, chunk=5, p=0.3),
}


@pytest.mark.parametrize("case", list(CROSS_CASES))
def test_scama_cross_mask_matches_jax(case):
    c = CROSS_CASES[case]
    rng = np.random.default_rng(len(case))
    B = 3
    peaks = rng.random((B, c["T"])) < c["p"]
    enc_lens = np.array([c["T"] - 1, c["T"] - 9, c["T"] - 17], np.int32)
    tok_lens = np.array([c["U"], c["U"] - 3, 2], np.int32)
    want = np.asarray(JD.scama_cross_mask(jnp.asarray(peaks.astype(np.float32)),
                                          jnp.asarray(enc_lens), jnp.asarray(tok_lens), c["U"],
                                          c["chunk"], c["look_back"], n_frames=c["n_frames"]))
    got = TD.scama_cross_mask(torch.from_numpy(peaks), torch.from_numpy(enc_lens),
                              torch.from_numpy(tok_lens), c["U"], c["chunk"], c["look_back"],
                              n_frames=c["n_frames"])
    np.testing.assert_array_equal(got.numpy(), want)
    n_fires = peaks[:, : c["n_frames"] or c["T"]].sum(axis=1)
    assert (n_fires < tok_lens).any()  # some token never fires: it keeps the last window


# -------------------------------------------------------------- encoder
def test_encoder_under_the_chunk_mask_float32():
    jm, variables, tm = family()
    x, lens = speech()
    want, _ = _jax_fn("encode")(variables, x, lens)
    got, got_lens = tm.encode(torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=0)
    assert torch.equal(got_lens, torch.from_numpy(lens))
    # the mask is live: the full-context encoder differs
    full, _ = tm.encoder(torch.from_numpy(x), torch.from_numpy(lens))
    assert float((full - got).abs().max()) > 1e-2


def test_encoder_under_the_chunk_mask_bf16():
    _, variables, _ = family()
    tm = SCAMA(**model_kw(torch.bfloat16), device="cpu")
    tm.load_state_dict(C.scama_from_jax(variables), strict=True)
    x, lens = speech(seed=6)
    want, _ = _jax_fn("encode", dtype=jnp.bfloat16)(variables, x, lens)
    got, _ = tm.encode(torch.from_numpy(x), torch.from_numpy(lens))
    want = np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_ULPS * ulp, rtol=0)


def test_encoder_under_the_chunk_mask_int8(monkeypatch):
    _, variables, _ = family()
    for mod, m, n in ((JQ, "_MIN_M", "_MIN_N"), (Q, "MIN_M", "MIN_N")):
        monkeypatch.setattr(mod, m, 0)
        monkeypatch.setattr(mod, n, 0)
    tm = SCAMA(**model_kw(torch.bfloat16), device="cpu", quantize=True)
    tm.load_state_dict(C.scama_from_jax(variables), strict=True)
    x, lens = speech(seed=7, T=40)
    with pytest.raises(RuntimeError, match="quantize_weights"):
        tm.encode(torch.from_numpy(x), torch.from_numpy(lens))
    tm.quantize_weights()
    layer = tm.encoder.encoders[0]
    assert layer.int8 is None and layer.self_attn.linear_q_k_v.w8 is not None
    assert layer.feed_forward.int8 is not None  # the fused int8 FFN
    with JQ.quantized(True):
        want, _ = _jax_fn("encode", dtype=jnp.bfloat16)(variables, x, lens)
    want32, _ = _jax_fn("encode")(variables, x, lens)
    got, _ = tm.encode(torch.from_numpy(x), torch.from_numpy(lens))
    scale = float(np.abs(np.asarray(want32)).max())
    err = np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()
    assert err <= INT8_TOL * scale, (err, scale)
    # the int8 outputs stay near float32 too: the route is the quantized one
    assert np.abs(got.float().numpy() - np.asarray(want32)).max() <= 2 * INT8_TOL * scale


def test_encoder_without_a_mask_keeps_the_kernel_path(monkeypatch):
    """No attention mask: the attention goes through the kernel wrapper, as
    before; with one it does not, and a fused int8 layer refuses the mask."""
    _, _, tm = family()
    calls = []
    real = A.fused_attention
    monkeypatch.setattr(A, "fused_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    x, lens = map(torch.from_numpy, speech(seed=8))
    tm.encoder(x, lens)
    assert len(calls) == 2  # one a layer
    tm.encode(x, lens)
    assert len(calls) == 2
    from funasr_torch.models.sanm import SANMEncoder

    enc = SANMEncoder(IN, output_size=D, attention_heads=2, linear_units=32, num_blocks=2,
                      kernel_size=5, param_dtype=torch.float32, dtype=torch.bfloat16)
    enc.quantize_weights()
    assert enc.encoders[0].int8 is not None
    am = M.chunk_attn_mask(x.shape[1], 10)[None].expand(x.shape[0], -1, -1)
    with pytest.raises(RuntimeError, match="fused_int8 = False"):
        enc(x, lens, attn_mask=am)


# -------------------------------------------------------------- decoder
def _dec_inputs(seed=3, U=7):
    jm, variables, tm = family()
    x, lens = speech(seed=seed)
    enc, enc_lens = _jax_fn("encode")(variables, x, lens)
    rng = np.random.default_rng(seed)
    ys = rng.integers(3, V, (3, U)).astype(np.int32)
    ys[:, 0] = 1  # sos
    ys_lens = np.array([U, U - 2, 3], np.int32)
    peaks = (rng.random((3, enc.shape[1] + 1)) < 0.3).astype(np.float32)
    cross = np.asarray(JD.scama_cross_mask(jnp.asarray(peaks), enc_lens, jnp.asarray(ys_lens),
                                           U, 10, 1, n_frames=enc.shape[1]))
    return np.asarray(enc), np.asarray(enc_lens), ys, ys_lens, cross


@pytest.mark.parametrize("masked", [True, False], ids=["cross_mask", "key_mask"])
def test_decoder_logits_match_jax(masked):
    jm, variables, tm = family()
    enc, enc_lens, ys, ys_lens, cross = _dec_inputs()
    cm = cross if masked else None
    jdec = JD.FsmnDecoderSCAMAOpt(V, D, **CONF["decoder_conf"])
    want = jax.jit(lambda p, *a: jdec.apply(p, *a))(
        {"params": variables["params"]["decoder"]}, enc, enc_lens, ys, ys_lens, cm)
    got = tm.decoder(*map(torch.from_numpy, (enc, enc_lens, ys, ys_lens)),
                     chunk_mask=None if cm is None else torch.from_numpy(cm))
    valid = np.arange(ys.shape[1])[None] < ys_lens[:, None]
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], atol=F32_TOL, rtol=0)
    assert tm.decoder.decoders[0].self_attn.left == 4  # causal: (5 - 1) // 2 + 2


def test_cached_step_matches_forward_and_jax():
    jm, variables, tm = family()
    enc, enc_lens, ys, ys_lens, cross = _dec_inputs(seed=4, U=6)
    ys_lens[:] = ys.shape[1]
    dec = tm.decoder
    cm = torch.from_numpy(cross)
    want_tf = torch.log_softmax(dec(*map(torch.from_numpy, (enc, enc_lens, ys, ys_lens)),
                                    chunk_mask=cm).float(), dim=-1)
    scorer = TD.CachedScamaDecoder(dec, torch.from_numpy(enc), torch.from_numpy(enc_lens),
                                   n_head=2, kernel_size=5, cross_mask=cm)
    jsc = JD.CachedScamaDecoder(variables["params"]["decoder"], jnp.asarray(enc),
                                jnp.asarray(enc_lens), n_head=2, kernel_size=5,
                                cross_mask=jnp.asarray(cross))
    state, jstate = scorer.init_state(), jsc.init_state()
    assert state.fsmn.shape == (3, 3, 5, D)  # (L1 + L2, N, K, D)
    for pos in range(ys.shape[1]):
        logp, state = scorer.step(torch.from_numpy(ys[:, pos]).long(), pos, state)
        jlogp, jstate = jsc.step(jnp.asarray(ys[:, pos]), pos, jstate)
        np.testing.assert_allclose(logp.numpy(), want_tf[:, pos].numpy(), atol=F32_TOL, rtol=0)
        np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp), atol=F32_TOL, rtol=0)
        np.testing.assert_allclose(state.fsmn.numpy(), np.asarray(jstate.fsmn), atol=F32_TOL,
                                   rtol=0)
    src = torch.tensor([2, 0, 0])
    re = TD.CachedScamaDecoder.reorder_state(state, src)
    jre = JD.CachedScamaDecoder.reorder_state(jstate, jnp.asarray(src.numpy()))
    assert torch.equal(re.fsmn, state.fsmn[:, src])
    np.testing.assert_allclose(re.fsmn.numpy(), np.asarray(jre.fsmn), atol=F32_TOL, rtol=0)


# ------------------------------------------------------------------ beam
@pytest.mark.parametrize("beam,ctc", [(1, 0.0), (5, 0.0), (5, 0.5)],
                         ids=["beam1", "beam5", "beam5_ctc"])
def test_decode_beam_matches_jax(beam, ctc):
    _, variables, tm = family()
    x, lens = speech(seed=9)
    want = _jax_fn("decode_beam", beam=beam, maxlen=12, decoding_ctc_weight=ctc)(
        variables, x, lens)
    got = tm.decode_beam(torch.from_numpy(x), torch.from_numpy(lens), beam=beam, maxlen=12,
                         decoding_ctc_weight=ctc)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=SCORE_TOL,
                               rtol=0)
    toks = got.tokens[:, 0]
    assert len(set(toks.flatten().tolist())) >= 4  # not one repeated token
    if beam == 1:
        g_toks, g_lens = tm.greedy_decode(torch.from_numpy(x), torch.from_numpy(lens),
                                          max_tokens=12)
        assert torch.equal(g_toks, toks) and torch.equal(g_lens, got.lengths[:, 0])


def test_int8_kv_names_its_cause():
    _, _, tm = family()
    x, lens = map(torch.from_numpy, speech())
    with pytest.raises(ValueError, match="FSMN window"):
        tm.decode_beam(x, lens, beam=2, maxlen=4, int8_kv=True)


def test_state_dict_converts_back_to_the_jax_tree():
    _, variables, tm = family()
    back = scama_from_torch({k: v.numpy() for k, v in tm.state_dict().items()})
    want = jax.tree_util.tree_leaves_with_path(variables["params"])
    got = dict(jax.tree_util.tree_leaves_with_path(back["params"]))
    assert len(want) > 20 and len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf, err_msg=str(path))


# ------------------------------------------------------------- AutoModel
def _cfg(init_param):
    return dict(model="SCAMA", tokenizer_conf={"token_list": TOKENS}, init_param=init_param,
                **{k: CONF[k] for k in ("vocab_size", "input_size", "encoder_conf",
                                        "decoder_conf", "predictor_conf", "model_conf")})


@pytest.fixture(scope="module")
def scama_pair(tmp_path_factory):
    """The JAX and the port's AutoModel of the tiny SCAMA on the same weights,
    behind FSMN-VAD and CT-Transformer."""
    tmp = tmp_path_factory.mktemp("scama")
    variables = family()[1]
    vad, punc = vad_params(0), punc_params(0)
    files = dict(j_asr=_save_flax(tmp / "j_asr.npz", variables["params"]),
                 asr=_save(tmp / "asr.npz", C.scama_from_jax(variables)))
    jam = JaxAutoModel(
        model=_cfg(files["j_asr"]),
        vad_model=dict(VAD_CFG, init_param=_save_flax(tmp / "j_vad.npz", vad["params"])),
        punc_model=dict(PUNC_CFG, init_param=_save_flax(tmp / "j_punc.npz", punc["params"])))
    am = AutoModel(
        model=_cfg(files["asr"]),
        vad_model=dict(VAD_CFG, init_param=_save(tmp / "vad.npz", C.fsmn_vad_from_jax(vad))),
        punc_model=dict(PUNC_CFG, init_param=_save(tmp / "punc.npz",
                                                   C.ct_transformer_from_jax(punc))),
        device="cpu")
    return jam, am, files


def test_automodel_route(scama_pair):
    _, am, _ = scama_pair
    eng = am.engine
    assert isinstance(eng, TE.HybridEngine) and type(eng.module) is SCAMA
    assert (eng.beam, eng.maxlen, eng.decoding_ctc_weight) == (5, 96, 0.0)
    assert type(eng.module.decoder) is TD.FsmnDecoderSCAMAOpt


@pytest.mark.parametrize("with_vad", [False, True], ids=["plain", "vad_punc"])
def test_automodel_generate_matches_jax(scama_pair, with_vad):
    """Records equal; scores (plain ``generate`` and its n-best) within
    ``SCORE_TOL``.  Behind the VAD the segments stay apart
    (``merge_length_s=2``: random weights end the merged 10 s at once)."""
    jam, am, files = scama_pair
    if with_vad:
        kw = dict(with_timestamp=False, merge_length_s=2)
        want = jam.generate(long_recording(), key=["a"], **kw)
        got = am.generate(long_recording(), key=["a"], **kw)
        assert "timestamp" not in got[0] and len(got[0]["text"]) > 8
        assert got == want
        return
    jam = JaxAutoModel(model=_cfg(files["j_asr"]))
    am = AutoModel(model=_cfg(files["asr"]), device="cpu")
    inputs, keys = wavs()[:2], ["a", "b"]
    want = jam.generate(inputs, key=keys, nbest=2)
    got = am.generate(inputs, key=keys, nbest=2)
    scores = lambda res: [h["score"] for r in res for h in r["nbest"]]  # noqa: E731
    np.testing.assert_allclose(scores(got), scores(want), atol=SCORE_TOL, rtol=0)
    for r in want + got:
        for h in [r] + r["nbest"]:
            h.pop("score")
    assert got == want and all(r["text"] for r in got)


@pytest.mark.parametrize("with_vad", [False, True], ids=["plain", "vad_punc"])
def test_timestamps_are_a_guarded_jax_fault(scama_pair, with_vad):
    """The JAX HybridEngine asks SCAMA for ``decode_beam_align`` whenever
    timestamps are on (the VAD pipeline's default) and fails with
    AttributeError; the port raises an error that says why."""
    jam, am, _ = scama_pair
    if with_vad:
        run = lambda m: m.generate(long_recording(), key=["a"])  # noqa: E731
    else:
        run = lambda m: m.engine.transcribe(wavs()[:1], with_timestamp=True)  # noqa: E731
    with pytest.raises(AttributeError, match="decode_beam_align"):
        run(jam)
    with pytest.raises(NotImplementedError, match="SCAMA has no timestamps"):
        run(am)


# ------------------------------------------------------------------ CMVN
def test_cmvn_lives_on_the_engine_device(monkeypatch):
    """The engine holds its frontend's CMVN on its device from its build; a
    feature call copies nothing (it used to copy the CMVN to the features'
    device on the first call), and a CMVN on another device than the
    features is refused, not copied."""
    _, _, tm = family()
    cmvn = np.stack([np.linspace(-1, 1, IN), np.linspace(0.5, 2, IN)]).astype(np.float32)
    eng = TE.HybridEngine(tm, TE.FrontendConfig(cmvn=cmvn), None, beam=1, maxlen=4,
                          device="cpu")
    assert eng.frontend.cmvn.device == eng.device
    moved = []
    real_to = torch.Tensor.to

    def spy(t, *a, **k):
        if t is eng.frontend.cmvn:
            moved.append(a)
        return real_to(t, *a, **k)

    monkeypatch.setattr(torch.Tensor, "to", spy)
    wav_d, lens_d = eng._pack(wavs()[:2])
    feats, _ = eng.frontend.device_features(wav_d, lens_d)
    assert moved == [] and feats.shape[-1] == IN
    elsewhere = TE.FrontendConfig(cmvn=cmvn, device="meta")
    assert elsewhere.cmvn.device.type == "meta"
    with pytest.raises((RuntimeError, NotImplementedError)):
        elsewhere.features_from_fbank(torch.zeros((1, 14, 80)), torch.tensor([14]))
