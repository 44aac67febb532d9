"""The port's ContextualParaformer (``funasr_torch/models/contextual_paraformer``),
``HotwordEngine(seaco=False)`` and ``AutoModel`` with it, against the JAX
package on the CPU.

A tiny Paraformer (D = 32, ``tests/test_torch_bicif.py``'s widths, CIF
predictor) with a 3-layer contextual decoder (2 plain layers, the last one
with the bias branch), initialised in JAX and carried over by
``convert.contextual_paraformer_from_jax``; inputs from numpy seeds.

- float32: ``decode_with_hotwords`` tokens and token lengths equal, the
  biased log-probs within ``LOGP_F32_ATOL`` (the float32 Paraformer bar),
  for one hotword, several and 50; the hotword memory (embedding, 1-layer
  LSTM, output at ``len - 1``) within 1e-6 of ``_hotword_memory``; the state
  dict back through ``contextual_paraformer_from_torch``.
- int8 (``quantize=True``, bf16), D = 256: the decoder on the JAX encoder
  output and embeddings, the JAX fused decoder layer forced on in
  interpret mode (its T % 8 rule: 48 memory rows) for the two plain
  layers, the last layer and the bias branch on the module path in both:
  log-probs within ``LOGP_ATOL`` and argmax agreement >= ``MIN_AGREE``
  where the JAX top-2 margin is clear, the bars of
  ``test_torch_paraformer_int8.py``.
- ``HotwordEngine(seaco=False)``: the grid as the JAX engine builds it (no
  no-bias row); records equal to the JAX engine's with a hotword (text and
  tokens, no timestamp) and without one (the Paraformer path, CIF stamps).
- ``AutoModel(ContextualParaformer, FSMN-VAD, CT-Transformer).generate`` of
  ``tests/test_torch_vad.py``'s recording with a hotword: the record equals
  the JAX ``AutoModel``'s.  Without a hotword the port decodes the waveform
  path; the JAX call raises there (its contextual engine inherits BiCif's
  fbank entry, and the model has no ``timestamps``), so the port is held to
  the JAX record under ``FUNASR_TPU_DISABLE_SHARED_FRONTEND=1``, JAX's own
  waveform path, and the JAX fault is pinned.  ``hotword=""`` (or words
  with no token) raises ``ValueError`` in the port, where the JAX engine
  fails on a None grid: pinned too.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from funasr_tpu.auto import engines as JE
from funasr_tpu.auto.auto_model import AutoModel as JaxAutoModel
from funasr_tpu.models.contextual_paraformer.model import ContextualParaformer as JaxContextual
from funasr_tpu.tokenizer.char_tokenizer import CharTokenizer as JaxTokenizer
from funasr_torch import convert as C
from funasr_torch.auto import engines as TE
from funasr_torch.auto.auto_model import AutoModel
from funasr_torch.models.contextual_paraformer.model import ContextualParaformer
from funasr_torch.tokenizer.char_tokenizer import CharTokenizer
from tests.test_torch_bicif import TOKENS, _conf, _wavs
from tests.test_torch_paraformer_int8 import LOGP_ATOL, MIN_AGREE
from tests.test_torch_pipeline import (PUNC_CFG, VAD_CFG, _port_frontend, _save,
                                       _save_flax)
from tests.test_torch_vad import (CONF as VAD_CONF, built_once, calibrated_params,
                                  init_params, recording)
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

LOGP_F32_ATOL = 1e-4
MAX_TOKENS = 48
HOTWORD = " ".join(TOKENS[5:8]) + " " + TOKENS[10] + TOKENS[11] + " zz"


def contextual_conf(D=32, heads=2, units=48, dec_layers=3):
    conf = _conf(D, heads, units, 2, dec_layers)
    conf["predictor_conf"].pop("upsample_type")
    return dict(conf, inner_dim=D)


def init_contextual(conf, seed):
    """Jitted JAX init through ``decode_with_hotwords`` (which creates the
    bias branch), numpy leaves."""
    return built_once(("init_contextual", repr(conf), seed),
                      lambda: _init_contextual_uncached(conf, seed))


def _init_contextual_uncached(conf, seed):
    jm = JaxContextual(**conf)
    p = jax.jit(lambda key: jm.init(
        {"params": key}, jnp.zeros((1, 16, 560)), jnp.array([16]),
        jnp.asarray([[5, 6]], jnp.int32), jnp.array([2]), max_tokens=8,
        method=jm.decode_with_hotwords))(jax.random.PRNGKey(seed))
    return jm, jax.tree_util.tree_map(np.asarray, p)


def hotword_grid(rows, L=8):
    pad = np.zeros((len(rows), max(L, max(map(len, rows)))), np.int32)
    for i, r in enumerate(rows):
        pad[i, : len(r)] = r
    return pad, np.array([len(r) for r in rows], np.int32)


def hotword_sets():
    rng = np.random.default_rng(4)
    return {"one": [[5, 6, 7]], "several": [[5, 6, 7], [9, 10], [12], [14, 15, 16, 17]],
            "fifty": [list(rng.integers(3, len(TOKENS) - 1, rng.integers(2, 5)))
                      for _ in range(50)]}


@pytest.fixture(scope="module")
def models():
    conf = contextual_conf()
    jm, p = init_contextual(conf, 3)
    tm = ContextualParaformer(**conf, device="cpu")
    tm.load_state_dict(C.contextual_paraformer_from_jax(p), strict=True)
    return conf, jm, p, tm


def _speech():
    rng = np.random.default_rng(7)
    return (rng.standard_normal((3, 64, 560)).astype(np.float32),
            np.array([64, 50, 37], np.int32))


def _jax_logprobs(m, x, xl, pad, lens, max_tokens):
    """The JAX decoder's biased log-probs (``decode_with_hotwords`` is their
    argmax within the token lengths)."""
    enc, el = m.encode(x, xl, True)
    pred = m.predictor(enc, el, max_tokens=max_tokens, deterministic=True)
    tl = jnp.clip(jnp.round(pred.token_num).astype(jnp.int32), 0, max_tokens)
    mem = m._hotword_memory(pad, lens)
    ctx = jnp.broadcast_to(mem[None], (enc.shape[0],) + mem.shape)
    logits = m.decoder(enc, el, pred.acoustic_embeds, tl, True, contextual_info=ctx,
                       clas_scale=m.clas_scale)
    return jax.nn.log_softmax(logits.astype(jnp.float32), -1), tl


@pytest.mark.parametrize("which", ["one", "several", "fifty"])
def test_decode_with_hotwords_matches_jax(models, which):
    _, jm, p, tm = models
    pad, lens = hotword_grid(hotword_sets()[which])
    x, xl = _speech()
    args = tuple(map(jnp.asarray, (x, xl, pad, lens)))

    def both(m, *a):
        return _jax_logprobs(m, *a, MAX_TOKENS) + m.decode_with_hotwords(
            *a, max_tokens=MAX_TOKENS)

    want_lp, w_tl, w_tok, w_tl2 = map(np.asarray, jax.jit(lambda p, *a: jm.apply(
        p, *a, method=both))(p, *args))
    t = tuple(map(torch.from_numpy, (x, xl, pad, lens)))
    lp, tl, _ = tm.hotword_logprobs(*t, max_tokens=MAX_TOKENS)
    tok, tl2 = tm.decode_with_hotwords(*t, max_tokens=MAX_TOKENS)
    np.testing.assert_array_equal(w_tl, w_tl2)
    np.testing.assert_array_equal(tl.numpy(), w_tl)
    np.testing.assert_array_equal(tl2.numpy(), w_tl)
    assert (w_tl < MAX_TOKENS).all() and (w_tl > 4).all()
    np.testing.assert_array_equal(tok.numpy(), w_tok)
    valid = np.arange(MAX_TOKENS)[None] < w_tl[:, None]
    np.testing.assert_allclose(lp.numpy()[valid], want_lp[valid], rtol=0, atol=LOGP_F32_ATOL)
    # the bias branch moves the decoder: the same grid's log-probs differ
    # from the unbiased decoder's
    with torch.no_grad():
        plain, _, _ = tm.inference_logits(*t[:2], max_tokens=MAX_TOKENS)
    assert np.abs(plain.numpy() - lp.numpy())[valid].max() > 1e-2


def test_hotword_memory_matches_jax(models):
    _, jm, p, tm = models
    pad, lens = hotword_grid(hotword_sets()["several"])
    want = np.asarray(jax.jit(lambda p, a, b: jm.apply(
        p, a, b, method=jm._hotword_memory))(p, jnp.asarray(pad), jnp.asarray(lens)))
    with torch.no_grad():
        got = tm.hotword_memory(torch.from_numpy(pad), torch.from_numpy(lens))
    assert got.dtype == torch.float32 and got.shape == want.shape == (4, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert tm.bias_encoder.num_layers == 1 and not tm.bias_encoder.bias_hh_l0.any()


def test_convert_round_trips_through_jax_converter(models):
    from funasr_tpu.convert import contextual_paraformer_from_torch

    _, _, p, tm = models
    sd = tm.state_dict()
    assert sd["decoder.bias_output.weight"].shape == (32, 64, 1)
    assert len(tm.decoder.decoders) == 2 and tm.decoder.decoders2 is None
    for key in ("decoder.last_decoder.src_attn.linear_k_v.weight",
                "decoder.bias_decoder.norm3.weight", "decoder.bias_decoder.src_attn.linear_q.bias",
                "bias_encoder.weight_ih_l0", "bias_embed.weight", "decoder.decoders3.0.norm1.bias"):
        assert key in sd, key
    back = contextual_paraformer_from_torch({k: v.numpy() for k, v in sd.items()})
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    want, got = flat(p["params"]), flat(back["params"])
    # the inference tree has no training embedding; the port keeps zeros for it
    assert set(got) - set(want) == {"['decoder']['embed']['embedding']"}
    assert set(want) <= set(got)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=0, atol=1e-6, err_msg=key)


def test_int8_decoder_matches_jax(monkeypatch):
    from funasr_tpu.ops import decoder_layer_pallas as JDL
    from funasr_tpu.ops import ffn_pallas as JFP
    from funasr_tpu.ops import quant as JQ
    from funasr_tpu.ops import sanm_layer_pallas as JSL
    from funasr_torch.ops import decoder_layer as DL

    conf = contextual_conf(256, 2, 256)
    _, p = init_contextual(conf, 0)
    calls = {"dec": 0}

    def dec_spy(*a, f=JDL._call, **k):
        calls["dec"] += 1
        return f(*a, **k)

    for mod in (JSL, JDL, JFP):
        monkeypatch.setattr(mod, "enabled", lambda: True)
    monkeypatch.setattr(JDL, "_call", dec_spy)
    rng = np.random.default_rng(9)
    pad, lens = hotword_grid([list(rng.integers(3, 30, rng.integers(2, 5))) for _ in range(5)])
    B, U, T, D = 2, 64, 48, 256
    enc = rng.standard_normal((B, T, D)).astype(np.float32)
    enc_lens = np.array([T, 35], np.int32)
    emb = rng.standard_normal((B, U, D)).astype(np.float32)
    tl = np.array([U, 41], np.int32)
    jmb = JaxContextual(**conf, dtype=jnp.bfloat16)

    def jax_decoder(m, enc, el, emb, tl, hp, hl):
        mem = m._hotword_memory(hp, hl)
        ctx = jnp.broadcast_to(mem[None], (enc.shape[0],) + mem.shape)
        return m.decoder(enc, el, emb, tl, True, contextual_info=ctx)

    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    with JQ.quantized(True), pltpu.force_tpu_interpret_mode():
        logits = jax.jit(lambda p, *a: jmb.apply(p, *a, method=jax_decoder))(
            p, bf(enc), enc_lens, bf(emb), tl, pad, lens)
    assert calls["dec"] >= 1, calls  # the scanned plain layers (traced once)
    want = np.asarray(jax.nn.log_softmax(logits.astype(jnp.float32), -1))

    tm = ContextualParaformer(**conf, device="cpu", dtype=torch.bfloat16, quantize=True)
    tm.load_state_dict(C.contextual_paraformer_from_jax(p), strict=True)
    tm.quantize_weights()
    assert tm.decoder.bias_output.weight.dtype == torch.float32
    launches = {"n": 0}
    real = DL.decoder_layer_ref

    def counted(*a, **k):
        launches["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(DL, "decoder_layer_ref", counted)
    f32 = lambda a: torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))
    with torch.no_grad():
        mem = tm.hotword_memory(torch.from_numpy(pad), torch.from_numpy(lens))
        got = tm.decoder(f32(bf(enc)), torch.from_numpy(enc_lens), f32(bf(emb)),
                         torch.from_numpy(tl), contextual=mem[None].expand(B, *mem.shape))
    assert launches["n"] == 2  # the plain layers; the last one stays on the module path
    lp = torch.log_softmax(got.float(), -1).numpy()
    valid = np.arange(U)[None] < tl[:, None]
    np.testing.assert_allclose(lp[valid], want[valid], rtol=0, atol=LOGP_ATOL)
    top2 = np.sort(want, -1)[..., -2:]
    clear = valid & (top2[..., 1] - top2[..., 0] > 2 * LOGP_ATOL)
    agree = (lp.argmax(-1) == want.argmax(-1))[clear]
    assert clear.sum() >= 8 and agree.mean() >= MIN_AGREE, agree.mean()


@pytest.fixture(scope="module")
def engines(models):
    """One JAX engine for the module: its jitted programs compile once."""
    _, jm, p, tm = models
    jax_engine = JE.HotwordEngine(jm, p, JE.FrontendConfig(), JaxTokenizer(TOKENS),
                                  seaco=False)
    port = TE.HotwordEngine(tm, TE.FrontendConfig(), CharTokenizer(TOKENS), device="cpu",
                            seaco=False)
    return jax_engine, port


@pytest.mark.parametrize("hotword", [HOTWORD, ["丅丆", "丈", "zz", "丒且丘"], "", "zz"])
def test_encode_hotwords_matches_jax(engines, hotword):
    """No no-bias row: the grid holds only the words that tokenize; with
    none, the port raises where the JAX engine hands on None."""
    jax_engine, port = engines
    want_pad, want_lens = jax_engine._encode_hotwords(hotword)
    if want_pad is None:
        with pytest.raises(ValueError, match="no word that tokenizes"):
            port.encode_hotwords(hotword)
        return
    grid = port.encode_hotwords(hotword)
    np.testing.assert_array_equal(grid.pad.numpy(), np.asarray(want_pad))
    np.testing.assert_array_equal(grid.lengths.numpy(), np.asarray(want_lens))
    assert not port.from_fbank


@pytest.mark.parametrize("with_timestamp", [True, False])
def test_engine_matches_jax(engines, with_timestamp):
    jax_engine, port = engines
    wavs, offsets = _wavs(), [0, 120, 5000]
    want = jax_engine.transcribe(wavs, hotword=HOTWORD, with_timestamp=with_timestamp,
                                 vad_offsets=offsets)
    got = port.transcribe(wavs, with_timestamp, offsets, hotword=HOTWORD)
    assert got == want and all(r["text"] and "timestamp" not in r for r in got)
    grid = port.encode_hotwords(HOTWORD)
    assert port.transcribe(wavs, with_timestamp, offsets, hotword=grid) == got
    # no hotword: the Paraformer path, 60 ms CIF-peak stamps
    want = jax_engine.transcribe(wavs, with_timestamp=with_timestamp, vad_offsets=offsets)
    plain = port.transcribe(wavs, with_timestamp, offsets)
    assert plain == want and ("timestamp" in plain[0]) == with_timestamp
    assert [r["text"] for r in plain] != [r["text"] for r in got]
    assert port.transcribe([], hotword=HOTWORD) == []


# ------------------------------------------- AutoModel with a VAD and punctuation
@pytest.fixture(scope="module")
def pipeline_pair(tmp_path_factory, models):
    """The JAX AutoModel and the port's on the contextual model's weights, the
    VAD's head calibrated, the punctuation model random."""
    from funasr_tpu.models.ct_transformer.model import CTTransformerModel
    from tests.test_torch_punc import jax_params

    conf, _, p, tm = models
    tmp = tmp_path_factory.mktemp("contextual")
    cfg = dict(model="ContextualParaformer", tokenizer_conf={"token_list": TOKENS},
               frontend_conf=dict(n_mels=80, lfr_m=7, lfr_n=6),
               model_conf=dict(inner_dim=conf["inner_dim"]),
               **{k: v for k, v in conf.items() if k != "inner_dim"})
    vad = calibrated_params(init_params(VAD_CONF, 0)[1], VAD_CONF, _port_frontend())
    punc = jax_params(CTTransformerModel(**{k: v for k, v in PUNC_CFG.items()
                                            if k in ("vocab_size", "embed_unit", "att_unit",
                                                     "encoder_conf")}), 0)
    jam = JaxAutoModel(
        model=dict(cfg, init_param=_save_flax(tmp / "j_asr.npz", p["params"])),
        vad_model=dict(VAD_CFG, init_param=_save_flax(tmp / "j_vad.npz", vad["params"])),
        punc_model=dict(PUNC_CFG, init_param=_save_flax(tmp / "j_punc.npz", punc["params"])))
    am = AutoModel(model=dict(cfg, init_param=_save(tmp / "asr.npz", tm.state_dict())),
                   vad_model=dict(VAD_CFG, init_param=_save(tmp / "vad.npz",
                                                            C.fsmn_vad_from_jax(vad))),
                   punc_model=dict(PUNC_CFG, init_param=_save(
                       tmp / "punc.npz", C.ct_transformer_from_jax(punc))), device="cpu")
    return jam, am


def test_generate_with_vad_matches_jax(monkeypatch, pipeline_pair):
    jam, am = pipeline_pair
    assert isinstance(am.engine, TE.HotwordEngine) and not am.engine.seaco
    wav = recording(0)
    want = jam.generate(wav, key=["h"], hotword=HOTWORD)[0]
    got = am.generate(wav, key=["h"], hotword=HOTWORD)[0]
    assert got == want and got["text"] and got["timestamp"] == []
    # no hotword: the JAX call fails on the shared-fbank path (pinned); its
    # waveform path is the reference
    with pytest.raises(AttributeError, match="timestamps"):
        jam.generate(wav, key=["n"])
    monkeypatch.setenv("FUNASR_TPU_DISABLE_SHARED_FRONTEND", "1")
    want = jam.generate(wav, key=["n"])[0]
    got_n = am.generate(wav, key=["n"])[0]
    assert got_n == want and got_n["timestamp"] and got_n["sentence_info"]


def test_generate_empty_hotword_raises_in_both(pipeline_pair):
    """``hotword=""``: no grid row.  The JAX engine fails on the None grid;
    the port names the cause."""
    jam, am = pipeline_pair
    wav = _wavs((16000,))[0]
    jam_plain = JaxAutoModel(model=None)
    jam_plain.engine = jam.engine
    with pytest.raises(AttributeError, match="dtype"):
        jam_plain.generate(wav, hotword="")
    am_plain = AutoModel(model=None, device="cpu")
    am_plain.engine = am.engine
    with pytest.raises(ValueError, match="no word that tokenizes"):
        am_plain.generate(wav, hotword="")
    with pytest.raises(ValueError, match="no word that tokenizes"):
        am.generate(recording(0), hotword="  ")
