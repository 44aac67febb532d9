"""The port's SeacoParaformer (``funasr_torch/models/seaco_paraformer``) and
``HotwordEngine`` against the JAX package on the CPU.

A tiny BiCif Paraformer (D = 32, ``tests/test_torch_bicif.py``'s) with a
2-block SeACo decoder, initialised in JAX and carried over by
``convert.seaco_paraformer_from_jax``; inputs from numpy seeds.  The bias
head's no-bias logit is raised by ``NO_BIAS_SHIFT`` so that both branches
of the merge occur (random weights otherwise never pick the no-bias
class, and the merge would be the bias head alone).

- float32: ``decode_with_hotwords`` tokens and token lengths equal; merged
  log-probs within ``LOGP_F32_ATOL`` and ``us_alphas`` within the BiCif
  test's 1e-5; the upsampled fires equal (the JAX frame-0 fault corrected as
  ``test_torch_bicif.py`` does); for one hotword, several, the no-bias row
  alone and 50 hotwords (H + 1 = 51 memory rows).
- ``HotwordEngine``: the hotword grid as the JAX engine builds it, its
  records equal to the JAX engine's with and without timestamps, and with
  ``hotword=None`` equal to ``BiCifEngine``'s.
- int8 (``quantize=True``, bf16): the SeACo decoder on the JAX decoder's
  hiddens and embeddings, as ``test_torch_bicif.py``'s int8 decoder test
  feeds its decoders, with the JAX fused decoder layer forced on in
  interpret mode (H + 1 = 8 memory rows, the JAX kernel's T % 8 rule): the
  branch of the merge equal wherever the JAX bias head's no-bias logit is
  clear of its best other by 2 x ``LOGP_ATOL`` (a flip elsewhere is a near
  tie either side may break), and the merged log-probs within ``LOGP_ATOL``
  and argmax agreement >= ``MIN_AGREE`` where both took the same branch and
  the JAX top-2 margin is clear: the int8 bars of
  ``test_torch_paraformer_int8.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from funasr_tpu.auto import engines as JE
from funasr_tpu.models.seaco_paraformer.model import SeacoParaformer as JaxSeaco
from funasr_tpu.tokenizer.char_tokenizer import CharTokenizer as JaxTokenizer
from funasr_torch.auto import engines as TE
from funasr_torch.convert import bicif_paraformer_from_jax, seaco_paraformer_from_jax
from funasr_torch.models.bicif_paraformer.model import BiCifParaformer
from funasr_torch.models.seaco_paraformer.model import SeacoParaformer
from funasr_torch.tokenizer.char_tokenizer import CharTokenizer
from tests.test_torch_bicif import TOKENS, US_ATOL, _conf, _jax_fires, _wavs
from tests.test_torch_paraformer_int8 import LOGP_ATOL, MIN_AGREE
from tests.test_torch_vad import built_once
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

NB = len(TOKENS) - 1  # the no-bias class: the vocabulary's last id
NO_BIAS_SHIFT = 2.5  # raises the no-bias logit: about half the positions keep the decoder
LOGP_F32_ATOL = 1e-4
MAX_TOKENS = 48


def seaco_conf(D=32, heads=2, units=48, vocab_size=len(TOKENS)):
    conf = _conf(D, heads, units, 2, 2, vocab_size=vocab_size)
    conf.update(inner_dim=D, no_bias_id=vocab_size - 1,
                seaco_decoder_conf=dict(attention_heads=heads, linear_units=2 * units,
                                        num_blocks=2, att_layer_num=2,
                                        kernel_size=5 if D < 128 else 11))
    return conf


def init_seaco(conf, seed, shift=NO_BIAS_SHIFT):
    """Jitted JAX init through ``decode_with_hotwords`` (which creates the
    bias branch), numpy leaves, the no-bias logit raised by ``shift``."""
    return built_once(("init_seaco", repr(conf), seed, shift),
                      lambda: _init_seaco_uncached(conf, seed, shift))


def _init_seaco_uncached(conf, seed, shift=NO_BIAS_SHIFT):
    jm = JaxSeaco(**conf)
    hw = jnp.asarray([[conf["no_bias_id"]]], jnp.int32)
    p = jax.jit(lambda key: jm.init(
        {"params": key}, jnp.zeros((1, 16, 560)), jnp.array([16]), hw, jnp.array([1]),
        max_tokens=8, method=jm.decode_with_hotwords))(jax.random.PRNGKey(seed))
    p = jax.tree_util.tree_map(np.array, p)
    p["params"]["hotword_output_layer"]["bias"][conf["no_bias_id"]] += shift
    return jm, p


def hotword_grid(rows, L=8):
    """[[ids], ...] (the no-bias row included) -> (pad, lens) int32."""
    pad = np.zeros((len(rows), max(L, max(map(len, rows)))), np.int32)
    for i, r in enumerate(rows):
        pad[i, : len(r)] = r
    return pad, np.array([len(r) for r in rows], np.int32)


def hotword_sets():
    rng = np.random.default_rng(4)
    many = [list(rng.integers(3, NB, rng.integers(2, 5))) for _ in range(50)]
    return {"one": [[5, 6, 7]], "several": [[5, 6, 7], [9, 10], [12], [14, 15, 16, 17]],
            "no_bias_only": [], "fifty": many}


@pytest.fixture(scope="module")
def models():
    conf = seaco_conf()
    jm, p = init_seaco(conf, 3)
    tm = SeacoParaformer(**conf, device="cpu")
    tm.load_state_dict(seaco_paraformer_from_jax(p), strict=True)
    return conf, jm, p, tm


def _speech():
    rng = np.random.default_rng(7)
    return (rng.standard_normal((3, 64, 560)).astype(np.float32),
            np.array([64, 50, 37], np.int32))


@pytest.mark.parametrize("which", ["one", "several", "no_bias_only", "fifty"])
def test_decode_with_hotwords_matches_jax(models, which):
    _, jm, p, tm = models
    pad, lens = hotword_grid(hotword_sets()[which] + [[NB]])
    x, xl = _speech()
    args = tuple(map(jnp.asarray, (x, xl, pad, lens)))
    # decode_with_hotwords is the argmax of these within the lengths
    want_lp, w_tl, pred = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda p, *a: jm.apply(p, *a, max_tokens=MAX_TOKENS, method=jm.hotword_logprobs))(
            p, *args))
    valid = np.arange(MAX_TOKENS)[None] < w_tl[:, None]
    w_tok = np.where(valid, want_lp.argmax(-1), 0)
    w_a, w_p = pred.us_alphas, pred.us_peaks
    t = tuple(map(torch.from_numpy, (x, xl, pad, lens)))
    lp, tl, _ = tm.hotword_logprobs(*t, max_tokens=MAX_TOKENS)
    tok, tl2, us_a, us_p = tm.decode_with_hotwords(*t, max_tokens=MAX_TOKENS)
    np.testing.assert_array_equal(tl.numpy(), w_tl)
    np.testing.assert_array_equal(tl2.numpy(), w_tl)
    assert (w_tl < MAX_TOKENS).all() and (w_tl > 4).all()
    np.testing.assert_array_equal(tok.numpy(), w_tok)
    np.testing.assert_allclose(lp.numpy()[valid], want_lp[valid], rtol=0, atol=LOGP_F32_ATOL)
    np.testing.assert_allclose(us_a.numpy(), w_a, rtol=0, atol=US_ATOL)
    np.testing.assert_array_equal(us_p.numpy(), _jax_fires(w_p, w_a))


def test_merge_takes_both_branches(models):
    """The no-bias shift leaves both branches of the merge in use, so the
    parity above covers the decoder's log-probs and the mixed ones."""
    _, _, _, tm = models
    pad, lens = hotword_grid(hotword_sets()["several"] + [[NB]])
    x, xl = _speech()
    seen = {}
    real = tm.merge_logprobs

    def spy(dec, dha):
        seen["keep"] = torch.argmax(dha, -1) == NB
        return real(dec, dha)

    tm.merge_logprobs = spy
    try:
        lp, tl, _ = tm.hotword_logprobs(*map(torch.from_numpy, (x, xl, pad, lens)),
                                        max_tokens=MAX_TOKENS)
    finally:
        del tm.merge_logprobs
    valid = torch.arange(MAX_TOKENS)[None] < tl[:, None]
    share = float(seen["keep"][valid].float().mean())
    assert 0.2 <= share <= 0.8, share


def test_hotword_representation_matches_jax(models):
    """Embedding, 2-layer LSTM, output at len - 1 (the gate order and the
    bias carried across)."""
    _, jm, p, tm = models
    pad, lens = hotword_grid(hotword_sets()["several"] + [[NB]])
    want = np.asarray(jax.jit(lambda p, a, b: jm.apply(
        p, a, b, method=jm._hotword_representation))(p, jnp.asarray(pad), jnp.asarray(lens)))
    with torch.no_grad():
        got = tm.hotword_representation(torch.from_numpy(pad), torch.from_numpy(lens))
    assert got.dtype == torch.float32 and got.shape == want.shape == (5, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert tm.bias_encoder.num_layers == 2
    assert not tm.bias_encoder.bias_hh_l1.any()  # the flax bias sits in bias_ih


def test_convert_round_trips_through_jax_converter(models):
    from funasr_tpu.convert import seaco_paraformer_from_torch

    _, _, p, tm = models
    back = seaco_paraformer_from_torch({k: v.numpy() for k, v in tm.state_dict().items()})
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    want, got = flat(p["params"]), flat(back["params"])
    # the SeACo decoder's embedding is FunASR's unused one: zeros in the port
    assert set(got) - set(want) == {"['seaco_decoder']['embed']['embedding']"}
    assert set(want) <= set(got)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=0, atol=1e-6, err_msg=key)
    assert tm.seaco_decoder.output_layer is None and tm.hotword_output_layer.weight.shape == (
        len(TOKENS), 32)


@pytest.fixture(scope="module")
def engines(models):
    """The JAX and port hotword engines, built once for the module (the JAX
    engine jits its programs per instance)."""
    conf, jm, p, tm = models
    jax_engine = JE.HotwordEngine(jm, p, JE.FrontendConfig(), JaxTokenizer(TOKENS),
                                  seaco=True)
    port = TE.HotwordEngine(tm, TE.FrontendConfig(), CharTokenizer(TOKENS), device="cpu")
    return jax_engine, port


@pytest.mark.parametrize("hotword", ["丅丆 丈 zz 丒且丘", ["丅丆", "丈", "丒且丘"], "", "zz"])
def test_encode_hotwords_matches_jax(engines, hotword):
    """Whitespace words or a list; a word with no known token dropped; the
    no-bias row appended; padded to max(8, the longest)."""
    jax_engine, port = engines
    want_pad, want_lens = map(np.asarray, jax_engine._encode_hotwords(hotword))
    grid = port.encode_hotwords(hotword)
    np.testing.assert_array_equal(grid.pad.numpy(), want_pad)
    np.testing.assert_array_equal(grid.lengths.numpy(), want_lens)
    assert grid.pad.dtype == torch.int32 and grid.pad.shape[1] >= 8
    assert int(grid.pad[-1, 0]) == NB and int(grid.lengths[-1]) == 1


@pytest.mark.parametrize("with_timestamp", [True, False])
def test_engine_hotword_matches_jax(monkeypatch, engines, with_timestamp):
    real = JE.BiCifEngine._ts_results

    def fixed(self, wavs, tokens, tok_lens, us_alphas, us_peaks, vad_offsets, us_lens=None):
        return real(self, wavs, tokens, tok_lens, us_alphas,
                    _jax_fires(np.asarray(us_peaks), us_alphas), vad_offsets, us_lens=us_lens)

    monkeypatch.setattr(JE.BiCifEngine, "_ts_results", fixed)
    jax_engine, port = engines
    wavs, offsets = _wavs(), [0, 120, 5000]
    hot = "丅丆 丈 丒且丘"
    want = jax_engine.transcribe(wavs, hotword=hot, with_timestamp=with_timestamp,
                                 vad_offsets=offsets)
    got = port.transcribe(wavs, with_timestamp, offsets, hotword=hot)
    assert got == want and all(r["text"] for r in got)
    grid = port.encode_hotwords(hot)
    assert port.transcribe(wavs, with_timestamp, offsets, hotword=grid) == got
    assert port.transcribe([], hotword=hot) == []


def test_engine_without_hotword_is_bicif(models, engines):
    """``hotword=None``: the BiCif path, the same records as ``BiCifEngine``
    on the model's BiCif weights and as the JAX engine's."""
    conf, jm, p, tm = models
    jax_engine, port = engines
    bconf = {k: v for k, v in conf.items()
             if k not in ("inner_dim", "no_bias_id", "seaco_decoder_conf")}
    bicif = BiCifParaformer(**bconf, device="cpu")
    sd = {k: v for k, v in tm.state_dict().items() if k in bicif.state_dict()}
    bicif.load_state_dict(sd, strict=True)
    assert sd.keys() == bicif_paraformer_from_jax(p).keys()
    wavs = _wavs((20000, 9000))
    got = port.transcribe(wavs, vad_offsets=[0, 40])
    want = TE.BiCifEngine(bicif, TE.FrontendConfig(), CharTokenizer(TOKENS),
                          device="cpu").transcribe(wavs, vad_offsets=[0, 40])
    assert got == want and got[0]["timestamp"]
    jw = jax_engine.transcribe(wavs, vad_offsets=[0, 40])
    assert [r["text"] for r in jw] == [r["text"] for r in got]


def test_contextual_is_not_ported(models):
    """``seaco=False``, ContextualParaformer's engine, is ported (its parity:
    ``tests/test_torch_contextual.py``): its grid has no no-bias row, and it
    has no entry from a shared fbank grid."""
    _, _, _, tm = models
    eng = TE.HotwordEngine(tm, TE.FrontendConfig(), CharTokenizer(TOKENS), device="cpu",
                           seaco=False)
    seaco = TE.HotwordEngine(tm, TE.FrontendConfig(), CharTokenizer(TOKENS), device="cpu")
    assert not eng.seaco and not eng.from_fbank and seaco.from_fbank
    grid = eng.encode_hotwords("丅丆 丈")
    assert grid.pad.shape[0] == 2 and NB not in grid.pad[:, 0].tolist()
    assert seaco.encode_hotwords("丅丆 丈").pad.shape[0] == 3


def test_seaco_defaults_and_hidden_decoder():
    """The class's SeACo decoder defaults (4 heads, 1024 units, 3 blocks,
    kernel 11, no output layer), and the decoder's hidden output: the
    logits are ``project`` of ``return_hidden``."""
    conf = seaco_conf()
    conf.pop("seaco_decoder_conf")
    tm = SeacoParaformer(**conf, device="cpu")
    sd = tm.seaco_decoder
    assert len(sd.decoders) == 3 and sd.decoders2 is None and sd.output_layer is None
    assert sd.decoders[0].src_attn.n_head == 4
    assert sd.decoders[0].feed_forward.w_1.weight.shape == (1024, 32)
    assert sd.decoders[0].self_attn.fsmn_block.weight.shape == (32, 1, 11)
    torch.manual_seed(0)
    mem, emb = torch.randn(2, 12, 32), torch.randn(2, 6, 32)
    ml, tl = torch.tensor([12, 9]), torch.tensor([6, 4])
    with torch.no_grad():
        logits = tm.decoder(mem, ml, emb, tl)
        hidden = tm.decoder(mem, ml, emb, tl, return_hidden=True)
        assert hidden.shape == (2, 6, 32)
        torch.testing.assert_close(tm.decoder.project(hidden), logits, rtol=0, atol=0)
        assert tm.seaco_decoder(mem, ml, emb, tl).shape == (2, 6, 32)


# ---------------------------------------------------------------- int8
INT8_V = 160


def test_int8_seaco_decoder_matches_jax(monkeypatch):
    from funasr_tpu.ops import decoder_layer_pallas as JDL
    from funasr_tpu.ops import ffn_pallas as JFP
    from funasr_tpu.ops import quant as JQ
    from funasr_tpu.ops import sanm_layer_pallas as JSL
    from funasr_torch.ops import decoder_layer as DL

    conf = seaco_conf(256, 2, 256, vocab_size=INT8_V)
    nb = conf["no_bias_id"]
    jm, p = init_seaco(conf, 0, shift=0.0)
    calls = {"dec": 0}

    def dec_spy(*a, f=JDL._call, **k):
        calls["dec"] += 1
        return f(*a, **k)

    for mod in (JSL, JDL, JFP):
        monkeypatch.setattr(mod, "enabled", lambda: True)
    monkeypatch.setattr(JDL, "_call", dec_spy)
    rng = np.random.default_rng(9)
    rows = [list(rng.integers(3, nb, rng.integers(2, 5))) for _ in range(7)] + [[nb]]
    pad, lens = hotword_grid(rows)
    B, U, T, D = 2, 64, 48, 256
    enc = rng.standard_normal((B, T, D)).astype(np.float32)
    enc_lens = np.array([T, 35], np.int32)
    emb = rng.standard_normal((B, U, D)).astype(np.float32)
    tl = np.array([U, 41], np.int32)
    jmb = JaxSeaco(**conf, dtype=jnp.bfloat16)
    # shift the no-bias logit so that both branches occur at bf16's scale
    p["params"]["hotword_output_layer"]["bias"][nb] += 1.5

    def jax_parts(m, enc, el, emb, tl, hp, hl):
        hidden = m.decoder(enc, el, emb, tl, True, return_hidden=True)
        ctx = m._hotword_representation(hp, hl)
        return m.decoder.project(hidden), m._dha_logits(ctx, enc.shape[0], emb, hidden, tl), \
            hidden

    with JQ.quantized(True), pltpu.force_tpu_interpret_mode():
        dec_l, dha_l, hidden = jax.jit(lambda p, *a: jmb.apply(p, *a, method=jax_parts))(
            p, jnp.asarray(enc).astype(jnp.bfloat16), enc_lens, jnp.asarray(emb).astype(
                jnp.bfloat16), tl, pad, lens)
    assert calls["dec"] >= 4, calls  # 2 main + 2 x 2 SeACo full layers (traced once each)
    dec_lp = np.asarray(jax.nn.log_softmax(dec_l.astype(jnp.float32), -1))
    dha_lp = np.asarray(jax.nn.log_softmax(dha_l.astype(jnp.float32), -1))

    tm = SeacoParaformer(**conf, device="cpu", dtype=torch.bfloat16, quantize=True)
    tm.load_state_dict(seaco_paraformer_from_jax(p), strict=True)
    tm.quantize_weights()
    launches = {"n": 0}
    real = DL.decoder_layer_ref

    def counted(*a, **k):
        launches["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(DL, "decoder_layer_ref", counted)
    f32 = lambda a: torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))
    with torch.no_grad():
        ctx = tm.hotword_representation(torch.from_numpy(pad), torch.from_numpy(lens))
        dha = tm.dha_logits(ctx, f32(emb).to(torch.bfloat16),
                            f32(hidden).to(torch.bfloat16), torch.from_numpy(tl))
        merged = tm.merge_logprobs(f32(dec_l), dha).numpy()
    assert launches["n"] == 4  # the SeACo decoder's 2 full layers, twice
    keep_w = dha_lp.argmax(-1) == nb
    keep_g = torch.argmax(dha.float(), -1).numpy() == nb
    valid = np.arange(U)[None] < tl[:, None]
    others = np.delete(dha_lp, nb, axis=-1).max(-1)
    clear_branch = np.abs(dha_lp[..., nb] - others) > 2 * LOGP_ATOL
    flips = (keep_w != keep_g) & valid
    assert 0 < (keep_w & valid).sum() < valid.sum()
    assert not (flips & clear_branch).any(), int(flips.sum())
    want = np.where(keep_w[..., None], dec_lp, dha_lp)  # seaco_weight 1
    same = valid & ~flips
    np.testing.assert_allclose(merged[same], want[same], rtol=0, atol=LOGP_ATOL)
    top2 = np.sort(want, -1)[..., -2:]
    clear = same & (top2[..., 1] - top2[..., 0] > 2 * LOGP_ATOL)
    agree = (merged.argmax(-1) == want.argmax(-1))[clear]
    assert clear.sum() >= 8 and agree.mean() >= MIN_AGREE, agree.mean()
