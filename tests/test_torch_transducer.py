"""The port's transducer family (``models/transducer``: Transducer; the RWKV
encoder and RWKV-BAT, ``models/rwkv.py``; the WKV wrapper ``ops/wkv.py``)
against the JAX package on the CPU, inputs from numpy seeds.

Each family is a tiny model (vocabulary 32, D = 16, 2 encoder blocks, the
prediction network and joint 16 wide) initialised in JAX once a module
(``family``) and carried into the port by ``convert.transducer_from_jax`` /
``convert.rwkv_bat_from_jax``.  Random weights make the joint pick a
non-blank token almost every time, so every row would stop at
``max_tokens``: the family's blank bias is raised (``BLANK_SHIFT``) so rows
emit a few tokens a frame and stop short of the cap, with several distinct
tokens.  Bars:

- the WKV twin (through the wrapper on CPU tensors) at edge shapes (T = 1,
  C = 33, one row, keys far above the -1e30 start) and the RWKV encoder,
  channel mix and decoder state within 1e-5 (float32);
- ``RNNTDecoder`` over a whole token sequence and step by step, the joint
  network and ``logits_grid`` within 1e-5;
- ``greedy_decode`` tokens and counts equal, float32, for both families and
  under a ``max_tokens`` cap; fed its own decisions (teacher forcing) it
  gives them back; int8 (``quantize=True``, bf16 activations,
  the int8 gate lowered to 0 rows in both packages so the Conformer's FFNs
  take int8) against the JAX package under ``quant.quantized(True)``:
  ``logits_grid`` within the int8 log-prob bar of
  ``tests/test_torch_paraformer_int8.py`` (0.15) and greedy tokens and
  counts equal;
- the state dicts convert back to the JAX trees through
  ``funasr_tpu.convert.transducer_from_torch`` (the Conformer transducer;
  the JAX package has none for the RWKV encoder);
- ``AutoModel`` records equal to the JAX ``AutoModel``'s, without a VAD and
  behind FSMN-VAD and CT-Transformer (texts joined, no timestamps, as the
  JAX pipeline gives them for this engine).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from funasr_tpu.auto.auto_model import AutoModel as JaxAutoModel
from funasr_tpu.convert import transducer_from_torch
from funasr_tpu.models import rwkv as JR
from funasr_tpu.models.transducer import model as JTM
from funasr_tpu.ops import quant as JQ
from funasr_torch import convert as C
from funasr_torch.auto import engines as TE
from funasr_torch.auto.auto_model import AutoModel
from funasr_torch.models import rwkv as TR
from funasr_torch.models.transducer import model as TTM
from funasr_torch.ops import quant as Q
from funasr_torch.ops import wkv as W
from tests.test_torch_bicif import TOKENS
from tests.test_torch_e_paraformer import wavs
from tests.test_torch_pipeline import (PUNC_CFG, VAD_CFG, _save, _save_flax, _save_variables,
                                       long_recording, punc_params, vad_params)
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

V, IN, D = len(TOKENS), 80, 16
CONFORMER = dict(output_size=D, attention_heads=2, linear_units=32, num_blocks=2,
                 cnn_module_kernel=7, dropout_rate=0.0)
RWKV = dict(output_size=D, num_blocks=2, linear_units=32)
HEADS = dict(decoder_conf=dict(embed_size=D, hidden_size=D), joint_conf=dict(joint_size=D))
# family: (JAX class, port class, encoder_conf, JAX -> port converter)
FAMILIES = {
    "transducer": (JTM.Transducer, TTM.Transducer, CONFORMER, C.transducer_from_jax),
    "bat": (JR.RWKVBAT, TR.RWKVBAT, RWKV, C.rwkv_bat_from_jax),
}
BLANK_SHIFT = {"transducer": 0.5, "bat": 1.5}
TOL = 1e-5
INT8_LOGP_ATOL = 0.15  # tests/test_torch_paraformer_int8.py LOGP_ATOL


def conf(name):
    return dict(vocab_size=V, input_size=IN, encoder_conf=FAMILIES[name][2], **HEADS)


@functools.lru_cache(maxsize=None)
def family(name):
    """(JAX model, its float32 variables as numpy (blank bias raised), the
    port's float32 model on the CPU with those weights)."""
    from tests.test_torch_conformer import perturb_batch_stats

    jax_cls, port_cls, _, convert = FAMILIES[name]
    jm = jax_cls(**conf(name))
    B, T, U = 2, 40, 5
    variables = jax.jit(lambda k: jm.init(
        {"params": k, "dropout": k}, jnp.zeros((B, T, IN)), jnp.array([T, T - 8]),
        jnp.zeros((B, U), jnp.int32), jnp.array([U, U - 1]), deterministic=True)
    )(jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map(np.array, variables)
    if "batch_stats" in variables:
        variables = perturb_batch_stats(variables)
    variables["params"]["joint_network"]["lin_out"]["bias"][0] += BLANK_SHIFT[name]
    tm = port_cls(**conf(name), device="cpu")
    tm.load_state_dict(convert(variables), strict=True)
    return jm, variables, tm


def speech(seed=5, B=3, T=44):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, IN)).astype(np.float32)
    return x, np.array([T, T - 9, T - 21][:B], np.int32)


# ------------------------------------------------------------------ WKV
@pytest.mark.parametrize("B,T,C,scale", [(2, 1, 8, 1.0), (1, 9, 33, 3.0), (3, 17, 5, 60.0),
                                         (2, 12, 16, 0.2)],
                         ids=["T1", "C33_one_row", "large_k", "small_k"])
def test_wkv_twin_matches_jax(B, T, C, scale):
    rng = np.random.default_rng(int(10 * scale) + T)
    k = (scale * rng.standard_normal((B, T, C))).astype(np.float32)
    v = rng.standard_normal((B, T, C)).astype(np.float32)
    w = np.exp(rng.standard_normal(C)).astype(np.float32)
    u = (scale * rng.standard_normal(C)).astype(np.float32)
    want = np.asarray(JR.wkv_scan(*map(jnp.asarray, (k, v, w, u))))
    got = W.wkv(*map(torch.from_numpy, (k, v, w, u))).numpy()
    assert np.isfinite(got).all() and W.wkv.launches == 0  # the twin on CPU tensors
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_wkv_wrapper_refuses_other_devices():
    m = torch.empty((2, 3, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        W.wkv(m, m, torch.empty(4, device="meta"), torch.empty(4, device="meta"))


def test_channel_mix_and_block_match_jax():
    _, variables, tm = family("bat")
    node = jax.tree_util.tree_map(lambda a: a[0], variables["params"]["encoder"]["blocks"])
    x = np.random.default_rng(2).standard_normal((3, 7, D)).astype(np.float32)
    want_ffn = jax.jit(JR.ChannelMix(D, 32).apply)({"params": node["ffn"]}, jnp.asarray(x))
    want_blk, _ = jax.jit(lambda p, a: JR.RWKVBlock(D, 32).apply(p, a, None))(
        {"params": node}, jnp.asarray(x))
    with torch.no_grad():
        blk = tm.encoder.blocks[0]
        got_ffn = blk.ffn(torch.from_numpy(x))
        got_blk = blk(torch.from_numpy(x))
    np.testing.assert_allclose(got_ffn.numpy(), np.asarray(want_ffn), atol=TOL, rtol=0)
    np.testing.assert_allclose(got_blk.numpy(), np.asarray(want_blk), atol=TOL, rtol=0)


def test_rwkv_encoder_matches_jax():
    jm, variables, tm = family("bat")
    x, lens = speech()
    want, want_lens = jax.jit(lambda v, a, b: jm.apply(
        v, a, b, method=lambda m, a, b: m.encoder(a, b, True)))(
            variables, jnp.asarray(x), jnp.asarray(lens))
    with torch.no_grad():
        got, got_lens = tm.encoder(torch.from_numpy(x), torch.from_numpy(lens))
    assert got.dtype == torch.float32 and len(tm.encoder.blocks) == 2
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


# ---------------------------------------------------- prediction network
def test_rnnt_decoder_full_and_step_match_jax():
    jm, variables, tm = family("transducer")
    toks = np.random.default_rng(3).integers(0, V, (3, 6)).astype(np.int32)

    def full_and_steps(m, t):
        state, steps = m.decoder.init_state(3), []
        for u in range(t.shape[1]):
            state, g = m.decoder.step(state, t[:, u])
            steps.append(g)
        return m.decoder(t), jnp.stack(steps, 1)

    want, want_steps = jax.jit(lambda v, t: jm.apply(v, t, method=full_and_steps))(
        variables, jnp.asarray(toks))
    with torch.no_grad():
        got = tm.decoder(torch.from_numpy(toks).long()).numpy()
        st, got_steps = tm.decoder.init_state(3), []
        for u in range(toks.shape[1]):
            st, g = tm.decoder.step(st, torch.from_numpy(toks[:, u]).long())
            got_steps.append(g.numpy())
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)
    np.testing.assert_allclose(np.stack(got_steps, 1), np.asarray(want_steps), atol=TOL, rtol=0)
    np.testing.assert_array_equal(got, np.stack(got_steps, 1))


def test_joint_network_matches_jax():
    jm, variables, tm = family("transducer")
    rng = np.random.default_rng(4)
    enc = rng.standard_normal((2, 5, 1, D)).astype(np.float32)
    dec = rng.standard_normal((2, 1, 3, D)).astype(np.float32)
    want = jax.jit(lambda v, a, b: jm.apply(v, a, b, method=lambda m, a, b: m.joint_network(
        a, b)))(variables, jnp.asarray(enc), jnp.asarray(dec))
    with torch.no_grad():
        got = tm.joint_network(torch.from_numpy(enc), torch.from_numpy(dec))
    assert got.shape == (2, 5, 3, V) and tm.joint_network.lin_dec.bias is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("name", ["transducer", "bat"])
def test_logits_grid_matches_jax(name):
    jm, variables, tm = family(name)
    x, lens = speech(seed=6)
    toks = np.random.default_rng(7).integers(1, V, (3, 4)).astype(np.int32)
    want, want_lens = jax.jit(lambda v, a, b, c: jm.apply(v, a, b, c, method=jm.logits_grid))(
        variables, jnp.asarray(x), jnp.asarray(lens), jnp.asarray(toks))
    got, got_lens = tm.logits_grid(torch.from_numpy(x), torch.from_numpy(lens),
                                   torch.from_numpy(toks))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def _greedy(jm, variables, x, lens, max_tokens, module=None):
    module = module or jm
    run = jax.jit(lambda v, a, b: module.apply(v, a, b, max_tokens=max_tokens,
                                               method=module.greedy_decode))
    return [np.asarray(a) for a in run(variables, jnp.asarray(x), jnp.asarray(lens))]


@pytest.mark.parametrize("name,max_tokens", [("transducer", 64), ("bat", 64), ("bat", 8)],
                         ids=["transducer", "bat", "bat_cap8"])
def test_greedy_decode_matches_jax(name, max_tokens):
    jm, variables, tm = family(name)
    x, lens = speech(seed=8)
    want_toks, want_counts = _greedy(jm, variables, x, lens, max_tokens)
    got_toks, got_counts = tm.greedy_decode(torch.from_numpy(x), torch.from_numpy(lens),
                                            max_tokens=max_tokens)
    np.testing.assert_array_equal(got_counts.numpy(), want_counts)
    np.testing.assert_array_equal(got_toks.numpy(), want_toks)
    emitted = np.concatenate([want_toks[b, :n] for b, n in enumerate(want_counts)])
    assert (emitted != 0).all() and len(set(emitted.tolist())) >= 3
    if max_tokens == 8:
        assert (want_counts == 8).any()
    else:  # the blank shift keeps rows off the cap
        assert 0 < want_counts.min() and want_counts.max() < max_tokens


def test_greedy_decode_fed_its_own_decisions():
    _, _, tm = family("bat")
    x, lens = map(torch.from_numpy, speech(seed=9))
    toks, counts, picks, live = tm.greedy_decode(x, lens, max_tokens=8, return_decisions=True)
    assert picks.shape == live.shape == (3, x.shape[1], tm.max_symbols_per_frame)
    assert not live[2, lens[2]:].any() and int(live.sum()) < live.numel()
    forced = tm.greedy_decode(x, lens, max_tokens=8, forced=picks, return_decisions=True)
    assert all(torch.equal(a, b) for a, b in zip(forced, (toks, counts, picks, live)))
    # another row's decisions drive the prediction network: the argmaxes move
    other = tm.greedy_decode(x, lens, max_tokens=8, forced=picks.roll(1, 0),
                             return_decisions=True)
    assert not torch.equal(other[2], picks)


def test_int8_matches_jax_module_path(monkeypatch):
    jm, variables, _ = family("transducer")
    for mod, m, n in ((JQ, "_MIN_M", "_MIN_N"), (Q, "MIN_M", "MIN_N")):
        monkeypatch.setattr(mod, m, 0)
        monkeypatch.setattr(mod, n, 0)
    jmb = JTM.Transducer(**conf("transducer"), dtype=jnp.bfloat16)
    tm = TTM.Transducer(**conf("transducer"), device="cpu", dtype=torch.bfloat16, quantize=True)
    tm.load_state_dict(C.transducer_from_jax(variables), strict=True)
    with pytest.raises(RuntimeError, match="quantize_weights"):
        tm.greedy_decode(*map(torch.from_numpy, speech()), max_tokens=4)
    tm.quantize_weights()
    assert tm.encoder.encoders[0].feed_forward.w_1.w8 is not None
    assert tm.joint_network.lin_out.w8 is None  # plain nn.Dense in JAX: never int8
    x, lens = speech(seed=8)
    toks = np.random.default_rng(7).integers(1, V, (3, 4)).astype(np.int32)
    with JQ.quantized(True):
        want_grid, _ = jax.jit(lambda v, a, b, c: jmb.apply(v, a, b, c, method=jmb.logits_grid))(
            variables, jnp.asarray(x), jnp.asarray(lens), jnp.asarray(toks))
        want_toks, want_counts = _greedy(jmb, variables, x, lens, 48, module=jmb)
    got_grid, _ = tm.logits_grid(torch.from_numpy(x), torch.from_numpy(lens),
                                 torch.from_numpy(toks))
    np.testing.assert_allclose(got_grid.float().numpy(), np.asarray(want_grid, np.float32),
                               atol=INT8_LOGP_ATOL, rtol=0)
    got_toks, got_counts = tm.greedy_decode(torch.from_numpy(x), torch.from_numpy(lens),
                                            max_tokens=48)
    np.testing.assert_array_equal(got_counts.numpy(), want_counts)
    np.testing.assert_array_equal(got_toks.numpy(), want_toks)
    assert want_counts.min() > 0


def test_state_dict_converts_back_to_the_jax_tree():
    _, variables, tm = family("transducer")
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    back = transducer_from_torch(sd, n_mels_after_conv=((IN - 1) // 2 - 1) // 2)
    for coll in ("params", "batch_stats"):
        want = jax.tree_util.tree_leaves_with_path(variables[coll])
        got = dict(jax.tree_util.tree_leaves_with_path(back[coll]))
        assert len(want) >= (10 if coll == "params" else 2) and len(got) == len(want)
        for path, leaf in want:
            np.testing.assert_array_equal(np.asarray(got[path]), leaf, err_msg=str(path))


def test_bat_state_dict_names():
    _, variables, tm = family("bat")
    sd = tm.state_dict()
    assert set(sd) == set(C.rwkv_bat_from_jax(variables))
    for name in ("encoder.blocks.1.att.time_decay", "encoder.blocks.0.ffn.receptance.weight",
                 "encoder.ln_in.weight", "decoder.rnn.0.weight_hh_l0",
                 "joint_network.lin_dec.weight"):
        assert name in sd, name
    assert "joint_network.lin_dec.bias" not in sd


# ------------------------------------------------------------- AutoModel
def _cfg(name, init_param):
    model = {"transducer": "Transducer", "bat": "BAT"}[name]
    return dict(conf(name), model=model, tokenizer_conf={"token_list": TOKENS},
                frontend_conf=dict(n_mels=80, lfr_m=1, lfr_n=1), init_param=init_param)


def automodel_pair(tmp_path, name, with_vad, blank_shift=0.0):
    """The JAX and the port's AutoModel of one family on the same weights
    (the blank bias moved by ``blank_shift`` more), with FSMN-VAD and
    CT-Transformer when ``with_vad``."""
    variables = jax.tree_util.tree_map(np.array, family(name)[1])
    variables["params"]["joint_network"]["lin_out"]["bias"][0] += blank_shift
    jkw, kw = {}, {}
    if with_vad:
        vad, punc = vad_params(0), punc_params(0)
        jkw = dict(vad_model=dict(VAD_CFG, init_param=_save_flax(tmp_path / "j_vad.npz",
                                                                 vad["params"])),
                   punc_model=dict(PUNC_CFG, init_param=_save_flax(tmp_path / "j_punc.npz",
                                                                   punc["params"])))
        kw = dict(vad_model=dict(VAD_CFG, init_param=_save(tmp_path / "vad.npz",
                                                           C.fsmn_vad_from_jax(vad))),
                  punc_model=dict(PUNC_CFG, init_param=_save(tmp_path / "punc.npz",
                                                             C.ct_transformer_from_jax(punc))))
    jam = JaxAutoModel(model=_cfg(name, _save_variables(tmp_path / "j_asr.npz", variables)), **jkw)
    am = AutoModel(model=_cfg(name, _save(tmp_path / "asr.npz", FAMILIES[name][3](variables))),
                   device="cpu", **kw)
    return jam, am


@pytest.mark.parametrize("name,with_vad", [("transducer", False), ("bat", False),
                                           ("transducer", True)],
                         ids=["transducer", "bat", "transducer_vad_punc"])
def test_automodel_matches_jax(tmp_path, name, with_vad):
    # BAT on fbank frames (100 a second, no subsampling) stays blank at its
    # test shift: the AutoModel case takes the initial blank bias back
    jam, am = automodel_pair(tmp_path, name, with_vad,
                             blank_shift=-BLANK_SHIFT[name] if name == "bat" else 0.0)
    assert isinstance(am.engine, TE.TransducerEngine) and am.engine.max_tokens == 128
    assert type(am.engine.module) is FAMILIES[name][1]
    inputs = long_recording() if with_vad else wavs()[:2]
    keys = ["a"] if with_vad else ["a", "b"]
    want = jam.generate(inputs, key=keys)
    got = am.generate(inputs, key=keys)
    assert got == want and all(r["text"] for r in got)
    if with_vad:
        assert got[0]["timestamp"] == [] and "sentence_info" in got[0]


def test_automodel_names_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="CTC"):
        AutoModel(model=dict(model="CTC", tokenizer_conf={"token_list": TOKENS}), device="cpu")
    with pytest.raises(NotImplementedError, match="Transducer, BAT, RWKVBAT, Emotion2vec"):
        AutoModel(model=dict(model="NoSuchModel", tokenizer_conf={"token_list": TOKENS}),
                  device="cpu")
