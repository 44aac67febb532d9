"""The port's emotion2vec (``models/emotion2vec``) and the ALiBi route of the
attention wrapper (``ops/attention.py``) against the JAX package on the CPU,
float32, inputs from numpy seeds.

A tiny emotion2vec with the served head size (dim 128, 2 heads: d = 64;
1 prenet block, 2 main blocks, MLP 256, 3 labels; the 512-channel feature
extractor is fixed) is initialised in JAX once a module (``model``), its
extra tokens moved off zero and its ALiBi scales set to (0.7, -0.3) (the
second head's bias clamps to 0), and loaded into the port through
``convert.emotion2vec_from_jax``.  Bars:

- the twin's ALiBi term against ``symmetric_alibi`` padded for the extra
  tokens, times the scale, within 1 float32 ulp of its largest value (the
  product rounds in another order); with zero slopes the twin gives the
  plain attention's bits; AltAttention with a key mask within 1e-5;
- the wrapper refuses ALiBi in bf16, at d != 64 and on other devices;
- the feature extractor, the module's logits, pooled embedding and frames
  within 1e-5, frame lengths equal;
- ``Emotion2vec.generate`` (with and without ``feats``) and ``AutoModel``
  (without a VAD, and behind FSMN-VAD and CT-Transformer) against the JAX
  ``Emotion2vec`` / ``AutoModel``: labels and texts equal, scores and feats
  within 1e-5;
- the state dict converts back to the JAX tree through
  ``funasr_tpu.convert.emotion2vec_from_torch``.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from funasr_tpu.auto.auto_model import AutoModel as JaxAutoModel
from funasr_tpu.convert import emotion2vec_from_torch
from funasr_tpu.models.emotion2vec import model as JE
from funasr_torch import convert as C
from funasr_torch.auto import engines as TE
from funasr_torch.auto.auto_model import AutoModel
from funasr_torch.models.emotion2vec import model as TEM
from funasr_torch.ops import attention as A
from tests.test_torch_pipeline import (PUNC_CFG, VAD_CFG, _save, _save_flax, long_recording,
                                       punc_params, vad_params)
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

LABELS = ["angry", "happy", "neutral"]
TINY = dict(dim=128, depth=2, prenet_depth=1, n_head=2, ffn=256)
SCALES = (0.7, -0.3)
TOL = 1e-5


@functools.lru_cache(maxsize=None)
def model():
    """(JAX Emotion2vec with its params as numpy, the port's on the CPU)."""
    jm = JE.Emotion2vec(labels=LABELS, **TINY)
    n = 3200
    params = jax.jit(lambda k: jm.module.init(k, jnp.zeros((1, n)), jnp.array([n], jnp.int32)))(
        jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.array, params)
    rng = np.random.default_rng(3)
    p = params["params"]
    p["extra_tokens"] = (0.5 * rng.standard_normal(p["extra_tokens"].shape)).astype(np.float32)
    p["alibi_scale"] = np.asarray(SCALES, np.float32).reshape(1, 1, 2, 1, 1)
    jm.params = params
    tm = TEM.Emotion2vec(labels=LABELS, **TINY, device="cpu")
    tm.load_state_dict(C.emotion2vec_from_jax(params), strict=True)
    return jm, tm


def audio(lengths=(16000, 7000, 11111), seed=4):
    rng = np.random.default_rng(seed)
    return [(0.1 * np.sin(2 * np.pi * (180 + 90 * i) * np.arange(n) / 16000.0)
             + 0.05 * rng.standard_normal(n)).astype(np.float32) for i, n in enumerate(lengths)]


def batch(wavs):
    pad = 3200 * ((max(map(len, wavs)) + 3199) // 3200)
    x = np.zeros((len(wavs), pad), np.float32)
    for i, w in enumerate(wavs):
        x[i, : len(w)] = JE.normalize_wav(w)
    return x, np.array([len(w) for w in wavs], np.int32)


# ---------------------------------------------------------------- ALiBi
@pytest.mark.parametrize("extra", [0, 10])
def test_alibi_bias_matches_symmetric_alibi(extra):
    T, H = 23, 12
    scale = np.linspace(-0.5, 2.0, H).astype(np.float32)
    slopes = torch.from_numpy(TEM.alibi_slopes(H).astype(np.float32)) * torch.from_numpy(
        scale).clamp(min=0)
    want = (JE.symmetric_alibi(T, H).astype(np.float32)
            * np.maximum(scale, 0)[:, None, None])
    want = np.pad(want, ((0, 0), (extra, 0), (extra, 0)))
    got = A.alibi_bias(slopes, T + extra, T + extra, extra).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=np.spacing(np.abs(want).max()))
    assert (got[:, :extra] == 0).all() and (got[:, :, :extra] == 0).all()
    np.testing.assert_array_equal(TEM.alibi_slopes(H), JE.alibi_slopes(H))


def _qkv(seed, B=2, T=17, H=2, d=64):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, T, H * d)).astype(np.float32))
               for _ in range(3))
    lens = torch.tensor([T, T - 6])
    return q, k, v, torch.where(torch.arange(T)[None] < lens[:, None], 0.0, -1e30)


def test_alibi_zero_slopes_give_the_plain_attention():
    q, k, v, kb = _qkv(1)
    plain = A.fused_attention(q, k, v, kb, 2)
    zero = A.fused_attention(q, k, v, kb, 2, alibi_slopes=torch.zeros(2), extra=3)
    some = A.fused_attention(q, k, v, kb, 2, alibi_slopes=torch.tensor([0.5, 0.0]), extra=3)
    assert torch.equal(zero, plain) and not torch.equal(some, plain)
    assert A.fused_attention.launches_alibi == 0  # the twin on CPU tensors


@pytest.mark.parametrize("case", ["bf16", "d32", "slopes_shape", "extra"])
def test_alibi_wrapper_refuses(case):
    q, k, v, kb = _qkv(2)
    slopes, H, extra = torch.ones(2), 2, 0
    if case == "bf16":
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    elif case == "d32":
        H, slopes = 4, torch.ones(4)
    elif case == "slopes_shape":
        slopes = torch.ones(3)
    else:
        extra = -1
    with pytest.raises(ValueError):
        A.fused_attention(q, k, v, kb, H, alibi_slopes=slopes, extra=extra)


def test_alibi_wrapper_refuses_other_devices():
    m = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="unsupported device"):
        A.fused_attention(m(2, 5, 128), m(2, 5, 128), m(2, 5, 128), m(2, 5), 2,
                          alibi_slopes=m(2), extra=1)


def test_alt_attention_matches_jax():
    jm, tm = model()
    node = jax.tree_util.tree_map(lambda a: a[0], jm.params["params"]["blocks"]["block"])
    rng = np.random.default_rng(5)
    B, T, ex = 2, 21, 4
    x = rng.standard_normal((B, T, 128)).astype(np.float32)
    lens = np.array([T, T - 7])
    mask = np.arange(T)[None] < lens[:, None]
    alibi = np.pad(JE.symmetric_alibi(T - ex, 2).astype(np.float32)
                   * np.maximum(np.asarray(SCALES, np.float32), 0)[:, None, None],
                   ((0, 0), (ex, 0), (ex, 0)))[None]
    want = jax.jit(JE.AltAttention(128, 2).apply)(
        {"params": node["attn"]}, jnp.asarray(x), jnp.asarray(alibi), jnp.asarray(mask))
    slopes = tm.slopes * tm.modality_encoders["AUDIO"].alibi_scale.reshape(-1).clamp(min=0)
    kb = torch.where(torch.from_numpy(mask), 0.0, -1e30)
    with torch.no_grad():
        got = tm.blocks[0].attn(torch.from_numpy(x), kb, slopes, ex)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


# ---------------------------------------------------------------- model
def test_feature_extractor_and_frame_lengths_match_jax():
    jm, tm = model()
    x, lens = batch(audio())
    le = jm.params["params"]["local_encoder"]
    want = jax.jit(JE.ConvFeatureExtractor().apply)({"params": le}, jnp.asarray(x))
    with torch.no_grad():
        got = tm.modality_encoders["AUDIO"].local_encoder(torch.from_numpy(x))
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want), atol=TOL, rtol=0)
    n = torch.tensor([400, 3199, 16000, 240000, 7000])
    assert tm.frame_lengths(n).tolist() == [JE.conv_out_length(int(v)) for v in n]


def test_module_matches_jax():
    jm, tm = model()
    x, lens = batch(audio())
    want = jax.jit(lambda p, a, b: jm.module.apply(p, a, b, return_frames=True))(
        jm.params, jnp.asarray(x), jnp.asarray(lens))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(lens), return_frames=True)
    wl, wp, wx, wf = (np.asarray(a) for a in want)
    gl, gp, gx, gf = (a.numpy() for a in got)
    np.testing.assert_array_equal(gf, wf)
    np.testing.assert_allclose(gl, wl, atol=TOL, rtol=0)
    np.testing.assert_allclose(gp, wp, atol=TOL, rtol=0)
    for b, n in enumerate(wf):  # the valid frames (pad frames see no mask)
        np.testing.assert_allclose(gx[b, :n], wx[b, :n], atol=TOL, rtol=0)


@pytest.mark.parametrize("extract_embedding", [False, True])
def test_generate_matches_jax(extract_embedding):
    jm, tm = model()
    wavs = audio((9000, 16000), seed=6)
    want = jm.generate(wavs, extract_embedding=extract_embedding)
    got = tm.generate(wavs, extract_embedding=extract_embedding)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["labels"] == w["labels"] == LABELS
        assert set(g) == set(w) == ({"labels", "scores", "feats"} if extract_embedding
                                    else {"labels", "scores"})
        np.testing.assert_allclose(g["scores"], w["scores"], atol=TOL, rtol=0)
        assert np.argmax(g["scores"]) == np.argmax(w["scores"])
        if extract_embedding:
            np.testing.assert_allclose(g["feats"], w["feats"], atol=TOL, rtol=0)


def test_state_dict_converts_back_to_the_jax_tree():
    jm, tm = model()
    back = emotion2vec_from_torch({k: v.numpy() for k, v in tm.state_dict().items()})
    want = jax.tree_util.tree_leaves_with_path(jm.params["params"])
    got = dict(jax.tree_util.tree_leaves_with_path(back["params"]))
    assert len(want) >= 20 and len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf, err_msg=str(path))


def test_random_weights_keep_every_head_biased():
    tm = TEM.Emotion2vec(labels=LABELS, **TINY, device="cpu")
    tm.init_weights_(torch.Generator().manual_seed(0))
    enc = tm.modality_encoders["AUDIO"]
    assert torch.equal(enc.alibi_scale, torch.ones(1, 1, 2, 1, 1))
    assert enc.extra_tokens.abs().sum() > 0 and len(enc.context_encoder.blocks) == 1
    assert tm.slopes.tolist() == TEM.alibi_slopes(2).astype(np.float32).tolist()


# ------------------------------------------------------------- AutoModel
def automodel_pair(tmp_path, with_vad):
    jm, _ = model()
    cfg = dict(model="Emotion2vec", model_conf=dict(labels=LABELS, **TINY))
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
    jam = JaxAutoModel(model=dict(cfg, init_param=_save_flax(tmp_path / "j_e2v.npz",
                                                             jm.params["params"])), **jkw)
    am = AutoModel(model=dict(cfg, init_param=_save(tmp_path / "e2v.npz",
                                                    C.emotion2vec_from_jax(jm.params))),
                   device="cpu", **kw)
    return jam, am


@pytest.mark.parametrize("with_vad", [False, True], ids=["plain", "vad_punc"])
def test_automodel_matches_jax(tmp_path, with_vad):
    jam, am = automodel_pair(tmp_path, with_vad)
    assert isinstance(am.engine, TE.SerEngine)
    inputs = long_recording() if with_vad else audio()
    keys = ["a"] if with_vad else ["a", "b", "c"]
    want = jam.generate(inputs, key=keys)
    got = am.generate(inputs, key=keys)
    assert [set(r) for r in got] == [set(r) for r in want]
    for g, w in zip(got, want):
        assert g["key"] == w["key"] and g["text"] == w["text"] and g["text"]
        if with_vad:
            assert g == w and g["timestamp"] == []
        else:
            assert g["labels"] == w["labels"]
            np.testing.assert_allclose(g["scores"], w["scores"], atol=TOL, rtol=0)
