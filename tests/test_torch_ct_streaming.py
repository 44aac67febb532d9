"""The port's streaming CT-Transformer punctuation
(``models/ct_transformer/streaming.py``: ``vad_mask``,
``CTTransformerStreamingModel``, the ``AutoModel`` route) against the JAX
package on the CPU.

The tiny model of ``tests/test_torch_punc.py`` (vocab 64, D = 64 with 2
heads, 2 blocks), initialised in JAX once for the module and carried over by
``convert.ct_transformer_from_jax``.  Random weights label a window with a
few classes only, so each sequence's weights move the decoder's class
biases (``BIASES``): "mixed" spreads the labels over every class, "commas"
puts no sentence end anywhere (the 200-word force-break at the last comma).
Bars:

- ``vad_mask``: equal, at ``vad_pos`` 0, 1, inside, n and past n;
- logits under the mask over the valid tokens: float32 within ``F32_ATOL``,
  bf16 within ``BF16_ULPS`` bf16 ulps of the largest logit (the bars of
  ``tests/test_torch_punc.py``); without a mask the attention still goes
  through the kernel wrapper, with one it does not;
- ``punctuate_streaming`` call sequences, float32: every call's text,
  ``punc_array`` and cache equal, through carried tails, empty inputs, the
  final flush and the force-break;
- ``AutoModel(model=CTTransformerStreaming)``: ``generate(text)`` records
  equal (the offline ``inference``, as in JAX); the engine's model serves
  ``punctuate_streaming`` with its tokenizer attached, where the JAX
  ``_build_punc`` attaches none and raises ``RuntimeError``.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from funasr_tpu.auto.auto_model import AutoModel as JaxAutoModel
from funasr_tpu.models.ct_transformer import streaming as JS
from funasr_tpu.tokenizer.char_tokenizer import CharTokenizer as JaxTokenizer
from funasr_torch.auto.auto_model import AutoModel
from funasr_torch.convert import ct_transformer_from_jax
from funasr_torch.models.ct_transformer import streaming as TS
from funasr_torch.ops import attention as A
from funasr_torch.tokenizer.char_tokenizer import CharTokenizer
from tests.test_torch_pipeline import _save, _save_flax
from tests.test_torch_punc import BF16_ULPS, CONF, F32_ATOL, TOKENS, jax_params, texts
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

# decoder class biases ("<unk>", "_", "，", "。", "？", "、") a sequence's weights add
BIASES = {"mixed": (-9.0, 0.0, 0.8, 0.6, 0.2, 0.1), "commas": (-9.0, 0.0, 1.2, -9.0, -9.0, 0.0)}


@functools.lru_cache(maxsize=None)
def models(bias="mixed", dtype="float32"):
    """(JAX streaming model, the port's) on the same weights, tokenizers
    attached."""
    jm = JS.CTTransformerStreamingModel(**CONF, dtype=dtype)
    p = jax_params(jm, 0)
    p["params"]["decoder"]["bias"] = p["params"]["decoder"]["bias"] + np.asarray(
        BIASES[bias], np.float32)
    jm.params = p
    jm.set_tokenizer(JaxTokenizer(token_list=TOKENS))
    tm = TS.CTTransformerStreamingModel(**CONF, dtype=dtype, device="cpu")
    tm.module.load_state_dict(ct_transformer_from_jax(p), strict=True)
    tm.set_tokenizer(CharTokenizer(token_list=TOKENS))
    return jm, tm


@pytest.mark.parametrize("n,vad_pos", [(9, 0), (9, 1), (9, 2), (9, 5), (9, 9), (9, 12),
                                       (1, 1)])
def test_vad_mask_matches_jax(n, vad_pos):
    want = JS.vad_mask(n, vad_pos)
    got = TS.vad_mask(n, vad_pos)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if 1 < vad_pos < n:
        assert got[: vad_pos - 1, vad_pos:].sum() == 0 and got.sum() < n * n


def _masked_inputs(seed, n, vad_pos):
    ids = np.random.default_rng(seed).integers(4, len(TOKENS), n).astype(np.int64)
    pad = max(8, 8 * ((n + 7) // 8))
    text = np.zeros((1, pad), np.int64)
    text[0, :n] = ids
    am = np.ones((1, pad, pad), np.float32)
    am[0, :n, :n] = TS.vad_mask(n, vad_pos)
    return text, np.array([n], np.int32), am


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_logits_match_jax(dtype, monkeypatch):
    jm, tm = models("mixed", dtype)
    text, lens, am = _masked_inputs(3, 21, 9)
    want = jax.jit(lambda p, t, l, m: jm.module.apply(p, t, l, attn_mask=m))(
        jm.params, jnp.asarray(text, jnp.int32), jnp.asarray(lens), jnp.asarray(am))
    want = np.asarray(want, np.float32)[0, :21]
    calls = []
    real = A.fused_attention
    monkeypatch.setattr(A, "fused_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.inference_mode():
        got = tm.module(torch.from_numpy(text), torch.from_numpy(lens),
                        torch.from_numpy(am)).float().numpy()[0, :21]
        assert calls == []  # the mask takes the module path
        unmasked = tm.module(torch.from_numpy(text), torch.from_numpy(lens)).float()
        assert len(calls) == 2  # without it, the kernel wrapper a layer
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(got, want, atol=BF16_ULPS * ulp, rtol=0)
    # the mask is live: the unmasked logits differ
    assert float((unmasked[0, :21] - torch.from_numpy(got)).abs().max()) > 1e-3


def _calls(name):
    """A call sequence: [(text, is_final), ...]."""
    if name == "mixed":
        lens = (5, 17, 25, 9, 22, 13)
        out = [(t, False) for t in texts(11, len(lens), lens)]
        return out + [("", False), ("", True)]
    if name == "empty_flush":
        words = texts(12, 1, (7,))[0]
        return [("", False), ("", True), (words, False), ("", True), ("", True)]
    if name == "final_with_words":
        return [(t, False) for t in texts(13, 3, (14, 23, 8))] + [(texts(14, 1, (31,))[0], True)]
    if name == "force_break":
        return [(t, False) for t in texts(15, 22, (20,))] + [("", True)]
    raise KeyError(name)


@pytest.mark.parametrize("seq,bias", [("mixed", "mixed"), ("empty_flush", "mixed"),
                                      ("final_with_words", "mixed"),
                                      ("force_break", "commas")])
def test_punctuate_streaming_matches_jax(seq, bias):
    jm, tm = models(bias)
    jcache, cache = {}, {}
    early = []  # the words committed before the final call
    for i, (text, final) in enumerate(_calls(seq)):
        want = jm.punctuate_streaming(text, jcache, is_final=final)
        got = tm.punctuate_streaming(text, cache, is_final=final)
        assert got["text"] == want["text"], (i, text)
        np.testing.assert_array_equal(got["punc_array"], want["punc_array"])
        assert got["punc_array"].dtype == np.int64
        assert cache == {k: list(v) for k, v in jcache.items()}
        if not final and len(got["punc_array"]):
            early.append(got)
    assert cache.get("words", []) == []  # the final flush empties the cache
    if seq in ("mixed", "force_break"):
        assert len(early) >= 2  # sentences committed along the way
    if seq == "force_break":  # no 。/？ predicted: each commit is a forced comma break
        assert all(r["text"][-1] in "。." and r["punc_array"][-1] == 3 for r in early)
        assert max(len(r["punc_array"]) for r in early) > 150


# ------------------------------------------------------------- AutoModel
def _cfg(init_param):
    return dict(model="CTTransformerStreaming", tokenizer_conf={"token_list": TOKENS},
                init_param=init_param, **CONF)


@pytest.fixture(scope="module")
def punc_pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ct_streaming")
    jm, _ = models("mixed")
    jam = JaxAutoModel(model=_cfg(_save_flax(tmp / "j_punc.npz", jm.params["params"])))
    am = AutoModel(model=_cfg(_save(tmp / "punc.npz", ct_transformer_from_jax(jm.params))),
                   device="cpu")
    return jam, am


def test_automodel_generate_matches_jax(punc_pair):
    jam, am = punc_pair
    assert type(am.engine.model) is TS.CTTransformerStreamingModel
    inputs = texts(21, 3, (12, 47, 5))
    want = jam.generate(inputs, key=["a", "b", "c"])
    got = am.generate(inputs, key=["a", "b", "c"])
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.pop("punc_array"), w.pop("punc_array"))
    assert got == want and all(r["text"] for r in got)


def test_streaming_demo_is_a_guarded_jax_fault(punc_pair):
    """The route's demo calls ``am.engine.model.punctuate_streaming``: the
    JAX AutoModel never attaches the tokenizer and raises; the port's
    serves it, as the model with its tokenizer does."""
    jam, am = punc_pair
    text = texts(22, 1, (30,))[0]
    with pytest.raises(RuntimeError, match="set_tokenizer"):
        jam.engine.model.punctuate_streaming(text, {})
    got = am.engine.model.punctuate_streaming(text, {}, is_final=True)
    want = models("mixed")[0].punctuate_streaming(text, {}, is_final=True)
    assert got["text"] == want["text"] and got["text"]
    np.testing.assert_array_equal(got["punc_array"], want["punc_array"])
