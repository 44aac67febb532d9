"""The port's CT-Transformer punctuation (``funasr_torch/models/ct_transformer``,
``PuncEngine``) against the JAX package on the CPU.

A tiny model (vocab 64, D = 64 with 2 heads, so the attention's head size
is 32 as in the published 256 / 8; 2 blocks), initialised in JAX and
carried over by ``convert.ct_transformer_from_jax``.

- ``split_words`` and ``split_to_mini_sentence``: equal.
- Logits over the valid tokens: float32 atol 1e-5 (sums in another order);
  bf16 (the serving dtype) within 4 bf16 ulps of the largest logit (the
  packages round the same bf16 operations but sum them in another order, and
  a rounding that lands apart moves a bf16 activation by one ulp).
- ``inference`` and ``inference_batch``, float32: texts and ``punc_array``
  equal, through windows with the carried cache, the forced break at the
  last comma (a low ``cache_pop_trigger_limit``), ascii words, empty texts.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from funasr_tpu.auto import engines as JE
from funasr_tpu.models.ct_transformer import model as JM
from funasr_tpu.tokenizer.char_tokenizer import CharTokenizer as JaxTokenizer
from funasr_torch.auto import engines as TE
from funasr_torch.convert import ct_transformer_from_jax
from funasr_torch.models.ct_transformer import model as TM
from funasr_torch.tokenizer.char_tokenizer import CharTokenizer
from tests.test_torch_vad import built_once
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

WORDS = ["hello", "world", "ok", "go"]
TOKENS = ["<blank>", "<s>", "</s>", "<unk>"] + WORDS + [chr(0x4E00 + i) for i in range(56)]
CONF = dict(vocab_size=len(TOKENS), embed_unit=64, att_unit=64,
            encoder_conf=dict(output_size=64, attention_heads=2, linear_units=96,
                              num_blocks=2, kernel_size=11))
F32_ATOL = 1e-5
BF16_ULPS = 4


def jax_params(jm, seed=0):
    """Random params of a JAX ``CTTransformerModel`` (its ``init_params``,
    jitted)."""
    return built_once(("jax_params", repr(jm.module), seed),
                      lambda: _jax_params_uncached(jm, seed))


def _jax_params_uncached(jm, seed=0):
    t, n = jnp.zeros((1, 8), jnp.int32), jnp.array([8])
    p = jax.jit(lambda key: jm.module.init(key, t, n))(jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, p)


def init_models(dtype="float32", seed=0, conf=CONF):
    jm = JM.CTTransformerModel(**conf, dtype=dtype)
    p = jm.params = jax_params(jm, seed)
    tm = TM.CTTransformerModel(**conf, dtype=dtype, device="cpu")
    tm.module.load_state_dict(ct_transformer_from_jax(p), strict=True)
    return jm, tm


def texts(seed, n, lengths):
    """Texts of CJK chars with an ascii word now and then."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        parts = []
        for _ in range(int(lengths[i % len(lengths)])):
            if rng.random() < 0.1:
                parts.append(" " + WORDS[int(rng.integers(len(WORDS)))] + " ")
            else:
                parts.append(chr(0x4E00 + int(rng.integers(56))))
        out.append("".join(parts).strip())
    return out


@pytest.fixture(scope="module")
def models():
    return init_models()


def test_split_helpers_match_jax():
    cases = ["hello 世界，ok go。", "a,b 北京欢迎你", "", "  ", "x" * 30, "测试 测试　end",
             "数字123和abc混合"] + texts(1, 4, (45,))
    for text in cases:
        assert TM.split_words(text) == JM.split_words(text), text
    words = list(range(47))
    for limit in (1, 20, 47, 50):
        assert TM.split_to_mini_sentence(words, limit) == JM.split_to_mini_sentence(words, limit)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_match_jax(dtype):
    jm, tm = init_models(dtype, seed=1)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, len(TOKENS), (3, 40))
    lens = np.array([40, 23, 1])
    want = np.asarray(jax.jit(jm.module.apply)(jm.params, jnp.asarray(ids),
                                               jnp.asarray(lens))).astype(np.float32)
    with torch.no_grad():
        got = tm.module(torch.from_numpy(ids), torch.from_numpy(lens)).float().numpy()
    valid = np.arange(40)[None] < lens[:, None]
    atol = F32_ATOL if dtype == "float32" else BF16_ULPS * 2.0 ** -8 * np.abs(want[valid]).max()
    np.testing.assert_allclose(got[valid], want[valid], rtol=0, atol=atol)


def _tokenizers():
    return JaxTokenizer(TOKENS), CharTokenizer(TOKENS)


@pytest.mark.parametrize("limit", [200, 12])
def test_inference_batch_matches_jax(models, limit):
    jm, tm = models
    jt, tt = _tokenizers()
    batch = texts(3, 5, (65, 7, 130, 0, 41))
    want = jm.inference_batch(batch, jt, cache_pop_trigger_limit=limit)
    got = tm.inference_batch(batch, tt, cache_pop_trigger_limit=limit)
    assert len(got) == len(batch)
    for g, w in zip(got, want):
        assert g["text"] == w["text"]
        np.testing.assert_array_equal(g["punc_array"], w["punc_array"])
    assert got[3]["text"] == "" and len(got[3]["punc_array"]) == 0
    assert any(len(g["punc_array"]) > 100 for g in got)
    # one text at a time: the same as its row of the batch
    for text, g in zip(batch[:2], got):
        one = tm.inference(text, tt, cache_pop_trigger_limit=limit)
        assert one["text"] == g["text"] == jm.inference(text, jt, cache_pop_trigger_limit=limit)["text"]


def test_window_rounds_are_batched(models):
    """``inference_batch`` makes one device call per window round, padded to
    a (power of two, multiple of 8) grid."""
    _, tm = models
    _, tt = _tokenizers()
    calls = []
    real = tm._argmax
    tm._argmax = lambda t, n: (calls.append(t.shape), real(t, n))[1]
    try:
        tm.inference_batch(texts(4, 3, (65, 30, 10)), tt)
    finally:
        del tm._argmax
    assert len(calls) == 4  # 65 words: 4 windows of 20
    assert calls[0][0] == 4 and all(w % 8 == 0 for _, w in calls)


def test_punc_engine_matches_jax(models):
    jm, tm = models
    jt, tt = _tokenizers()
    text = texts(5, 1, (77,))[0]
    assert TE.PuncEngine(tm, tt).punctuate(text)["text"] == \
        JE.PuncEngine(jm, jt).punctuate(text)["text"]
