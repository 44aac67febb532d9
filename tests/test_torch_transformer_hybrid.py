"""The port's CTC/attention hybrid families against the JAX package on the
CPU: Transformer, Branchformer and E-Branchformer (Transformer decoder) and
the Conformer with the RWKV decoder (the aishell conformer_rwkv recipe).

Each family is a tiny hybrid (V = 32, D = 16, 2 heads, 2 blocks, conv
kernels 7) initialised in JAX (``family``, shared with
``tests/test_torch_branchformer.py`` and ``tests/test_torch_rwkv_decoder.py``)
and carried into the port by ``convert.hybrid_from_jax``; inputs come from
numpy with a seed, padded rows included (the Branchformer convolutions see
the pad frames, so both packages get the same padded batch).  Bars:

- encoders, per family and input layer (the Branchformers' in
  ``tests/test_torch_branchformer.py``): float32 within 1e-5 (measured up
  to 1.5e-6); bf16 within 0.0625, 4 bf16 ulps at the outputs' |x| < 4
  (measured up to 0.031: the packages round bf16 intermediates of the
  float32 sums in different places); output lengths equal;
- cached ``decode_beam`` (the Transformer decoder): tokens and lengths
  equal, scores within 1e-4 (``tests/test_torch_beam.py``'s float32 bar);
- the decoder's state dict through ``funasr_tpu.convert``'s
  ``_std_transformer_decoder_tree`` gives back the JAX tree exactly;
- int8 (``quantize=True``) against the JAX package run on its fused int8
  path (``quant.quantized(True)``, ``pltpu.force_tpu_interpret_mode()``,
  ``ffn_pallas.enabled`` forced on, a spy on ``_ffn_call_int8``): the
  position-wise FFN bit-equal where the JAX package takes its Pallas FFN
  (rows a multiple of 128); at other row counts the JAX package takes two
  QDense (``w_1`` int8 from 1024 rows, ``w_2`` in bf16) and the port stays
  on its fused int8 FFN: pinned, outputs within 0.0625 (measured 0.039),
  with at least half of them differing;
- ``AutoModel`` from each of the four aishell recipes with a tiny override,
  ``quantize=True`` on the CPU; what is not ported raises
  ``NotImplementedError`` naming itself.
"""

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from funasr_tpu.convert import _std_transformer_decoder_tree
from funasr_tpu.models import branchformer as JBF
from funasr_tpu.models.sanm import PositionwiseFeedForward as JaxFFN
from funasr_tpu.models.transformer import model as JTM
from funasr_tpu.ops import ffn_pallas as JFP
from funasr_tpu.ops import quant as JQ
from funasr_torch import convert as C
from funasr_torch.auto import engines as TE
from funasr_torch.auto.auto_model import AutoModel
from funasr_torch.models import branchformer as TBF
from funasr_torch.models.sanm import PositionwiseFeedForward
from funasr_torch.models.transformer import decoder as TD
from funasr_torch.models.transformer import model as TTM
from funasr_torch.registry import tables
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

V, IN = 32, 20
ENC = dict(output_size=16, attention_heads=2, linear_units=32, num_blocks=2, dropout_rate=0.0)
BRANCH_ENC = dict(ENC, cgmlp_linear_units=32, cgmlp_conv_kernel=7)
DEC = dict(attention_heads=2, linear_units=32, num_blocks=2, dropout_rate=0.0)
# family: (JAX class, port class, encoder_conf, decoder)
FAMILIES = {
    "transformer": (JTM.Transformer, TTM.Transformer, ENC, "TransformerDecoder"),
    "branchformer": (JBF.Branchformer, TBF.Branchformer, BRANCH_ENC, "TransformerDecoder"),
    "ebranchformer": (JBF.EBranchformer, TBF.EBranchformer, BRANCH_ENC, "TransformerDecoder"),
    "conformer_rwkv": (JTM.Conformer, TTM.Conformer, dict(ENC, cnn_module_kernel=7),
                       "TransformerRWKVDecoder"),
}
F32_TOL = 1e-5
BF16_TOL = 0.0625
SCORE_TOL = 1e-4
FFN_PINNED_TOL = 0.0625


def family_conf(name, input_layer="conv2d"):
    _, _, enc, dec = FAMILIES[name]
    return dict(vocab_size=V, input_size=IN, encoder_conf=dict(enc, input_layer=input_layer),
                decoder_conf=DEC, ctc_weight=0.3, decoder=dec)


@functools.lru_cache(maxsize=None)
def family(name, input_layer):
    """(JAX model, its float32 variables as numpy, the port's float32 model
    on the CPU with those weights); BatchNorm statistics of a Conformer
    moved away from (0, 1).  The linear input layer's variables are the
    conv2d model's with the embedding replaced by seeded numpy weights (one
    jitted init a family)."""
    from tests.test_torch_conformer import perturb_batch_stats

    jax_cls, port_cls, _, _ = FAMILIES[name]
    conf = family_conf(name, input_layer)
    jm = jax_cls(**conf)
    if input_layer == "linear":
        variables = jax.tree_util.tree_map(np.array, family(name, "conv2d")[1])
        rng = np.random.default_rng(17)
        D = conf["encoder_conf"]["output_size"]
        enc = variables["params"]["encoder"]
        enc["embed"] = dict(kernel=(rng.standard_normal((IN, D)) / np.sqrt(IN)).astype(
            np.float32), bias=(0.1 * rng.standard_normal(D)).astype(np.float32))
        if name == "transformer":  # its linear embed ends in a layer norm
            enc["embed_norm"] = dict(
                scale=(1 + 0.1 * rng.standard_normal(D)).astype(np.float32),
                bias=(0.1 * rng.standard_normal(D)).astype(np.float32))
    else:
        B, T, U = 2, 40, 5
        variables = jax.jit(lambda k: jm.init(
            {"params": k, "dropout": k}, jnp.zeros((B, T, IN)), jnp.array([T, T - 8]),
            jnp.zeros((B, U), jnp.int32), jnp.array([U, U - 1]), deterministic=True)
        )(jax.random.PRNGKey(0))
        variables = jax.tree_util.tree_map(np.array, variables)
        if "batch_stats" in variables:
            variables = perturb_batch_stats(variables)
    tm = port_cls(**conf, device="cpu")
    tm.load_state_dict(C.hybrid_from_jax(variables), strict=True)
    return jm, variables, tm


@functools.lru_cache(maxsize=None)
def jax_encode(name, input_layer, dtype="float32"):
    """The family's JAX encoder in ``dtype``, jitted once a process:
    (variables, x, lens) -> (out, lens)."""
    jm = family(name, input_layer)[0]
    if dtype == "bfloat16":
        jm = FAMILIES[name][0](**family_conf(name, input_layer), dtype=jnp.bfloat16)
    return jax.jit(lambda v, a, b: jm.apply(v, a, b, method=jm.encode))


def speech(seed=5, B=3, T=44):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, IN)).astype(np.float32)
    return x, np.array([T, T - 9, T - 21][:B], np.int32)


def jax_beam(jm, variables, x, lens, method="decode_beam", **kw):
    run = jax.jit(functools.partial(jm.apply, method=getattr(jm, method), **kw))
    return [np.asarray(a) for a in run(variables, jnp.asarray(x), jnp.asarray(lens))]


def assert_same_beam(got, want):
    np.testing.assert_array_equal(got.tokens.numpy(), want[0])
    np.testing.assert_array_equal(got.lengths.numpy(), want[1])
    np.testing.assert_allclose(got.scores.numpy(), want[2], atol=SCORE_TOL, rtol=0)


def check_encoder(name, input_layer, dtype):
    """The family's encoder against JAX on ``speech()``'s padded batch."""
    _, variables, tm = family(name, input_layer)
    x, lens = speech()
    if dtype == "bfloat16":
        tm = FAMILIES[name][1](**family_conf(name, input_layer), device="cpu",
                               dtype=torch.bfloat16)
        tm.load_state_dict(C.hybrid_from_jax(variables), strict=True)
    want, want_lens = jax_encode(name, input_layer, dtype)(
        variables, jnp.asarray(x), jnp.asarray(lens))
    with torch.no_grad():
        got, got_lens = tm.encode(torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    assert got.shape[1] == (10 if input_layer == "conv2d" else 44)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=F32_TOL if dtype == "float32" else BF16_TOL, rtol=0)


def check_cached_beam(name):
    """The family's cached ``decode_beam`` against JAX's."""
    jm, variables, tm = family(name, "conv2d")
    x, lens = speech()
    kw = dict(beam=4, maxlen=8, decoding_ctc_weight=0.3)
    want = jax_beam(jm, variables, x, lens, **kw)
    got = tm.decode_beam(torch.from_numpy(x), torch.from_numpy(lens), **kw)
    assert_same_beam(got, want)
    assert 1 <= got.steps <= 8 and want[1].max() >= 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("input_layer", ["conv2d", "linear"])
def test_encoder_matches_jax(input_layer, dtype):
    check_encoder("transformer", input_layer, dtype)


def test_cached_decode_beam_matches_jax():
    check_cached_beam("transformer")


def test_decoder_state_dict_round_trips_through_jax_converter():
    _, variables, tm = family("transformer", "conv2d")
    sd = {k: v.numpy() for k, v in tm.state_dict().items() if k.startswith("decoder.")}
    back = _std_transformer_decoder_tree(sd, "decoder")
    want = jax.tree_util.tree_leaves_with_path(variables["params"]["decoder"])
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf, err_msg=str(path))


# ---- int8: the position-wise FFN of the Transformer encoder and the RWKV decoder

FFN_K, FFN_H = 128, 256  # the JAX Pallas FFN needs K, H and N multiples of 128


@pytest.fixture(scope="module")
def ffn_pair():
    jf = JaxFFN(FFN_H, FFN_K, dtype=jnp.bfloat16)
    p = jax.tree_util.tree_map(np.asarray, jf.init(jax.random.PRNGKey(1),
                                                   jnp.zeros((128, FFN_K), jnp.bfloat16)))
    tf = PositionwiseFeedForward(FFN_K, FFN_H, dtype=torch.bfloat16, param_dtype=torch.float32)
    sd = {}
    C._ffn(sd, "ffn", p["params"])
    tf.load_state_dict({k[len("ffn."):]: v for k, v in sd.items()}, strict=True)
    tf.quantize_weights()
    return jf, p, tf


def _fused_jax(monkeypatch):
    calls = []
    monkeypatch.setattr(JFP, "enabled", lambda: True)
    monkeypatch.setattr(JFP, "_ffn_call_int8",
                        lambda *a, f=JFP._ffn_call_int8, **k: calls.append(1) or f(*a, **k))
    return calls


@pytest.mark.parametrize("M", [128, 384, 74, 1040])
def test_int8_ffn_against_jax(monkeypatch, ffn_pair, M):
    """Bit-equal to the JAX Pallas FFN where the JAX package takes it (M a
    multiple of 128); elsewhere the pinned difference to its QDense path."""
    jf, p, tf = ffn_pair
    calls = _fused_jax(monkeypatch)
    x = jnp.asarray(np.random.default_rng(M).standard_normal((M, FFN_K)), jnp.bfloat16)
    with JQ.quantized(True), pltpu.force_tpu_interpret_mode():
        want = np.asarray(jf.apply(p, x).astype(jnp.float32))
    with torch.no_grad():
        got = tf(torch.tensor(np.asarray(x.astype(jnp.float32)), dtype=torch.bfloat16))
    got = got.float().numpy()
    if M % 128 == 0:
        assert len(calls) == 1
        np.testing.assert_array_equal(got, want)
    else:
        assert not calls
        np.testing.assert_allclose(got, want, atol=FFN_PINNED_TOL, rtol=0)
        assert (got != want).mean() >= 0.5  # two different functions


# ---- AutoModel from the aishell recipes, and what is not ported

RECIPES = {
    "transformer": ("examples/aishell/transformer/conf/transformer_12e_6d_2048_256.yaml",
                    TTM.Transformer, "TransformerEncoder", TD.TransformerDecoder,
                    dict(linear_units=32)),
    "branchformer": ("examples/aishell/branchformer/conf/branchformer_12e_6d_2048_256.yaml",
                     TBF.Branchformer, "BranchformerEncoder", TD.TransformerDecoder,
                     dict(cgmlp_linear_units=32, cgmlp_conv_kernel=7)),
    "ebranchformer": ("examples/aishell/e_branchformer/conf/"
                      "e_branchformer_12e_6d_2048_256.yaml", TBF.EBranchformer,
                      "EBranchformerEncoder", TD.TransformerDecoder,
                      dict(cgmlp_linear_units=32, cgmlp_conv_kernel=7, linear_units=32)),
    "conformer_rwkv": ("examples/aishell/conformer/conf/conformer_rwkv.yaml", TTM.Conformer,
                       "ConformerEncoder", TD.TransformerRWKVDecoder,
                       dict(linear_units=32, cnn_module_kernel=5)),
}
TOKENS = ["<blank>", "<s>", "</s>"] + [chr(0x4E00 + i) for i in range(16)] + ["<unk>"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_override(name):
    return dict(vocab_size=len(TOKENS), tokenizer_conf={"token_list": TOKENS},
                encoder_conf=dict(output_size=16, attention_heads=2, num_blocks=1,
                                  **RECIPES[name][4]),
                decoder_conf=dict(attention_heads=2, linear_units=32, num_blocks=1),
                decoding_conf=dict(beam_size=3, maxlenratio_tokens=6))


@pytest.mark.parametrize("name", list(RECIPES))
def test_automodel_from_aishell_recipe(name):
    path, cls, enc_name, dec_cls, _ = RECIPES[name]
    am = AutoModel(model=os.path.join(REPO, path), model_conf=tiny_override(name),
                   quantize=True, seed=3, device="cpu")
    eng = am.engine
    assert isinstance(eng, TE.HybridEngine) and type(eng.module) is cls
    assert (eng.beam, eng.maxlen, eng.decoding_ctc_weight) == (3, 6, 0.3)
    assert type(eng.module.encoder) is tables.get("encoder_classes", enc_name)
    assert type(eng.module.decoder) is dec_cls
    assert eng.module.quantize and eng.module.dtype == torch.bfloat16
    rng = np.random.default_rng(4)
    wavs = [(0.1 * np.sin(2 * np.pi * 220 * np.arange(n) / 16000)
             + 0.05 * rng.standard_normal(n)).astype(np.float32) for n in (7000, 11000)]
    res = am.generate(wavs, key=["a", "b"])
    assert [r["key"] for r in res] == ["a", "b"]
    assert all(isinstance(r["text"], str) for r in res)
    top = eng.transcribe(wavs, nbest=3, with_timestamp=True)
    for r in top:
        scores = [h["score"] for h in r["nbest"]]
        assert np.isfinite(scores).all() and scores == sorted(scores, reverse=True)
        assert len(r["timestamp"]) == len(r["raw_tokens"])


def test_recipe_behind_vad_and_punctuation():
    """The E-Branchformer recipe as the main model behind FSMN-VAD and
    CT-Transformer (tiny, seeded weights): records with CTC-alignment
    timestamps inside the recording, as the Conformer hybrid's
    (``tests/test_torch_hybrid_align.py`` holds those to the JAX package)."""
    from tests.test_torch_pipeline import PUNC_CFG, VAD_CFG
    from tests.test_torch_vad import recording

    path = os.path.join(REPO, RECIPES["ebranchformer"][0])
    punc = dict(PUNC_CFG, vocab_size=len(TOKENS), tokenizer_conf={"token_list": TOKENS})
    am = AutoModel(model=path, model_conf=tiny_override("ebranchformer"), vad_model=VAD_CFG,
                   punc_model=punc, quantize=True, seed=5, device="cpu")
    wav = recording(0)
    res = am.generate(wav, key=["e"])[0]
    assert res["key"] == "e" and res["text"] and res["sentence_info"]
    ts = res["timestamp"]
    assert ts and all(0 <= b <= e <= len(wav) // 16 for b, e in ts)


@pytest.mark.parametrize("what", [
    "model CTC",
    "LightweightConvolutionTransformerDecoder", "LightweightConvolution2DTransformerDecoder",
    "DynamicConvolutionTransformerDecoder", "DynamicConvolution2DTransformerDecoder"])
def test_not_ported_raises_naming_itself(what):
    conf = dict(tiny_override("transformer"), model="Transformer",
                frontend_conf=dict(n_mels=80, lfr_m=1, lfr_n=1))
    if what.startswith("model "):
        conf["model"], name = what.split()[1], what.split()[1]
    else:
        conf["decoder"], name = what, what
    with pytest.raises(NotImplementedError, match=name):
        AutoModel(model=conf, device="cpu")
    if what.startswith("model "):
        with pytest.raises(NotImplementedError, match=name):
            tables.get("model_classes", name)(vocab_size=V)


@pytest.mark.parametrize("name", list(RECIPES))
def test_families_raise_without_cuda(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = family_conf(name, "conv2d")
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no GPU"):
            FAMILIES[name][1](**conf, device=device)
    with pytest.raises(RuntimeError, match="no GPU"):
        AutoModel(model=os.path.join(REPO, RECIPES[name][0]), model_conf=tiny_override(name),
                  quantize=True)

