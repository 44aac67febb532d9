"""E-Paraformer of the port (``funasr_torch/models/e_paraformer``: the PIF
predictor, the SANM encoder and ``ParaformerSANDecoder``) against the JAX
package on the CPU.

A tiny E-Paraformer with the aishell recipe's head size (D = 128, 2 heads:
d = 64; 2 encoder and 2 decoder layers, vocabulary 32) is initialised in
JAX (jitted, once for the module), its PIF ``sigma`` and ``bias`` moved
off their constant init, and loaded into the port through
``convert.e_paraformer_from_jax``; inputs from numpy seeds.

- ``PifPredictor`` alone, at (l, r) = (1, 1) and (2, 1), with an empty
  utterance: embeddings, ``token_num`` and alphas within 1e-5.
- The model, float32: tokens and token lengths equal, log-probs within
  1e-4 (the float32 Paraformer bar).
- int8 (``quantize=True``, bf16 activations) against the JAX package's
  int8 module path (``quant.quantized(True)``): token lengths equal,
  log-probs within 0.15, greedy tokens agree on >= 0.99 of the positions
  where JAX's top-2 margin exceeds 0.3 and on >= 0.9 of all, the bars of
  ``tests/test_torch_paraformer_int8.py``.  The port runs its fused int8
  SANM layer (head size 64), the JAX package its XLA path there (its
  Pallas layer gates on head sizes of 128), as ``test_torch_sensevoice.py``
  holds SenseVoice.
- The state dict converts back to the JAX tree (``funasr_tpu.convert``'s
  SANM encoder and Transformer decoder trees).
- ``ParaformerEngine.transcribe`` with and without timestamps: records
  equal to the JAX engine's.  The PIF predictor has no fire track, so the
  stamps come from an empty one in both packages (pinned).
- ``AutoModel`` from ``examples/aishell/e_paraformer``'s YAML (widths
  overridden), without and with FSMN-VAD and CT-Transformer: records equal
  to the JAX ``AutoModel``'s.
"""

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from funasr_tpu.auto import engines as JE
from funasr_tpu.auto.auto_model import AutoModel as JaxAutoModel
from funasr_tpu.convert import _encoder_tree, _std_transformer_decoder_tree
from funasr_tpu.models.e_paraformer.model import EParaformer as JaxEParaformer
from funasr_tpu.models.e_paraformer.predictor import PifPredictor as JaxPif
from funasr_tpu.ops import quant as JQ
from funasr_tpu.tokenizer.char_tokenizer import CharTokenizer as JaxCharTokenizer
from funasr_torch import convert as C
from funasr_torch.auto import engines as TE
from funasr_torch.auto.auto_model import AutoModel
from funasr_torch.config import deep_update, load_config
from funasr_torch.models.e_paraformer.model import EParaformer
from funasr_torch.models.e_paraformer.predictor import PifPredictor
from funasr_torch.models.paraformer.decoder import ParaformerSANDecoder
from funasr_torch.tokenizer.char_tokenizer import CharTokenizer
from tests.test_torch_bicif import TOKENS
from tests.test_torch_pipeline import (PUNC_CFG, VAD_CFG, _save, _save_flax, _save_variables,
                                       punc_params, vad_params)
from tests.test_torch_vad import built_once
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "examples/aishell/e_paraformer/conf/"
                    "e_paraformer_conformer_12e_6d_2048_256.yaml")
V, IN, D, NH = len(TOKENS), 560, 128, 2
ENC = dict(output_size=D, attention_heads=NH, linear_units=128, num_blocks=2,
           kernel_size=11, dropout_rate=0.0)
DEC = dict(attention_heads=NH, linear_units=128, num_blocks=2, dropout_rate=0.0)
CONF = dict(vocab_size=V, input_size=IN, encoder_conf=ENC, decoder_conf=DEC,
            predictor_conf=dict(idim=D, sigma_heads=4))
F32_ATOL = 1e-4  # the float32 Paraformer bar
PIF_ATOL = 1e-5
# int8: tests/test_torch_paraformer_int8.py's bars
INT8_LOGP_ATOL = 0.15
INT8_MIN_AGREE = 0.99  # where the JAX top-2 margin exceeds 2 * INT8_LOGP_ATOL
INT8_MIN_AGREE_ALL = 0.9
MAX_TOKENS = 16


def move_pif(pred, seed=3):
    """A PIF parameter tree's sigma and bias off their constant init (0.5
    and 0), one value a head, so each head's Gaussian differs."""
    rng = np.random.default_rng(seed)
    H = pred["sigma"].shape[0]
    pred["sigma"] = (0.3 + 0.5 * rng.random(H)).astype(np.float32)
    pred["bias"] = (0.2 * rng.standard_normal(H)).astype(np.float32)
    return pred


def jax_init(jm, seed=0, T=32):
    """A jitted greedy-decode init of a JAX Paraformer-family module -> its
    variables as numpy (writable)."""
    return built_once(("jax_init", repr(jm), seed, T),
                      lambda: _jax_init_uncached(jm, seed, T))


def _jax_init_uncached(jm, seed=0, T=32):
    """A jitted greedy-decode init of a JAX Paraformer-family module -> its
    variables as numpy (writable)."""
    p = jax.jit(lambda key: jm.init({"params": key}, jnp.zeros((1, T, IN)), jnp.array([T]),
                                    max_tokens=8, method=jm.greedy_decode))(
        jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.array, p)


@functools.lru_cache(maxsize=None)
def jax_model():
    jm = JaxEParaformer(**CONF, decoder_name="ParaformerSANDecoder")
    variables = jax_init(jm)
    move_pif(variables["params"]["predictor"])
    return jm, variables


def port_model(variables, **kw):
    tm = EParaformer(**CONF, decoder_name="ParaformerSANDecoder", device="cpu", **kw)
    tm.load_state_dict(C.e_paraformer_from_jax(variables), strict=True)
    return tm.quantize_weights() if kw.get("quantize") else tm


def speech(seed=5, B=3, T=48):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, IN)).astype(np.float32)
    return x, np.array([T, T - 11, T - 30][:B], np.int32)


def compare_logits(jm, variables, tm, dtype="float32", max_tokens=MAX_TOKENS, seed=5):
    """(JAX log-probs, token lengths), (the port's) on ``speech(seed)``."""
    x, lens = speech(seed)
    run = jax.jit(functools.partial(jm.apply, method=jm.inference_logits,
                                    max_tokens=max_tokens))
    want_lp, want_tl, _ = run(variables, jnp.asarray(x), jnp.asarray(lens))
    with torch.no_grad():
        got_lp, got_tl, _ = tm.inference_logits(torch.from_numpy(x), torch.from_numpy(lens),
                                                max_tokens=max_tokens)
    return ((np.asarray(want_lp), np.asarray(want_tl)),
            (got_lp.float().numpy(), got_tl.numpy()))


def assert_float32_logits(want, got):
    (wlp, wtl), (glp, gtl) = want, got
    np.testing.assert_array_equal(gtl, wtl)
    assert wtl.min() >= 1
    for b, n in enumerate(wtl):
        np.testing.assert_allclose(glp[b, :n], wlp[b, :n], atol=F32_ATOL, rtol=0)
        np.testing.assert_array_equal(glp[b, :n].argmax(-1), wlp[b, :n].argmax(-1))


def assert_int8_logits(want, got):
    (wlp, wtl), (glp, gtl) = want, got
    np.testing.assert_array_equal(gtl, wtl)
    rows = np.concatenate([np.arange(n) + b * wlp.shape[1] for b, n in enumerate(wtl)])
    w, g = wlp.reshape(-1, V)[rows], glp.reshape(-1, V)[rows]
    np.testing.assert_allclose(g, w, atol=INT8_LOGP_ATOL, rtol=0)
    top2 = np.sort(w, -1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > 2 * INT8_LOGP_ATOL
    agree = g.argmax(-1) == w.argmax(-1)
    assert sure.sum() >= 8 and agree[sure].mean() >= INT8_MIN_AGREE
    assert agree.mean() >= INT8_MIN_AGREE_ALL


# ------------------------------------------------------------ PIF predictor
@pytest.mark.parametrize("l_order,r_order", [(1, 1), (2, 1)])
def test_pif_predictor_matches_jax(l_order, r_order):
    conf = dict(idim=16, l_order=l_order, r_order=r_order, sigma_heads=4)
    rng = np.random.default_rng(l_order)
    h = rng.standard_normal((3, 20, 16)).astype(np.float32)
    lens = np.array([20, 13, 0], np.int32)
    jp = JaxPif(**conf, dropout=0.0)
    init = jax.jit(functools.partial(jp.init, max_tokens=10))
    p = jax.tree_util.tree_map(np.array, init(jax.random.PRNGKey(0), jnp.asarray(h),
                                              jnp.asarray(lens)))
    p["params"]["cif_output"]["bias"] += 1.0  # alphas near 0.7: tokens to count
    move_pif(p["params"])
    want = jp.apply(p, jnp.asarray(h), jnp.asarray(lens), max_tokens=10)
    tp = PifPredictor(**conf)
    sd = {}
    C._predictor(sd, "p", p["params"])
    tp.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = tp(torch.from_numpy(h), torch.from_numpy(lens), 10)
    for name in ("acoustic_embeds", "token_num", "alphas"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=PIF_ATOL, rtol=0, err_msg=name)
    tn = np.asarray(want.token_num)
    assert tn[0] >= 3 and tn[2] == 0 and not got.peaks.any() and not got.fires.any()
    emb = got.acoustic_embeds.numpy()
    for b, n in enumerate(np.round(tn).astype(int)):
        assert np.abs(emb[b, n:]).max(initial=0) == 0  # zero past ceil(round(token_num))
        assert n == 0 or np.abs(emb[b, :n]).max() > 0


# ------------------------------------------------------------ the model
def test_float32_matches_jax():
    jm, variables = jax_model()
    tm = port_model(variables)
    assert type(tm.decoder) is ParaformerSANDecoder and tm.encoder.encoders[0].n_head == NH
    assert_float32_logits(*compare_logits(jm, variables, tm))


def test_int8_matches_jax_module_path():
    jm, variables = jax_model()
    jmb = JaxEParaformer(**CONF, decoder_name="ParaformerSANDecoder", dtype=jnp.bfloat16)
    tm = port_model(variables, dtype=torch.bfloat16, quantize=True)
    with JQ.quantized(True):
        want, got = compare_logits(jmb, variables, tm)
    assert_int8_logits(want, got)


def test_state_dict_converts_back_to_jax_trees():
    _, variables = jax_model()
    tm = port_model(variables)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    tree = variables["params"]
    for got, want in ((_encoder_tree(sd, "encoder"), tree["encoder"]),
                      (_std_transformer_decoder_tree(sd, "decoder"), tree["decoder"])):
        got = dict(jax.tree_util.tree_leaves_with_path(got))
        leaves = jax.tree_util.tree_leaves_with_path(want)
        assert len(leaves) >= 10
        for path, leaf in leaves:
            np.testing.assert_array_equal(np.asarray(got[path]), leaf, err_msg=str(path))
    assert not sd["ctc.ctc_lo.weight"].any()  # the inference tree has no CTC head
    assert sd["predictor.cif_conv1d.weight"].shape == (D, 1, 3)


def wavs(lengths=(24000, 9000, 15500), seed=11):
    rng = np.random.default_rng(seed)
    return [(0.1 * np.sin(2 * np.pi * (200 + 150 * i) * np.arange(n) / 16000.0)
             + 0.05 * rng.standard_normal(n)).astype(np.float32)
            for i, n in enumerate(lengths)]


@pytest.mark.parametrize("with_timestamp", [False, True])
def test_engine_records_match_jax(with_timestamp):
    jm, variables = jax_model()
    je = JE.ParaformerEngine(jm, variables, JE.FrontendConfig(),
                             JaxCharTokenizer(token_list=TOKENS))
    te = TE.ParaformerEngine(port_model(variables), TE.FrontendConfig(),
                             CharTokenizer(token_list=TOKENS), device="cpu")
    offsets = [0, 700, 3000]
    want = je.transcribe(wavs(), with_timestamp=with_timestamp, vad_offsets=offsets)
    got = te.transcribe(wavs(), with_timestamp=with_timestamp, vad_offsets=offsets)
    assert got == want and any(r["text"] for r in got)
    assert all(("timestamp" in r) == with_timestamp for r in got)


# ------------------------------------------------------------ AutoModel
def recipe(path, override, init_param, tokens=TOKENS):
    """A recipe YAML as a config dict, widths overridden, weights from
    ``init_param``, the test vocabulary."""
    cfg = load_config(path)
    deep_update(cfg, override)
    return dict(cfg, vocab_size=len(tokens), tokenizer_conf={"token_list": tokens},
                init_param=init_param)


def automodel_pair(tmp_path, path, override, variables, convert, with_vad, tokens=TOKENS):
    """The JAX and the port's AutoModel of one recipe on the same weights,
    with FSMN-VAD and CT-Transformer when ``with_vad``."""
    jfile = (_save_variables if "batch_stats" in variables else
             lambda f, v: _save_flax(f, v["params"]))(tmp_path / "j_asr.npz", variables)
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
    jam = JaxAutoModel(model=recipe(path, override, jfile, tokens), **jkw)
    am = AutoModel(model=recipe(path, override, _save(tmp_path / "asr.npz", convert(variables)),
                                tokens), device="cpu", **kw)
    return jam, am


@pytest.mark.parametrize("with_vad", [False, True], ids=["plain", "vad_punc"])
def test_automodel_from_recipe_matches_jax(tmp_path, with_vad):
    from tests.test_torch_pipeline import long_recording

    _, variables = jax_model()
    override = dict(encoder_conf=dict(ENC, num_blocks=2), decoder_conf=DEC,
                    predictor_conf=dict(idim=D, sigma_heads=4))
    jam, am = automodel_pair(tmp_path, YAML, override, variables, C.e_paraformer_from_jax,
                             with_vad)
    assert isinstance(am.engine, TE.ParaformerEngine)
    assert type(am.engine.module) is EParaformer
    assert type(am.engine.module.decoder) is ParaformerSANDecoder
    inputs = long_recording() if with_vad else wavs()[:2]
    keys = ["a"] if with_vad else ["a", "b"]
    want = jam.generate(inputs, key=keys)
    got = am.generate(inputs, key=keys)
    assert got == want and all(r["text"] for r in got)
    if with_vad:
        assert got[0]["sentence_info"] and "timestamp" in got[0]


def test_registry_names_of_the_slice():
    """The names the aishell YAMLs use resolve in the port's registry to the
    port's classes, as in the JAX package's."""
    from funasr_tpu.registry import tables as jax_tables
    from funasr_torch.models.conformer import ConformerEncoder
    from funasr_torch.models.transformer.model import SANM
    from funasr_torch.registry import tables

    for table, name, cls in (("model_classes", "EParaformer", EParaformer),
                             ("model_classes", "SANM", SANM),
                             ("predictor_classes", "PifPredictor", PifPredictor),
                             ("decoder_classes", "ParaformerSANDecoder", ParaformerSANDecoder),
                             ("encoder_classes", "ConformerEncoder", ConformerEncoder)):
        assert tables.get(table, name) is cls and jax_tables.get(table, name)
