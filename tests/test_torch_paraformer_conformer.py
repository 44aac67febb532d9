"""The aishell Paraformer-Conformer of the port (``Paraformer`` with
``encoder_name="ConformerEncoder"`` and its ``linear`` input layer,
``decoder_name="ParaformerSANDecoder"``, the CIF predictor) and the SAN
decoder alone, against the JAX package on the CPU.

A tiny model with the recipe's head size (D = 128, 2 heads: d = 64; 2
encoder and 2 decoder layers, vocabulary 32), initialised in JAX (jitted,
once), its BatchNorm statistics moved off (0, 1), carried into the port by
``convert.paraformer_from_jax``; inputs from numpy seeds.

- ``ParaformerSANDecoder`` alone, float32, ragged token and memory lengths:
  the valid rows within 1e-5.  Its self-attention is masked by the token
  lengths only (bidirectional), its cross-attention by the memory lengths;
  the port runs both through the fused attention kernel's function.  A row
  with no valid token is not part of the contract (the kernel gives
  uniform weights, the JAX package zeros).
- The model, float32: tokens and token lengths equal, log-probs within
  1e-4; the encoder config's ``kernel_size`` and ``pos_enc_layer_type``
  are dropped as the JAX package drops them (the Conformer's own
  ``cnn_module_kernel``, 15, is taken).
- int8 (``quantize=True``): the bars of ``tests/test_torch_e_paraformer.py``.
- The decoder's state dict converts back to the JAX tree
  (``funasr_tpu.convert._std_transformer_decoder_tree``).
- ``AutoModel`` from ``examples/aishell/paraformer``'s YAML (widths
  overridden), without and with FSMN-VAD and CT-Transformer: records
  (texts, 60 ms CIF stamps, ``sentence_info``) equal to the JAX
  ``AutoModel``'s.
"""

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from funasr_tpu.convert import _std_transformer_decoder_tree
from funasr_tpu.models.paraformer.decoder import ParaformerSANDecoder as JaxSANDecoder
from funasr_tpu.models.paraformer.model import Paraformer as JaxParaformer
from funasr_tpu.ops import quant as JQ
from funasr_torch import convert as C
from funasr_torch.auto import engines as TE
from funasr_torch.models.conformer import ConformerEncoder
from funasr_torch.models.paraformer.decoder import ParaformerSANDecoder
from funasr_torch.models.paraformer.model import Paraformer
from tests.test_torch_bicif import TOKENS
from tests.test_torch_conformer import perturb_batch_stats
from tests.test_torch_e_paraformer import (REPO, assert_float32_logits, assert_int8_logits,
                                           automodel_pair, compare_logits, jax_init, wavs)
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

YAML = os.path.join(REPO, "examples/aishell/paraformer/conf/"
                    "paraformer_conformer_12e_6d_2048_256.yaml")
V, IN, D, NH = len(TOKENS), 560, 128, 2
ENC = dict(output_size=D, attention_heads=NH, linear_units=128, num_blocks=2,
           dropout_rate=0.0, attention_dropout_rate=0.0, input_layer="linear",
           pos_enc_layer_type="rel_pos", kernel_size=15)
DEC = dict(attention_heads=NH, linear_units=128, num_blocks=2, dropout_rate=0.0)
PRED = dict(idim=D, threshold=1.0, l_order=1, r_order=1, tail_threshold=0.45)
CONF = dict(vocab_size=V, input_size=IN, encoder_conf=ENC, decoder_conf=DEC,
            predictor_conf=PRED)
NAMES = dict(encoder_name="ConformerEncoder", decoder_name="ParaformerSANDecoder")
SAN_ATOL = 1e-5


@functools.lru_cache(maxsize=None)
def jax_model():
    jm = JaxParaformer(**CONF, **NAMES)
    variables = jax_init(jm)
    variables["params"]["predictor"]["cif_output"]["bias"] += 0.5  # tokens to decode
    return jm, perturb_batch_stats(variables)


def port_model(variables, **kw):
    tm = Paraformer(**CONF, **NAMES, device="cpu", **kw)
    tm.load_state_dict(C.paraformer_from_jax(variables), strict=True)
    return tm.quantize_weights() if kw.get("quantize") else tm


# ------------------------------------------------------------ the SAN decoder
def test_san_decoder_matches_jax():
    jd = JaxSANDecoder(vocab_size=V, encoder_output_size=D, **DEC)
    rng = np.random.default_rng(2)
    B, U, T = 3, 12, 30
    mem = rng.standard_normal((B, T, D)).astype(np.float32)
    emb = rng.standard_normal((B, U, D)).astype(np.float32)
    ml, tl = np.array([30, 17, 9], np.int32), np.array([12, 5, 1], np.int32)
    args = tuple(jnp.asarray(a) for a in (mem, ml, emb, tl))
    p = jax.tree_util.tree_map(np.array, jax.jit(lambda k: jd.init(k, *args))(
        jax.random.PRNGKey(4)))
    want = np.asarray(jax.jit(jd.apply)(p, *args))
    td = ParaformerSANDecoder(vocab_size=V, encoder_output_size=D, **DEC)
    sd = {}
    C._decoder(sd, "d", p["params"], V)
    td.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = td(*(torch.from_numpy(a) for a in (mem, ml, emb, tl))).numpy()
    for b, n in enumerate(tl):
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=SAN_ATOL, rtol=0)
    # bidirectional: the first token sees the later ones
    emb2 = emb.copy()
    emb2[0, -1] += rng.standard_normal(D).astype(np.float32)  # not a constant: LN takes it out
    with torch.no_grad():
        got2 = td(*(torch.from_numpy(a) for a in (mem, ml, emb2, tl))).numpy()
    assert np.abs(got2[0, 0] - got[0, 0]).max() > 1e-4


# ------------------------------------------------------------ the model
def test_float32_matches_jax():
    jm, variables = jax_model()
    tm = port_model(variables)
    assert type(tm.encoder) is ConformerEncoder and tm.encoder.input_layer == "linear"
    assert tm.encoder.encoders[0].conv_module.depthwise_conv.kernel_size == (15,)
    assert type(tm.decoder) is ParaformerSANDecoder and not hasattr(tm, "ctc")
    assert_float32_logits(*compare_logits(jm, variables, tm))


def test_int8_matches_jax_module_path():
    jm, variables = jax_model()
    jmb = JaxParaformer(**CONF, **NAMES, dtype=jnp.bfloat16)
    tm = port_model(variables, dtype=torch.bfloat16, quantize=True)
    with JQ.quantized(True):
        want, got = compare_logits(jmb, variables, tm)
    assert_int8_logits(want, got)


def test_decoder_state_dict_converts_back_to_the_jax_tree():
    _, variables = jax_model()
    sd = {k: v.numpy() for k, v in port_model(variables).state_dict().items()}
    back = dict(jax.tree_util.tree_leaves_with_path(_std_transformer_decoder_tree(sd, "decoder")))
    want = jax.tree_util.tree_leaves_with_path(variables["params"]["decoder"])
    assert len(want) >= 10
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(back[path]), leaf, err_msg=str(path))
    assert sd["encoder.embed.0.weight"].shape == (D, IN)


@pytest.mark.parametrize("with_vad", [False, True], ids=["plain", "vad_punc"])
def test_automodel_from_recipe_matches_jax(tmp_path, with_vad):
    from tests.test_torch_pipeline import long_recording

    _, variables = jax_model()
    override = dict(encoder_conf=ENC, decoder_conf=DEC, predictor_conf=PRED)
    jam, am = automodel_pair(tmp_path, YAML, override, variables, C.paraformer_from_jax,
                             with_vad)
    assert isinstance(am.engine, TE.ParaformerEngine)
    assert type(am.engine.module.encoder) is ConformerEncoder
    inputs = long_recording() if with_vad else wavs()[:2]
    keys = ["a"] if with_vad else ["a", "b"]
    want = jam.generate(inputs, key=keys)
    got = am.generate(inputs, key=keys)
    assert got == want and all(r["text"] for r in got)
    if with_vad:
        assert got[0]["sentence_info"] and got[0]["timestamp"]
