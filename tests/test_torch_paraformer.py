"""Port Paraformer modules against the JAX package, float32 on the CPU.

A tiny Paraformer (V=32, D=32, 2 heads, 3 encoder + 2+1+1 decoder layers)
is initialised in JAX from a fixed key; its params go through
``funasr_torch.convert.paraformer_from_jax`` into the port.  Inputs come
from numpy with a seed.  Tolerances (float32, summation order differs):
encoder output and acoustic embeddings atol 1e-4, log-probs atol 1e-4,
alphas atol 1e-6 and the fire track (a fraction of the
prefix sum, up to ~20) atol 1e-5; CIF ``peaks``, token counts and greedy tokens exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from funasr_tpu.models.paraformer.model import Paraformer as JaxParaformer
from funasr_torch.convert import paraformer_from_jax
from funasr_torch.models.paraformer.model import Paraformer
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

V, IN, D = 32, 24, 32
ENC = dict(output_size=D, attention_heads=2, linear_units=48, num_blocks=3,
           kernel_size=5)
DEC = dict(attention_heads=2, linear_units=48, num_blocks=4, att_layer_num=2,
           kernel_size=5)
PRED = dict(idim=D, threshold=1.0, l_order=1, r_order=1, tail_threshold=0.45)
MAX_TOKENS = 16


@pytest.fixture(scope="module")
def models():
    jm = JaxParaformer(vocab_size=V, input_size=IN, encoder_conf=ENC,
                       decoder_conf=DEC, predictor_conf=PRED)
    x = jnp.zeros((1, 16, IN))
    params = jax.jit(lambda key: jm.init(
        {"params": key}, x, jnp.array([16]), max_tokens=8,
        method=jm.greedy_decode))(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, params)
    tm = Paraformer(vocab_size=V, input_size=IN, encoder_conf=ENC,
                    decoder_conf=DEC, predictor_conf=PRED, device="cpu")
    tm.load_state_dict(paraformer_from_jax(params), strict=True)
    return jm, params, tm


@pytest.fixture(scope="module")
def speech():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 40, IN)).astype(np.float32)
    return x, np.array([40, 31, 17], np.int32)


@pytest.fixture(scope="module")
def jax_outputs(models, speech):
    jm, params, _ = models
    x, lens = speech

    def run(p, x, lens):
        enc, enc_lens = jm.apply(p, x, lens, method=jm.encode)
        log_probs, tok_lens, pred = jm.apply(
            p, x, lens, max_tokens=MAX_TOKENS, method=jm.inference_logits)
        greedy = jm.apply(p, x, lens, max_tokens=MAX_TOKENS,
                          method=jm.greedy_decode)
        return enc, log_probs, tok_lens, pred, greedy

    out = jax.jit(run)(params, jnp.asarray(x), jnp.asarray(lens))
    return jax.tree_util.tree_map(np.asarray, out)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_encoder_parity(models, speech, jax_outputs):
    _, _, tm = models
    x, lens = speech
    with torch.no_grad():
        enc, enc_lens = tm.encode(_t(x), _t(lens))
    np.testing.assert_array_equal(enc_lens.numpy(), lens)
    for i, n in enumerate(lens):  # padding frames are not part of the contract
        np.testing.assert_allclose(enc.numpy()[i, :n], jax_outputs[0][i, :n],
                                   atol=1e-4, rtol=1e-4)


def test_predictor_parity_peaks_exact(models, speech, jax_outputs):
    _, _, tm = models
    x, lens = speech
    want = jax_outputs[3]
    with torch.no_grad():
        enc = tm.encode(_t(x), _t(lens))[0]
        pred = tm.predictor(_t(jax_outputs[0]), _t(lens), MAX_TOKENS)
    np.testing.assert_array_equal(pred.peaks.numpy(), want.peaks)
    np.testing.assert_array_equal(pred.token_num.numpy(), want.token_num)
    np.testing.assert_allclose(pred.alphas.numpy(), want.alphas, atol=1e-6)
    np.testing.assert_allclose(pred.fires.numpy(), want.fires, atol=1e-5)
    np.testing.assert_allclose(pred.acoustic_embeds.numpy(),
                               want.acoustic_embeds, atol=1e-4, rtol=1e-4)
    # and from the port's own encoder output
    with torch.no_grad():
        own = tm.predictor(enc, _t(lens), MAX_TOKENS)
    np.testing.assert_array_equal(own.peaks.numpy(), want.peaks)


def test_decoder_parity(models, speech, jax_outputs):
    jm, params, tm = models
    x, lens = speech
    enc, _, tok_lens, pred, _ = jax_outputs
    want = jax.jit(lambda p: jm.apply(
        p, jnp.asarray(enc), jnp.asarray(lens),
        jnp.asarray(pred.acoustic_embeds), jnp.asarray(tok_lens),
        method=lambda m, *a: m.decoder(*a)))(params)
    with torch.no_grad():
        got = tm.decoder(_t(enc), _t(lens), _t(pred.acoustic_embeds),
                         _t(tok_lens))
    for i, n in enumerate(tok_lens):
        np.testing.assert_allclose(got.numpy()[i, :n], np.asarray(want)[i, :n],
                                   atol=1e-4, rtol=1e-4)


def test_inference_logits_and_greedy_decode(models, speech, jax_outputs):
    _, _, tm = models
    x, lens = speech
    _, log_probs, tok_lens, _, (tokens, g_lens, scores) = jax_outputs
    lp, tl, _ = tm.inference_logits(_t(x), _t(lens), max_tokens=MAX_TOKENS)
    np.testing.assert_array_equal(tl.numpy(), tok_lens)
    for i, n in enumerate(tok_lens):
        np.testing.assert_allclose(lp.numpy()[i, :n], log_probs[i, :n],
                                   atol=1e-4)
    got_tokens, got_lens, got_scores = tm.greedy_decode(
        _t(x), _t(lens), max_tokens=MAX_TOKENS)
    np.testing.assert_array_equal(got_tokens.numpy(), tokens)
    np.testing.assert_array_equal(got_lens.numpy(), g_lens)
    np.testing.assert_allclose(got_scores.numpy(), scores, atol=1e-3)


def test_state_dict_round_trip(models):
    """paraformer_from_torch(port.state_dict()) gives back the JAX tree;
    the decoder embedding, absent from the inference tree, comes back as
    the zeros the conversion filled in."""
    from funasr_tpu.convert import paraformer_from_torch

    _, params, tm = models
    back = paraformer_from_torch(
        {k: v.numpy() for k, v in tm.state_dict().items()})

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}/"))
            else:
                out[prefix + k] = np.asarray(v)
        return out

    got, want = flat(back["params"]), flat(params["params"])
    embed = got.pop("decoder/embed/embedding")
    np.testing.assert_array_equal(embed, np.zeros((V, D), np.float32))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("T", [1, 2, 7, 64, 257])
def test_compensated_cumsum_bit_exact(T):
    from funasr_tpu.ops.cif import compensated_cumsum as jax_cumsum
    from funasr_torch.ops.cif import compensated_cumsum

    a = np.random.default_rng(T).uniform(0, 1, (3, T)).astype(np.float32)
    ws, wc = jax.jit(jax_cumsum)(jnp.asarray(a))
    gs, gc = compensated_cumsum(torch.from_numpy(a))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


def test_cif_and_tail_match_jax():
    from funasr_tpu.ops import cif as JC
    from funasr_torch.ops import cif as TC

    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((2, 30, 8)).astype(np.float32)
    alphas = rng.uniform(0, 1, (2, 30)).astype(np.float32)
    alphas[1, 21:] = 0.0
    lens = np.array([30, 21], np.int32)
    wh, wa, wn = JC.cif_tail(jnp.asarray(hidden), jnp.asarray(alphas),
                             jnp.asarray(lens), 0.45)
    gh, ga, gn = TC.cif_tail(_t(hidden), _t(alphas), _t(lens), 0.45)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
    want = jax.jit(JC.cif, static_argnums=2)(wh, wa, 24)
    got = TC.cif(gh, ga, 24)
    np.testing.assert_array_equal(got.peaks.numpy(), np.asarray(want.peaks))
    np.testing.assert_array_equal(got.fires.numpy(), np.asarray(want.fires))
    np.testing.assert_array_equal(got.token_num.numpy(),
                                  np.asarray(want.token_num))
    np.testing.assert_allclose(got.embeds.numpy(), np.asarray(want.embeds),
                               atol=1e-5)


@pytest.mark.parametrize("shift", [0, 2])
def test_fsmn_memory_matches_jax(shift):
    from funasr_tpu.models.sanm import fsmn_memory as jax_fsmn
    from funasr_torch.models.sanm import fsmn_memory, fsmn_padding

    rng = np.random.default_rng(5)
    v = rng.standard_normal((2, 12, 6)).astype(np.float32)
    w = rng.standard_normal((5, 1, 6)).astype(np.float32)  # (K, 1, D)
    mask = (np.arange(12)[None, :, None] < np.array([12, 7])[:, None, None])
    mask = mask.astype(np.float32)
    left, right = fsmn_padding(5, shift)
    assert left == 2 + shift
    want = jax_fsmn(jnp.asarray(v), jnp.asarray(w), jnp.asarray(mask), left,
                    right)
    got = fsmn_memory(_t(v), _t(np.transpose(w, (2, 1, 0))), _t(mask), left,
                      right)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_posenc_and_masks_match_jax():
    from funasr_tpu.ops import masks as JM
    from funasr_tpu.ops.posenc import sinusoidal_encoding as jax_pe
    from funasr_torch.ops import masks as TM
    from funasr_torch.ops.posenc import sinusoidal_encoding

    np.testing.assert_array_equal(sinusoidal_encoding(50, 560).numpy(),
                                  np.asarray(jax_pe(50, 560)))
    lens = np.array([5, 0, 9], np.int32)
    np.testing.assert_array_equal(TM.key_mask(_t(lens), 9).numpy(),
                                  np.asarray(JM.key_mask(jnp.asarray(lens), 9)))


def test_registry_resolves_the_port_classes():
    from funasr_torch.registry import tables

    assert tables.get("model_classes", "Paraformer") is Paraformer
    assert tables.get("encoder_classes", "SANMEncoder").__module__ == \
        "funasr_torch.models.sanm"
    assert tables.get("tokenizer_classes", "CharTokenizer").__module__ == \
        "funasr_torch.tokenizer.char_tokenizer"
