"""int8 Paraformer of the port (``Paraformer(quantize=True)``) against the
JAX Paraformer on its fused int8 path, on the CPU.

A tiny Paraformer that passes the JAX kernels' ``supported()`` gates (D=256,
2 heads of 128, FFN 256, 3 encoder + 2 decoder layers + ``decoders3``) is
initialised in JAX; its float32 params go through
``convert.paraformer_from_jax`` into the port, which is then quantized.
The JAX side runs under ``quant.quantized(True)`` and
``pltpu.force_tpu_interpret_mode()`` with the three kernels' ``enabled``
switches forced on, and spies assert that ``sanm_layer_pallas._call``,
``decoder_layer_pallas._call`` and ``ffn_pallas._ffn_call_int8`` were
reached.  The QDense gate runs at its defaults and at 0 (every projection
in int8).

What agrees, and why not more: both sides quantize the same values, but
the port sums layer-norm statistics in float64 and XLA orders its float32
sums its own way.  Where a value sits within an ulp of an int8 rounding
tie, the two land one step apart.  In ``encoders0`` (its FFN is int8 and
row-local) that leaves every row at float32 agreement except the few rows
holding such a tie (``test_int8_first_layer_rows``).  The attention of
the next layers then spreads those rows' perturbation, and every later
quantize moves more ties, so the outputs agree to the int8 noise floor:
log-probs to atol 0.15, with token lengths and CIF peaks equal.  With the
gate at 0 the projections before the predictor are int8 too, and a
cumulative alpha within that noise of an integer may move its fire by a
frame; the decoder then reads other acoustic embeddings.  So that case
gives both decoders the JAX encoder output and embeddings
(``test_int8_decoder_gate_zero``).  Greedy tokens agree on >= 0.99 of the
positions where the JAX top-2 margin exceeds twice the log-prob tolerance
(at least 8 such positions).  A
position below that margin is a near tie that either side may break, so
overall agreement is only held to >= 0.9 (random weights give flat logits:
12-14 % of the positions here have a margin under 0.05).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from funasr_tpu.models.paraformer.model import Paraformer as JaxParaformer
from funasr_tpu.ops import decoder_layer_pallas as JDL
from funasr_tpu.ops import ffn_pallas as JFP
from funasr_tpu.ops import quant as JQ
from funasr_tpu.ops import sanm_layer_pallas as JSL
from funasr_torch.convert import paraformer_from_jax
from funasr_torch.models.paraformer.model import Paraformer
from funasr_torch.ops import decoder_layer as DL
from funasr_torch.ops import quant as Q
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

V, IN, D = 32, 560, 256
CONF = dict(
    vocab_size=V, input_size=IN,
    encoder_conf=dict(output_size=D, attention_heads=2, linear_units=256,
                      num_blocks=3, kernel_size=11),
    decoder_conf=dict(attention_heads=2, linear_units=256, num_blocks=2,
                      att_layer_num=2, kernel_size=11),
    predictor_conf=dict(idim=D, threshold=1.0, l_order=1, r_order=1,
                        tail_threshold=0.45),
)
MAX_TOKENS = 16
LOGP_ATOL = 0.15
MIN_AGREE = 0.99      # where the JAX top-2 margin exceeds 2 * LOGP_ATOL
MIN_AGREE_ALL = 0.9


@pytest.fixture(scope="module")
def params():
    jm = JaxParaformer(**CONF)
    p = jax.jit(lambda key: jm.init(
        {"params": key}, jnp.zeros((1, 64, IN)), jnp.array([64]), max_tokens=16,
        method=jm.greedy_decode))(jax.random.PRNGKey(0))
    return jm, jax.tree_util.tree_map(np.asarray, p)


def _fused_jax(monkeypatch, gate_zero: bool):
    """Put the JAX package on its fused int8 path for the test's duration;
    returns the spy counts."""
    calls = {"sanm": 0, "dec": 0, "ffn": 0}

    def spy(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    for mod in (JSL, JDL, JFP):
        monkeypatch.setattr(mod, "enabled", lambda: True)
    monkeypatch.setattr(JSL, "_call", spy("sanm", JSL._call))
    monkeypatch.setattr(JDL, "_call", spy("dec", JDL._call))
    monkeypatch.setattr(JFP, "_ffn_call_int8", spy("ffn", JFP._ffn_call_int8))
    if gate_zero:
        for mod, m, n in ((JQ, "_MIN_M", "_MIN_N"), (Q, "MIN_M", "MIN_N")):
            monkeypatch.setattr(mod, m, 0)
            monkeypatch.setattr(mod, n, 0)
    return calls


def _port_model(p, device="cpu"):
    tm = Paraformer(**CONF, device=device, dtype=torch.bfloat16, quantize=True)
    tm.load_state_dict(paraformer_from_jax(p), strict=True)
    return tm.quantize_weights()


def _check_log_probs(lp, want_lp, want_tl):
    valid = np.arange(MAX_TOKENS)[None] < want_tl[:, None]
    np.testing.assert_allclose(lp[valid], want_lp[valid], rtol=0, atol=LOGP_ATOL)
    same = (lp.argmax(-1) == want_lp.argmax(-1))[valid]
    top2 = np.sort(want_lp, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0])[valid] > 2 * LOGP_ATOL
    assert clear.sum() >= 8
    assert same[clear].mean() >= MIN_AGREE, same[clear].mean()
    assert same.mean() >= MIN_AGREE_ALL, same.mean()


def _speech():
    rng = np.random.default_rng(7)
    return (rng.standard_normal((2, 64, IN)).astype(np.float32),
            np.array([64, 41], np.int32))


def test_int8_model_matches_jax_fused_path(monkeypatch, params):
    jm, p = params
    calls = _fused_jax(monkeypatch, gate_zero=False)
    x, lens = _speech()
    jmb = JaxParaformer(**CONF, dtype=jnp.bfloat16)
    with JQ.quantized(True), pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda p, x, l: jmb.apply(
            p, x, l, max_tokens=MAX_TOKENS, method=jmb.inference_logits))(
                p, jnp.asarray(x), jnp.asarray(lens))
    assert calls["sanm"] and calls["dec"] and calls["ffn"], calls
    want_lp, want_tl, want_pred = jax.tree_util.tree_map(np.asarray, want)

    tm = _port_model(p)
    lp, tl, pred = tm.inference_logits(torch.from_numpy(x), torch.from_numpy(lens),
                                       max_tokens=MAX_TOKENS)
    np.testing.assert_array_equal(tl.numpy(), want_tl)
    np.testing.assert_array_equal(pred.peaks.numpy(), want_pred.peaks)
    _check_log_probs(lp.numpy(), want_lp, want_tl)


def test_int8_decoder_gate_zero(monkeypatch, params):
    """Every QDense projection in int8 (decoders3 w_1, output_layer): both
    decoders read the JAX encoder output and acoustic embeddings."""
    jm, p = params
    calls = _fused_jax(monkeypatch, gate_zero=True)
    x, lens = _speech()
    jmb = JaxParaformer(**CONF, dtype=jnp.bfloat16)
    with JQ.quantized(True), pltpu.force_tpu_interpret_mode():
        enc, enc_lens = jax.jit(lambda p, x, l: jmb.apply(
            p, x, l, method=jmb.encode))(p, jnp.asarray(x), jnp.asarray(lens))
        pred = jax.jit(lambda p, e, l: jmb.apply(
            p, e, l, MAX_TOKENS, method=lambda m, *a: m.predictor(*a)))(
                p, enc, enc_lens)
        tl = jnp.clip(jnp.round(pred.token_num).astype(jnp.int32), 0, MAX_TOKENS)
        logits = jax.jit(lambda p, *a: jmb.apply(
            p, *a, method=lambda m, *b: m.decoder(*b)))(
                p, enc, enc_lens, pred.acoustic_embeds, tl)
    assert calls["sanm"] and calls["dec"] and calls["ffn"], calls
    want_lp = np.asarray(jax.nn.log_softmax(logits.astype(jnp.float32), -1))

    tm = _port_model(p)
    t = lambda a: torch.from_numpy(np.asarray(a.astype(jnp.float32)
                                              if a.dtype == jnp.bfloat16 else a))
    memq = []
    monkeypatch.setattr(DL, "quantize_memory",
                        lambda m, f=DL.quantize_memory: memq.append(m) or f(m))
    with torch.no_grad():
        got = tm.decoder(t(enc).to(torch.bfloat16), t(enc_lens),
                         t(pred.acoustic_embeds), t(tl))
    assert Q.gate(got.shape[0] * got.shape[1], V)
    assert len(memq) == 1  # the memory is row-quantized once for all layers
    lp = torch.log_softmax(got.float(), -1).numpy()
    _check_log_probs(lp, want_lp, np.asarray(tl))


def test_int8_first_layer_rows(monkeypatch):
    """``encoders0`` alone in float32 compute (its FFN int8, projections
    under the gate): every row agrees with JAX to 1e-5 except rows that
    hold an int8 rounding tie, at most 3 % of them."""
    from funasr_tpu.models.sanm import SANMEncoder as JaxEncoder
    from funasr_torch import convert as C
    from funasr_torch.models.sanm import SANMEncoder

    calls = _fused_jax(monkeypatch, gate_zero=False)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 64, IN)).astype(np.float32)
    lens = np.array([64, 41], np.int32)
    conf = dict(input_size=IN, output_size=D, attention_heads=2, linear_units=256,
                num_blocks=1, kernel_size=11)
    je = JaxEncoder(**conf, dropout_rate=0.0)
    p = jax.jit(je.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(lens))
    with JQ.quantized(True), pltpu.force_tpu_interpret_mode():
        want, _ = jax.jit(je.apply)(p, jnp.asarray(x), jnp.asarray(lens))
    assert calls["ffn"]
    tree = jax.tree_util.tree_map(np.asarray, p["params"])
    sd = {}
    C._enc_layer(sd, "encoders0.0", tree["encoders0"])
    C._norm(sd, "after_norm", tree["after_norm"])
    te = SANMEncoder(**conf, param_dtype=torch.float32)
    te.load_state_dict(sd)
    te.quantize_weights()
    with torch.no_grad():
        got, _ = te(torch.from_numpy(x), torch.from_numpy(lens))
    row_err = np.abs(got.numpy() - np.asarray(want)).max(-1)
    valid = np.arange(64)[None] < lens[:, None]
    assert (row_err[valid] > 1e-5).mean() <= 0.03, row_err[valid]


def test_quantize_once_buffers_and_state_dict(params):
    _, p = params
    tm = _port_model(p)
    bufs = {k: v.clone() for k, v in tm.named_buffers()}
    assert any(v.dtype == torch.int8 for v in bufs.values())
    tm.quantize_weights()
    again = dict(tm.named_buffers())
    assert set(again) == set(bufs)
    assert all(torch.equal(again[k], bufs[k]) for k in bufs)
    float_model = Paraformer(**CONF, device="cpu")
    assert list(tm.state_dict()) == list(float_model.state_dict())
    assert all(v.dtype != torch.int8 for v in tm.state_dict().values())
    # fused layers hold their int8 weights; nothing is quantized per batch
    assert tm.encoder.encoders[0].int8 is not None
    assert tm.decoder.decoders[0].int8 is not None
    assert tm.decoder.output_layer.w8 is not None


def test_loading_weights_again_requires_quantize(params):
    _, p = params
    tm = _port_model(p)
    tm.load_state_dict(paraformer_from_jax(p))
    x = torch.zeros((1, 64, IN))
    with pytest.raises(RuntimeError, match="quantize_weights"):
        tm.inference_logits(x, torch.tensor([64]), max_tokens=MAX_TOKENS)
    tm.quantize_weights()
    tm.inference_logits(x, torch.tensor([64]), max_tokens=MAX_TOKENS)
    with pytest.raises(RuntimeError, match="quantize=True"):
        Paraformer(**CONF, device="cpu").quantize_weights()


def test_int8_transcribe_matches_jax_engine(monkeypatch, params):
    from funasr_tpu.auto import engines as JE
    from funasr_tpu.tokenizer.char_tokenizer import CharTokenizer as JaxTokenizer
    from funasr_torch.auto import engines as TE
    from funasr_torch.tokenizer.char_tokenizer import CharTokenizer

    _, p = params
    tokens = (["<blank>", "<s>", "</s>"] + [chr(0x4E00 + i) for i in range(V - 4)]
              + ["<unk>"])
    rng = np.random.default_rng(11)
    wavs = [(0.1 * np.sin(2 * np.pi * (200 + 150 * i) * np.arange(n) / 16000.0)
             + 0.05 * rng.standard_normal(n)).astype(np.float32)
            for i, n in enumerate([24000, 9000, 15500])]
    calls = _fused_jax(monkeypatch, gate_zero=False)
    jax_engine = JE.ParaformerEngine(JaxParaformer(**CONF, dtype=jnp.bfloat16), p,
                                     JE.FrontendConfig(), JaxTokenizer(tokens))
    with JQ.quantized(True), pltpu.force_tpu_interpret_mode():
        want = jax_engine.transcribe(wavs)
    assert calls["sanm"] and calls["dec"] and calls["ffn"], calls
    port = TE.ParaformerEngine(_port_model(p), TE.FrontendConfig(),
                               CharTokenizer(tokens), device="cpu")
    got = port.transcribe(wavs)
    assert [r["text"] for r in got] == [r["text"] for r in want]
    assert any(r["text"] for r in got)
