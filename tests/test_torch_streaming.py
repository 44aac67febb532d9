"""The port's streaming Paraformer (``funasr_torch/frontends/streaming.py``,
``funasr_torch/models/paraformer_streaming/``) against the JAX package's on
the CPU, on the same weights: a jitted JAX Paraformer init, converted for
the port by ``convert.paraformer_from_jax`` (as ``tests/test_torch_pipeline.py``
``_pair`` does).  Tiny model: D = 64 with 2 heads (head size 32), 3 + 2
layers, FSMN kernel 5, chunk (0, 6, 3), look-back 2 (a 12-frame KV cache),
8 mels with LFR 3/2 and a random CMVN.

Tolerances: frontend frames atol 1e-3 / rtol 1e-4 (the fbank twin's bar of
``tests/test_torch_fbank.py``); float32 activations, caches, CIF embeds and
log-probs abs 1e-4; token counts and tokens exact.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from funasr_tpu.frontends.streaming import StreamingFrontend as JaxFrontend
from funasr_tpu.models.paraformer.model import Paraformer as JaxParaformer
from funasr_tpu.models.paraformer_streaming import functional as JSF
from funasr_tpu.models.paraformer_streaming.model import ParaformerStreaming as JaxStreaming
from funasr_torch import convert as C
from funasr_torch.auto.engines import FrontendConfig
from funasr_torch.frontends.streaming import StreamingFrontend
from funasr_torch.models.paraformer_streaming import functional as SF
from funasr_torch.models.paraformer_streaming.model import ParaformerStreaming
from tests.test_torch_vad import built_once
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-4  # float32 activations, caches, embeds, log-probs
FE_TOL = dict(rtol=1e-4, atol=1e-3)  # fbank frames (tests/test_torch_fbank.py)
TINY = dict(vocab_size=32, input_size=24,
            encoder_conf=dict(output_size=64, attention_heads=2, linear_units=96,
                              num_blocks=3, kernel_size=5),
            decoder_conf=dict(attention_heads=2, linear_units=96, num_blocks=2,
                              att_layer_num=2, kernel_size=5),
            predictor_conf=dict(idim=64, tail_threshold=0.45))
STREAM = dict(input_size=24, d_model=64, n_head=2, enc_kernel=5, dec_kernel=5,
              n_enc_layers=3, n_dec_layers=2, chunk_size=(0, 6, 3),
              encoder_chunk_look_back=2)
FE = dict(n_mels=8, lfr_m=3, lfr_n=2)


def jax_paraformer_params(conf, seed=0):
    return built_once(("jax_paraformer_params", repr(conf), seed),
                      lambda: _jax_paraformer_params_uncached(conf, seed))


def _jax_paraformer_params_uncached(conf, seed=0):
    jm = JaxParaformer(**conf)
    return jax.tree_util.tree_map(np.asarray, jax.jit(lambda key: jm.init(
        {"params": key}, jnp.zeros((1, 16, conf["input_size"])), jnp.array([16]),
        max_tokens=8, method=jm.greedy_decode))(jax.random.PRNGKey(seed)))


def cmvn(dim, seed=7):
    rng = np.random.default_rng(seed)
    return np.stack([rng.normal(0.0, 1.0, dim),
                     rng.uniform(0.5, 1.5, dim)]).astype(np.float32)


def audio(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    return (0.1 * rng.standard_normal(n) + 0.3 * np.sin(2 * np.pi * 300 * t)
            ).astype(np.float32)


def _streaming_pair(params):
    cm = cmvn(24)
    jsm = JaxStreaming(params, frontend=JaxFrontend(cmvn=cm, **FE), **STREAM)
    psm = ParaformerStreaming(C.paraformer_from_jax(params), device="cpu",
                              frontend=StreamingFrontend(cmvn=cm, device="cpu", **FE),
                              **STREAM)
    return params, jsm, psm


@pytest.fixture(scope="module")
def pair():
    """(JAX params, JAX ParaformerStreaming, the port's) on the same weights."""
    return _streaming_pair(jax_paraformer_params(TINY))


@pytest.fixture(scope="module")
def sparse_pair():
    """The same with the predictor's alpha pinned near 0.15 a frame (its
    output kernel scaled down, its bias at logit(0.15)): windows that fire
    no token, and a decoder stream that starts late."""
    params = jax.tree_util.tree_map(np.array, jax_paraformer_params(TINY, seed=1))
    out = params["params"]["predictor"]["cif_output"]
    out["kernel"] *= 0.05
    out["bias"][:] = np.log(0.15 / 0.85)
    return _streaming_pair(params)


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


# ------------------------------------------------------------------ frontend
@pytest.mark.parametrize("fe, chunks", [
    (dict(), [9600] * 4 + [3000]),  # Paraformer-large's frontend, 600 ms chunks
    (FE, [3200, 100, 0, 5000, 3333, 250]),  # ragged chunks, one below a frame
])
def test_frontend_steps_match_jax_and_offline(fe, chunks):
    dim = fe.get("n_mels", 80) * fe.get("lfr_m", 7)
    cm = cmvn(dim)
    wav = audio(sum(chunks))
    jfe, pfe = JaxFrontend(cmvn=cm, **fe), StreamingFrontend(cmvn=cm, device="cpu", **fe)
    js, ps = jfe.init_state(), pfe.init_state()
    outs, pos = [], 0
    for i, n in enumerate(chunks):
        part, final = wav[pos:pos + n], i == len(chunks) - 1
        pos += n
        jo, js = jfe.step(js, part, final)
        po, ps = pfe.step(ps, part, final)
        assert po.shape == jo.shape and po.dtype == np.float32
        np.testing.assert_allclose(po, jo, **FE_TOL)
        np.testing.assert_array_equal(ps.sample_cache, js.sample_cache)
        outs.append(po)
    stream = np.concatenate(outs)
    # the port's offline frontend on the whole recording
    off = FrontendConfig(cmvn=cm, **fe)
    feats, flens = off.device_features(torch.from_numpy(wav)[None],
                                       torch.tensor([len(wav)]))
    offline = feats[0, :int(flens[0])].numpy()
    assert stream.shape == offline.shape
    np.testing.assert_allclose(stream, offline, **FE_TOL)


def test_frontend_counts_one_fbank_launch_per_step_with_frames(monkeypatch):
    from funasr_torch.ops import fbank_kernel as FK

    calls = []
    real = FK.fused_fbank
    monkeypatch.setattr(FK, "fused_fbank", lambda *a, **k: calls.append(1) or real(*a, **k))
    pfe = StreamingFrontend(device="cpu", **FE)
    st = pfe.init_state()
    for n in (300, 50, 9600, 0):  # 300 + 50 < 400: no frame until the third
        pfe.step(st, audio(n), False)
    assert len(calls) == 1


# ------------------------------------------------------------------------ CIF
def test_cif_chunk_with_carry():
    rng = np.random.default_rng(3)
    B, D, U = 2, 8, 9
    js = JSF.init_cif_state(B, D)
    ps = SF.init_cif_state(B, D, "cpu")
    fired = 0
    for T in (7, 5, 1, 7):
        h = rng.standard_normal((B, T, D)).astype(np.float32)
        a = rng.uniform(0.0, 0.6, (B, T)).astype(np.float32)
        je, jn, js = JSF.cif_chunk(jnp.asarray(h), jnp.asarray(a), js, U)
        pe, pn, ps = SF.cif_chunk(t(h), t(a), ps, U)
        np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
        np.testing.assert_allclose(pe.numpy(), np.asarray(je), atol=ATOL)
        np.testing.assert_allclose(ps.integrate.numpy(), np.asarray(js.integrate), atol=ATOL)
        np.testing.assert_allclose(ps.frame.numpy(), np.asarray(js.frame), atol=ATOL)
        fired += int(pn.sum())
    assert fired > 4  # the carry crossed chunk boundaries


# ------------------------------------------------------------------------ FSMN
def test_fsmn_stream_first_later_empty_chunks_and_gap():
    """Chunks that fire none before the stream starts, the symmetric first
    chunk with its right-pad gap, causal later chunks, empty chunks between."""
    rng = np.random.default_rng(4)
    B, U, D, K = 1, 6, 8, 5
    w = rng.standard_normal((D, 1, K)).astype(np.float32)
    jw = jnp.asarray(np.transpose(w, (2, 1, 0)))
    jc, pc = jnp.zeros((B, K - 1, D)), torch.zeros((B, K - 1, D))
    jst, pst = jnp.zeros((B,), bool), torch.zeros((B,), dtype=torch.bool)
    for n in (0, 3, 0, 2, 6, 1):
        x = np.zeros((B, U, D), np.float32)
        x[:, :n] = rng.standard_normal((B, n, D))
        jn, pn = jnp.asarray([n], jnp.int32), torch.tensor([n], dtype=torch.int32)
        jm, jc = JSF.fsmn_stream(jnp.asarray(x), jn, jw, jc, jst, kernel_size=K)
        pm, pc = SF.fsmn_stream(t(x), pn, t(w), pc, pst)
        np.testing.assert_allclose(pm.numpy(), np.asarray(jm), atol=ATOL)
        np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=ATOL)
        jst, pst = jst | (jn > 0), pst | (pn > 0)


# --------------------------------------------------------------------- encoder
jax_encoder_chunk = jax.jit(functools.partial(JSF.encoder_chunk, n_head=2, kernel_size=5,
                                              d_model=64),
                            static_argnames=("keep", "overlap"))
jax_decoder_chunk = jax.jit(functools.partial(JSF.decoder_chunk, n_head=2, kernel_size=5))


def test_encoder_chunk_cache_empty_partial_full_and_final(pair):
    """Windows 1-3 meet the cache empty, half filled and full (keep = 6 of
    C = 12); window 4 is a final window with 2 real frames of 6."""
    params, jsm, psm = pair
    l, c, r = STREAM["chunk_size"]
    keep, C = l + c, jsm.kv_cache_len
    enc = params["params"]["encoder"]
    rng = np.random.default_rng(5)
    jstate = JSF.init_enc_state(3, 1, C, 64)
    pstate = SF.init_enc_state(3, 1, C, 64, "cpu")
    W = l + c + r
    for i, win_valid in enumerate((W, W, W, l + r + 2)):
        window = rng.standard_normal((1, W, 24)).astype(np.float32)
        window[:, win_valid:] = 0.0
        assert pstate.kv_valid == int(jstate.kv_valid) == min(i * keep, C)
        jo, jstate = jax_encoder_chunk(enc, jnp.asarray(window), jstate, i * c, win_valid,
                                       keep=keep, overlap=l + r)
        with torch.inference_mode():
            po, pstate = SF.encoder_chunk(psm.model.encoder, t(window), pstate, i * c,
                                          win_valid, psm.inv_ts, keep=keep, overlap=l + r)
        np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=ATOL)
        np.testing.assert_allclose(torch.stack(pstate.kv).numpy(), np.asarray(jstate.kv),
                                   atol=ATOL)


# --------------------------------------------------------------------- decoder
def test_decoder_chunk(pair):
    params, jsm, psm = pair
    dec = params["params"]["decoder"]
    rng = np.random.default_rng(6)
    U, W, D = jsm.max_tokens, jsm.window, 64
    jstate = JSF.init_dec_state(2, 1, 5, D)
    pstate = SF.init_dec_state(2, 1, 5, D, "cpu")
    for n, mem_valid in ((0, W), (4, W), (2, W), (U, 5)):
        emb = rng.standard_normal((1, U, D)).astype(np.float32)
        memory = rng.standard_normal((1, W, D)).astype(np.float32)
        jl, jstate = jax_decoder_chunk(dec, jnp.asarray(emb), jnp.asarray([n], jnp.int32),
                                       jnp.asarray(memory), jstate, memory_valid=mem_valid)
        with torch.inference_mode():
            pl, pstate = SF.decoder_chunk(psm.model.decoder, t(emb),
                                          torch.tensor([n], dtype=torch.int32), t(memory),
                                          pstate, mem_valid)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL)
        np.testing.assert_allclose(torch.stack(pstate.fsmn).numpy(), np.asarray(jstate.fsmn),
                                   atol=ATOL)
        assert pstate.started.tolist() == np.asarray(jstate.started).tolist()


# ---------------------------------------------------------------- whole streams
def _window_log(sm, n_tok_of):
    """Record each window's (final, n_real, tokens) and its n_tok (read
    from the step's output by ``n_tok_of``) on ``sm``."""
    log, n_toks, real_run, real_step = [], [], sm._run_window, sm._step

    def run(cache, chunk, final, n_real=None):
        out = real_run(cache, chunk, final, n_real)
        log.append((final, n_real, out))
        return out

    def step(*a):
        out = real_step(*a)
        n_toks.append(n_tok_of(out))
        return out

    saved = {k: vars(sm)[k] for k in ("_run_window", "_step") if k in vars(sm)}
    sm._run_window, sm._step = run, step

    def restore():  # the JAX step is an instance attribute, the port's a method
        for k in ("_run_window", "_step"):
            delattr(sm, k)
        vars(sm).update(saved)

    return log, n_toks, restore


@pytest.mark.parametrize("which, n_samples, chunk_ms, tail", [
    ("pair", 33234, 200, "short"), ("pair", 30800, 200, "empty"),
    ("pair", 40000, 600, "short"), ("pair", 30800, 600, "empty"),
    ("sparse_pair", 33234, 200, "short"), ("sparse_pair", 30800, 600, "empty")])
def test_whole_streams_equal_jax(request, which, n_samples, chunk_ms, tail):
    """generate_chunk chunk by chunk, then the final flush: the final window
    has a short tail (1 <= n_real < c) or none (n_real = 0); with sparse
    fires, windows of no token."""
    _, jsm, psm = request.getfixturevalue(which)
    jlog, jn, jrestore = _window_log(jsm, lambda out: int(out[1][0]))
    plog, pn, prestore = _window_log(psm, lambda out: int(out[0][0][0][0, 0]))
    try:
        wav = audio(n_samples, seed=n_samples)
        stride = 16000 * chunk_ms // 1000
        jc, pc = jsm.init_cache(), psm.init_cache()
        for i in range(0, n_samples, stride):
            jsm.generate_chunk(jc, wav[i:i + stride], False)
            psm.generate_chunk(pc, wav[i:i + stride], False)
        jsm.generate_chunk(jc, wav[:0], True)
        psm.generate_chunk(pc, wav[:0], True)
    finally:
        jrestore()
        prestore()
    assert pn == jn and plog == jlog and pc.tokens == jc.tokens
    final, n_real, _ = plog[-1]
    assert final and all(not f for f, _, _ in plog[:-1])
    assert (n_real == 0) == (tail == "empty")
    assert len(plog) > 10 and len(pc.tokens) > 10
    assert (0 in pn) == (which == "sparse_pair")


def test_inference_counts_tokens_per_window(pair):
    """``inference`` (the whole waveform in 600 ms chunks) equals JAX's and
    reads one (n_tok, tokens) row a window."""
    _, jsm, psm = pair
    wav = audio(25000, seed=2)
    assert psm.inference(wav)["token_ids"] == jsm.inference(wav)["token_ids"]
    row = []
    real = psm._step

    def step(*a):
        out = real(*a)
        row.append(out[0][0][0])
        return out

    psm._step = step
    try:
        cache = psm.init_cache()
        toks = psm.generate_chunk(cache, wav, True)
    finally:
        del psm._step
    assert all(r.shape == (1, 1 + psm.max_tokens) for r in row)
    n_tok = [int(r[0, 0]) for r in row]
    assert sum(n_tok) >= len(toks) == len(cache.tokens)


def test_constructor_checks(pair):
    _, _, psm = pair
    with pytest.raises(ValueError, match="differ"):
        ParaformerStreaming(psm.model, device="cpu", **dict(STREAM, n_head=4))
    with pytest.raises(ValueError, match="float32"):
        from funasr_torch.models.paraformer.model import Paraformer

        ParaformerStreaming(Paraformer(**TINY, dtype=torch.bfloat16, device="cpu"),
                            device="cpu", **STREAM)
    same = ParaformerStreaming(psm.model, device="cpu", **STREAM)
    assert same.model is psm.model
