"""Whisper of the port (``funasr_torch/models/whisper``,
``frontends/whisper_frontend.py``, ``convert.whisper_from_jax``,
``WhisperEngine``, the ``AutoModel`` route) against the JAX package on the
CPU.

The tiny config: D = 128, 2 heads of 64, 2 + 2 layers, FFN 512,
``max_target_positions`` 64 and the real vocabulary of 51865 (so the
special-token ids of an openai checkpoint, 50257 and 50258, lie inside it;
at a tiny vocabulary ``whisper_from_openai_pt`` falls back to HF's
defaults, outside it).  ``max_source_positions`` is 1500 (3000 mel frames):
the engine's frontend always gives one 30 s window, and one flax init of
one config (about 20 s to compile) then serves every case, the JAX
``AutoModel``'s included.

Weights are drawn from a seed with numpy in openai-whisper's layout, by
the rule of ``models/whisper/model.py`` ``init_weights_`` (its docstring
says why greedy decoding at random weights needs it): LeCun-normal
projections and convolutions, the residual writes (``out``, ``mlp.2``)
scaled by 1/sqrt(2 x blocks), the encoder's sinusoid table as HF
initialises it, token embeddings at std 0.02 and decoder positions at 1.
So that every bias and layer-norm parameter takes part in the comparison,
biases are N(0, 0.02^2) and layer-norm scales 1 + N(0, 0.02^2) here.  They
reach the JAX package as a ``.pt`` loaded by its
``WhisperWrap(model_path=...)`` and the port through
``convert.whisper_from_jax`` of the JAX tree (or the same ``.pt``).  Every
decode case asserts at least 4 distinct tokens a row, so a fixed point
cannot pass.

Bars: log-mel 1e-4 (float32); the encoder 1e-4 of its largest magnitude in
float32; in bf16 within 5e-2 (|x| <= 4 here) of JAX's float32 encoder and
no further from it than 1.25 x JAX's bf16 encoder; float32 greedy tokens
equal; in bf16 the port's predictions fed JAX's bf16 tokens equal them at
every step where JAX's own float32 top-2 margin on the same prefix exceeds
0.1, and on >= 0.9 of all steps (bf16 logits tie at a vocabulary of 51865,
and both packages' argmax takes the first maximum); float32 logits of a
decode fed its own tokens 1e-5 of their largest magnitude of JAX's
full-prefix decode; ``detect_language`` probabilities 1e-5 in float32.  On
the CPU the port runs the attention kernel's twin.
"""

import copy
import functools
import shutil
import tempfile

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from funasr_tpu.auto.auto_model import AutoModel as JaxAutoModel
from funasr_tpu.convert import whisper_from_openai_pt
from funasr_tpu.frontends import whisper_frontend as JF
from funasr_tpu.models.whisper.model import WhisperLID as JaxLID, WhisperWrap as JaxWrap
from funasr_torch import convert as C
from funasr_torch.auto import engines as TE
from funasr_torch.auto.auto_model import AutoModel
from funasr_torch.frontends import whisper_frontend as TF
from funasr_torch.models.whisper.model import (SIZES, WhisperLID, WhisperWrap, dims_of,
                                               sinusoids, whisper_config)
from funasr_torch.registry import tables
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TINY = dict(d_model=128, encoder_attention_heads=2, decoder_attention_heads=2,
            encoder_layers=2, decoder_layers=2, encoder_ffn_dim=512, decoder_ffn_dim=512,
            max_source_positions=1500, max_target_positions=64)
MEL_TOL = 1e-4
ENC_F32_RTOL = 1e-4
ENC_BF16_ATOL = 5e-2
BF16_SPREAD = 1.25
LID_TOL = 1e-5
LOGIT_RTOL = 1e-5  # float32 logits on the same prefix, of their largest magnitude
MARGIN = 0.1
MIN_AGREE = 0.9  # bf16 predictions on JAX's prefix, near-ties included
MIN_DISTINCT = 4
MAX_TOKENS = 16
LANGS = list(range(50259, 50359))  # the language tokens of the 51865/51866 vocabularies
# two of them whose order differs across features(B=4, seed=4)'s rows at these
# weights (log-prob gaps 0.002-0.006): transcribe_with_lid decodes two groups
LANG_SPLIT = [50309, 50358]
_TMPDIRS = []  # the cached pairs' files, removed with the caches when the module ends


def _tmpdir(prefix):
    _TMPDIRS.append(tempfile.mkdtemp(prefix=prefix))
    return _TMPDIRS[-1]


@pytest.fixture(autouse=True, scope="module")
def _remove_tmpdirs():
    yield
    jax_pair.cache_clear()
    auto_pair.cache_clear()
    while _TMPDIRS:
        shutil.rmtree(_TMPDIRS.pop(), ignore_errors=True)


@pytest.fixture(autouse=True, scope="module")
def _jitted_holder_init():
    """``funasr_tpu.convert.whisper_from_openai_pt`` initialises a flax
    model only to read its parameter layout, then takes every value from
    the checkpoint.  Flax initialises it op by op: about 15 s of small
    compiles at TINY.  Here each configuration's init is one jitted program,
    built once for the module's every JAX build."""
    from transformers.models.whisper.modeling_flax_whisper import (
        FlaxWhisperForConditionalGeneration as Flax)

    real = Flax.init_weights
    programs = {}

    def init_weights(self, rng, input_shape, params=None):
        if params is not None:
            return real(self, rng, input_shape, params)
        key = (self.config.to_json_string(), str(self.dtype), tuple(input_shape))
        if key not in programs:
            programs[key] = jax.jit(lambda r, model=self: real(model, r, input_shape))
        return programs[key](rng)

    Flax.init_weights = init_weights
    yield
    Flax.init_weights = real


def draw_checkpoint(conf, seed=0):
    """An openai-whisper checkpoint of seeded numpy weights (see the module
    docstring)."""
    rng = np.random.default_rng(seed)
    cfg = whisper_config(**conf)
    dims = dims_of(cfg)
    D, F, V = cfg.d_model, 4 * cfg.d_model, cfg.vocab_size
    sd = {}

    def dense(name, n_in, n_out, bias=True, scale=1.0):
        sd[f"{name}.weight"] = scale * rng.standard_normal((n_out, n_in)) / np.sqrt(n_in)
        if bias:
            sd[f"{name}.bias"] = 0.02 * rng.standard_normal(n_out)

    def norm(name):
        sd[f"{name}.weight"] = 1.0 + 0.02 * rng.standard_normal(D)
        sd[f"{name}.bias"] = 0.02 * rng.standard_normal(D)

    def block(p, cross, n_blocks):
        scale = 1.0 / np.sqrt(2 * n_blocks)  # the residual writes
        for att in ("attn", "cross_attn") if cross else ("attn",):
            for proj in ("query", "key", "value", "out"):
                dense(f"{p}.{att}.{proj}", D, D, bias=proj != "key",
                      scale=scale if proj == "out" else 1.0)
            norm(f"{p}.{att}_ln")
        dense(f"{p}.mlp.0", D, F)
        dense(f"{p}.mlp.2", F, D, scale=scale)
        norm(f"{p}.mlp_ln")

    for name, n_in in (("conv1", cfg.num_mel_bins), ("conv2", D)):
        sd[f"encoder.{name}.weight"] = (rng.standard_normal((D, n_in, 3))
                                        / np.sqrt(3 * n_in))
        sd[f"encoder.{name}.bias"] = 0.02 * rng.standard_normal(D)
    sd["encoder.positional_embedding"] = sinusoids(cfg.max_source_positions, D)
    for i in range(cfg.encoder_layers):
        block(f"encoder.blocks.{i}", False, cfg.encoder_layers)
    norm("encoder.ln_post")
    sd["decoder.token_embedding.weight"] = 0.02 * rng.standard_normal((V, D))
    sd["decoder.positional_embedding"] = rng.standard_normal((cfg.max_target_positions, D))
    for i in range(cfg.decoder_layers):
        block(f"decoder.blocks.{i}", True, cfg.decoder_layers)
    norm("decoder.ln")
    return {"dims": dims, "model_state_dict": {
        k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()}}


def as_dtype(w, dtype):
    """A JAX WhisperWrap computing in ``dtype`` on the same float32 params
    (what its ``.pt`` branch builds with that dtype; no second flax init)."""
    from transformers.models.whisper.modeling_flax_whisper import (
        FlaxWhisperForConditionalGeneration)

    wd = copy.copy(w)
    wd.model = FlaxWhisperForConditionalGeneration(w.config, dtype=dtype, _do_init=False)
    wd._greedy_key = None
    return wd


@functools.lru_cache(maxsize=None)
def jax_pair():
    """(checkpoint path, JAX float32 model, JAX bf16 model) of the seeded
    weights, built once: the flax init compiles for ~20 s, and the JAX
    AutoModel's bf16 build of the same ``.pt`` reuses it."""
    path = f"{_tmpdir('whisper_pt_')}/tiny.pt"
    torch.save(draw_checkpoint(TINY), path)
    w16 = JaxWrap(model_path=path, dtype=jnp.bfloat16)
    return path, as_dtype(w16, jnp.float32), w16


def port_model(dtype, lid=False, through="jax"):
    """The port's model on the CPU, its weights from the JAX tree
    (``whisper_from_jax``) or the ``.pt``."""
    path, w32, _ = jax_pair()
    cls = WhisperLID if lid else WhisperWrap
    kw = dict(language_token_ids=LANG_SPLIT) if lid else {}
    if through == "pt":
        return cls(model_path=path, dtype=dtype, device="cpu", **kw)
    m = cls(model_path=path, dtype=dtype, device="cpu", **kw)
    params = jax.tree_util.tree_map(np.asarray, w32.params)
    m.model.load_state_dict(C.whisper_from_jax(params, w32.config), strict=True)
    return m


def features(conf, B=2, seed=1):
    """(B, 80, 2 max_source) log-mel-like inputs."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.5, (B, 80, 2 * conf["max_source_positions"])).astype(np.float32)


def distinct_ok(tokens):
    for row in np.asarray(tokens):
        assert len(set(row.tolist())) >= MIN_DISTINCT, row


# ---------------------------------------------------------------- frontend
def waveform(kind, seed=0):
    rng = np.random.default_rng(seed)
    n = dict(short=16000, long=16000 * 31 + 123, silent=24000)[kind]
    if kind == "silent":
        return np.zeros(n, np.float32)
    t = np.arange(n) / 16000
    return (0.3 * np.sin(2 * np.pi * 440 * t) * np.sin(2 * np.pi * 2 * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("kind", ["short", "long", "silent"])
def test_log_mel_matches_jax(kind, n_mels):
    wav = np.stack([waveform(kind), waveform(kind, 1)])
    pad = 3000 if kind != "long" else None
    want = np.asarray(JF.log_mel_spectrogram(jnp.asarray(wav), n_mels, pad_to=pad))
    got = TF.log_mel_spectrogram(torch.from_numpy(wav), n_mels, pad_to=pad).numpy()
    assert got.shape == want.shape == (2, n_mels, pad or len(wav[0]) // 160)
    np.testing.assert_allclose(got, want, rtol=0, atol=MEL_TOL)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_frontend_ragged_windows_match_jax(n_mels):
    """Ragged waveforms (one past 30 s, one silent) through both
    ``WhisperFrontend``s: each cut or padded to one window."""
    wavs = [waveform("short"), waveform("long"), waveform("silent"), waveform("short")[:5000]]
    jf = JF.WhisperFrontend(n_mels=n_mels)
    want = np.concatenate([np.asarray(jf(w)) for w in wavs])
    tf = TF.WhisperFrontend(n_mels=n_mels, device="cpu")
    got = tf.batch(wavs).numpy()
    assert got.shape == (4, n_mels, 3000)
    np.testing.assert_allclose(got, want, rtol=0, atol=MEL_TOL)
    np.testing.assert_allclose(tf(wavs[1]).numpy(), want[1:2], rtol=0, atol=MEL_TOL)


# ---------------------------------------------------------------- encoder
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_jax(dtype):
    """float32 against JAX's float32.  bf16 against the same function at
    float32 (JAX's float32 encoder): within ``ENC_BF16_ATOL`` and no further
    from it than ``BF16_SPREAD`` x JAX's own bf16 encoder.  The two bf16
    encoders round in different places (JAX's scores and softmax in bf16,
    the kernel contract's in float32), so they sit up to twice one
    package's error apart (measured: 0.0625 at |x| = 2.3; each 0.040-0.045
    from float32)."""
    _, w32, w16 = jax_pair()
    tm = port_model(getattr(torch, dtype))
    x = features(TINY)
    want = np.asarray(w32.encode(jnp.asarray(x)))
    got = tm.encode(torch.from_numpy(x)).to(torch.float32).numpy()
    assert got.shape == want.shape == (2, 1500, 128)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=ENC_F32_RTOL * np.abs(want).max())
        return
    assert np.abs(want).max() <= 4.0
    jax16 = np.asarray(w16.encode(jnp.asarray(x)).astype(jnp.float32))
    err, jax_err = np.abs(got - want).max(), np.abs(jax16 - want).max()
    assert err <= ENC_BF16_ATOL and err <= BF16_SPREAD * jax_err, (err, jax_err)


# ---------------------------------------------------------------- greedy decode
def bf16_tokens_agree(w32, tm, feats, forced, want):
    """JAX's bf16 tokens ``want`` against the port's bf16 predictions on the
    same prefix (the port fed ``want``): equal at every step where JAX's
    float32 top-2 margin on that prefix exceeds ``MARGIN``, and on at least
    ``MIN_AGREE`` of all steps.  Returns the steps held to equality."""
    sot = w32.config.decoder_start_token_id
    prefix = np.concatenate([np.full((len(want), 1), sot), np.tile(forced, (len(want), 1)),
                             want[:, :-1]], axis=1).astype(np.int32)
    enc = w32.model.encode(input_features=jnp.asarray(feats), params=w32.params)
    logits = np.asarray(w32.model.decode(decoder_input_ids=jnp.asarray(prefix),
                                         encoder_outputs=enc, params=w32.params).logits)
    top2 = np.sort(logits[:, len(forced):], axis=-1)[..., -2:]  # predicts want[:, t]
    clear = top2[..., 1] - top2[..., 0] > MARGIN
    got = tm.greedy_decode(torch.from_numpy(feats), forced_tokens=forced,
                           tokens=torch.from_numpy(np.asarray(want, np.int64))).numpy()
    np.testing.assert_array_equal(got[clear], want[clear])
    assert (got == want).mean() >= MIN_AGREE, (got == want).mean()
    return int(clear.sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("forced", [[], [50260, 50359, 50363]], ids=["plain", "forced"])
def test_greedy_decode_matches_jax(dtype, forced):
    _, w32, w16 = jax_pair()
    tm = port_model(getattr(torch, dtype), through="pt")
    x = features(TINY, B=3, seed=2)
    jw = w32 if dtype == "float32" else w16
    want = np.asarray(jw.greedy_decode(jnp.asarray(x), max_tokens=MAX_TOKENS,
                                       forced_tokens=forced))
    got = tm.greedy_decode(torch.from_numpy(x), max_tokens=MAX_TOKENS,
                           forced_tokens=forced).numpy()
    assert got.shape == want.shape == (3, MAX_TOKENS)
    distinct_ok(want)
    distinct_ok(got)
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
    else:
        assert bf16_tokens_agree(w32, tm, x, forced, want) > 0


@pytest.mark.parametrize("forced", [[], [50260, 50359, 50363]], ids=["plain", "forced"])
def test_teacher_forced_logits_match_jax(forced):
    """``greedy_decode(tokens=, return_logits=True)`` in float32 fed its own
    greedy tokens: the same predictions, and logits within ``LOGIT_RTOL`` of
    their largest magnitude of the JAX model's full-prefix decode."""
    _, w32, _ = jax_pair()
    tm = port_model(torch.float32)
    x = features(TINY, B=2, seed=5)
    own = tm.greedy_decode(torch.from_numpy(x), max_tokens=MAX_TOKENS, forced_tokens=forced)
    distinct_ok(own)
    pred, logits = tm.greedy_decode(torch.from_numpy(x), forced_tokens=forced, tokens=own,
                                    return_logits=True)
    assert torch.equal(pred, own) and torch.equal(logits.argmax(-1), own)
    sot = w32.config.decoder_start_token_id
    prefix = np.concatenate([np.full((2, 1), sot), np.tile(forced, (2, 1)),
                             own.numpy()[:, :-1]], axis=1).astype(np.int32)
    enc = w32.model.encode(input_features=jnp.asarray(x), params=w32.params)
    want = np.asarray(w32.model.decode(decoder_input_ids=jnp.asarray(prefix),
                                       encoder_outputs=enc, params=w32.params).logits)
    want = want[:, len(forced):]
    assert logits.shape == want.shape == (2, MAX_TOKENS, 51865)
    np.testing.assert_allclose(logits.numpy(), want, rtol=0,
                               atol=LOGIT_RTOL * np.abs(want).max())


# ---------------------------------------------------------------- language id
def test_detect_language_matches_jax():
    _, w32, _ = jax_pair()
    tm = port_model(torch.float32)
    x = features(TINY, B=3, seed=3)
    want = np.asarray(w32.detect_language(jnp.asarray(x), LANGS))
    got = tm.detect_language(torch.from_numpy(x), LANGS).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LID_TOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=0, atol=1e-6)


def test_transcribe_with_lid_matches_jax():
    path, w32, _ = jax_pair()
    jl = JaxLID.__new__(JaxLID)  # JaxLID(model_path=path, dtype=float32, ...) without a re-init
    jl.__dict__.update(as_dtype(w32, jnp.float32).__dict__, language_token_ids=LANG_SPLIT)
    tm = port_model(torch.float32, lid=True)
    x = features(TINY, B=4, seed=4)
    want_t, want_p = jl.transcribe_with_lid(jnp.asarray(x), max_tokens=MAX_TOKENS)
    got_t, got_p = tm.transcribe_with_lid(torch.from_numpy(x), max_tokens=MAX_TOKENS)
    assert len(set(np.asarray(want_p).argmax(-1).tolist())) == 2  # two groups
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=0, atol=LID_TOL)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    distinct_ok(got_t)
    with pytest.raises(ValueError, match="language_token_ids"):
        WhisperLID(model_path=path, device="cpu").transcribe_with_lid(torch.from_numpy(x))


# ---------------------------------------------------------------- weights
def test_whisper_from_jax_round_trip():
    """JAX tree -> port state dict -> ``whisper_from_openai_pt``: the JAX tree
    back, exactly; the port's checkpoint carries its dims."""
    _, w32, _ = jax_pair()
    tm = port_model(torch.float32)
    ckpt = tm.checkpoint()
    config, params = whisper_from_openai_pt(ckpt, dtype=jnp.bfloat16)  # the cached init
    want = jax.tree_util.tree_leaves_with_path(w32.params)
    got = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(got) == len(want)
    for k, v in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=str(k))
    assert (config.decoder_start_token_id, config.eos_token_id) == (50258, 50257)
    assert (tm.config.decoder_start_token_id, tm.config.eos_token_id) == (50258, 50257)


def test_pt_loads_strictly(tmp_path):
    """An openai ``.pt`` (with the ``alignment_heads`` buffer openai-whisper
    saves) is the port's state dict; a missing or an extra weight raises."""
    path, _, _ = jax_pair()
    ckpt = torch.load(path, weights_only=True)
    tm = WhisperWrap(model_path=path, dtype=torch.float32, device="cpu")
    for k, v in tm.model.state_dict().items():
        assert torch.equal(v, ckpt["model_state_dict"][k]), k
    ckpt["model_state_dict"]["alignment_heads"] = torch.zeros(2, 2, dtype=torch.bool)
    torch.save(ckpt, tmp_path / "heads.pt")
    WhisperWrap(model_path=str(tmp_path / "heads.pt"), device="cpu")
    for broken in ({k: v for k, v in ckpt["model_state_dict"].items()
                    if k != "decoder.ln.bias"},
                   dict(ckpt["model_state_dict"], **{"decoder.extra": torch.zeros(1)})):
        torch.save(dict(ckpt, model_state_dict=broken), tmp_path / "broken.pt")
        with pytest.raises(RuntimeError, match="state_dict"):
            WhisperWrap(model_path=str(tmp_path / "broken.pt"), device="cpu")


# ---------------------------------------------------------------- engine, AutoModel
def speech(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    return (0.3 * np.sin(2 * np.pi * (200 + 40 * seed) * t)
            + 0.05 * rng.standard_normal(len(t))).astype(np.float32)


@functools.lru_cache(maxsize=None)
def auto_pair():
    """The JAX and port ``AutoModel`` behind FSMN-VAD and CT-Transformer on
    the same weights (the VAD's head calibrated), and the same two without
    the VAD and punctuation."""
    from tests.test_torch_pipeline import (PUNC_CFG, VAD_CFG, _save, _save_flax, punc_params,
                                           vad_params)

    d = _tmpdir("whisper_am_")
    cfg = dict(model="Whisper", model_path_hf=jax_pair()[0], max_tokens=MAX_TOKENS)
    vad, punc = vad_params(0), punc_params(0)
    jam = JaxAutoModel(
        model=cfg,
        vad_model=dict(VAD_CFG, init_param=_save_flax(f"{d}/j_vad.npz", vad["params"])),
        punc_model=dict(PUNC_CFG, init_param=_save_flax(f"{d}/j_punc.npz", punc["params"])))
    am = AutoModel(model=cfg,
                   vad_model=dict(VAD_CFG, init_param=_save(f"{d}/vad.npz",
                                                            C.fsmn_vad_from_jax(vad))),
                   punc_model=dict(PUNC_CFG, init_param=_save(
                       f"{d}/punc.npz", C.ct_transformer_from_jax(punc))),
                   device="cpu")
    alone = []
    for m in (jam, am):
        a = copy.copy(m)
        a.vad_engine = a.punc_engine = None
        alone.append(a)
    return (jam, am), tuple(alone)


def engine_records_agree(jam, am, call, got):
    """One batch of the engines: ``text`` "", ``raw_tokens`` JAX's tokens
    cut at eos, and the full token rows of the two models on the same
    windows at the bf16 rule (JAX's float32 graph on the same params gives
    the margins)."""
    wavs = call["wavs"]
    jm = jam.engine.model
    feats = np.concatenate([np.asarray(jam.engine.frontend(w)) for w in wavs])
    full = np.asarray(jm.greedy_decode(jnp.asarray(feats), max_tokens=MAX_TOKENS))
    port = am.engine.model.greedy_decode(am.engine.frontend.batch(wavs),
                                         max_tokens=MAX_TOKENS).numpy()
    distinct_ok(full)
    distinct_ok(port)
    assert bf16_tokens_agree(as_dtype(jm, jnp.float32), am.engine.model, feats, [], full) > 0
    eos = am.engine.model.config.eos_token_id
    assert eos == jm.config.eos_token_id == 50257
    for w, g, jrow, prow in zip(call["records"], got, full, port):
        assert g["text"] == w["text"] == ""
        for rec, row in ((w, jrow.tolist()), (g, prow.tolist())):
            assert rec["raw_tokens"] == (row[: row.index(eos)] if eos in row else row)


def _spy(monkeypatch, cls, calls):
    real = cls.transcribe

    def spy(self, wavs, **kw):
        out = real(self, wavs, **kw)
        calls.append(dict(wavs=list(wavs), records=out))
        return out

    monkeypatch.setattr(cls, "transcribe", spy)


def test_automodel_alone_matches_jax(monkeypatch):
    """``AutoModel({"model": "Whisper", "model_path_hf": <.pt>})`` without a
    VAD: both route to their WhisperEngine (bf16), records at the bf16 rule."""
    from funasr_tpu.auto import engines as JE

    (_, _), (jam, am) = auto_pair()
    assert isinstance(am.engine, TE.WhisperEngine) and am.engine.model.dtype == torch.bfloat16
    wavs = [speech(3.0, 0), speech(31.0, 2)]
    jc, tc = [], []
    _spy(monkeypatch, JE.WhisperEngine, jc)
    _spy(monkeypatch, TE.WhisperEngine, tc)
    want = jam.generate(wavs, key=["a", "b"])
    got = am.generate(wavs, key=["a", "b"])
    assert [r["key"] for r in got] == ["a", "b"]
    assert [set(r) for r in got] == [set(r) for r in want]
    engine_records_agree(jam, am, jc[0], tc[0]["records"])


def test_automodel_vad_punc_matches_jax(monkeypatch):
    """Behind FSMN-VAD and CT-Transformer: the same segments, each padded to
    a 30 s window by the engine; records at the bf16 rule; punctuation gets
    no text (no Whisper tokenizer in the repo), so the records equal."""
    from funasr_tpu.auto import engines as JE
    from tests.test_torch_vad import recording

    (jam, am), _ = auto_pair()
    wav = recording(0)
    jc, tc = [], []
    _spy(monkeypatch, JE.WhisperEngine, jc)
    _spy(monkeypatch, TE.WhisperEngine, tc)
    want = jam.generate(wav, key=["r"])
    got = am.generate(wav, key=["r"])
    assert got == want == [{"key": "r", "text": "", "timestamp": []}]
    assert len(jc) == len(tc) >= 1
    for j, t in zip(jc, tc):
        assert [len(w) for w in j["wavs"]] == [len(w) for w in t["wavs"]]
        engine_records_agree(jam, am, j, t["records"])


# ---------------------------------------------------------------- guards
def test_input_length_and_sizes_guarded():
    """HF's input check: (n_mels, 2 max_source_positions), else ValueError.
    An unknown size raises in the port; the JAX package builds tiny for it
    (``SIZES.get(size, SIZES["tiny"])``, pinned here)."""
    tm = port_model(torch.float32)
    with pytest.raises(ValueError, match="max_source_positions"):
        tm.encode(torch.zeros(1, 80, 2998))
    with pytest.raises(ValueError, match="max_target_positions"):
        tm.greedy_decode(torch.zeros(1, 80, 3000), max_tokens=64)
    with pytest.raises(ValueError, match="SIZES"):
        WhisperWrap(size="large-v2", device="cpu")
    with pytest.raises(ValueError, match="SIZES"):
        tables.get("model_classes", "Whisper-large-v3-turbo")(device="cpu")
    assert set(SIZES) == {"tiny", "base", "small", "medium", "large-v3"}
    from funasr_tpu.models.whisper import model as JM
    assert JM.SIZES.get("large-v2", JM.SIZES["tiny"]) is JM.SIZES["tiny"]


def test_routes_and_aliases():
    """The registry names of the JAX package resolve; a tokenizer, an HF
    directory and ``init_param`` raise on the AutoModel route."""
    for name in ("Whisper", "WhisperWrap", "WhisperWarp", "OpenAIWhisperModel",
                 "Whisper-tiny", "Whisper-large-v3"):
        assert tables.get("model_classes", name) is not None
    lid = tables.get("model_classes", "OpenAIWhisperLIDModel")(
        size="tiny", config_overrides=TINY, dtype=torch.float32, device="cpu",
        language_token_ids=LANGS)
    assert isinstance(lid, WhisperLID) and lid.config.d_model == 128
    assert tables.get("frontend_classes", "WhisperFrontend") is TF.WhisperFrontend
    path, _, _ = jax_pair()
    for cfg, what in ((dict(tokenizer="WhisperTokenizer"), "tokenizer"),
                      (dict(model_path_hf="/nonexistent/hf_dir"), "HF checkpoint"),
                      (dict(init_param=path), "init_param")):
        with pytest.raises(NotImplementedError, match=what):
            AutoModel(model=dict(model="Whisper", **cfg), device="cpu")


def test_entry_points_need_a_gpu(monkeypatch):
    """Without a GPU the entry points raise unless given ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path, _, _ = jax_pair()
    with pytest.raises(RuntimeError, match="no GPU"):
        WhisperWrap(model_path=path)
    with pytest.raises(RuntimeError, match="no GPU"):
        TF.WhisperFrontend()
    with pytest.raises(RuntimeError, match="no GPU"):
        AutoModel(model=dict(model="Whisper", model_path_hf=path))
    m = WhisperWrap(model_path=path, device="cpu")
    m.device = torch.device("cuda")
    with pytest.raises(RuntimeError, match="no GPU"):
        TE.WhisperEngine(m)
