"""The port's long-audio pipeline (``funasr_torch/auto/auto_model.py``
``AutoModel.generate`` with a VAD and punctuation) against the JAX
package's ``AutoModel`` on the CPU.

Tiny models as in ``tests/test_torch_vad.py`` (the scorer, its last layer
set so that it separates tone from silence), ``tests/test_torch_bicif.py``
(BiCif, D = 32) and ``tests/test_torch_punc.py`` (punctuation, head size
32), initialised in JAX (jitted) and loaded by both packages' ``AutoModel``
through ``init_param``: flax trees for the JAX package, the port's
``convert.*_from_jax`` state dicts for the port.  The recording is
``tests/test_auto_model.py:74``'s, and a longer one with two more bursts.

- float32, BiCif main model (the shared fbank grid) and plain Paraformer
  (the waveform path, 60 ms CIF stamps): the same segments, text,
  timestamps and ``sentence_info`` as the JAX package.  The JAX BiCif
  program's frame-0 fires are corrected as ``tests/test_torch_bicif.py``
  does (``_jax_fires``).
- The port's shared-grid path and its waveform path give the same result.
- int8 (``quantize=True``, bf16 activations, the opt-in routes off; the JAX
  package's fused layers forced on in interpret mode), against JAX's device
  program run op by op (``jax.disable_jit()``) and the rest of the JAX
  pipeline as it is.  Jitted on the CPU, that program is not its own
  op-by-op function in bf16: XLA fuses the bf16 steps and rounds them its
  own way (on a random input the first layer norm's output already
  differs in a fifth of its elements by one bf16 ulp), every int8 rounding
  tie it moves moves more, and at the encoder output the jitted program is up to 1.23 away
  from the op-by-op one (|x| <= 4.4; 96 % of the elements differ), where
  the port is 0.047 away (measured on this recording).  Against the jitted
  program the fires drift by two frames and a fifth of the tokens differ
  (the port's record gave 40 stamps to its 41, 38 before the port's bf16
  ``Dense`` stopped depending on torch's thread count).  The test pins
  that finding: the jitted encoder is more than ``JIT_GAP`` times as far
  from the op-by-op one as the port's is.  Against the op-by-op program:
  segments equal; each ASR batch's token lengths equal and upsampled fires
  equal in number and within one frame, ``test_torch_bicif.py``'s int8
  bars; greedy tokens agree on >= 0.99 of the positions where JAX's top-2
  margin exceeds 0.3 and on >= 0.9 of all, the bars of
  ``test_torch_paraformer_int8.py`` (measured: 39 of 39, 83 of 87); the
  record's stamp count is JAX's within the number of token differences at
  a JAX margin under 0.3 (measured: 40 to 39, 4 such differences).  The
  port's result is the same at every torch thread count (its CPU bf16
  ``Dense`` takes the dot in float32 and rounds it before adding the bias,
  as flax's does; torch's bf16 GEMM blocks its sums by the thread count).
- Edges: an input shorter than a frame gives ``{"key", "text": ""}``; what
  the port lacks raises ``NotImplementedError``; ``hotword=`` on a main
  model without a bias head is ignored, as the JAX engines ignore it; a
  ContextualParaformer main model and a hybrid one behind a VAD build and
  serve (their parity: ``test_torch_contextual.py``,
  ``test_torch_hybrid_align.py``).
- SeACo hotwords and the CAM++ speaker branch, float32
  (``AutoModel(SeacoParaformer, VAD, punctuation, CAMPPlus)``; the tiny
  SeACo of ``tests/test_torch_seaco.py``, the narrow CAM++ of
  ``tests/test_torch_campplus.py``): on a 25 s recording of eight bursts
  of two alternating tones (32 speaker chunks), with a hotword and
  ``preset_spk_num=2`` and with neither (the speaker count from the
  eigen-gap), the same text, timestamps, ``sentence_info`` (each with its
  ``spk``) and ``spk_info`` as the JAX ``AutoModel``: the records equal.
- SenseVoiceSmall through FunASR's README call (``vad_model`` FSMN-VAD,
  ``max_single_segment_time`` 30 s, ``language``, ``use_itn=True``,
  ``batch_size_s=60``, ``merge_vad=True``, ``merge_length_s=15``), float32,
  the tiny model of ``tests/test_torch_sensevoice.py`` with a CMVN file of
  the recording's feature statistics: the record (``text`` after ITN,
  ``timestamp`` from the CTC alignment) equals the JAX ``AutoModel``'s.
  With a VAD the call's ``language`` and ``use_itn`` steer only the text
  ITN; ``language="auto"`` names no ITN language, so the text passes
  through, as in the JAX package.  ``use_itn`` without a VAD (SenseVoice's
  text-norm prompt; BiCif's texts through ITN), and on the BiCif pipeline
  with "segment" and "joint" punctuation, also equal the JAX package.
- Past 15 s: T = 384 LFR frames at Paraformer-large's D = 512, the served
  bucket after 256 (frames pad to a multiple of 128; 15.4-23 s), where the
  JAX package's fused layers' VMEM gate (T <= 312 at D = 512) sends it to
  its XLA int8 module path, which it also takes on the CPU at every length:
  the port's fused int8 encoder against that path.  Measured: 86 % of the
  outputs differ, by at most 3 bf16 ulps of the largest magnitude (0.094 at
  4.9; mean 0.011).  Held to 8 ulps.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from funasr_tpu.auto import engines as JE
from funasr_tpu.auto.auto_model import AutoModel as JaxAutoModel
from funasr_torch import convert as C
from funasr_torch.auto.auto_model import AutoModel
from tests.test_torch_bicif import TOKENS, _conf, _init, _jax_fires
from tests.test_torch_paraformer_int8 import LOGP_ATOL, MIN_AGREE, MIN_AGREE_ALL
from tests.test_torch_sensevoice import CONF as SV_CONF, TOKENS as SV_TOKENS
from tests.test_torch_vad import (CONF as VAD_CONF, calibrated_params, init_params,
                                  recording, tone)
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

VAD_CFG = dict(model="FsmnVADStreaming", encoder="FSMN", encoder_conf=VAD_CONF,
               frontend_conf=dict(n_mels=80, lfr_m=5, lfr_n=1),
               model_conf=dict(max_end_silence_time=500))
FIRE_FRAMES = 1  # int8: port and JAX upsampled fires, in 20 ms frames
BAR_ULPS = 8  # past 15 s: port's fused int8 encoder against JAX's XLA int8 path
JIT_GAP = 8  # int8 encoder: JAX jitted against op by op, over the port against op by op
PUNC_CFG = dict(model="CTTransformer", vocab_size=len(TOKENS),
                tokenizer_conf={"token_list": TOKENS}, embed_unit=64, att_unit=64,
                encoder_conf=dict(output_size=64, attention_heads=2, linear_units=96,
                                  num_blocks=2, kernel_size=11))


def asr_cfg(model="BiCifParaformer", conf=None):
    conf = dict(conf or _conf(32, 2, 48, 2, 2))
    if model == "Paraformer":
        conf["predictor_conf"] = {k: v for k, v in conf["predictor_conf"].items()
                                  if k != "upsample_type"}
    return dict(model=model, tokenizer_conf={"token_list": TOKENS},
                frontend_conf=dict(n_mels=80, lfr_m=7, lfr_n=6), **conf)


def long_recording():
    """tests/test_auto_model.py:74's recording with two more bursts."""
    rng = np.random.default_rng(1)
    return np.concatenate([recording(0), tone(rng, 2.5, 300.0), np.zeros(9000, np.float32),
                           tone(rng, 1.2, 180.0), np.zeros(6000, np.float32)])


def _save(path, sd):
    np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    return str(path)


def _save_flax(path, tree, prefix="params"):
    """A flax tree as the JAX AutoModel's ``init_param`` (an .npz of
    '/'-joined names)."""
    flat = {}

    def walk(node, name):
        for k, v in node.items():
            walk(v, f"{name}/{k}") if isinstance(v, dict) else flat.__setitem__(
                f"{name}/{k}", np.asarray(v))

    walk(tree, prefix)
    np.savez(path, **flat)
    return str(path)


@functools.lru_cache(maxsize=None)
def vad_params(seed=0):
    """The VAD's jitted-init flax variables, its head calibrated; built once
    a seed for the module's pairs (read only)."""
    return calibrated_params(init_params(VAD_CONF, seed)[1], VAD_CONF, _port_frontend())


@functools.lru_cache(maxsize=None)
def punc_params(seed=0):
    """The punctuation model's jitted-init flax variables, once a seed."""
    from funasr_tpu.models.ct_transformer.model import CTTransformerModel
    from tests.test_torch_punc import jax_params

    return jax_params(CTTransformerModel(**{k: v for k, v in PUNC_CFG.items()
                                            if k in ("vocab_size", "embed_unit", "att_unit",
                                                     "encoder_conf")}), seed)


@functools.lru_cache(maxsize=None)
def bicif_params(seed=0):
    """``asr_cfg()``'s BiCif as jitted-init flax variables, once a seed."""
    cfg = asr_cfg()
    return _init({k: cfg[k] for k in ("vocab_size", "input_size", "encoder_conf",
                                      "decoder_conf", "predictor_conf")}, seed)[1]


def _pair(tmp_path, cfg, quantize=False, jax_dtype=None, seed=0):
    """The JAX AutoModel and the port's on the same random weights (the VAD's
    head calibrated): jitted JAX inits, saved for the JAX AutoModel as flax
    trees and for the port through ``convert.*_from_jax``."""
    from funasr_tpu.models.paraformer.model import Paraformer as JaxParaformer

    conf = {k: cfg[k] for k in ("vocab_size", "input_size", "encoder_conf", "decoder_conf",
                                "predictor_conf")}
    if cfg["model"] == "BiCifParaformer":
        asr = bicif_params(seed) if cfg == asr_cfg() else _init(conf, seed)[1]
        convert = C.bicif_paraformer_from_jax
    else:
        jm = JaxParaformer(**conf)
        asr = jax.tree_util.tree_map(np.asarray, jax.jit(lambda key: jm.init(
            {"params": key}, jnp.zeros((1, 16, 560)), jnp.array([16]), max_tokens=8,
            method=jm.greedy_decode))(jax.random.PRNGKey(seed)))
        convert = C.paraformer_from_jax
    vad, punc = vad_params(seed), punc_params(seed)
    jam = JaxAutoModel(
        model=dict(cfg, init_param=_save_flax(tmp_path / "j_asr.npz", asr["params"]),
                   **({"dtype": jax_dtype} if jax_dtype else {})),
        vad_model=dict(VAD_CFG, init_param=_save_flax(tmp_path / "j_vad.npz", vad["params"])),
        punc_model=dict(PUNC_CFG, init_param=_save_flax(tmp_path / "j_punc.npz",
                                                        punc["params"])),
        quantize=quantize)
    files = dict(asr=_save(tmp_path / "asr.npz", convert(asr)),
                 vad=_save(tmp_path / "vad.npz", C.fsmn_vad_from_jax(vad)),
                 punc=_save(tmp_path / "punc.npz", C.ct_transformer_from_jax(punc)))
    return jam, lambda **kw: AutoModel(
        model=dict(cfg, init_param=files["asr"]),
        vad_model=dict(VAD_CFG, init_param=files["vad"]),
        punc_model=dict(PUNC_CFG, init_param=files["punc"]), quantize=quantize,
        device="cpu", **kw)


def _port_frontend():
    from funasr_torch.auto.engines import FrontendConfig

    return FrontendConfig(n_mels=80, lfr_m=5, lfr_n=1)


def _correct_jax_fires(monkeypatch):
    real = JE.BiCifEngine._ts_results

    def fixed(self, wavs, tokens, tok_lens, us_alphas, us_peaks, vad_offsets, us_lens=None):
        return real(self, wavs, tokens, tok_lens, us_alphas,
                    _jax_fires(np.asarray(us_peaks), us_alphas), vad_offsets, us_lens=us_lens)

    monkeypatch.setattr(JE.BiCifEngine, "_ts_results", fixed)


@pytest.fixture(scope="module")
def bicif_pair(tmp_path_factory):
    return _pair(tmp_path_factory.mktemp("bicif"), asr_cfg())


@pytest.mark.parametrize("which", ["test_auto_model", "long"])
def test_generate_bicif_matches_jax(monkeypatch, bicif_pair, which):
    _correct_jax_fires(monkeypatch)
    jam, port = bicif_pair
    am = port()
    wav = recording(0) if which == "test_auto_model" else long_recording()
    segs = am.vad_engine.segments_shared(wav)[0]
    assert segs == jam.vad_engine.segments_shared(wav)[0] and len(segs) >= 2
    want = jam.generate(wav, key=["long"])[0]
    got = am.generate(wav, key=["long"])[0]
    assert got == want
    assert got["text"] and got["timestamp"] and got["sentence_info"]
    assert len(got["timestamp"]) == sum(len(s["timestamp"]) for s in got["sentence_info"])


def test_shared_grid_equals_waveform_path(bicif_pair):
    _, port = bicif_pair
    wav = long_recording()
    shared = port().generate(wav, key=["k"])
    wave = port(shared_frontend=False).generate(wav, key=["k"])
    assert shared == wave and shared[0]["text"]


def test_generate_paraformer_matches_jax(tmp_path):
    """The plain Paraformer serves the waveform path (no fbank-grid entry):
    ``ParaformerEngine.transcribe_async`` with 60 ms CIF stamps."""
    jam, port = _pair(tmp_path, asr_cfg("Paraformer"))
    wav = long_recording()
    got = port().generate(wav, key=["p"])
    assert got == jam.generate(wav, key=["p"]) and got[0]["timestamp"]
    joint = port().generate(wav, key=["p"], punc_mode="joint")
    assert joint == jam.generate(wav, key=["p"], punc_mode="joint")


def test_generate_int8_matches_jax(monkeypatch, tmp_path):
    from funasr_tpu.models.bicif_paraformer import model as JBM
    from funasr_tpu.ops import decoder_layer_pallas as JDL
    from funasr_tpu.ops import ffn_pallas as JFP
    from funasr_tpu.ops import quant as JQ
    from funasr_tpu.ops import sanm_layer_pallas as JSL
    from funasr_torch.auto import engines as TE

    _correct_jax_fires(monkeypatch)
    calls = {"sanm": 0}

    def sanm_spy(*a, f=JSL._call, **k):
        calls["sanm"] += 1
        assert not k.get("int8_attn")
        return f(*a, **k)

    for mod in (JSL, JDL, JFP):
        monkeypatch.setattr(mod, "enabled", lambda: True)
    monkeypatch.setattr(JSL, "_call", sanm_spy)
    jam, port = _pair(tmp_path, asr_cfg(conf=_conf(256, 2, 256, 3, 2)), quantize=True,
                      jax_dtype="bfloat16")

    def timestamps(self, speech, speech_lengths, max_tokens=128):
        """JAX's ``timestamps`` and its log-probs and input features."""
        log_probs, token_lengths, pred = self.inference_logits(speech, speech_lengths,
                                                               max_tokens)
        return (jnp.argmax(log_probs, axis=-1), token_lengths, pred.us_alphas, pred.us_peaks,
                log_probs, speech, speech_lengths)

    monkeypatch.setattr(JBM.BiCifParaformer, "timestamps", timestamps)
    outs = {"jax": [], "port": []}
    real_fb = JE.BiCifEngine._fb_runner

    def fb_runner(self):
        """JAX's device program op by op; its first four outputs go on to the
        JAX pipeline."""
        run = real_fb(self)

        def op_by_op(*a):
            with jax.disable_jit():
                out = run(*a)
            outs["jax"].append([np.asarray(x) for x in out])
            return out[:4]
        return op_by_op

    monkeypatch.setattr(JE.BiCifEngine, "_fb_runner", fb_runner)
    real_run = TE.BiCifEngine.run_ts_fbank

    def run_ts_fbank(self, *a):
        out = real_run(self, *a)
        outs["port"].append([x.numpy() for x in out])
        return out

    monkeypatch.setattr(TE.BiCifEngine, "run_ts_fbank", run_ts_fbank)
    am = port()
    assert am.engine.module.quantize and am.engine.module.dtype == torch.bfloat16
    assert not am.engine.module.encoder.encoders[0].int8_attn
    wav = long_recording()
    assert am.vad_engine.segments_shared(wav)[0] == jam.vad_engine.segments_shared(wav)[0]
    got = am.generate(wav, key=["q"])[0]
    with pltpu.force_tpu_interpret_mode():
        want = jam.generate(wav, key=["q"])[0]
    assert calls["sanm"] and len(outs["jax"]) == len(outs["port"]) >= 1
    same = clear = clear_same = n = low_diff = 0
    for (gt, gl, _, gp), (wt, wl, wa, wp, lp, _, _) in zip(outs["port"], outs["jax"]):
        np.testing.assert_array_equal(gl, wl)
        for g, w in zip(gp, _jax_fires(wp, wa)):
            g, w = np.nonzero(g)[0], np.nonzero(w)[0]
            assert len(g) == len(w) > 0 and np.abs(g - w).max() <= FIRE_FRAMES, (g, w)
        top2 = np.sort(lp.astype(np.float32), axis=-1)[..., -2:]
        for b, u in enumerate(wl.tolist()):
            eq = gt[b, :u] == wt[b, :u]
            sure = top2[b, :u, 1] - top2[b, :u, 0] > 2 * LOGP_ATOL
            same, n = same + eq.sum(), n + u
            clear, clear_same = clear + sure.sum(), clear_same + (eq & sure).sum()
            low_diff += (~eq & ~sure).sum()
    assert clear >= 8 and clear_same >= MIN_AGREE * clear, (clear_same, clear)
    assert same >= MIN_AGREE_ALL * n, (same, n)
    assert got["text"] and want["text"] and got["timestamp"]
    assert abs(len(got["timestamp"]) - len(want["timestamp"])) <= low_diff, (
        len(got["timestamp"]), len(want["timestamp"]), low_diff)
    assert len(got["timestamp"]) == sum(len(s["timestamp"]) for s in got["sentence_info"])

    # the pinned JAX finding: its jitted program is not its op-by-op function
    speech, lens = (jnp.asarray(x) for x in outs["jax"][0][5:7])
    module, params = jam.engine.module, jam.engine.params
    encode = lambda p, x, l: module.apply(p, x, l, True, method=module.encode)[0]
    with JQ.quantized(True), pltpu.force_tpu_interpret_mode():
        op_enc = encode(params, speech, lens)
        jit_enc = jax.jit(encode)(params, speech, lens)
    with torch.inference_mode():
        port_enc = am.engine.module.encode(torch.from_numpy(np.asarray(speech, np.float32)),
                                           torch.from_numpy(np.asarray(lens)))[0]
    f32 = lambda x: np.asarray(x, np.float32)[0, :int(lens[0])]
    port_gap = np.abs(f32(port_enc.float()) - f32(op_enc.astype(jnp.float32))).max()
    jit_gap = np.abs(f32(jit_enc.astype(jnp.float32)) - f32(op_enc.astype(jnp.float32))).max()
    assert jit_gap > JIT_GAP * port_gap, (jit_gap, port_gap)


def test_edges_and_not_ported(monkeypatch, bicif_pair, tmp_path):
    from funasr_torch.auto import engines as TE

    _correct_jax_fires(monkeypatch)
    jam, port = bicif_pair
    am = port()
    short = np.zeros(300, np.float32)  # under one frame: no segment
    assert am.generate(short, key=["s"]) == jam.generate(short, key=["s"]) == \
        [{"key": "s", "text": ""}]
    silence = np.zeros(32000, np.float32)
    spk = AutoModel(model=asr_cfg(), spk_model=CAMP_CFG, device="cpu")
    assert spk.spk_engine.model.embedding_size == 16 and spk.spk_engine.device.type == "cpu"
    assert AutoModel(model=asr_cfg(), use_itn=True, device="cpu").kwargs == {"use_itn": True}
    assert am.generate(silence, key=["s"], hotword="公园") == \
        jam.generate(silence, key=["s"], hotword="公园")
    assert am.generate(silence, key=["s"], use_itn=True, language="zh", merge_vad=True) == \
        jam.generate(silence, key=["s"], use_itn=True, language="zh", merge_vad=True)
    with pytest.raises(NotImplementedError):
        am.generate(silence, output_dir=str(tmp_path))
    # ContextualParaformer, ported: the hotword engine without SeACo's head
    # (its parity: tests/test_torch_contextual.py)
    ctx = AutoModel(model=dict(asr_cfg("Paraformer"), model="ContextualParaformer",
                               model_conf=dict(inner_dim=32)), device="cpu")
    assert isinstance(ctx.engine, TE.HotwordEngine) and not ctx.engine.seaco
    out = ctx.generate(silence, key=["c"], hotword="公园")
    assert out[0]["key"] == "c" and "raw_tokens" in out[0] and "timestamp" not in out[0]
    with pytest.raises(NotImplementedError, match="URL"):
        am.generate("https://example.invalid/a.wav")
    with pytest.raises(ValueError, match="unsupported audio format"):
        am.generate(str(tmp_path / "a.mp3"))
    hybrid = dict(model="Conformer", vocab_size=len(TOKENS),
                  tokenizer_conf={"token_list": TOKENS},
                  frontend_conf=dict(n_mels=80, lfr_m=1, lfr_n=1), input_size=80,
                  encoder_conf=dict(output_size=16, attention_heads=2, linear_units=16,
                                    num_blocks=1, cnn_module_kernel=3),
                  decoder_conf=dict(attention_heads=2, linear_units=16, num_blocks=1),
                  decoding_conf=dict(beam_size=2, maxlenratio_tokens=4))
    # a hybrid main model with a VAD, ported: CTC-alignment timestamps (its
    # parity: tests/test_torch_hybrid_align.py)
    res = AutoModel(model=hybrid, vad_model=VAD_CFG, device="cpu").generate(recording(0),
                                                                          key=["h"])
    assert res[0]["key"] == "h" and isinstance(res[0]["text"], str) and "timestamp" in res[0]
    with pytest.raises(NotImplementedError, match="no engine"):
        AutoModel(model=dict(asr_cfg(), model="WhisperModel"), device="cpu")
    with pytest.raises(NotImplementedError, match="qmm"):
        AutoModel(model=SV_CFG, quantize=True, qmm=True, device="cpu")


def test_standalone_vad_and_punc_models(bicif_pair, tmp_path):
    """A VAD config as the main model gives segment lists; a CT-Transformer
    config as the main model punctuates text; wav files load."""
    import wave

    jam, port = bicif_pair
    am = port()
    wav = recording(0)
    vad_only = AutoModel(model=am_vad_cfg(tmp_path, jam), device="cpu")
    segs = am.vad_engine.segments(wav)
    assert vad_only.generate(wav, key=["v"]) == [{"text": "", "value": segs, "key": "v"}]
    path = tmp_path / "x.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1), w.setsampwidth(2), w.setframerate(8000)
        w.writeframes((np.clip(wav[::2], -1, 1) * 32767).astype("<i2").tobytes())
    res = vad_only.generate(str(path))
    assert res[0]["key"] == "x" and len(res[0]["value"]) == len(segs)
    text = "".join(TOKENS[4:20]) * 3
    punc = AutoModel(model=dict(PUNC_CFG), device="cpu")
    out = punc.generate(text, key=["t"])
    assert out[0]["key"] == "t" and out[0]["text"] and len(out[0]["punc_array"]) == len(text)


def am_vad_cfg(tmp_path, jam):
    return dict(VAD_CFG, init_param=_save(tmp_path / "v.npz",
                                          C.fsmn_vad_from_jax(jam.vad_engine.model.params)))



def test_past_15s_int8_encoder_against_jax_xla_path():
    """T = 384 LFR frames at D = 512, the served bucket after 256: past the
    JAX package's fused-layer gate, so the JAX package runs its XLA int8
    module path (bf16 projections under the QDense gate, casts between ops)
    while the port keeps the fused int8 layers' function at every length."""
    from funasr_tpu.models.sanm import SANMEncoder as JaxEncoder
    from funasr_tpu.ops import quant as JQ
    from funasr_tpu.ops import sanm_layer_pallas as JSL
    from funasr_torch.models.sanm import SANMEncoder

    T, D, H = 384, 512, 2048
    conf = dict(input_size=560, output_size=D, attention_heads=4, linear_units=H,
                num_blocks=3, kernel_size=11)
    assert not JSL.enabled() and JSL.supported(256, D, H, 4) and not JSL.supported(T, D, H, 4)
    assert JSL.supported(312, D, H, 4) and not JSL.supported(320, D, H, 4)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, T, 560)).astype(np.float32)
    lens = np.array([T, 301], np.int32)
    je = JaxEncoder(**conf, dropout_rate=0.0, dtype=jnp.bfloat16)
    p = jax.jit(je.init)(jax.random.PRNGKey(5), jnp.asarray(x), jnp.asarray(lens))
    with JQ.quantized(True):
        want, _ = jax.jit(je.apply)(p, jnp.asarray(x), jnp.asarray(lens))
    want = np.asarray(want.astype(jnp.float32))
    sd = {}
    C._encoder(sd, "encoder", jax.tree_util.tree_map(np.asarray, p["params"]))
    te = SANMEncoder(**conf, dtype=torch.bfloat16, param_dtype=torch.float32)
    te.load_state_dict({k[len("encoder."):]: v for k, v in sd.items()}, strict=True)
    te.quantize_weights()
    with torch.no_grad():
        got, _ = te(torch.from_numpy(x), torch.from_numpy(lens))
    got = got.float().numpy()
    valid = np.arange(T)[None] < lens[:, None]
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want[valid]).max())) - 7)
    err = np.abs(got - want)[valid].max()
    assert np.isfinite(got).all() and err <= BAR_ULPS * ulp, (err, ulp)


# ------------------------------------------- SeACo hotwords and CAM++ speakers
NB = len(TOKENS) - 1
SEACO_CFG = dict(asr_cfg(), model="SeacoParaformer", model_conf=dict(
    inner_dim=32, no_bias_id=NB, seaco_decoder_conf=dict(
        attention_heads=2, linear_units=64, num_blocks=2, att_layer_num=2, kernel_size=5)))
CAMP_CFG = dict(model="CAMPPlus", model_conf=dict(
    feat_dim=80, embedding_size=16, growth_rate=8, bn_size=2, init_channels=16,
    blocks=((2, 3, 1), (2, 3, 2))))
HOTWORD = " ".join(TOKENS[5:8]) + " " + TOKENS[10] + TOKENS[11] + " zz"


def diarization_recording(seed=5):
    """Eight 1.5-3 s bursts, alternately 220 and 330 Hz, 0.75 s apart."""
    rng = np.random.default_rng(seed)
    parts = [np.zeros(8000, np.float32)]
    for i in range(8):
        parts += [tone(rng, float(rng.uniform(1.5, 3.0)), 220.0 if i % 2 == 0 else 330.0),
                  np.zeros(12000, np.float32)]
    return np.concatenate(parts)


def _save_variables(path, variables):
    """Flax variables (``params`` and ``batch_stats``) as the JAX AutoModel's
    ``init_param``."""
    flat = {}
    for coll, tree in variables.items():
        _save_flax(path, tree, prefix=coll)
        flat.update(np.load(path))
    np.savez(path, **flat)
    return str(path)


@pytest.fixture(scope="module")
def seaco_spk_pair(tmp_path_factory):
    from tests.test_torch_campplus import init_campplus
    from tests.test_torch_seaco import init_seaco

    tmp = tmp_path_factory.mktemp("seaco_spk")
    conf = {k: SEACO_CFG[k] for k in ("vocab_size", "input_size", "encoder_conf",
                                      "decoder_conf", "predictor_conf")}
    _, asr = init_seaco(dict(conf, **SEACO_CFG["model_conf"]), 0)
    _, spk = init_campplus(CAMP_CFG["model_conf"], 1)
    vad, punc = vad_params(0), punc_params(0)
    jam = JaxAutoModel(
        model=dict(SEACO_CFG, init_param=_save_flax(tmp / "j_asr.npz", asr["params"])),
        vad_model=dict(VAD_CFG, init_param=_save_flax(tmp / "j_vad.npz", vad["params"])),
        punc_model=dict(PUNC_CFG, init_param=_save_flax(tmp / "j_punc.npz", punc["params"])),
        spk_model=dict(CAMP_CFG, init_param=_save_variables(tmp / "j_spk.npz", spk)))
    am = AutoModel(
        model=dict(SEACO_CFG, init_param=_save(tmp / "asr.npz",
                                               C.seaco_paraformer_from_jax(asr))),
        vad_model=dict(VAD_CFG, init_param=_save(tmp / "vad.npz", C.fsmn_vad_from_jax(vad))),
        punc_model=dict(PUNC_CFG, init_param=_save(tmp / "punc.npz",
                                                   C.ct_transformer_from_jax(punc))),
        spk_model=dict(CAMP_CFG, init_param=_save(tmp / "spk.npz", C.campplus_from_jax(spk))),
        device="cpu")
    return jam, am


@pytest.mark.parametrize("hotword, n_spk", [(HOTWORD, 2), (None, None)],
                         ids=["hotword_two_speakers", "plain_eigen_gap"])
def test_generate_seaco_spk_matches_jax(monkeypatch, seaco_spk_pair, hotword, n_spk):
    from funasr_torch.auto.engines import HotwordEngine

    _correct_jax_fires(monkeypatch)
    jam, am = seaco_spk_pair
    assert isinstance(am.engine, HotwordEngine)
    wav = diarization_recording()
    kw = {} if hotword is None else dict(hotword=hotword, preset_spk_num=n_spk)
    want = jam.generate(wav, key=["d"], **kw)[0]
    got = am.generate(wav, key=["d"], **kw)[0]
    assert got == want
    assert got["text"] and got["timestamp"] and len(got["spk_info"]) >= 20
    assert {s["spk"] for s in got["sentence_info"]} <= {l for _, _, l in got["spk_info"]}
    assert all(b - a == 1500 for a, b, _ in got["spk_info"])
    if n_spk:
        assert {l for _, _, l in got["spk_info"]} == set(range(n_spk))


def test_hotword_changes_the_seaco_text(seaco_spk_pair):
    """The bias head is in the path: a hotword changes the decoded text, and
    its call (the waveform path) without the hotword equals the shared-grid
    result."""
    _, am = seaco_spk_pair
    wav = diarization_recording()
    plain = am.generate(wav, key=["d"])[0]
    biased = am.generate(wav, key=["d"], hotword=HOTWORD)[0]
    assert plain["text"] != biased["text"] and plain["spk_info"] == biased["spk_info"]
    am.shared_frontend = False
    try:
        assert am.generate(wav, key=["d"])[0] == plain
    finally:
        am.shared_frontend = True
    am.warmup(seconds=(2,))


def test_hotword_on_bicif_is_ignored_as_in_jax(monkeypatch, bicif_pair):
    """A main model without a bias head takes and ignores ``hotword=``, as
    the JAX engines do (only the waveform path is chosen)."""
    _correct_jax_fires(monkeypatch)
    jam, port = bicif_pair
    am = port()
    wav = recording(0)
    got = am.generate(wav, key=["h"], hotword=HOTWORD)
    assert got == jam.generate(wav, key=["h"], hotword=HOTWORD) == am.generate(wav, key=["h"])
    assert got[0]["text"]


# ------------------------------------------- SenseVoice and inverse text normalization
SV_CFG = dict(model="SenseVoiceSmall", encoder="SenseVoiceEncoderSmall",
              tokenizer="CharTokenizer", frontend_conf=dict(fs=16000, n_mels=80, lfr_m=7,
                                                            lfr_n=6),
              **{k: v for k, v in SV_CONF.items() if k != "vocab_size"},
              vocab_size=len(SV_TOKENS), tokenizer_conf={"token_list": SV_TOKENS})
README_KW = dict(language="auto", use_itn=True, batch_size_s=60, merge_vad=True,
                 merge_length_s=15)
VAD_README_CONF = {"model_conf": {"max_single_segment_time": 30000}}


@pytest.fixture(scope="module")
def sensevoice_pair(tmp_path_factory):
    """The JAX AutoModel and the port's with SenseVoice as the main model and
    the calibrated VAD, on the same weights and CMVN file."""
    from tests.test_torch_sensevoice import feature_cmvn, init_sense_voice, write_cmvn

    tmp = tmp_path_factory.mktemp("sensevoice")
    _, sv = init_sense_voice(SV_CONF, 0)
    vad = vad_params(0)
    cfg = dict(SV_CFG, cmvn_file=write_cmvn(tmp / "am.mvn", feature_cmvn([long_recording()])))
    jam = JaxAutoModel(
        model=dict(cfg, init_param=_save_flax(tmp / "j_sv.npz", sv["params"])),
        vad_model=dict(VAD_CFG, init_param=_save_flax(tmp / "j_vad.npz", vad["params"])),
        vad_conf=VAD_README_CONF)
    files = dict(sv=_save(tmp / "sv.npz", C.sense_voice_from_jax(sv)),
                 vad=_save(tmp / "vad.npz", C.fsmn_vad_from_jax(vad)),
                 jax_sv=str(tmp / "j_sv.npz"))
    port = lambda vad_model=True, **kw: AutoModel(
        model=dict(cfg, init_param=files["sv"]),
        vad_model=dict(VAD_CFG, init_param=files["vad"]) if vad_model else None,
        vad_conf=VAD_README_CONF, device="cpu", **kw)
    return jam, port, cfg, files


@pytest.mark.parametrize("language", ["auto", "zh"])
def test_readme_call_sensevoice_matches_jax(sensevoice_pair, language):
    from funasr_torch.auto.engines import SenseVoiceEngine

    jam, port, _, _ = sensevoice_pair
    am = port()
    assert isinstance(am.engine, SenseVoiceEngine)
    assert am.vad_engine.model.opts.max_single_segment_time == 30000
    wav = long_recording()
    kw = dict(README_KW, language=language)
    got = am.generate(wav, key=["sv"], **kw)
    assert got == jam.generate(wav, key=["sv"], **kw)
    r = got[0]
    assert r["text"] and len(r["timestamp"]) >= 4 and "<|" not in r["text"]
    assert all(0 <= a <= b <= len(wav) // 16 for a, b in r["timestamp"])
    plain = am.generate(wav, key=["sv"], **dict(kw, use_itn=False))[0]
    assert plain["timestamp"] == r["timestamp"]
    assert (plain["text"] != r["text"]) == (language == "zh")  # "auto": no ITN language
    assert port(use_itn=True).generate(wav, key=["sv"], **dict(kw, use_itn=False)) == got


@pytest.mark.parametrize("main", ["sensevoice", "bicif"])
def test_plain_path_itn_matches_jax(monkeypatch, tmp_path, sensevoice_pair, main):
    """Without a VAD: SenseVoice gets ``use_itn`` as its text-norm prompt (the
    call's ``language`` is consumed by the ITN step and never reaches the
    engine, as in the JAX package); other engines' texts go through ITN."""
    from tests.test_torch_vad import tone

    _correct_jax_fires(monkeypatch)
    if main == "sensevoice":
        _, port, cfg, files = sensevoice_pair
        am = port(vad_model=False)
        jam = JaxAutoModel(model=dict(cfg, init_param=files["jax_sv"]))
    else:
        cfg, tree = asr_cfg(), bicif_params(0)
        am = AutoModel(model=dict(cfg, init_param=_save(
            tmp_path / "asr.npz", C.bicif_paraformer_from_jax(tree))), device="cpu")
        jam = JaxAutoModel(model=dict(cfg, init_param=_save_flax(tmp_path / "j_asr.npz",
                                                                 tree["params"])))
    rng = np.random.default_rng(9)
    wavs = [tone(rng, 1.1, 260.0), tone(rng, 2.3, 190.0)]
    for kw in ({"use_itn": True, "language": "zh"}, {"use_itn": False}, {"use_itn": True}):
        got = am.generate(wavs, key=["a", "b"], **kw)
        assert got == jam.generate(wavs, key=["a", "b"], **kw), kw
        assert all(r["text"] for r in got)


@pytest.mark.parametrize("punc_mode", ["segment", "joint"])
def test_bicif_pipeline_itn_matches_jax(monkeypatch, bicif_pair, punc_mode):
    _correct_jax_fires(monkeypatch)
    jam, port = bicif_pair
    am = port()
    wav = long_recording()
    kw = dict(use_itn=True, language="zh", punc_mode=punc_mode)
    got = am.generate(wav, key=["i"], **kw)
    assert got == jam.generate(wav, key=["i"], **kw)
    assert got[0]["text"] and got[0]["sentence_info"]
    assert port(use_itn=True).generate(wav, key=["i"], language="zh",
                                       punc_mode=punc_mode) == got
