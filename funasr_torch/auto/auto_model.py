"""AutoModel: the user-facing pipeline API (port of funasr_tpu/auto/auto_model.py;
reference funasr/auto/auto_model.py:111).

Builds the main ASR model and, optionally, a VAD, a punctuation and a
speaker model from configs, and exposes ``generate()``:

- plain batched inference without a VAD;
- with a VAD, the long-audio pipeline (``_inference_with_vad``, reference
  auto_model.py:378): VAD segments -> ``merge_vad`` -> segments sorted by
  length -> greedy batches under the ``batch_size_s`` budget -> every
  batch's ASR dispatched before any is finalized -> segment texts joined ->
  punctuation (``punc_mode`` "segment": one batched device call per window
  round; "joint": one window chain over the joined text) ->
  ``sentence_info`` from the timestamps.  When the main engine decodes from
  fbank (BiCif) and both frontends share the mel settings, fbank runs once
  over the whole recording in the VAD stage (one kernel launch, its energy
  column the VAD's decibel track) and the ASR stage gathers each segment's
  frames from that grid.

With a speaker model (CAM++, ``spk_model``) the pipeline also cuts each VAD
segment into 1.5 s chunks at a 0.75 s step (``sv_chunk``), embeds them
all in one device call dispatched after the ASR batches, clusters the
embeddings on the host (``ClusterBackend``; ``preset_spk_num`` fixes the
speaker count) into ``spk_info`` and gives each sentence of
``sentence_info`` its speaker (``distribute_spk``).

Main models: Paraformer and EParaformer (their config's ``encoder`` and
``decoder`` by registry name, as in the JAX package: the aishell
Paraformer-Conformer and E-Paraformer recipes), BiCifParaformer,
SeacoParaformer, ContextualParaformer, SenseVoiceSmall, the CTC/attention
hybrids Conformer, Transformer, SANM, Branchformer and EBranchformer, whose
config's ``encoder`` (Conformer, Transformer and SANM), ``decoder``
(``TransformerDecoder`` or ``TransformerRWKVDecoder``) and
``decoding_conf`` are honoured as in the JAX package (``ParaformerEngine``
(EParaformer too, sos/eos filtered by id), ``BiCifEngine``,
``HotwordEngine`` (``seaco=False`` for ContextualParaformer),
``SenseVoiceEngine``, ``HybridEngine``), and SCAMA (``HybridEngine`` with
``decoding_conf``'s beam 5, maxlen 96 and CTC weight 0 by default, as the JAX
AutoModel builds it; no timestamps: ``with_timestamp=True``, the pipeline's
default, raises as the JAX engine fails there, so serve it with
``generate(..., with_timestamp=False)``); the RNN-T models Transducer, BAT and
RWKVBAT (``TransducerEngine``: ``decoder_conf``, ``joint_conf``; behind a VAD
the segment texts joined, no timestamps, as the JAX pipeline gives them);
Emotion2vec (``SerEngine``: ``model_conf`` to the model, float32 always;
``text`` the best label, ``extract_embedding=True`` adds ``feats``);
Whisper, WhisperWrap and WhisperLID as the JAX
AutoModel routes them (``size``, ``model_path_hf`` an openai ``.pt``,
``config_overrides``, ``max_tokens``; bf16 whatever ``dtype``/``quantize``
say; ``WhisperEngine``, which behind a VAD runs each batch when it is
finalized, as the JAX pipeline does for an engine without an async entry;
a tokenizer raises ``NotImplementedError``); a
FsmnVADStreaming, CTTransformer or CTTransformerStreaming config as the main
model serves VAD or punctuation alone (``generate(text)`` the offline
punctuation; the streaming model's ``punctuate_streaming`` with its
tokenizer attached, which the JAX AutoModel leaves out).
``generate(hotword=...)`` decodes a SeacoParaformer or a
ContextualParaformer with its bias; as in the JAX package a call with a
hotword takes the waveform path, not the shared fbank grid, and another
main model ignores the hotword.  Only an engine with ``from_fbank`` (BiCif,
SeACo) takes the shared grid: ContextualParaformer decodes the waveform
path with or without a hotword (the JAX package, whose contextual engine
inherits the fbank entry, fails there without one: ROADMAP.md Queue 3).  A
hybrid main model with a VAD runs its batches one after another, each with
CTC-alignment timestamps of its top hypothesis
(``HybridEngine.transcribe(with_timestamp=True, vad_offsets=...)``).

``quantize=True`` builds the int8 serving models (int8 layers, bf16
activations between them, as ``bench.py`` serves them; a config's
``dtype`` overrides bf16) with the JAX package's two opt-in int8
routes off; ``qmm`` and ``int8_attn`` turn them on (arguments here, the
JAX package's ``FUNASR_TPU_PALLAS_QMM`` / ``FUNASR_TPU_INT8_ATTN``).
Punctuation computes in bf16 when ``quantize=True`` and never takes the
int8 route.

Weights load from ``init_param`` (a key of the main model's config, or an
argument, as the reference's ``AutoModel(model=..., init_param=...)``): a
``.pt`` state dict (``bin/train.py``'s ``model.avg.pt``) or a ``.npz`` of
FunASR torch-layout names (``convert.*_from_jax`` produce them).  Without
weights every model gets seeded random weights (``seed``).  ``device=None``
means the card (raises without one unless ``device="cpu"``).

``use_itn`` (inverse text normalization, ``funasr_torch/text``) follows the
JAX package, quirks included.  Without a VAD, an engine that normalizes
itself (SenseVoice: ``handles_itn``) gets ``use_itn`` as its text-norm
prompt, and any other engine's texts go through
``inverse_normalize(text, language)``; ``language`` is consumed there and
never reaches the engine.  With a VAD (``_inference_with_vad``) ``language``
and ``use_itn`` are taken from the call, the engine decodes with its
defaults (SenseVoice: language "auto", no text-norm prompt), and the joined
text is normalized (``use_itn`` of the call or of the constructor), or each
segment's text before "segment" punctuation.  ``merge_vad`` is accepted and
ignored.

Not ported, and raising ``NotImplementedError`` rather than skipped: the
``CTC`` model class (the JAX AutoModel has no engine for it either), the
convolution Transformer decoders, ``output_dir``, URL inputs; the JAX
package's meshes and parallel serving options are not arguments here.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from funasr_torch.auto.engines import (
    BiCifEngine,
    FrontendConfig,
    HotwordEngine,
    HybridEngine,
    ParaformerEngine,
    PuncEngine,
    SenseVoiceEngine,
    SerEngine,
    SpkEngine,
    TransducerEngine,
    VadEngine,
    WhisperEngine,
)
from funasr_torch.config import deep_update, load_config
from funasr_torch.device import resolve_device
from funasr_torch.models.campplus.cluster import ClusterBackend, distribute_spk, sv_chunk
from funasr_torch.models.paraformer.model import init_random_
from funasr_torch.ops.fbank import load_cmvn_file
from funasr_torch.registry import tables
from funasr_torch.text.itn import inverse_normalize
from funasr_torch.utils import vad_utils
from funasr_torch.utils.audio import load_audio
from funasr_torch.utils.postprocess import join_segment_texts
from funasr_torch.utils.timestamp_tools import timestamp_sentence

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float32": torch.float32, "fp32": torch.float32}
# the CTC/attention hybrids the JAX AutoModel serves through HybridEngine
_HYBRIDS = ("Conformer", "Transformer", "SANM", "Branchformer", "EBranchformer")
# the Whisper classes the JAX AutoModel routes to WhisperEngine (auto_model.py:392)
_WHISPERS = ("Whisper", "WhisperWrap", "WhisperLID")
# the RNN-T classes the JAX AutoModel serves through TransducerEngine (auto_model.py:353)
_TRANSDUCERS = ("Transducer", "BAT", "RWKVBAT")
_PORTED = ("Paraformer", "EParaformer", "BiCifParaformer", "SeacoParaformer",
           "ContextualParaformer", "SenseVoiceSmall") + _HYBRIDS + _TRANSDUCERS + (
               "Emotion2vec",) + _WHISPERS + ("SCAMA",)
# punctuation as the main model: text in (auto_model.py:194)
_PUNCS = ("CTTransformer", "CTTransformerStreaming")


def _resolve_cfg(model: Union[str, Dict, None], conf: Optional[Dict]) -> Dict:
    """A config dict, a YAML file or model directory, or a model class name."""
    if isinstance(model, dict):
        cfg = dict(model)
    elif isinstance(model, str) and (os.path.isdir(model) or os.path.isfile(model)):
        cfg = load_config(model)
    elif isinstance(model, str):
        cfg = {"model": model}
    else:
        cfg = {}
    if conf:
        deep_update(cfg, conf)
    return cfg


def _load_state(cfg: Dict) -> Optional[Dict[str, torch.Tensor]]:
    """``init_param`` (or ``model_path``/model.pt) -> a state dict, or None."""
    path = cfg.get("init_param")
    if not path and cfg.get("model_path"):
        cand = os.path.join(cfg["model_path"], "model.pt")
        path = cand if os.path.exists(cand) else None
    if not path:
        return None
    if str(path).endswith(".npz"):
        with np.load(path, allow_pickle=False) as data:
            return {k: torch.from_numpy(np.array(data[k])) for k in data.files}
    state = torch.load(path, map_location="cpu", weights_only=True)
    return state.get("state_dict", state)


def _weights(module: torch.nn.Module, state: Optional[Dict], seed: int, device,
             prefix: str = "") -> None:
    """Load ``state`` (keys under ``prefix`` taken, the prefix dropped, when
    they carry it) or give ``module`` seeded random weights (its own
    ``init_weights_`` rule where it has one)."""
    if state is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        getattr(module, "init_weights_", lambda g: init_random_(module, g))(gen)
        return
    if prefix and any(k.startswith(prefix) for k in state):
        state = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
    module.load_state_dict(state, strict=True)


def _build_tokenizer(cfg: Dict):
    conf = dict(cfg.get("tokenizer_conf") or {})
    if "token_list" in cfg and "token_list" not in conf:
        conf["token_list"] = cfg["token_list"]
    return tables.get("tokenizer_classes", cfg.get("tokenizer", "CharTokenizer"))(**conf)


def _build_frontend(cfg: Dict, device) -> FrontendConfig:
    """The serving frontend of a config on ``device`` (dither is a training
    setting: the serving extractor is deterministic)."""
    conf = dict(cfg.get("frontend_conf") or {})
    cmvn = None
    cmvn_file = conf.pop("cmvn_file", None) or cfg.get("cmvn_file")
    if cmvn_file and os.path.exists(cmvn_file):
        cmvn = load_cmvn_file(cmvn_file)
    conf.pop("dither", None)
    return FrontendConfig(cmvn=cmvn, device=device, **conf)


class AutoModel:
    def __init__(self, model: Union[str, Dict, None] = None,
                 model_conf: Optional[Dict] = None,
                 vad_model: Union[str, Dict, None] = None, vad_conf: Optional[Dict] = None,
                 punc_model: Union[str, Dict, None] = None,
                 punc_conf: Optional[Dict] = None,
                 spk_model: Union[str, Dict, None] = None, spk_conf: Optional[Dict] = None,
                 seed: int = 0, quantize: bool = False, qmm: bool = False,
                 int8_attn: bool = False, shared_frontend: bool = True, device=None,
                 **kwargs):
        """``shared_frontend=False`` keeps the waveform path in the pipeline
        (the JAX package's ``FUNASR_TPU_DISABLE_SHARED_FRONTEND``);
        ``use_itn=True`` here normalizes every pipeline text, as there;
        ``init_param`` goes into the main model's config."""
        if "init_param" in kwargs:
            model_conf = dict(model_conf or {}, init_param=kwargs.pop("init_param"))
        self.kwargs = kwargs
        self.seed = seed
        self.device = resolve_device(device)
        self._quantize = bool(quantize)
        self._qmm, self._int8_attn = bool(qmm), bool(int8_attn)
        self.shared_frontend = shared_frontend
        self.engine = self.vad_engine = self.punc_engine = self.spk_engine = None
        self.main_cfg: Dict = {}
        if model is not None:
            self.main_cfg = _resolve_cfg(model, model_conf)
            self.engine = self._build_main(self.main_cfg)
        if vad_model is not None:
            self.vad_engine = self._build_vad(_resolve_cfg(vad_model, vad_conf))
        if punc_model is not None:
            self.punc_engine = self._build_punc(_resolve_cfg(punc_model, punc_conf))
        if spk_model is not None:
            self.spk_engine = self._build_spk(_resolve_cfg(spk_model, spk_conf))

    # ------------------------------------------------------------- builders
    def _build_main(self, cfg: Dict):
        name = cfg.get("model", "Paraformer")
        if name in _PUNCS:
            return self._build_punc(cfg)
        if name == "FsmnVADStreaming":  # standalone VAD: segment lists out
            return self._build_vad(cfg)
        if name in _WHISPERS:
            return self._build_whisper(cfg)
        if name == "Emotion2vec":
            return self._build_emotion2vec(cfg)
        if name not in _PORTED:
            raise NotImplementedError(
                f"AutoModel: no engine for model class {name!r} in the port (ported: "
                f"{', '.join(_PORTED)}; not yet: CTC, which the JAX AutoModel does not "
                "build either, and the convolution Transformer decoders)")
        tokenizer = _build_tokenizer(cfg)
        frontend = _build_frontend(cfg, self.device)
        dtype = cfg.get("dtype") or ("bfloat16" if self._quantize else "float32")
        if dtype not in _DTYPES:
            raise ValueError(f"unsupported dtype {dtype!r}")
        if name == "SenseVoiceSmall":
            return self._build_sense_voice(cfg, tokenizer, frontend, _DTYPES[dtype])
        if name in _TRANSDUCERS:
            return self._build_transducer(cfg, tokenizer, frontend, _DTYPES[dtype])
        common = dict(vocab_size=cfg.get("vocab_size") or tokenizer.get_vocab_size(),
                      input_size=cfg.get("input_size", frontend.n_mels * frontend.lfr_m),
                      encoder_conf=cfg.get("encoder_conf"),
                      decoder_conf=cfg.get("decoder_conf"), dtype=_DTYPES[dtype],
                      device=self.device, quantize=self._quantize,
                      **(cfg.get("model_conf") or {}))
        cls = tables.get("model_classes", name)
        if name in _HYBRIDS:
            # the JAX AutoModel passes the config's encoder to these three only
            # (auto_model.py:324-350)
            kw = ({"encoder_name": cfg["encoder"]}
                  if name in ("Conformer", "Transformer", "SANM") and cfg.get("encoder") else {})
            module = cls(decoder=cfg.get("decoder", "TransformerDecoder"), **common, **kw)
        else:
            kw = {}
            if name in ("Paraformer", "EParaformer"):  # by name (auto_model.py:281-310)
                kw = dict(encoder_name=cfg.get("encoder"), decoder_name=cfg.get("decoder"))
            elif name == "SCAMA":  # its decoder by the class (auto_model.py:259-264)
                kw = dict(encoder_name=cfg.get("encoder"))
            else:
                dec = ("ContextualParaformerDecoder" if name == "ContextualParaformer"
                       else "ParaformerSANMDecoder")
                for key, want in (("encoder", "SANMEncoder"), ("decoder", dec)):
                    if cfg.get(key, want) != want:
                        raise NotImplementedError(f"AutoModel: {key} {cfg[key]!r} "
                                                  f"({want} only)")
            module = cls(**common, predictor_conf=cfg.get("predictor_conf"),
                         qmm=self._qmm, int8_attn=self._int8_attn, **kw)
        _weights(module, _load_state(cfg), self.seed, self.device)
        if self._quantize:
            module.quantize_weights()
        if name in _HYBRIDS or name == "SCAMA":
            # SCAMA: the JAX route's beam defaults (auto_model.py:255-279)
            dec = cfg.get("decoding_conf") or {}
            scama = name == "SCAMA"
            return HybridEngine(module, frontend, tokenizer,
                                beam=dec.get("beam_size", 5 if scama else 10),
                                maxlen=dec.get("maxlenratio_tokens", 96),
                                decoding_ctc_weight=dec.get("decoding_ctc_weight",
                                                            0.0 if scama else 0.3),
                                device=self.device)
        if name in ("SeacoParaformer", "ContextualParaformer"):
            return HotwordEngine(module, frontend, tokenizer, blank_id=module.blank_id,
                                 device=self.device, seaco=name == "SeacoParaformer")
        eng = BiCifEngine if name == "BiCifParaformer" else ParaformerEngine
        return eng(module, frontend, tokenizer, blank_id=module.blank_id, device=self.device)

    def _build_whisper(self, cfg: Dict) -> WhisperEngine:
        """The JAX route (auto_model.py:392-402): ``size``, ``model_path_hf``
        (an openai ``.pt``), ``config_overrides``, ``max_tokens``; bf16 whatever
        ``dtype``/``quantize`` say; seeded random weights without a path."""
        if cfg.get("tokenizer") or cfg.get("tokenizer_conf"):
            raise NotImplementedError("AutoModel: a Whisper tokenizer is not ported (the JAX "
                                      "package's WhisperTokenizer needs HF tokenizer files)")
        if cfg.get("init_param"):
            raise NotImplementedError("AutoModel: Whisper weights load from model_path_hf "
                                      "(an openai-whisper .pt), not init_param")
        module = tables.get("model_classes", cfg["model"])(
            size=cfg.get("size", "tiny"), model_path=cfg.get("model_path_hf"),
            config_overrides=cfg.get("config_overrides", {}), device=self.device,
            seed=self.seed)
        return WhisperEngine(module, None, max_tokens=cfg.get("max_tokens", 64))

    def _build_transducer(self, cfg: Dict, tokenizer, frontend: FrontendConfig,
                          dtype: torch.dtype) -> TransducerEngine:
        """The JAX route (auto_model.py:353-369): ``decoder_conf``,
        ``joint_conf``, ``encoder_conf`` and ``model_conf``; the engine's
        defaults (128 tokens, blank 0)."""
        module = tables.get("model_classes", cfg["model"])(
            vocab_size=cfg.get("vocab_size") or tokenizer.get_vocab_size(),
            input_size=cfg.get("input_size", frontend.n_mels * frontend.lfr_m),
            encoder_conf=cfg.get("encoder_conf"), decoder_conf=cfg.get("decoder_conf"),
            joint_conf=cfg.get("joint_conf"), dtype=dtype, device=self.device,
            quantize=self._quantize, **(cfg.get("model_conf") or {}))
        _weights(module, _load_state(cfg), self.seed, self.device)
        if self._quantize:
            module.quantize_weights()
        return TransducerEngine(module, frontend, tokenizer, device=self.device)

    def _build_emotion2vec(self, cfg: Dict) -> SerEngine:
        """The JAX route (auto_model.py:370-391): ``model_conf`` to the model,
        float32 whatever ``dtype``/``quantize`` say, as there."""
        model = tables.get("model_classes", "Emotion2vec")(
            **(cfg.get("model_conf") or {}), device=self.device)
        _weights(model, _load_state(cfg), self.seed, self.device)
        return SerEngine(model)

    def _build_sense_voice(self, cfg: Dict, tokenizer, frontend: FrontendConfig,
                           dtype: torch.dtype) -> SenseVoiceEngine:
        if self._qmm or self._int8_attn:
            raise NotImplementedError("AutoModel: the qmm / int8_attn routes are not "
                                      "ported for SenseVoiceSmall")
        if cfg.get("encoder", "SenseVoiceEncoderSmall") != "SenseVoiceEncoderSmall":
            raise NotImplementedError(f"AutoModel: encoder {cfg['encoder']!r} "
                                      "(SenseVoiceEncoderSmall only)")
        module = tables.get("model_classes", "SenseVoiceSmall")(
            vocab_size=cfg.get("vocab_size") or tokenizer.get_vocab_size(),
            input_size=cfg.get("input_size", frontend.n_mels * frontend.lfr_m),
            encoder_conf=cfg.get("encoder_conf"), dtype=dtype, device=self.device,
            quantize=self._quantize, **(cfg.get("model_conf") or {}))
        _weights(module, _load_state(cfg), self.seed, self.device)
        if self._quantize:
            module.quantize_weights()
        return SenseVoiceEngine(module, frontend, tokenizer, device=self.device)

    def _build_vad(self, cfg: Dict) -> VadEngine:
        cls = tables.get("model_classes", cfg.get("model", "FsmnVADStreaming"))
        model = cls(encoder=cfg.get("encoder", "FSMN"), encoder_conf=cfg.get("encoder_conf"),
                    device=self.device, **(cfg.get("model_conf") or {}))
        _weights(model.scorer, _load_state(cfg), self.seed, self.device, prefix="encoder.")
        return VadEngine(model, _build_frontend(cfg, self.device))

    def _build_punc(self, cfg: Dict) -> PuncEngine:
        tokenizer = _build_tokenizer(cfg)
        cls = tables.get("model_classes", cfg.get("model", "CTTransformer"))
        model = cls(vocab_size=cfg.get("vocab_size") or tokenizer.get_vocab_size(),
                    punc_list=cfg.get("punc_list", ("<unk>", "_", "，", "。", "？", "、")),
                    embed_unit=cfg.get("embed_unit", 256), att_unit=cfg.get("att_unit", 256),
                    encoder=cfg.get("encoder", "SANMEncoder"),
                    encoder_conf=cfg.get("encoder_conf"),
                    dtype=cfg.get("dtype", "bfloat16" if self._quantize else "float32"),
                    device=self.device)
        _weights(model.module, _load_state(cfg), self.seed, self.device)
        if hasattr(model, "set_tokenizer"):
            # the streaming model's words -> ids; the JAX _build_punc attaches
            # none, so its punctuate_streaming raises there
            model.set_tokenizer(tokenizer)
        return PuncEngine(model, tokenizer)

    def _build_spk(self, cfg: Dict) -> SpkEngine:
        cls = tables.get("model_classes", cfg.get("model", "CAMPPlus"))
        model = cls(**(cfg.get("model_conf") or {}), device=self.device)
        _weights(model, _load_state(cfg), self.seed, self.device)
        return SpkEngine(model)

    # ------------------------------------------------------------ generate
    def generate(self, input, fs: int = 16000, key: Optional[List[str]] = None,
                 batch_size: int = 16, output_dir: Optional[str] = None, **kwargs):
        """Transcribe ``input`` (a waveform, PCM16 bytes, a .wav/.pcm path, a
        .scp or .jsonl list, or a list of these; ``fs`` is the rate of raw
        inputs) -> one result dict per input, with its ``key``."""
        if output_dir is not None:
            raise NotImplementedError("AutoModel.generate: output_dir is not ported")
        if isinstance(self.engine, PuncEngine):
            texts = [input] if isinstance(input, str) else list(input)
            keys = key or [f"punc{i}" for i in range(len(texts))]
            return [dict(key=k, **self.engine.punctuate(t)) for k, t in zip(keys, texts)]
        target_fs = 16000
        for eng in (self.engine, self.vad_engine):
            fe = getattr(eng, "frontend", None)
            if fe is not None:
                target_fs = fe.fs
                break
        wavs, keys = self._prepare_inputs(input, target_fs, key, audio_fs=fs)
        if self.engine is None and self.vad_engine is not None:  # VAD alone
            results = self.vad_engine.transcribe(wavs)
            for r, k in zip(results, keys):
                r["key"] = k
            return results
        if self.vad_engine is not None:
            return [self._inference_with_vad(w, k, fs=target_fs, **kwargs)
                    for w, k in zip(wavs, keys)]
        # without a VAD there is no speaker branch; a hotword reaches only a
        # hotword engine (the JAX engines take and ignore it)
        kwargs.pop("preset_spk_num", None)
        hotword = kwargs.pop("hotword", None)
        if hotword is not None and isinstance(self.engine, HotwordEngine):
            kwargs["hotword"] = hotword
        use_itn = kwargs.pop("use_itn", False)
        itn_lang = kwargs.pop("language", "zh")
        if getattr(self.engine, "handles_itn", False):  # the prompt token
            kwargs["use_itn"] = use_itn
            use_itn = False
        results = []
        for i in range(0, len(wavs), batch_size):
            for j, r in enumerate(self.engine.transcribe(wavs[i: i + batch_size], **kwargs)):
                r["key"] = keys[i + j]
                if use_itn and r.get("text"):
                    r["text"] = inverse_normalize(r["text"], itn_lang)
                results.append(r)
        return results

    def warmup(self, batch_sizes=(1,), seconds=(15,), fs: int = 16000) -> None:
        """Run each engine once per (batch, seconds) bucket: builds the CUDA
        kernels and the libraries' handles before live traffic.  Each engine
        runs directly: through ``generate`` silence gives no VAD segment and
        the ASR stage would never run."""
        for b in batch_sizes:
            for s in seconds:
                wavs = [np.zeros(int(s * fs), np.float32)] * int(b)
                if self.engine is not None and hasattr(self.engine, "transcribe"):
                    self.engine.transcribe(wavs)
                if self.vad_engine is not None:
                    self.vad_engine.transcribe(wavs)
        if self.punc_engine is not None:
            self.punc_engine.punctuate("warmup")
        if self.spk_engine is not None:  # a failure here surfaces
            self.spk_engine.embed([np.zeros(int(seconds[0] * fs), np.float32)])

    def _prepare_inputs(self, input, fs, key, audio_fs=None):
        items = input if isinstance(input, (list, tuple)) else [input]
        expanded, keys = [], []
        for i, x in enumerate(items):
            if isinstance(x, str) and x.endswith(".scp"):
                with open(x, encoding="utf-8") as f:
                    for line in f:
                        parts = line.strip().split(maxsplit=1)
                        if len(parts) == 2:
                            keys.append(parts[0])
                            expanded.append(parts[1])
                continue
            if isinstance(x, str) and x.endswith(".jsonl"):
                with open(x, encoding="utf-8") as f:
                    for line in f:
                        if not line.strip():
                            continue
                        rec = json.loads(line)
                        src = rec.get("source") or rec.get("wav")
                        if src is None:
                            raise ValueError(f"jsonl record without 'source'/'wav': "
                                             f"{line.strip()[:120]}")
                        keys.append(rec.get("key", f"utt_{len(keys)}"))
                        expanded.append(src)
                continue
            if isinstance(x, str) and x.startswith(("http://", "https://")):
                raise NotImplementedError("AutoModel: URL inputs are not ported")
            keys.append(os.path.splitext(os.path.basename(x))[0]
                        if isinstance(x, str) else f"rand_key_{i}")
            expanded.append(x)
        wavs = [load_audio(x, fs=fs, audio_fs=audio_fs) for x in expanded]
        if key is not None:
            if len(key) != len(expanded):
                raise ValueError(f"got {len(key)} keys for {len(expanded)} inputs "
                                 "(scp/jsonl inputs expand; omit `key` to use theirs)")
            return wavs, key
        return wavs, keys

    # ----------------------------------------------- long audio pipeline
    def batches(self, segments: List[List[int]], fs: int, batch_size_s: int) -> List[List[int]]:
        """Segment indices sorted by length, longest first, in greedy batches
        whose padded span (longest x count) stays within ``batch_size_s``."""
        seg_len = [int((e - s) * (fs // 1000)) for s, e in segments]
        order = sorted(range(len(seg_len)), key=lambda i: -seg_len[i])
        budget = batch_size_s * fs
        batches: List[List[int]] = []
        cur: List[int] = []
        cur_max = 0
        for i in order:
            m = max(cur_max, seg_len[i])
            if cur and m * (len(cur) + 1) > budget:
                batches.append(cur)
                cur, cur_max = [], 0
                m = seg_len[i]
            cur.append(i)
            cur_max = m
        if cur:
            batches.append(cur)
        return batches

    def _inference_with_vad(self, wav: np.ndarray, key: str, batch_size_s: int = 300,
                            merge_length_s: int = 15, with_timestamp: bool = True,
                            fs: int = 16000, punc_mode: str = "segment", hotword=None,
                            preset_spk_num: Optional[int] = None, use_itn: bool = False,
                            language: str = "zh", merge_vad: bool = True) -> Dict[str, Any]:
        """One recording through the pipeline (``auto_model.py:670`` of the JAX
        package).  ``language`` and ``use_itn`` only steer the text ITN
        (``auto_model.py:680-681,791-821``): the engine decodes with its
        defaults.  ``merge_vad`` is accepted and ignored, as there."""
        afe, vfe = getattr(self.engine, "frontend", None), self.vad_engine.frontend
        shared = (self.shared_frontend and hotword is None
                  and getattr(self.engine, "from_fbank", False)
                  and afe is not None and afe.fs == vfe.fs and afe.n_mels == vfe.n_mels
                  and afe.window == vfe.window)
        raw_fbank = total_frames = None
        if shared:
            segments, raw_fbank, total_frames = self.vad_engine.segments_shared(wav)
        else:
            segments = self.vad_engine.segments(wav)
        segments = vad_utils.merge_vad(segments, merge_length_s * 1000)
        if not segments:
            return {"key": key, "text": ""}
        clips = None
        if not shared or self.spk_engine is not None:
            clips = vad_utils.slice_audio_by_segments(wav, segments, fs)
        hw = {}
        if hotword is not None and isinstance(self.engine, HotwordEngine):
            hw["hotword"] = self.engine.encode_hotwords(hotword)  # one upload

        # every batch's device work queued before any batch is finalized
        pending = []
        for batch in self.batches(segments, fs, batch_size_s):
            offsets = [segments[i][0] for i in batch] if with_timestamp else None
            if shared:
                fin = self.engine.transcribe_from_fbank_async(
                    raw_fbank, [segments[i] for i in batch], offsets, total_frames)
            elif not hasattr(self.engine, "transcribe_async"):
                # the hybrid beam (a host flag every step) and Whisper: each
                # batch runs when it is finalized (the JAX pipeline's fallback
                # for an engine without an async entry)
                fin = (lambda c=[clips[i] for i in batch], o=offsets: self.engine.transcribe(
                    c, with_timestamp=with_timestamp, vad_offsets=o))
            else:
                fin = self.engine.transcribe_async([clips[i] for i in batch],
                                                   with_timestamp=with_timestamp,
                                                   vad_offsets=offsets, **hw)
            pending.append((batch, fin))
        # the speaker chunks' embeddings queued after the ASR batches
        spk_chunks, spk_fin = [], None
        if self.spk_engine is not None:
            for (start_ms, end_ms), clip in zip(segments, clips):
                spk_chunks.extend(sv_chunk([start_ms / 1000.0, end_ms / 1000.0, clip], fs=fs))
            spk_fin = self.spk_engine.embed_async([c[2] for c in spk_chunks])
        seg_results: Dict[int, Dict] = {}
        for batch, finalize in pending:
            for i, r in zip(batch, finalize()):
                seg_results[i] = r

        texts, all_ts, all_tokens = [], [], []
        for i in range(len(segments)):
            r = seg_results.get(i, {})
            if r.get("text"):
                texts.append(r["text"])
            all_ts.extend(r.get("timestamp", []))
            all_tokens.extend(r.get("raw_tokens", []))
        text = join_segment_texts(texts)
        result: Dict[str, Any] = {"key": key, "text": text}
        if with_timestamp:
            result["timestamp"] = all_ts

        # ITN on the joined text, or on each segment's text before "segment"
        # punctuation
        do_itn = use_itn or self.kwargs.get("use_itn")
        seg_punc = self.punc_engine is not None and text and punc_mode == "segment"
        if do_itn and not seg_punc:
            text = inverse_normalize(text, language)
            result["text"] = text

        # "segment": each VAD segment is its own punctuation context, window
        # wi of every segment scored in one device call per round; "joint":
        # one window chain over the joined text (the reference's offline path)
        punc_out = None
        if self.punc_engine is not None and text:
            if punc_mode == "segment":
                seg_texts = [inverse_normalize(t, language) for t in texts] if do_itn else texts
                outs = self.punc_engine.model.inference_batch(seg_texts,
                                                              self.punc_engine.tokenizer)
                punc_out = {"text": join_segment_texts([o["text"] for o in outs]),
                            "punc_array": np.concatenate([o["punc_array"] for o in outs])}
            else:
                punc_out = self.punc_engine.punctuate(text)
            result["text"] = punc_out["text"]
        if punc_out is not None and with_timestamp:
            punc_array = punc_out["punc_array"]
            all_tokens_a, all_ts_a = all_tokens, all_ts
            if len(all_tokens) != len(punc_array):
                # the reference always emits sentence_info here: align to the
                # common prefix and close its last sentence
                logging.warning("punc/token length mismatch (%d tokens vs %d punc labels) "
                                "for key=%s; sentence_info aligned to the common prefix",
                                len(all_tokens), len(punc_array), key)
                n = min(len(all_tokens), len(punc_array))
                if n and punc_array[n - 1] <= 1:
                    punc_array = list(punc_array[:n])
                    punc_array[n - 1] = 2
                else:
                    punc_array = punc_array[:n]
                all_tokens_a, all_ts_a = all_tokens[:n], all_ts[:n]
            result["sentence_info"] = timestamp_sentence(
                punc_array, all_ts_a, all_tokens_a,
                punc_list=self.punc_engine.model.punc_list)
        if spk_chunks:
            labels = ClusterBackend()(spk_fin(), oracle_num=preset_spk_num)
            sd_segments = [[int(c[0] * 1000), int(c[1] * 1000), int(lab)]
                           for c, lab in zip(spk_chunks, labels)]
            result["spk_info"] = sd_segments
            if "sentence_info" in result:
                result["sentence_info"] = distribute_spk(result["sentence_info"], sd_segments)
        return result
