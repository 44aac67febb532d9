"""Serving engines for offline Paraformer and the CTC/attention beam (port of
the Paraformer and HybridEngine parts of funasr_tpu/auto/engines.py).

The engine owns the model, the frontend and the tokenizer and exposes a
batched ``transcribe``: pack waveforms into a bucketed (B, N) batch, run
fbank -> LFR -> CMVN -> encoder -> CIF -> decoder -> argmax on the device,
and detokenize on the host.  The fbank runs through the fused kernel
wrapper (``ops/fbank_kernel.py``) and attention through
``ops/attention.py``: the CUDA kernels on the card, their plain twins on
the CPU.  A module built with ``quantize=True`` and quantized
(``Paraformer.quantize_weights``) is served the same way, through its
int8 layer kernels.  ``HybridEngine`` serves the joint CTC/attention beam
of a Conformer (``models/transformer/model.py``), whose CTC prefix scores run
through the ``ops/ctc_prefix.py`` kernel once per decode step.  Timestamps,
meshes and sequence parallelism are later slices.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from funasr_torch.device import resolve_device
from funasr_torch.ops import fbank as F
from funasr_torch.ops import fbank_kernel as FK
from funasr_torch.utils.postprocess import sentence_postprocess


def quantize(n: int, step: int = 2000, minimum: int = 4000) -> int:
    """Pad a sample count to a bucket boundary: 0.125 s steps up to 16 s,
    then 1 s to 60 s, 4 s to 4 min, 15 s beyond, so padding stays under
    ~7% and the number of distinct batch shapes stays bounded."""
    if n > 240 * 16000:
        step = 240000        # 15 s
    elif n > 60 * 16000:
        step = 64000         # 4 s
    elif n > 16 * 16000:
        step = 16000         # 1 s
    return max(minimum, step * ((n + step - 1) // step))


class FrontendConfig:
    """Serving feature extractor: fbank (dither 0) -> LFR -> CMVN -> frame
    padding to a multiple of 128."""

    def __init__(self, fs: int = 16000, n_mels: int = 80, lfr_m: int = 7,
                 lfr_n: int = 6, cmvn=None, window: str = "hamming"):
        self.fs = fs
        self.n_mels = n_mels
        self.lfr_m = lfr_m
        self.lfr_n = lfr_n
        self.window = window
        if cmvn is None:
            dim = n_mels * lfr_m
            cmvn = np.stack([np.zeros(dim, np.float32), np.ones(dim, np.float32)])
        self.cmvn = torch.as_tensor(np.asarray(cmvn, np.float32))
        self._cmvn_on: Dict[torch.device, torch.Tensor] = {}

    def raw_fbank(self, wav: torch.Tensor, lengths: torch.Tensor):
        """Mel fbank only, no LFR/CMVN.  Each output frame is a function of
        exactly its 400 samples, so a slice of this grid at a
        160-sample-aligned offset equals fbank run on the sliced waveform.

        16 kHz audio takes the fused kernel (any window).  The kernel's
        frames are 400 samples at hop 160, so another rate runs only on the
        CPU, through the plain frontend."""
        if self.fs == FK.SAMPLE_RATE:
            return FK.fused_fbank(wav, lengths, num_mel_bins=self.n_mels,
                                  window=self.window)
        if wav.device.type != "cpu":
            raise ValueError(f"raw_fbank: the fbank kernel computes {FK.SAMPLE_RATE}"
                             f" Hz frames; fs={self.fs} runs only on the CPU")
        return F.fbank(wav, lengths, num_mel_bins=self.n_mels, fs=self.fs,
                       window_type=self.window)

    def features_from_fbank(self, feats: torch.Tensor, flens: torch.Tensor):
        """LFR + CMVN + frame padding on a precomputed raw fbank grid."""
        if self.lfr_m != 1 or self.lfr_n != 1:
            feats, flens = F.apply_lfr(feats, flens, self.lfr_m, self.lfr_n)
        cmvn = self._cmvn_on.get(feats.device)
        if cmvn is None:
            cmvn = self._cmvn_on[feats.device] = self.cmvn.to(feats.device)
        feats = F.apply_cmvn(feats, cmvn)
        return F.pad_frames(feats, 128), flens

    def device_features(self, wav: torch.Tensor, lengths: torch.Tensor):
        feats, flens = self.raw_fbank(wav, lengths)
        return self.features_from_fbank(feats, flens)


class BatchedAsrEngine:
    """Shared batching scaffold for offline ASR engines."""

    def __init__(self, frontend: FrontendConfig, tokenizer, device=None):
        self.frontend = frontend
        self.tokenizer = tokenizer
        self.device = resolve_device(device)

    def _pack(self, wavs: Sequence[np.ndarray]):
        """-> (B, quantize(max len)) float32 batch and (B,) int32 lengths on
        the engine's device, zero past each waveform."""
        lens = np.array([len(w) for w in wavs], np.int64)
        pad = quantize(int(lens.max(initial=1)))
        batch = np.zeros((len(wavs), pad), np.float32)
        for i, w in enumerate(wavs):
            batch[i, : len(w)] = w
        return (torch.from_numpy(batch).to(self.device),
                torch.from_numpy(lens.astype(np.int32)).to(self.device))


class ParaformerEngine(BatchedAsrEngine):
    """Offline Paraformer serving on ``device`` (default the GPU; raises
    without one unless ``device="cpu"``)."""

    def __init__(self, module, frontend: FrontendConfig, tokenizer,
                 blank_id: int = 0, max_tokens_per_15s: int = 128,
                 device=None):
        super().__init__(frontend, tokenizer, device)
        self.module = module.to(self.device).eval()
        self.blank_id = blank_id
        # sos/eos sit inside the predictor's token count; filter them by id
        # (e_paraformer/model.py:628) rather than by token spelling
        self._special_ids = {blank_id, int(getattr(module, "sos", 1) or 1),
                             int(getattr(module, "eos", 2) or 2)}
        self.max_tokens_per_15s = max_tokens_per_15s

    def _max_tokens(self, n_samples: int) -> int:
        """Token budget for a bucket: max_tokens_per_15s per 15 s, rounded
        up to 16 (128 at 15 s, 48 at 4 s)."""
        dur_s = n_samples / self.frontend.fs
        need = dur_s * self.max_tokens_per_15s / 15.0
        return max(16, int(np.ceil(need / 16.0)) * 16)

    @torch.inference_mode()
    def run(self, wav: torch.Tensor, lens: torch.Tensor, max_tokens: int):
        """The device program: (B, N) waveform batch -> tokens (B, U),
        token_lengths (B,), CIF peaks and alphas."""
        feats, flens = self.frontend.device_features(wav, lens)
        log_probs, tok_lens, pred = self.module.inference_logits(
            feats, flens, max_tokens=max_tokens)
        tokens = torch.argmax(log_probs, dim=-1)
        return tokens, tok_lens, pred.peaks, pred.alphas

    def transcribe(self, wavs: Sequence[np.ndarray]) -> List[Dict[str, Any]]:
        """Waveforms (float in [-1, 1], 16 kHz) -> one ``{"text",
        "raw_tokens"}`` dict each."""
        if not len(wavs):
            return []
        wav_d, lens_d = self._pack(wavs)
        tokens, tok_lens, _, _ = self.run(wav_d, lens_d,
                                          self._max_tokens(wav_d.shape[1]))
        tokens = tokens.cpu().numpy()
        tok_lens = tok_lens.cpu().numpy()
        results = []
        for i in range(len(wavs)):
            ids = [t for t in tokens[i, : int(tok_lens[i])].tolist()
                   if t != self.blank_id]
            toks = self.tokenizer.ids2tokens(ids)
            text, words = sentence_postprocess(
                [tk for t, tk in zip(ids, toks) if t not in self._special_ids])
            results.append({"text": text, "raw_tokens": words})
        return results


class HybridEngine(BatchedAsrEngine):
    """Joint CTC/attention beam serving (Conformer) on ``device`` (default the
    GPU; raises without one unless ``device="cpu"``): device beam decode,
    hypotheses detokenized on the host.  ``int8_kv`` stores the decoder's
    attention K/V as per-row int8 (an argument here, where the JAX package
    reads ``FUNASR_TPU_INT8_KV``).  ``steps`` counts the decode steps run
    over all calls."""

    def __init__(self, module, frontend: FrontendConfig, tokenizer, beam: int = 10,
                 maxlen: int = 96, decoding_ctc_weight: float = 0.3,
                 int8_kv: bool = False, device=None):
        super().__init__(frontend, tokenizer, device)
        self.module = module.to(self.device).eval()
        self.beam = beam
        self.maxlen = maxlen
        self.decoding_ctc_weight = decoding_ctc_weight
        self.int8_kv = int8_kv
        self.steps = 0

    @torch.inference_mode()
    def run(self, wav: torch.Tensor, lens: torch.Tensor):
        """The device program: (B, N) waveform batch -> BeamResult (tokens
        (B, K, L), lengths, scores, steps)."""
        feats, flens = self.frontend.device_features(wav, lens)
        return self.module.decode_beam(
            feats, flens, beam=self.beam, maxlen=self.maxlen,
            decoding_ctc_weight=self.decoding_ctc_weight, int8_kv=self.int8_kv)

    def transcribe(self, wavs: Sequence[np.ndarray], nbest: int = 1,
                   with_timestamp: bool = False) -> List[Dict[str, Any]]:
        """Waveforms (float in [-1, 1], 16 kHz) -> one ``{"text",
        "raw_tokens", "score"}`` dict each, the top hypothesis; ``nbest > 1``
        adds the best ``nbest`` hypotheses under ``"nbest"``, each with its
        ``"tokens"``.  Timestamps (CTC forced alignment) are not ported yet."""
        if with_timestamp:
            raise NotImplementedError("HybridEngine: with_timestamp needs "
                                      "decode_beam_align, not ported yet")
        if not len(wavs):
            return []
        res = self.run(*self._pack(wavs))
        self.steps += res.steps
        toks = res.tokens.cpu().numpy()
        tok_lens = res.lengths.cpu().numpy()
        scores = res.scores.cpu().numpy()
        nbest = max(1, min(int(nbest), self.beam))

        def hyp_result(i, k):
            ids = toks[i, k, : int(tok_lens[i, k])].tolist()
            text, raw = sentence_postprocess(self.tokenizer.ids2tokens(ids))
            return {"score": float(scores[i, k]), "text": text, "raw_tokens": raw,
                    "tokens": ids}

        results = []
        for i in range(len(wavs)):
            res_i = hyp_result(i, 0)
            res_i.pop("tokens")
            if nbest > 1:
                res_i["nbest"] = [hyp_result(i, k) for k in range(nbest)]
            results.append(res_i)
        return results
