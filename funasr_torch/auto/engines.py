"""Serving engines (port of the Paraformer, BiCif, hotword, SenseVoice, Hybrid,
Transducer, Whisper, VAD, speaker and punctuation parts of
funasr_tpu/auto/engines.py, and of the JAX AutoModel's emotion2vec engine).

The engine owns the model, the frontend and the tokenizer and exposes a
batched ``transcribe``: pack waveforms into a bucketed (B, N) batch, run
fbank -> LFR -> CMVN -> encoder -> CIF -> decoder -> argmax on the device,
and detokenize on the host.  The fbank runs through the fused kernel
wrapper (``ops/fbank_kernel.py``) and attention through
``ops/attention.py``: the CUDA kernels on the card, their plain twins on
the CPU.  A module built with ``quantize=True`` and quantized
(``Paraformer.quantize_weights``) is served the same way, through its
int8 layer kernels.  ``HybridEngine`` serves the joint CTC/attention beam
of a CTC/attention hybrid (``models/transformer/model.py``: Conformer,
Transformer; ``models/branchformer.py``: Branchformer, E-Branchformer; each
with the Transformer or the RWKV decoder), whose CTC prefix scores run
through the ``ops/ctc_prefix.py`` kernel once per decode step, with CTC
forced-alignment timestamps for each returned hypothesis.
``ParaformerEngine.transcribe(with_timestamp=True)`` adds 60 ms stamps from
the CIF fire track, and ``BiCifEngine`` serves a BiCifParaformer with 20 ms
stamps from its upsampled fire track (``utils/timestamp_tools.py`` on the
host), from waveforms or from segments of one shared fbank grid.

The ``*_async`` entries (``engines.py:260,343,417``) queue a batch's kernels
and non-blocking copies of its outputs into pinned host memory, record an
event, and return a ``finalize()`` closure that waits on that event alone
before the host work (detokenizing, the timestamp pass): the long-audio
pipeline dispatches every batch before it finalizes the first, so batch
k's host work overlaps batch k + 1's kernels.  Inputs go up the same way,
from pinned memory, so no entry waits on the card between two batches.

``VadEngine`` runs fbank, LFR, CMVN and the FSMN scorer on the device and
the endpoint state machine on the host; ``segments_shared`` takes the fbank
kernel's energy column as the decibel track and hands the raw fbank grid on
to ``BiCifEngine.transcribe_from_fbank_async``.  ``PuncEngine`` wraps the
CT-Transformer.  ``HotwordEngine`` serves SeacoParaformer and
ContextualParaformer: hotword strings become a padded id grid uploaded
once, decoded with the bias head (SeACo, in the same pass as the BiCif
timestamps) or the decoder's bias attention (Contextual).  ``SpkEngine`` embeds fixed-length
speaker chunks through the fbank kernel and CAM++, one batch per chunk
length.  ``SenseVoiceEngine`` serves SenseVoiceSmall: prompts for the
language and text norm, greedy CTC, rich tags decoded on the host and,
with timestamps, a CTC forced alignment whose emissions are gathered on
the device and whose Viterbi runs on the host.  ``WhisperEngine`` serves
Whisper and WhisperLID: a 30 s log-mel window a waveform and the greedy
decode over the KV cache, every attention through the head-size-64 kernel.
``TransducerEngine`` serves the Transducer and RWKV-BAT by their greedy RNN-T
decode (BAT's WKV recurrence through ``ops/wkv.py``), ``SerEngine``
emotion2vec (its attention through the ALiBi instance of the float32
attention kernel).
Meshes and sequence parallelism are later slices.
"""

from __future__ import annotations

import copy
from itertools import groupby
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from funasr_torch.device import fetch_async, fetched, resolve_device, upload
from funasr_torch.models.fsmn_vad.model import frame_decibel_device
from funasr_torch.models.sense_voice.model import N_PROMPT, lid_id, textnorm_id
from funasr_torch.ops import ctc_align
from funasr_torch.ops import fbank as F
from funasr_torch.ops import fbank_kernel as FK
from funasr_torch.utils.postprocess import rich_transcription_postprocess, sentence_postprocess
from funasr_torch.utils.timestamp_tools import ts_from_cif_peaks, ts_prediction_lfr6_batch


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
    padding to a multiple of 128.  The CMVN lives on ``device`` (the CPU by
    default) from construction; an engine takes the frontend through
    :meth:`on` with its own device when it is built, so no feature call
    copies the CMVN or the fbank tables to the card."""

    def __init__(self, fs: int = 16000, n_mels: int = 80, lfr_m: int = 7,
                 lfr_n: int = 6, cmvn=None, window: str = "hamming", device="cpu",
                 dither: float = 0.0):
        self.fs = fs
        self.dither = dither
        self.n_mels = n_mels
        self.lfr_m = lfr_m
        self.lfr_n = lfr_n
        self.window = window
        if cmvn is None:
            dim = n_mels * lfr_m
            cmvn = np.stack([np.zeros(dim, np.float32), np.ones(dim, np.float32)])
        self.cmvn = torch.as_tensor(np.asarray(cmvn, np.float32), device=device)
        if self.fs == FK.SAMPLE_RATE:
            FK.prepare(self.cmvn.device, n_mels, window)

    def on(self, device) -> "FrontendConfig":
        """This frontend with its CMVN (and the fbank kernel's tables) on
        ``device``: itself when it is there, else a copy that holds them
        there."""
        device = torch.device(device)
        if self.cmvn.device == device:
            return self
        fe = copy.copy(self)
        fe.cmvn = self.cmvn.to(device)
        if fe.fs == FK.SAMPLE_RATE:
            FK.prepare(device, fe.n_mels, fe.window)
        return fe

    def raw_fbank(self, wav: torch.Tensor, lengths: torch.Tensor,
                  with_energy: bool = False):
        """Mel fbank only, no LFR/CMVN (and with ``with_energy`` the frames'
        decibel track, (B, T)).  Each output frame is a function of exactly
        its 400 samples, so a slice of this grid at a 160-sample-aligned
        offset equals fbank run on the sliced waveform.

        16 kHz audio takes the fused kernel (any window), the decibels from
        its energy column.  The kernel's frames are 400 samples at hop 160,
        so another rate runs only on the CPU, through the plain frontend."""
        if self.fs == FK.SAMPLE_RATE:
            return FK.fused_fbank(wav, lengths, num_mel_bins=self.n_mels,
                                  with_energy=with_energy, window=self.window)
        if wav.device.type != "cpu":
            raise ValueError(f"raw_fbank: the fbank kernel computes {FK.SAMPLE_RATE}"
                             f" Hz frames; fs={self.fs} runs only on the CPU")
        out = F.fbank(wav, lengths, num_mel_bins=self.n_mels, fs=self.fs,
                      window_type=self.window)
        return out + (frame_decibel_device(wav),) if with_energy else out

    def features_from_fbank(self, feats: torch.Tensor, flens: torch.Tensor):
        """LFR + CMVN + frame padding on a precomputed raw fbank grid."""
        if self.lfr_m != 1 or self.lfr_n != 1:
            feats, flens = F.apply_lfr(feats, flens, self.lfr_m, self.lfr_n)
        feats = F.apply_cmvn(feats, self.cmvn)
        return F.pad_frames(feats, 128), flens

    def device_features(self, wav: torch.Tensor, lengths: torch.Tensor):
        feats, flens = self.raw_fbank(wav, lengths)
        return self.features_from_fbank(feats, flens)

    def featurize(self, batch: Dict[str, Any], train: bool = True) -> Dict[str, torch.Tensor]:
        """A collated training batch (numpy ``speech``, ``speech_lengths``,
        ``text``, ``text_lengths``) -> its tensors on the CMVN's device, the
        speech as features: fbank (the kernel on the card) -> LFR -> CMVN,
        with no padding to 128 frames (funasr_tpu/bin/train.py:144-160).
        ``dither`` != 0 on the training path needs a noise input to the
        fbank kernel, which no shipped config uses: it raises."""
        if train and self.dither:
            raise NotImplementedError(
                f"featurize: dither={self.dither} needs a noise input to the fbank "
                "kernel (csrc/fbank.cu; ROADMAP.md, Queue 1: training)")
        dev = self.cmvn.device
        feats, flens = self.raw_fbank(upload(batch["speech"], dev),
                                      upload(batch["speech_lengths"], dev))
        if self.lfr_m != 1 or self.lfr_n != 1:
            feats, flens = F.apply_lfr(feats, flens, self.lfr_m, self.lfr_n)
        return {"speech": F.apply_cmvn(feats, self.cmvn), "speech_lengths": flens,
                "text": upload(batch["text"], dev),
                "text_lengths": upload(batch["text_lengths"], dev)}


class BatchedAsrEngine:
    """Shared batching scaffold for offline ASR engines."""

    def __init__(self, frontend: FrontendConfig, tokenizer, device=None):
        self.device = resolve_device(device)
        self.frontend = frontend.on(self.device)
        self.tokenizer = tokenizer

    def _pack(self, wavs: Sequence[np.ndarray]):
        """-> (B, quantize(max len)) float32 batch and (B,) int32 lengths on
        the engine's device, zero past each waveform."""
        lens = np.array([len(w) for w in wavs], np.int64)
        pad = quantize(int(lens.max(initial=1)))
        batch = np.zeros((len(wavs), pad), np.float32)
        for i, w in enumerate(wavs):
            batch[i, : len(w)] = w
        return upload(batch, self.device), upload(lens.astype(np.int32), self.device)


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
        base = getattr(pred, "base", pred)  # a BiCif predictor's base CIF track
        return tokens, tok_lens, base.peaks, base.alphas

    def transcribe(self, wavs: Sequence[np.ndarray], with_timestamp: bool = False,
                   vad_offsets: Optional[Sequence[int]] = None) -> List[Dict[str, Any]]:
        """Waveforms (float in [-1, 1], 16 kHz) -> one ``{"text",
        "raw_tokens"}`` dict each; ``with_timestamp`` adds ``"timestamp"``,
        [start_ms, end_ms] per kept token from the CIF fire track (60 ms
        grain), shifted by ``vad_offsets[i]`` ms."""
        return self.transcribe_async(wavs, with_timestamp, vad_offsets)()

    def transcribe_async(self, wavs: Sequence[np.ndarray], with_timestamp: bool = False,
                         vad_offsets: Optional[Sequence[int]] = None):
        """Queue :meth:`transcribe`'s device work and the copies of its
        outputs now; returns ``finalize()`` -> the results."""
        if not len(wavs):
            return lambda: []
        wav_d, lens_d = self._pack(wavs)
        tokens, tok_lens, peaks, alphas = self.run(wav_d, lens_d,
                                                   self._max_tokens(wav_d.shape[1]))
        out = fetch_async((tokens, tok_lens) + ((peaks, alphas) if with_timestamp else ()))
        return lambda: self._host_results(len(wavs), *fetched(*out),
                                          vad_offsets=vad_offsets)

    def _host_results(self, n: int, tokens, tok_lens, peaks=None, alphas=None,
                      vad_offsets=None) -> List[Dict[str, Any]]:
        """Detokenize (and, given the fire track, stamp) a fetched batch."""
        tokens, tok_lens = tokens.numpy(), tok_lens.numpy()
        with_timestamp = peaks is not None
        if with_timestamp:
            peaks, alphas = peaks.numpy(), alphas.numpy()
        results = []
        for i in range(n):
            ids = [t for t in tokens[i, : int(tok_lens[i])].tolist()
                   if t != self.blank_id]
            toks = self.tokenizer.ids2tokens(ids)
            if with_timestamp:
                offset = 0 if vad_offsets is None or not len(vad_offsets) else vad_offsets[i]
                _, ts = ts_from_cif_peaks(peaks[i], alphas[i], list(toks), vad_offset=offset)
                text, ts_kept, words = sentence_postprocess(toks, ts)
                results.append({"timestamp": ts_kept, "raw_tokens": words, "text": text})
                continue
            text, words = sentence_postprocess(
                [tk for t, tk in zip(ids, toks) if t not in self._special_ids])
            results.append({"text": text, "raw_tokens": words})
        return results


class BiCifEngine(ParaformerEngine):
    """BiCifParaformer serving on ``device`` (default the GPU): 20 ms
    timestamps from the upsampled fire track (reference
    bicif_paraformer/model.py:135 + timestamp_tools.py:31), one batched
    fire pass on the host per batch.  ``from_fbank``: the engine decodes
    segments of a shared fbank grid (``transcribe_from_fbank_async``)."""

    from_fbank = True

    @torch.inference_mode()
    def run_ts(self, wav: torch.Tensor, lens: torch.Tensor, max_tokens: int):
        """The device program: (B, N) waveform batch -> tokens (B, U),
        token_lengths (B,), us_alphas and us_peaks (B, 3 T)."""
        feats, flens = self.frontend.device_features(wav, lens)
        return self.module.timestamps(feats, flens, max_tokens=max_tokens)

    def transcribe(self, wavs: Sequence[np.ndarray], with_timestamp: bool = True,
                   vad_offsets: Optional[Sequence[int]] = None) -> List[Dict[str, Any]]:
        """Waveforms -> one ``{"text", "timestamp", "raw_tokens"}`` dict each
        (without ``with_timestamp``, :meth:`ParaformerEngine.transcribe`)."""
        return self.transcribe_async(wavs, with_timestamp, vad_offsets)()

    def transcribe_async(self, wavs: Sequence[np.ndarray], with_timestamp: bool = True,
                         vad_offsets: Optional[Sequence[int]] = None):
        """Queue :meth:`transcribe`'s device work and the copies of its
        outputs now; returns ``finalize()`` -> the results."""
        if not len(wavs):
            return lambda: []
        if not with_timestamp:
            return super().transcribe_async(wavs)
        wav_d, lens_d = self._pack(wavs)
        out = fetch_async(self.run_ts(wav_d, lens_d, self._max_tokens(wav_d.shape[1])))
        us_lens = self._us_lens([len(w) for w in wavs])
        return lambda: self._ts_results(len(wavs), *fetched(*out), vad_offsets, us_lens)

    # ---- shared-frontend path: decode VAD segments from one fbank grid of
    # the whole recording (FrontendConfig.raw_fbank: a slice of the grid at
    # a 160-sample-aligned start equals fbank of the sliced waveform)

    @staticmethod
    def quantize_frames(n: int, step: int = 96) -> int:
        """Pad a frame count to a multiple of ``step`` (at least one step)."""
        return max(step, step * ((n + step - 1) // step))

    def pack_segments_frames(self, segments_ms, total_frames: int,
                             frame_shift_ms: int = 10):
        """[[start_ms, end_ms], ...] -> (starts, nframes) int32 arrays in
        fbank frames (25 ms window, 10 ms shift, snip-edges count)."""
        starts = np.asarray([s // frame_shift_ms for s, _ in segments_ms], np.int32)
        ends = np.asarray([e for _, e in segments_ms], np.int64)
        seg_samples = (ends - np.asarray([s for s, _ in segments_ms], np.int64)) \
            * (self.frontend.fs // 1000)
        win = int(0.025 * self.frontend.fs)
        shift = int(0.010 * self.frontend.fs)
        nframes = np.maximum((seg_samples - win) // shift + 1, 1)
        nframes = np.minimum(nframes, np.maximum(total_frames - starts, 1))
        return starts, nframes.astype(np.int32)

    @torch.inference_mode()
    def run_ts_fbank(self, raw: torch.Tensor, starts: torch.Tensor,
                     nframes: torch.Tensor, max_tokens: int, fmax: int):
        """The device program from a shared (F, n_mels) fbank grid: each
        segment's ``fmax`` frames from ``starts``, LFR + CMVN on them, then
        :meth:`BiCifParaformer.timestamps`."""
        idx = starts[:, None].to(torch.int64) + torch.arange(fmax, device=raw.device)[None]
        frames = raw[torch.clamp(idx, 0, raw.shape[0] - 1)]  # (B, fmax, n_mels)
        feats, flens = self.frontend.features_from_fbank(frames, nframes)
        return self.module.timestamps(feats, flens, max_tokens=max_tokens)

    def transcribe_from_fbank(self, raw_fbank: torch.Tensor, segments_ms,
                              vad_offsets: Optional[Sequence[int]] = None,
                              total_frames: Optional[int] = None) -> List[Dict[str, Any]]:
        """Decode VAD segments [[start_ms, end_ms], ...] from ``raw_fbank``
        (F, n_mels) on the engine's device (padded past ``total_frames``
        when given).  The same records as :meth:`transcribe` of the sliced
        waveforms."""
        return self.transcribe_from_fbank_async(raw_fbank, segments_ms, vad_offsets,
                                                total_frames)()

    def transcribe_from_fbank_async(self, raw_fbank: torch.Tensor, segments_ms,
                                    vad_offsets: Optional[Sequence[int]] = None,
                                    total_frames: Optional[int] = None):
        """Queue :meth:`transcribe_from_fbank`'s device work and the copies
        of its outputs now; returns ``finalize()`` -> the results."""
        if not len(segments_ms):
            return lambda: []
        starts, nframes = self.pack_segments_frames(
            segments_ms, int(raw_fbank.shape[0] if total_frames is None else total_frames))
        fmax = self.quantize_frames(int(nframes.max()))
        # the token budget of the true longest segment, as the waveform path
        max_tokens = self._max_tokens(int(nframes.max()) * 160 + 240)
        dev = raw_fbank.device
        out = fetch_async(self.run_ts_fbank(raw_fbank, upload(starts, dev),
                                            upload(nframes, dev), max_tokens, fmax))
        us_lens = self._us_lens(nframes, in_frames=True)
        return lambda: self._ts_results(len(segments_ms), *fetched(*out), vad_offsets,
                                        us_lens)

    def _us_lens(self, n_samples_or_frames, in_frames: bool = False) -> np.ndarray:
        """True upsampled-track lengths: fbank frames -> LFR rows
        (ceil(frames / lfr_n)) -> x upsample_times.  Slicing the padded
        tracks to them keeps the stamps independent of the batch padding."""
        arr = np.asarray(n_samples_or_frames, np.int64)
        frames = arr if in_frames else np.maximum((arr - 400) // 160 + 1, 1)
        lfr = -(-frames // self.frontend.lfr_n)
        return lfr * self.module.predictor.upsample_times

    def _ts_results(self, n: int, tokens, tok_lens, us_alphas, us_peaks,
                    vad_offsets, us_lens) -> List[Dict[str, Any]]:
        """Detokenize a fetched batch and stamp it: one batched fire pass."""
        tokens, tok_lens = tokens.numpy(), tok_lens.numpy()
        toks_per = []
        for i in range(n):
            ids = [t for t in tokens[i, : int(tok_lens[i])].tolist() if t != self.blank_id]
            toks_per.append(self.tokenizer.ids2tokens(ids))
        ts_lists = ts_prediction_lfr6_batch(
            us_alphas.float().numpy(), us_peaks.numpy(), toks_per, us_lens,
            vad_offsets)
        results = []
        for toks, ts in zip(toks_per, ts_lists):
            text, ts_kept, words = sentence_postprocess(toks, ts)
            results.append({"text": text, "timestamp": ts_kept, "raw_tokens": words})
        return results


class HotwordGrid(NamedTuple):
    """Hotwords as the model takes them, on the engine's device: (H, L) int32
    token ids, zero-padded (SeACo: the no-bias row last), and (H,) int32
    lengths."""

    pad: torch.Tensor
    lengths: torch.Tensor


class HotwordEngine(BiCifEngine):
    """Hotword serving on ``device`` (default the GPU) (``engines.py:476`` of
    the JAX package).  SeacoParaformer: with a hotword the bias head decodes
    and the BiCif track stamps in one pass; with none it is
    :class:`BiCifEngine`.  ``seaco=False``, ContextualParaformer: with a
    hotword the biased decoder decodes, and the records carry no
    timestamp (its decode yields none); with none it is
    :class:`ParaformerEngine` (60 ms CIF-peak stamps), and it has no entry
    from a shared fbank grid (``from_fbank`` is False)."""

    def __init__(self, module, frontend: FrontendConfig, tokenizer, blank_id: int = 0,
                 max_tokens_per_15s: int = 128, device=None, seaco: bool = True):
        super().__init__(module, frontend, tokenizer, blank_id=blank_id,
                         max_tokens_per_15s=max_tokens_per_15s, device=device)
        self.seaco = self.from_fbank = seaco

    def encode_hotwords(self, hotword: Union[str, Sequence[str]]) -> HotwordGrid:
        """'word1 word2' (whitespace-split) or a list of words -> the grid:
        words that tokenize to nothing dropped, SeACo's no-bias row
        appended, rows padded to max(8, the longest) (``_encode_hotwords``,
        the reference's ``proc_hotword``).  One upload, no wait on the card.
        ContextualParaformer's grid has no no-bias row, so a hotword with no
        token raises ``ValueError`` (the JAX engine fails later, on a None
        grid)."""
        words = hotword.split() if isinstance(hotword, str) else list(hotword)
        rows = [r for r in (self.tokenizer.encode(w) for w in words) if len(r)]
        if self.seaco:
            rows.append([int(self.module.no_bias_id)])
        if not rows:
            raise ValueError(f"HotwordEngine(seaco=False): hotword {hotword!r} has no word "
                             "that tokenizes to a token, and ContextualParaformer's grid has "
                             "no no-bias row to fall back on")
        L = max(8, max(len(r) for r in rows))
        pad = np.zeros((len(rows), L), np.int32)
        lens = np.zeros((len(rows),), np.int32)
        for i, r in enumerate(rows):
            pad[i, : len(r)] = r[:L]
            lens[i] = min(len(r), L)
        return HotwordGrid(upload(pad, self.device), upload(lens, self.device))

    @torch.inference_mode()
    def run_hw(self, wav: torch.Tensor, lens: torch.Tensor, grid: HotwordGrid,
               max_tokens: int):
        """The device program: (B, N) waveform batch and the hotword grid ->
        tokens (B, U), token_lengths and, SeACo, us_alphas and us_peaks
        (B, 3 T)."""
        feats, flens = self.frontend.device_features(wav, lens)
        return self.module.decode_with_hotwords(feats, flens, grid.pad, grid.lengths,
                                                max_tokens=max_tokens)

    def transcribe(self, wavs: Sequence[np.ndarray], with_timestamp: bool = True,
                   vad_offsets: Optional[Sequence[int]] = None,
                   hotword: Union[None, str, Sequence[str], HotwordGrid] = None
                   ) -> List[Dict[str, Any]]:
        """Waveforms -> one ``{"text", "timestamp", "raw_tokens"}`` dict each
        (``{"text", "raw_tokens"}`` without ``with_timestamp``, or with a
        hotword and ``seaco=False``), decoded with ``hotword`` (words, or a
        grid from :meth:`encode_hotwords`)."""
        return self.transcribe_async(wavs, with_timestamp, vad_offsets, hotword)()

    def transcribe_async(self, wavs: Sequence[np.ndarray], with_timestamp: bool = True,
                         vad_offsets: Optional[Sequence[int]] = None,
                         hotword: Union[None, str, Sequence[str], HotwordGrid] = None):
        """Queue :meth:`transcribe`'s device work and the copies of its
        outputs now; returns ``finalize()`` -> the results."""
        if hotword is None or not len(wavs):
            if self.seaco:
                return super().transcribe_async(wavs, with_timestamp, vad_offsets)
            return ParaformerEngine.transcribe_async(self, wavs, with_timestamp, vad_offsets)
        grid = hotword if isinstance(hotword, HotwordGrid) else self.encode_hotwords(hotword)
        wav_d, lens_d = self._pack(wavs)
        out = fetch_async(self.run_hw(wav_d, lens_d, grid, self._max_tokens(wav_d.shape[1])))
        if not with_timestamp or not self.seaco:
            return lambda: self._text_results(len(wavs), *fetched(*out)[:2])
        us_lens = self._us_lens([len(w) for w in wavs])
        return lambda: self._ts_results(len(wavs), *fetched(*out), vad_offsets, us_lens)

    def _text_results(self, n: int, tokens, tok_lens) -> List[Dict[str, Any]]:
        """Detokenize a fetched batch, blanks dropped (the JAX engine's
        hotword path keeps sos/eos ids, as here)."""
        tokens, tok_lens = tokens.numpy(), tok_lens.numpy()
        results = []
        for i in range(n):
            ids = [t for t in tokens[i, : int(tok_lens[i])].tolist() if t != self.blank_id]
            text, words = sentence_postprocess(self.tokenizer.ids2tokens(ids))
            results.append({"text": text, "raw_tokens": words})
        return results


def _ctc_align_timestamps(align_row, tokens, offset_ms: int = 0,
                          frame_ms: int = 60) -> List[List[int]]:
    """Frame alignment -> [[start_ms, end_ms], ...] per non-blank token
    (``engines.py:579`` of the JAX package; reference
    sense_voice/model.py:932-960): runs of equal labels, 60 ms frames with
    a -30 ms half-frame shift, '▁' word separators dropped."""
    ts = []
    start = 0
    token_id = 0
    n = len(align_row)
    for label, run in groupby(align_row):
        end = start + len(list(run))
        if label != 0 and token_id < len(tokens):
            left = max((start * frame_ms - 30) / 1000.0, 0.0)
            right = min((end * frame_ms - 30) / 1000.0,
                        (n * frame_ms - 30) / 1000.0)
            if tokens[token_id] != "▁":
                ts.append([int(left * 1000) + offset_ms,
                           int(right * 1000) + offset_ms])
            token_id += 1
        start = end
    return ts


class SenseVoiceEngine(BatchedAsrEngine):
    """SenseVoiceSmall serving on ``device`` (default the GPU)
    (``engines.py:604`` of the JAX package): the language and text-norm
    prompts, greedy CTC on the device, rich-tag decoding on the host;
    ``with_timestamp`` adds 60 ms stamps from the CTC forced alignment (its
    emissions gathered on the device, the Viterbi on the host).  Text
    normalization is the model's own prompt token (``handles_itn``)."""

    handles_itn = True

    def __init__(self, module, frontend: FrontendConfig, tokenizer, device=None):
        super().__init__(frontend, tokenizer, device)
        self.module = module.to(self.device).eval()

    def _prompts(self, B: int, language: str, use_itn: bool):
        full = lambda v: torch.full((B,), v, dtype=torch.int32, device=self.device)
        return full(lid_id(language)), full(textnorm_id(use_itn))

    @torch.inference_mode()
    def run(self, wav: torch.Tensor, lens: torch.Tensor, lid: torch.Tensor,
            tn: torch.Tensor, with_alignment: bool = False):
        """The device program: (B, N) waveform batch and the prompt ids ->
        tokens (B, T + 4), token_lengths; ``with_alignment`` adds the
        alignment's emissions and lengths (``decode_for_alignment``)."""
        feats, flens = self.frontend.device_features(wav, lens)
        if with_alignment:
            return self.module.decode_for_alignment(feats, flens, lid, tn)
        return self.module.greedy_decode(feats, flens, lid, tn)

    def transcribe(self, wavs: Sequence[np.ndarray], language: str = "auto",
                   use_itn: bool = False, rich_text: bool = True,
                   with_timestamp: bool = False,
                   vad_offsets: Optional[Sequence[int]] = None, **kw) -> List[Dict[str, Any]]:
        """Waveforms -> one ``{"text", "raw_text"}`` dict each (``text``
        rich-tag decoded unless ``rich_text=False``); ``with_timestamp`` adds
        ``"timestamp"`` (shifted by ``vad_offsets[i]`` ms) and
        ``"raw_tokens"``.  Other keywords are accepted and ignored, as the
        JAX engine does."""
        return self.transcribe_async(wavs, language, use_itn, rich_text, with_timestamp,
                                     vad_offsets)()

    def transcribe_async(self, wavs: Sequence[np.ndarray], language: str = "auto",
                         use_itn: bool = False, rich_text: bool = True,
                         with_timestamp: bool = False,
                         vad_offsets: Optional[Sequence[int]] = None, **kw):
        """Queue :meth:`transcribe`'s device work and the copies of its
        outputs now; returns ``finalize()`` -> the results."""
        if not len(wavs):
            return lambda: []
        wav_d, lens_d = self._pack(wavs)
        out = fetch_async(self.run(wav_d, lens_d, *self._prompts(len(wavs), language, use_itn),
                                   with_alignment=with_timestamp))
        return lambda: self._host_results(len(wavs), *fetched(*out), rich_text=rich_text,
                                          vad_offsets=vad_offsets)

    def _host_results(self, n: int, tokens, tok_lens, em=None, in_lens=None, tgt_lens=None,
                      rich_text: bool = True, vad_offsets=None) -> List[Dict[str, Any]]:
        """Detokenize a fetched batch (and, given the emissions, align and
        stamp it: one batched Viterbi)."""
        tokens, tok_lens = tokens.numpy(), tok_lens.numpy()
        align = None
        if em is not None:
            align = ctc_align.viterbi(em.numpy(), tokens[:, N_PROMPT:], in_lens.numpy(),
                            tgt_lens.numpy(), self.module.blank_id)
        results = []
        for i in range(n):
            ids = tokens[i, : int(tok_lens[i])].tolist()
            text = self.tokenizer.decode(ids)
            res = {"text": rich_transcription_postprocess(text) if rich_text else text,
                   "raw_text": text}
            if align is not None:
                offset = 0 if vad_offsets is None or not len(vad_offsets) else vad_offsets[i]
                toks = self.tokenizer.ids2tokens(ids[N_PROMPT:])
                res["timestamp"] = _ctc_align_timestamps(align[i], toks, offset_ms=offset)
                res["raw_tokens"] = [t for t in toks if t != "▁"]
            results.append(res)
        return results


class HybridEngine(BatchedAsrEngine):
    """Joint CTC/attention beam serving (any ``_HybridModel``: Conformer,
    Transformer, Branchformer, E-Branchformer; the RWKV decoder through the
    full-prefix beam) on ``device`` (default the GPU; raises without one
    unless ``device="cpu"``): device beam decode,
    hypotheses detokenized on the host; with timestamps each returned
    hypothesis force-aligned to the encoder frames (``decode_beam_align``).
    ``int8_kv`` stores the decoder's attention K/V as per-row int8 (an
    argument here, where the JAX package reads ``FUNASR_TPU_INT8_KV``).
    ``steps`` counts the decode steps run over all calls."""

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
    def run(self, wav: torch.Tensor, lens: torch.Tensor, align_rows: int = 0):
        """The device program: (B, N) waveform batch -> BeamResult (tokens
        (B, K, L), lengths, scores, steps); with ``align_rows`` > 0 the
        AlignedBeam of ``decode_beam_align`` (its first ``align_rows``
        hypotheses aligned; one read back, the Viterbi on the host)."""
        feats, flens = self.frontend.device_features(wav, lens)
        kw = dict(beam=self.beam, maxlen=self.maxlen,
                  decoding_ctc_weight=self.decoding_ctc_weight, int8_kv=self.int8_kv)
        if align_rows:
            return self.module.decode_beam_align(feats, flens, nbest=align_rows, **kw)
        return self.module.decode_beam(feats, flens, **kw)

    def transcribe(self, wavs: Sequence[np.ndarray], nbest: int = 1,
                   with_timestamp: bool = False,
                   vad_offsets: Optional[Sequence[int]] = None, **kw) -> List[Dict[str, Any]]:
        """Waveforms (float in [-1, 1], 16 kHz) -> one ``{"text",
        "raw_tokens", "score"}`` dict each, the top hypothesis; ``nbest > 1``
        adds the best ``nbest`` hypotheses under ``"nbest"``, each with its
        ``"tokens"``; ``with_timestamp`` gives every returned hypothesis its
        own ``"timestamp"`` from its CTC forced alignment (frames of
        ``10 * round(fbank frames / encoder frames)`` ms, shifted by
        ``vad_offsets[i]`` ms) (``engines.py:709-777`` of the JAX package,
        the reference WFST decoder's lattice-backed word timings).  Other
        keywords are accepted and ignored, as the JAX engine does."""
        if not len(wavs):
            return []
        nbest = max(1, min(int(nbest), self.beam))
        res = self.run(*self._pack(wavs), align_rows=nbest if with_timestamp else 0)
        self.steps += res.steps
        toks = res.tokens.cpu().numpy()
        tok_lens = res.lengths.cpu().numpy()
        scores = res.scores.cpu().numpy()
        align = res.align.numpy() if with_timestamp else None
        enc_lens = res.enc_lens.numpy() if with_timestamp else None

        def frame_ms(i):
            # the encoder frame from the true fbank frame count and the
            # encoder's output length (LFR x conv subsampling)
            nf = max((len(wavs[i]) - 400) // 160 + 1, 1)
            return 10 * max(int(round(nf / max(int(enc_lens[i]), 1))), 1)

        def hyp_result(i, k):
            ids = toks[i, k, : int(tok_lens[i, k])].tolist()
            words = self.tokenizer.ids2tokens(ids)
            res_k: Dict[str, Any] = {"score": float(scores[i, k])}
            if align is not None:
                offset = 0 if vad_offsets is None or not len(vad_offsets) else vad_offsets[i]
                ts = _ctc_align_timestamps(align[i, k, : int(enc_lens[i])], words,
                                           offset_ms=offset, frame_ms=frame_ms(i))
                text, ts_kept, raw = sentence_postprocess(words, ts)
                res_k.update(text=text, timestamp=ts_kept, raw_tokens=raw)
            else:
                text, raw = sentence_postprocess(words)
                res_k.update(text=text, raw_tokens=raw)
            res_k["tokens"] = ids
            return res_k

        results = []
        for i in range(len(wavs)):
            res_i = hyp_result(i, 0)
            res_i.pop("tokens")
            if nbest > 1:
                res_i["nbest"] = [hyp_result(i, k) for k in range(nbest)]
            results.append(res_i)
        return results


class TransducerEngine(BatchedAsrEngine):
    """RNN-T / BAT greedy decode (``engines.py:782`` of the JAX package) on
    ``device`` (default the GPU; raises without one unless
    ``device="cpu"``): fbank -> LFR -> CMVN -> ``greedy_decode`` on the
    device, one read back; blank filtered and ``sentence_postprocess`` on the
    host -> ``{"text", "raw_tokens"}``."""

    def __init__(self, module, frontend: FrontendConfig, tokenizer, max_tokens: int = 128,
                 blank_id: int = 0, device=None):
        super().__init__(frontend, tokenizer, device)
        self.module = module.to(self.device).eval()
        self.max_tokens = max_tokens
        self.blank_id = blank_id

    @torch.inference_mode()
    def run(self, wav: torch.Tensor, lens: torch.Tensor):
        """The device program: (B, N) waveform batch -> tokens (B,
        max_tokens), counts (B,)."""
        feats, flens = self.frontend.device_features(wav, lens)
        return self.module.greedy_decode(feats, flens, max_tokens=self.max_tokens)

    def transcribe(self, wavs: Sequence[np.ndarray], **kw) -> List[Dict[str, Any]]:
        """Waveforms (float in [-1, 1], 16 kHz) -> one ``{"text",
        "raw_tokens"}`` dict each; other keywords (the pipeline's
        ``with_timestamp``, ``vad_offsets``) are accepted and ignored, as the
        JAX engine does."""
        return self.transcribe_async(wavs)()

    def transcribe_async(self, wavs: Sequence[np.ndarray], **kw):
        """Queue :meth:`transcribe`'s device work and the copy of its outputs
        now; returns ``finalize()`` -> the results."""
        if not len(wavs):
            return lambda: []
        out = fetch_async(self.run(*self._pack(wavs)))
        return lambda: self._host_results(len(wavs), *fetched(*out))

    def _host_results(self, n: int, toks, tok_lens) -> List[Dict[str, Any]]:
        toks, tok_lens = toks.numpy(), tok_lens.numpy()
        results = []
        for i in range(n):
            ids = [t for t in toks[i, : int(tok_lens[i])].tolist() if t != self.blank_id]
            text, raw = sentence_postprocess(self.tokenizer.ids2tokens(ids))
            results.append({"text": text, "raw_tokens": raw})
        return results


class SerEngine:
    """emotion2vec serving (the JAX AutoModel's ``SerEngine``,
    ``auto_model.py:377-389``): ``Emotion2vec.generate`` records with
    ``text`` the best label; ``extract_embedding`` adds ``feats``, any other
    keyword is ignored."""

    def __init__(self, model):
        self.model = model

    def transcribe(self, wavs: Sequence[np.ndarray], **kw) -> List[Dict[str, Any]]:
        res = self.model.generate(wavs, extract_embedding=kw.get("extract_embedding", False))
        for r in res:
            r["text"] = r["labels"][int(np.argmax(r["scores"]))]
        return res


class WhisperEngine:
    """Whisper-family models from raw audio (``engines.py:825`` of the JAX
    package): one 30 s log-mel window a waveform (``WhisperFrontend``, one
    upload and one frontend pass a batch), the model's greedy decode on the
    device, one read back, tokens cut at eos on the host.  ``text`` is ""
    without a tokenizer; ``transcribe`` ignores the pipeline's
    ``with_timestamp``/``vad_offsets``.  ``model`` is a ``WhisperWrap`` or
    ``WhisperLID``."""

    def __init__(self, model, tokenizer=None, max_tokens: int = 64, forced_tokens=None):
        from funasr_torch.frontends.whisper_frontend import WhisperFrontend

        self.model = model
        self.tokenizer = tokenizer
        self.max_tokens = max_tokens
        self.forced_tokens = list(forced_tokens or [])
        self.frontend = WhisperFrontend(n_mels=model.config.num_mel_bins, device=model.device)

    def transcribe(self, wavs: Sequence[np.ndarray], **kw) -> List[Dict[str, Any]]:
        if not len(wavs):
            return []
        toks = self.model.greedy_decode(self.frontend.batch(wavs), max_tokens=self.max_tokens,
                                        forced_tokens=self.forced_tokens)
        toks = fetched(*fetch_async([toks]))[0].numpy()
        eos = self.model.config.eos_token_id
        results = []
        for row in toks:
            ids = row.tolist()
            if eos in ids:
                ids = ids[: ids.index(eos)]
            text = self.tokenizer.decode(ids) if self.tokenizer is not None else ""
            results.append({"text": text, "raw_tokens": ids})
        return results


class VadEngine:
    """FSMN-VAD serving (``engines.py:860``): fbank -> LFR -> CMVN -> the FSMN
    scorer on the model's device, the endpoint state machine on the host.
    ``model`` is a :class:`FsmnVADStreaming`."""

    def __init__(self, model, frontend: FrontendConfig):
        self.model = model
        self.device = model.device
        self.frontend = frontend.on(self.device)

    @torch.inference_mode()
    def front(self, wav: torch.Tensor, lens: torch.Tensor):
        """(B, N) waveforms -> features, feature lengths and the frame
        decibels (``frame_decibel_device``)."""
        feats, flens = self.frontend.device_features(wav, lens)
        return feats, flens, frame_decibel_device(wav)

    @torch.inference_mode()
    def front_shared(self, wav: torch.Tensor, lens: torch.Tensor):
        """The shared frontend's device work: one fbank launch with its energy
        column (the decibel track) over the whole recording, then LFR, CMVN
        and the scorer -> (raw fbank grid, its frame lengths, posteriors,
        feature lengths, decibels)."""
        raw, rlens, db = self.frontend.raw_fbank(wav, lens, with_energy=True)
        feats, flens = self.frontend.features_from_fbank(raw, rlens)
        return raw, rlens, self.model.score(feats), flens, db

    def _one(self, wav: np.ndarray):
        return (upload(np.asarray(wav, np.float32)[None], self.device),
                upload(np.asarray([len(wav)], np.int32), self.device))

    def segments(self, wav: np.ndarray) -> List[List[int]]:
        """One waveform -> [[start_ms, end_ms], ...]."""
        feats, _, db = self.front(*self._one(wav))
        return self.model.segments_offline(feats, wav, decibels=db[0])

    def segments_shared(self, wav: np.ndarray):
        """One waveform -> (segments, the raw (F, n_mels) fbank grid on the
        device, its true frame count): the grid feeds the ASR stage's
        ``transcribe_from_fbank_async``."""
        raw, rlens, post, _, db = self.front_shared(*self._one(wav))
        segs = self.model.segments_from_posteriors(post, db[0])
        return segs, raw[0], int(rlens[0])

    def transcribe(self, wavs: Sequence[np.ndarray]) -> List[Dict[str, Any]]:
        """Standalone VAD (reference fsmn_vad_streaming/model.py:648):
        ``value`` holds the segment list, ``text`` stays empty."""
        return [{"text": "", "value": self.segments(np.asarray(w))} for w in wavs]


class SpkEngine:
    """CAM++ speaker embeddings (``engines.py:935`` of the JAX package; the
    reference's speaker branch, auto_model.py:467-483): 80-mel fbank (the
    fbank kernel, hamming, no LFR or CMVN), each chunk's mean over its
    frames taken out, CAM++ in float32.  ``model`` is a :class:`CAMPPlus`."""

    def __init__(self, model, fs: int = 16000):
        self.model = model
        self.device = model.device
        self.frontend = FrontendConfig(fs=fs, n_mels=model.feat_dim, lfr_m=1, lfr_n=1,
                                       device=self.device)

    @torch.inference_mode()
    def run(self, wav: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        """The device program: (B, N) chunks -> (B, emb) embeddings."""
        feats, flens = self.frontend.raw_fbank(wav, lens)
        mask = (torch.arange(feats.shape[1], device=feats.device)[None]
                < flens[:, None]).to(feats.dtype)[..., None]
        n = torch.clamp(flens.to(feats.dtype), min=1.0)[:, None, None]
        mean = (feats * mask).sum(1, keepdim=True) / n
        return self.model((feats - mean) * mask)

    def embed(self, wavs: Sequence[np.ndarray]) -> np.ndarray:
        """Chunk waveforms -> (N, emb) float32 embeddings in input order: the
        chunks of one length in one device call (the pipeline's are all 1.5
        s: one call), one upload and one read back each."""
        return self.embed_async(wavs)()

    def embed_async(self, wavs: Sequence[np.ndarray]):
        """Queue :meth:`embed`'s device work and the copies of its outputs
        now; returns ``finalize()`` -> the embeddings."""
        if not len(wavs):
            return lambda: np.zeros((0, 0), np.float32)
        order: Dict[int, List[int]] = {}
        for i, w in enumerate(wavs):
            order.setdefault(len(w), []).append(i)
        pending = []
        for n, idxs in order.items():
            batch = np.stack([np.asarray(wavs[i], np.float32) for i in idxs])
            lens = np.full((len(idxs),), n, np.int32)
            emb = self.run(upload(batch, self.device), upload(lens, self.device))
            pending.append((idxs, fetch_async([emb])))

        def finalize():
            out = np.zeros((len(wavs), self.model.embedding_size), np.float32)
            for idxs, host in pending:
                out[idxs] = fetched(*host)[0].numpy()
            return out
        return finalize


class PuncEngine:
    """CT-Transformer punctuation serving (``engines.py:980``)."""

    def __init__(self, model, tokenizer):
        self.model = model  # CTTransformerModel
        self.tokenizer = tokenizer

    def punctuate(self, text: str) -> Dict[str, Any]:
        return self.model.inference(text, self.tokenizer)
