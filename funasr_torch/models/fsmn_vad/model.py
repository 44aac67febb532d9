"""FSMN-VAD: the scorer on the device, the endpoint state machine on the host
(port of funasr_tpu/models/fsmn_vad/model.py; reference
funasr/models/fsmn_vad_streaming/model.py: ``VADXOptions``:49,
``WindowDetector``:159, ``GetFrameState``:493, ``DetectOneFrame``:782).

``VADXOptions``, ``WindowDetector`` and ``VadStateMachine`` are copied from
the JAX package as plain Python (model.py:31, :66, :123), with the reference
quirks it keeps: the double window update on frames under the decibel
threshold (see ``VadStateMachine.feed``), and the one fake start and end at
frame 0 when a final frame arrives before any segment was found.  Segments
are ``[start_ms, end_ms]`` on a global 10 ms timeline, streaming partials
``[beg, -1]`` / ``[-1, end]``.

``FsmnVADStreaming`` holds the FSMN scorer (``encoder.FSMN``, float32) on
its device.  ``frame_decibel_device`` is the frame energy track of a
waveform batch in PyTorch; ``compute_decibel`` its float64 host form.  The
JAX package's native C++ state machine (runtime/native/fta_vad.cc) is not
carried: ``new_state`` returns the Python machine.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from funasr_torch.device import resolve_device
from funasr_torch.models.fsmn_vad import encoder as _encoder  # noqa: F401  (registers FSMN)
from funasr_torch.registry import tables


@dataclass
class VADXOptions:
    """Tunables (reference model.py:49); times in ms."""

    sample_rate: int = 16000
    detect_mode: int = 1  # 0=single-utterance, 1=multiple-utterance
    max_end_silence_time: int = 800
    max_start_silence_time: int = 3000
    window_size_ms: int = 200
    sil_to_speech_time_thres: int = 150
    speech_to_sil_time_thres: int = 150
    speech_2_noise_ratio: float = 1.0
    do_extend: int = 1
    lookback_time_start_point: int = 200
    lookahead_time_end_point: int = 100
    max_single_segment_time: int = 60000
    noise_frame_num_used_for_snr: int = 100
    decibel_thres: float = -100.0
    snr_thres: float = -100.0
    speech_noise_thres: float = 0.6
    sil_pdf_ids: tuple = (0,)
    frame_in_ms: int = 10
    frame_length_ms: int = 25

    def __init__(self, **kwargs):
        for f_ in self.__dataclass_fields__.values():
            setattr(self, f_.name, kwargs.pop(f_.name, f_.default))
        # tolerate unknown config keys like the reference's **kwargs


# frame states
SIL, SPEECH = 0, 1
# machine states
NOT_DETECTED, IN_SEGMENT, END_DETECTED = 0, 1, 2


class WindowDetector:
    """Sliding majority-vote smoother (reference model.py:159)."""

    def __init__(self, window_ms: int, sil2speech_ms: int, speech2sil_ms: int,
                 frame_ms: int):
        self.win_size = window_ms // frame_ms
        self.sil2speech_cnt = sil2speech_ms // frame_ms
        self.speech2sil_cnt = speech2sil_ms // frame_ms
        self.reset()

    def reset(self):
        self.win = [0] * self.win_size
        self.pos = 0
        self.win_sum = 0
        self.pre_state = SIL

    def detect(self, frame_state: int) -> str:
        self.win_sum += frame_state - self.win[self.pos]
        self.win[self.pos] = frame_state
        self.pos = (self.pos + 1) % self.win_size
        if self.pre_state == SIL and self.win_sum >= self.sil2speech_cnt:
            self.pre_state = SPEECH
            return "sil2speech"
        if self.pre_state == SPEECH and self.win_sum <= self.speech2sil_cnt:
            self.pre_state = SIL
            return "speech2sil"
        return "sil2sil" if self.pre_state == SIL else "speech2speech"


@dataclass
class Segment:
    start_ms: int
    end_ms: int
    has_start: bool = False
    has_end: bool = False


@dataclass
class VadState:
    """All mutable streaming state (reference ``Stats``, model.py:244)."""

    frm_cnt: int = 0
    machine: int = NOT_DETECTED
    confirmed_start: int = -1
    latest_confirmed_speech: int = 0
    latest_confirmed_silence: int = -1
    continuous_silence: int = 0
    data_buf_start_frame: int = 0
    noise_average_decibel: float = -100.0
    number_end_detected: int = 0
    next_seg: bool = True
    out_offset: int = 0
    segments: List[Segment] = field(default_factory=list)
    scores: List[float] = field(default_factory=list)  # P(sil) per frame
    decibels: List[float] = field(default_factory=list)


class VadStateMachine:
    """Endpoint detection over per-frame silence posteriors + decibels."""

    def __init__(self, opts: VADXOptions):
        self.opts = opts
        self.window = WindowDetector(
            opts.window_size_ms, opts.sil_to_speech_time_thres,
            opts.speech_to_sil_time_thres, opts.frame_in_ms,
        )
        self.state = VadState()

    # ------------------------------------------------------------ helpers
    def _latency_frames(self) -> int:
        lat = self.window.win_size
        if self.opts.do_extend:
            lat += self.opts.lookback_time_start_point // self.opts.frame_in_ms
        return lat

    def _frame_state(self, t: int) -> int:
        s = self.state
        cur_db = s.decibels[t]
        if cur_db < self.opts.decibel_thres:
            return SIL
        sil_prob = min(max(s.scores[t], 1e-10), 1.0 - 1e-10)
        noise_prob = math.log(sil_prob) * self.opts.speech_2_noise_ratio
        speech_prob = math.log(1.0 - sil_prob)
        if math.exp(speech_prob) >= math.exp(noise_prob) + self.opts.speech_noise_thres:
            cur_snr = cur_db - s.noise_average_decibel
            if cur_snr >= self.opts.snr_thres:
                return SPEECH
            return SIL
        # noise frame: update running noise level (model.py:537-544)
        if s.noise_average_decibel < -99.9:
            s.noise_average_decibel = cur_db
        else:
            n = self.opts.noise_frame_num_used_for_snr
            s.noise_average_decibel = (cur_db + s.noise_average_decibel * (n - 1)) / n
        return SIL

    # ------------------------------------------------ segment construction
    def _seg_append_frame(self, frame: int):
        """OnVoiceDetected equivalent: extend the open segment to frame+1."""
        s = self.state
        s.latest_confirmed_speech = frame
        seg = s.segments[-1]
        seg.end_ms = (frame + 1) * self.opts.frame_in_ms
        s.data_buf_start_frame = frame + 1

    def _on_voice_start(self, start_frame: int, fake: bool = False):
        s = self.state
        if s.confirmed_start == -1:
            s.confirmed_start = start_frame
        if not fake and s.machine == NOT_DETECTED:
            seg = Segment(
                start_ms=start_frame * self.opts.frame_in_ms,
                end_ms=(start_frame + 1) * self.opts.frame_in_ms,
                has_start=True,
            )
            s.segments.append(seg)
            s.data_buf_start_frame = start_frame + 1

    def _on_voice_end(self, end_frame: int, fake: bool, is_last: bool):
        s = self.state
        for t in range(s.latest_confirmed_speech + 1, end_frame):
            self._seg_append_frame(t)
        if not fake and s.segments:
            self._seg_append_frame(end_frame)
            s.segments[-1].has_end = True
        s.number_end_detected += 1

    def _reset_detection(self):
        s = self.state
        s.continuous_silence = 0
        s.latest_confirmed_speech = 0
        s.latest_confirmed_silence = -1
        s.confirmed_start = -1
        s.machine = NOT_DETECTED
        self.window.reset()

    # -------------------------------------------------------------- driver
    def _detect_one_frame(self, frame_state: int, t: int, is_final_frame: bool):
        s, o = self.state, self.opts
        change = self.window.detect(frame_state)
        max_seg_frames = o.max_single_segment_time // o.frame_in_ms
        if change == "sil2speech":
            s.continuous_silence = 0
            if s.machine == NOT_DETECTED:
                start = max(s.data_buf_start_frame, t - self._latency_frames())
                self._on_voice_start(start)
                s.machine = IN_SEGMENT
                for tt in range(start + 1, t + 1):
                    self._seg_append_frame(tt)
            elif s.machine == IN_SEGMENT:
                for tt in range(s.latest_confirmed_speech + 1, t):
                    self._seg_append_frame(tt)
                if t - s.confirmed_start + 1 > max_seg_frames:
                    self._on_voice_end(t, False, False)
                    s.machine = END_DETECTED
                elif not is_final_frame:
                    self._seg_append_frame(t)
                else:
                    self._on_voice_end(t, False, True)
                    s.machine = END_DETECTED
        elif change == "speech2sil":
            s.continuous_silence = 0
            if s.machine == IN_SEGMENT:
                if t - s.confirmed_start + 1 > max_seg_frames:
                    self._on_voice_end(t, False, False)
                    s.machine = END_DETECTED
                elif not is_final_frame:
                    self._seg_append_frame(t)
                else:
                    self._on_voice_end(t, False, True)
                    s.machine = END_DETECTED
        elif change == "speech2speech":
            s.continuous_silence = 0
            if s.machine == IN_SEGMENT:
                if t - s.confirmed_start + 1 > max_seg_frames:
                    self._on_voice_end(t, False, False)
                    s.machine = END_DETECTED
                elif not is_final_frame:
                    self._seg_append_frame(t)
                else:
                    self._on_voice_end(t, False, True)
                    s.machine = END_DETECTED
        else:  # sil2sil
            s.continuous_silence += 1
            if s.machine == NOT_DETECTED:
                single = o.detect_mode == 0
                if (
                    single
                    and s.continuous_silence * o.frame_in_ms > o.max_start_silence_time
                ) or (is_final_frame and s.number_end_detected == 0):
                    s.latest_confirmed_silence = t - 1
                    self._on_voice_start(0, fake=True)
                    self._on_voice_end(0, True, False)
                    s.machine = END_DETECTED
                elif t >= self._latency_frames():
                    # silence confirmed up to t - latency; advance the buffer
                    s.latest_confirmed_silence = t - self._latency_frames()
                    if s.machine == NOT_DETECTED:
                        s.data_buf_start_frame = max(
                            s.data_buf_start_frame, s.latest_confirmed_silence
                        )
            elif s.machine == IN_SEGMENT:
                max_end_sil = (
                    o.max_end_silence_time - o.speech_to_sil_time_thres
                )
                if s.continuous_silence * o.frame_in_ms >= max_end_sil:
                    lookback = max_end_sil // o.frame_in_ms
                    if o.do_extend:
                        lookback -= o.lookahead_time_end_point // o.frame_in_ms
                        lookback -= 1
                        lookback = max(0, lookback)
                    self._on_voice_end(t - lookback, False, False)
                    s.machine = END_DETECTED
                elif t - s.confirmed_start + 1 > max_seg_frames:
                    self._on_voice_end(t, False, False)
                    s.machine = END_DETECTED
                elif o.do_extend and not is_final_frame:
                    if s.continuous_silence <= (
                        o.lookahead_time_end_point // o.frame_in_ms
                    ):
                        self._seg_append_frame(t)
                else:
                    if is_final_frame:
                        self._on_voice_end(t, False, True)
                        s.machine = END_DETECTED

        if s.machine == END_DETECTED and o.detect_mode == 1:
            self._reset_detection()

    def feed(self, sil_probs: np.ndarray, decibels: np.ndarray,
             is_final: bool = False):
        """Feed new frames (any count) and advance the machine."""
        s = self.state
        s.scores.extend(np.asarray(sil_probs, np.float64).tolist())
        s.decibels.extend(np.asarray(decibels, np.float64).tolist())
        n_new = len(sil_probs)
        first_new = s.frm_cnt
        s.frm_cnt += n_new
        for j in range(n_new):
            t = first_new + j
            frame_state = self._frame_state(t)
            last = is_final and (j == n_new - 1)
            # reference quirk kept for segment-boundary parity: on
            # sub-decibel-threshold frames GetFrameState (model.py:500)
            # runs DetectOneFrame itself and the caller runs it again, so
            # such frames advance the sliding window twice
            if s.decibels[t] < self.opts.decibel_thres:
                self._detect_one_frame(frame_state, t, False)
            self._detect_one_frame(frame_state, t, last)

    def pop_segments(self, streaming: bool = True) -> List[List[int]]:
        """Emit segments (reference forward:567-618).  streaming=True emits
        partials [beg,-1]/[-1,end]; otherwise only complete [beg,end]."""
        s = self.state
        out = []
        for i in range(s.out_offset, len(s.segments)):
            seg = s.segments[i]
            if streaming:
                if not seg.has_start:
                    continue
                if not s.next_seg and not seg.has_end:
                    continue
                start = seg.start_ms if s.next_seg else -1
                if seg.has_end:
                    out.append([start, seg.end_ms])
                    s.next_seg = True
                    s.out_offset += 1
                else:
                    out.append([start, -1])
                    s.next_seg = False
            else:
                if not (seg.has_start and seg.has_end):
                    continue
                out.append([seg.start_ms, seg.end_ms])
                s.out_offset += 1
        return out


def frame_decibel_device(wav: torch.Tensor, frame_length: int = 400,
                         frame_shift: int = 160) -> torch.Tensor:
    """Per-frame energy in dB of a (B, N) waveform batch in [-1, 1] on its
    device: 10 log10(sum over the frame's samples of (32768 x)^2 + 1e-6), in
    float32 (funasr_tpu/models/fsmn_vad/model.py:344).  gcd(400, 160) = 80, so
    a frame's energy is the sum of 5 consecutive 80-sample block sums at a
    stride of 2 blocks: one reshape-sum plus 5 strided adds, in the JAX
    function's order."""
    g = math.gcd(frame_length, frame_shift)
    per, step = frame_length // g, frame_shift // g
    B, N = wav.shape
    n_frames = max((N - frame_length) // frame_shift + 1, 0)
    if n_frames == 0:
        return wav.new_zeros((B, 0), dtype=torch.float32)
    w = wav.to(torch.float32) * float(1 << 15)
    sq = w * w
    m = (n_frames - 1) * step + per
    blk = sq[:, : m * g].reshape(B, m, g).sum(-1)
    e = blk[:, 0: (n_frames - 1) * step + 1: step]
    for k in range(1, per):
        e = e + blk[:, k: k + (n_frames - 1) * step + 1: step]
    return 10.0 * torch.log10(e + 1e-6)


def compute_decibel(waveform: np.ndarray, frame_length: int = 400,
                    frame_shift: int = 160) -> np.ndarray:
    """Per-frame energy in dB on the host, in float64 (reference
    ComputeDecibel, model.py:326; the waveform in [-1, 1] is scaled by
    1 << 15)."""
    w = np.asarray(waveform, np.float64) * (1 << 15)
    n = max(0, (len(w) - frame_length) // frame_shift + 1)
    if n == 0:
        return np.zeros((0,))
    sq = w * w
    frames = np.lib.stride_tricks.as_strided(
        sq, shape=(n, frame_length), strides=(sq.strides[0] * frame_shift, sq.strides[0]))
    return 10.0 * np.log10(np.einsum("ij->i", frames) + 1e-6)


@tables.register("model_classes", "FsmnVADStreaming")
class FsmnVADStreaming:
    """The VAD model (reference model.py:280): the FSMN scorer (``scorer``,
    an ``nn.Module`` on ``device``) and the state machine's options.
    ``device=None`` means the card (raises without one unless
    ``device="cpu"``).  The scorer's weights are FunASR's FSMN
    ``state_dict`` (``convert.fsmn_vad_from_jax``)."""

    def __init__(self, encoder: str = "FSMN", encoder_conf: Optional[Dict] = None,
                 device=None, **kwargs):
        self.device = resolve_device(device)
        self.scorer = tables.get("encoder_classes", encoder)(
            **dict(encoder_conf or {})).to(self.device).eval()
        self.opts = VADXOptions(**kwargs)
        self.sil_pdf_ids = list(self.opts.sil_pdf_ids)

    @torch.inference_mode()
    def score(self, feats: torch.Tensor, cache=None):
        """feats (B, T, D) -> (B, T, out) posteriors (and the new cache)."""
        return self.scorer(feats, cache)

    def sil_probs(self, posteriors: Union[np.ndarray, torch.Tensor]) -> np.ndarray:
        """The silence probability of each frame: the posteriors summed over
        ``sil_pdf_ids`` (a tensor is reduced on its device, then copied)."""
        if isinstance(posteriors, torch.Tensor):
            return posteriors[..., self.sil_pdf_ids].sum(-1).cpu().numpy()
        return np.asarray(posteriors)[..., self.sil_pdf_ids].sum(-1)

    def new_state(self) -> VadStateMachine:
        """The endpoint state machine (the Python one; the JAX package takes
        its native C++ twin when built)."""
        return VadStateMachine(self.opts)

    def segments_offline(self, feats: torch.Tensor, waveform: np.ndarray,
                         decibels=None) -> List[List[int]]:
        """Full-utterance VAD (a batch of 1) -> [[start_ms, end_ms], ...];
        ``decibels``: precomputed frame energies, else ``compute_decibel``."""
        post = self.score(feats)
        db = compute_decibel(waveform) if decibels is None else decibels
        return self.segments_from_posteriors(post, db)

    def segments_from_posteriors(self, post, decibels) -> List[List[int]]:
        """The state machine on the scorer's posteriors (a batch of 1) and the
        frame decibels (array or tensor)."""
        sil = self.sil_probs(post)[0]
        db = (decibels.cpu().numpy() if isinstance(decibels, torch.Tensor)
              else np.asarray(decibels))
        n = min(len(sil), len(db))
        sm = self.new_state()
        sm.feed(sil[:n], db[:n], is_final=True)
        return sm.pop_segments(streaming=False)
