"""CIF-peak timestamp prediction + sentence stitching (copy of
funasr_tpu/utils/timestamp_tools.py, numpy only).

Reference: funasr/utils/timestamp_tools.py:31 ``ts_prediction_lfr6_standard``
(fire positions -> per-token [start_ms, end_ms] at the LFR6 60ms frame rate)
and :108 ``timestamp_sentence`` (split token timestamps into sentences at
punctuation marks).

One deliberate change from the copied file: ``ts_prediction_lfr6_batch``
sums each row's alphas over its own slice ``alphas[i, :us_lens[i]]``, not
over the padded grid (funasr_tpu's :182), so its renormalisation divisor is
the single form's bit for bit and the batch form equals
``ts_prediction_lfr6_standard`` per row by construction.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

FRAME_MS = 60  # LFR6: 10 ms shift x 6


def _cif_fire_track(alphas: np.ndarray, threshold: float) -> np.ndarray:
    """Integrate-and-fire positions for an alpha track (numpy equivalent of
    cif_predictor.py:738 ``cif_wo_hidden``): a frame fires when the running
    integral crosses the next multiple of ``threshold``."""
    s = np.cumsum(alphas.astype(np.float64))
    return np.diff(np.floor(s / threshold), prepend=0.0) >= 1.0


def ts_prediction_lfr6_standard(
    us_alphas: np.ndarray,  # (T*u,) upsampled alpha track (BiCif cif2)
    us_peaks: np.ndarray,  # (T*u,) upsampled fire track
    tokens: List[str],
    vad_offset: int = 0,
    force_time_shift: float = -1.5,
    upsample_rate: int = 3,
    build_text: bool = True,
) -> Tuple[str, List[List[int]]]:
    """Frame-accurate token timestamps from BiCif's upsampled fire track
    (reference timestamp_tools.py:31): cif2 fires when a token STARTS, so
    there are len(tokens)+1 fires and the span of token i is
    [fire(i), fire(i+1)], every fire shifted by ``force_time_shift`` frames
    (CIF delay compensation).  If the fire count disagrees, alphas are
    renormalized to sum len+1 and re-fired.  Leading/trailing silence and
    over-long (> MAX_TOKEN_DURATION) gaps become <sil> segments excluded
    from the returned list.

    Vectorized over fires (the long-audio pipeline calls this once per VAD
    segment).  ``build_text=False`` skips the kaldi-style string
    (the pipeline discards it).  Output-equal to the scalar form — pinned
    by tests/test_torch_timestamps.py fuzz vs ``_ts_prediction_lfr6_scalar``.

    Returns (kaldi-style string, [[start_ms, end_ms], ...] per token).
    """
    char_list = list(tokens)
    if not char_list:
        return "", []
    if char_list[-1] == "</s>":
        char_list = char_list[:-1]
    START_END_THRESHOLD = 5
    MAX_TOKEN_DURATION = 12  # upsampled frames
    time_rate = 10.0 * 6 / 1000 / upsample_rate  # s per upsampled frame
    alphas = np.asarray(us_alphas, np.float64).reshape(-1)
    peaks = np.asarray(us_peaks, np.float64).reshape(-1)
    fire_place = np.nonzero(peaks >= 1.0 - 1e-4)[0] + force_time_shift
    if len(fire_place) != len(char_list) + 1 and alphas.sum() > 0:
        alphas = alphas / (alphas.sum() / (len(char_list) + 1))
        fires = _cif_fire_track(alphas, 1.0 - 1e-4)
        fire_place = np.nonzero(fires)[0] + force_time_shift
    if len(fire_place) < 2:
        # degenerate fallback: one uniform span per token
        n = max(len(char_list), 1)
        T = len(peaks)
        ts = [[int(i * T / n * time_rate * 1000) + vad_offset,
               int((i + 1) * T / n * time_rate * 1000) + vad_offset]
              for i in range(len(char_list))]
        txt = ";".join(f"{c} {b/1000.0:.3f} {e/1000.0:.3f}"
                       for c, (b, e) in zip(char_list, ts)) if build_text \
            else ""
        return txt, ts

    num_frames = len(peaks)
    n = min(len(fire_place) - 1, len(char_list))
    starts = fire_place[:n]
    ends = fire_place[1 : n + 1]
    over = (ends - starts) > MAX_TOKEN_DURATION  # split: token + <sil>
    lead = bool(fire_place[0] > START_END_THRESHOLD)
    n_rows = int(lead) + n + int(over.sum())
    span_b = np.empty(n_rows, np.float64)
    span_e = np.empty(n_rows, np.float64)
    sil = np.zeros(n_rows, bool)
    # row positions: lead sil at 0; token i at lead + i + (#over before i);
    # its overflow <sil> (if any) immediately after
    off = np.concatenate(([0], np.cumsum(over[:-1]))) if n else \
        np.zeros(0, np.int64)
    pos = int(lead) + np.arange(n) + off
    if lead:
        span_b[0] = 0.0
        span_e[0] = fire_place[0]
        sil[0] = True
    span_b[pos] = starts
    span_e[pos] = np.where(over, starts + MAX_TOKEN_DURATION, ends)
    if over.any():
        pos2 = pos[over] + 1
        span_b[pos2] = starts[over] + MAX_TOKEN_DURATION
        span_e[pos2] = ends[over]
        sil[pos2] = True
    span_b *= time_rate
    span_e *= time_rate
    tail = num_frames - fire_place[-1] > START_END_THRESHOLD
    if tail:
        end = (num_frames + fire_place[-1]) * 0.5
        if n_rows:
            span_e[-1] = end * time_rate
        span_b = np.append(span_b, end * time_rate)
        span_e = np.append(span_e, num_frames * time_rate)
        sil = np.append(sil, True)
    elif n_rows:
        span_e[-1] = num_frames * time_rate
    if vad_offset:
        span_b = span_b + vad_offset / 1000.0
        span_e = span_e + vad_offset / 1000.0
    tok_b = span_b[~sil]
    tok_e = span_e[~sil]
    ts_arr = np.stack([(tok_b * 1000).astype(np.int64),
                       (tok_e * 1000).astype(np.int64)], axis=1)
    ts = ts_arr.tolist()
    if not build_text:
        return "", ts
    chars: List[str] = (["<sil>"] if lead else [])
    for i in range(n):
        chars.append(char_list[i])
        if over[i]:
            chars.append("<sil>")
    if tail:
        chars.append("<sil>")
    txt = ";".join(f"{c} {b + 0.0005:.3f} {e + 0.0005:.3f}"
                   for c, b, e in zip(chars, span_b, span_e))
    return txt, ts


def ts_prediction_lfr6_batch(
    us_alphas: np.ndarray,  # (B, T) padded upsampled alpha tracks
    us_peaks: np.ndarray,  # (B, T) padded upsampled fire tracks
    tokens_per_seg: Sequence[List[str]],
    us_lens: np.ndarray,  # (B,) true track lengths (pad-invariance)
    vad_offsets: Optional[Sequence[int]] = None,
    force_time_shift: float = -1.5,
    upsample_rate: int = 3,
) -> List[List[List[int]]]:
    """Batched ``ts_prediction_lfr6_standard`` over a padded segment grid:
    ONE vectorized renorm+refire pass (masked row cumsum) for the whole
    batch instead of B per-row numpy passes — the long-audio pipeline's
    host stage calls this once per ASR batch.

    Per-row output is EXACTLY ``ts_prediction_lfr6_standard(
    us_alphas[i, :us_lens[i]], us_peaks[i, :us_lens[i]], tokens_per_seg[i],
    vad_offset=vad_offsets[i], build_text=False)[1]`` — same float64
    arithmetic in the same order, each row's sum over its own slice; pinned
    by the batch-vs-single fuzz in tests/test_torch_timestamps.py.  Returns
    [[start_ms, end_ms], ...] per row.
    """
    B = len(tokens_per_seg)
    alphas = np.asarray(us_alphas, np.float64)
    peaks = np.asarray(us_peaks, np.float64)
    lens = np.minimum(np.asarray(us_lens, np.int64).reshape(-1),
                      peaks.shape[1])
    offs = ([0] * B if vad_offsets is None or not len(vad_offsets)
            else list(vad_offsets))
    THR = 1.0 - 1e-4
    MAX_TOKEN_DURATION = 12
    START_END_THRESHOLD = 5
    time_rate = 10.0 * 6 / 1000 / upsample_rate

    # effective char counts (trailing </s> stripped, as in the single form)
    chars = [list(t) for t in tokens_per_seg]
    for cl in chars:
        if cl and cl[-1] == "</s>":
            cl.pop()
    nchar = np.asarray([len(c) for c in chars], np.int64)

    mask = np.arange(peaks.shape[1])[None, :] < lens[:, None]
    hit = (peaks >= THR) & mask
    counts = hit.sum(1)
    # each row summed over its own slice, as the single form sums it
    sums = np.array([alphas[i, :lens[i]].sum() for i in range(B)], np.float64)
    need = (counts != nchar + 1) & (sums > 0) & (nchar > 0)
    if need.any():
        # one masked cumsum refire for every row that needs it.  NB the
        # divisor is formed exactly as the single form's
        # ``alphas / (alphas.sum() / (len+1))`` — a*(n/s) differs by ULPs
        # and can shift a floor() crossing
        denom = np.where(sums > 0, sums, 1.0) / (nchar + 1)
        A = np.where(mask, alphas, 0.0) / denom[:, None]
        fl = np.floor(np.cumsum(A, axis=1) / THR)
        refires = np.empty(fl.shape, bool)
        refires[:, 0] = fl[:, 0] >= 1.0
        np.greater_equal(fl[:, 1:] - fl[:, :-1], 1.0, out=refires[:, 1:])
        refires &= mask

    out: List[List[List[int]]] = []
    for i in range(B):
        cl = chars[i]
        if not tokens_per_seg[i] or not cl:
            out.append([])
            continue
        m = int(lens[i])
        off = offs[i]
        row = refires[i] if need[i] else hit[i]
        fp = np.nonzero(row)[0] + force_time_shift
        if len(fp) < 2:
            n = max(len(cl), 1)
            out.append([[int(j * m / n * time_rate * 1000) + off,
                         int((j + 1) * m / n * time_rate * 1000) + off]
                        for j in range(len(cl))])
            continue
        n = min(len(fp) - 1, len(cl))
        if n == 0:
            out.append([])
            continue
        starts = fp[:n]
        ends = fp[1 : n + 1]
        tok_e = np.where(ends - starts > MAX_TOKEN_DURATION,
                         starts + MAX_TOKEN_DURATION, ends)
        # the last FULL row (token n-1, or its overflow <sil>) gets its end
        # rewritten by the tail rule; that touches token n-1 only when it
        # did NOT overflow-split
        if not ends[n - 1] - starts[n - 1] > MAX_TOKEN_DURATION:
            if m - fp[-1] > START_END_THRESHOLD:
                tok_e[n - 1] = (m + fp[-1]) * 0.5
            else:
                tok_e[n - 1] = float(m)
        tok_b = starts * time_rate
        tok_e = tok_e * time_rate
        if off:
            tok_b = tok_b + off / 1000.0
            tok_e = tok_e + off / 1000.0
        out.append(np.stack([(tok_b * 1000).astype(np.int64),
                             (tok_e * 1000).astype(np.int64)],
                            axis=1).tolist())
    return out


def _ts_prediction_lfr6_scalar(
    us_alphas: np.ndarray,
    us_peaks: np.ndarray,
    tokens: List[str],
    vad_offset: int = 0,
    force_time_shift: float = -1.5,
    upsample_rate: int = 3,
) -> Tuple[str, List[List[int]]]:
    """Scalar reference form of ``ts_prediction_lfr6_standard`` (the loop
    transliteration of reference timestamp_tools.py:31) — kept as the fuzz
    oracle for the vectorized production path."""
    char_list = list(tokens)
    if not char_list:
        return "", []
    if char_list[-1] == "</s>":
        char_list = char_list[:-1]
    START_END_THRESHOLD = 5
    MAX_TOKEN_DURATION = 12  # upsampled frames
    time_rate = 10.0 * 6 / 1000 / upsample_rate  # s per upsampled frame
    alphas = np.asarray(us_alphas, np.float64).reshape(-1)
    peaks = np.asarray(us_peaks, np.float64).reshape(-1)
    fire_place = np.nonzero(peaks >= 1.0 - 1e-4)[0] + force_time_shift
    if len(fire_place) != len(char_list) + 1 and alphas.sum() > 0:
        alphas = alphas / (alphas.sum() / (len(char_list) + 1))
        fires = _cif_fire_track(alphas, 1.0 - 1e-4)
        fire_place = np.nonzero(fires)[0] + force_time_shift
    if len(fire_place) < 2:
        # degenerate fallback: one uniform span per token
        n = max(len(char_list), 1)
        T = len(peaks)
        ts = [[int(i * T / n * time_rate * 1000) + vad_offset,
               int((i + 1) * T / n * time_rate * 1000) + vad_offset]
              for i in range(len(char_list))]
        txt = ";".join(f"{c} {b/1000.0:.3f} {e/1000.0:.3f}"
                       for c, (b, e) in zip(char_list, ts))
        return txt, ts

    num_frames = len(peaks)
    spans: List[List[float]] = []
    chars: List[str] = []
    if fire_place[0] > START_END_THRESHOLD:  # leading silence
        spans.append([0.0, fire_place[0] * time_rate])
        chars.append("<sil>")
    for i in range(len(fire_place) - 1):
        if i >= len(char_list):
            break
        chars.append(char_list[i])
        if fire_place[i + 1] - fire_place[i] <= MAX_TOKEN_DURATION:
            spans.append([fire_place[i] * time_rate,
                          fire_place[i + 1] * time_rate])
        else:  # split over-long spans: token + silence
            split = fire_place[i] + MAX_TOKEN_DURATION
            spans.append([fire_place[i] * time_rate, split * time_rate])
            spans.append([split * time_rate, fire_place[i + 1] * time_rate])
            chars.append("<sil>")
    if num_frames - fire_place[-1] > START_END_THRESHOLD:  # tail silence
        end = (num_frames + fire_place[-1]) * 0.5
        if spans:
            spans[-1][1] = end * time_rate
        spans.append([end * time_rate, num_frames * time_rate])
        chars.append("<sil>")
    elif spans:
        spans[-1][1] = num_frames * time_rate
    if vad_offset:
        spans = [[b + vad_offset / 1000.0, e + vad_offset / 1000.0]
                 for b, e in spans]
    txt = ";".join(f"{c} {b + 0.0005:.3f} {e + 0.0005:.3f}"
                   for c, (b, e) in zip(chars, spans))
    ts = [[int(b * 1000), int(e * 1000)]
          for c, (b, e) in zip(chars, spans) if c != "<sil>"]
    return txt, ts


def ts_from_cif_peaks(
    peaks: np.ndarray,  # (T,) fire track at the LFR frame rate
    alphas: np.ndarray,  # (T,) alphas (renorm fallback unused here)
    tokens: List[str],
    vad_offset: int = 0,
    force_time_shift: float = -1.5,
) -> Tuple[str, List[List[int]]]:
    """Coarse per-token spans from the base CIF predictor's fire track
    (fires mark token ENDS at the 60 ms LFR rate).  TPU-design extension:
    the reference only has frame-accurate stamps via BiCif; this gives the
    plain Paraformer usable 60 ms-granular stamps.  ``force_time_shift``
    compensates the CIF integration delay on every fire."""
    peaks = np.asarray(peaks)
    if peaks.dtype != np.bool_:
        peaks = peaks > (1.0 - 1e-4)
    fire_idx = np.nonzero(peaks)[0].astype(np.float64) + 1.0 + force_time_shift
    fire_idx = np.maximum(fire_idx, 0.0)
    n = min(len(tokens), len(fire_idx))
    ts: List[List[int]] = []
    prev = 0.0
    for i in range(n):
        end = float(fire_idx[i])
        begin_ms = int(prev * FRAME_MS) + vad_offset
        end_ms = int(max(end, prev) * FRAME_MS) + vad_offset
        ts.append([begin_ms, end_ms])
        prev = max(end, prev)
    for _ in range(n, len(tokens)):
        last_end = ts[-1][1] if ts else vad_offset
        ts.append([last_end, last_end + FRAME_MS])
    text = " ".join(
        f"{t} {b/1000.0:.3f} {e/1000.0:.3f}" for t, (b, e) in zip(tokens, ts)
    )
    return text, ts


SENTENCE_END = set("。？！?!.")
COMMA = set("，,、;；")


def timestamp_sentence(
    punc_array: Sequence[int],
    timestamps: List[List[int]],
    raw_tokens: List[str],
    punc_list: Sequence[str] = ("<unk>", "_", "，", "。", "？", "、"),
) -> List[dict]:
    """Stitch token timestamps into sentence_info records
    (reference timestamp_tools.py:108): each sentence = tokens up to a
    sentence-end punctuation, with [start, end] from its token spans."""
    sentences = []
    cur_tokens: List[str] = []
    cur_ts: List[List[int]] = []
    n = min(len(raw_tokens), len(timestamps), len(punc_array))
    for i in range(n):
        cur_tokens.append(raw_tokens[i])
        cur_ts.append(timestamps[i])
        punc = punc_list[punc_array[i]] if punc_array[i] < len(punc_list) else "_"
        if punc in SENTENCE_END or punc in COMMA:
            text = "".join(cur_tokens) + (punc if punc != "_" else "")
            sentences.append({
                "text": text,
                "start": cur_ts[0][0],
                "end": cur_ts[-1][1],
                "timestamp": list(cur_ts),
            })
            cur_tokens, cur_ts = [], []
    if cur_tokens:
        sentences.append({
            "text": "".join(cur_tokens),
            "start": cur_ts[0][0],
            "end": cur_ts[-1][1],
            "timestamp": list(cur_ts),
        })
    return sentences
