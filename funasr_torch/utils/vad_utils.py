"""VAD segment utilities (copy of funasr_tpu/utils/vad_utils.py; reference
funasr/utils/vad_utils.py:21,35)."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def slice_audio_by_segments(
    waveform: np.ndarray, segments: Sequence[Sequence[int]], fs: int = 16000
) -> List[np.ndarray]:
    """Cut [start_ms, end_ms] segments out of a waveform
    (reference ``slice_padding_audio_samples``)."""
    out = []
    for start_ms, end_ms in segments:
        beg = int(start_ms * fs / 1000)
        end = int(end_ms * fs / 1000)
        out.append(waveform[beg:end])
    return out


def merge_vad(segments: List[List[int]], max_length_ms: int = 15000) -> List[List[int]]:
    """Greedily merge adjacent VAD segments while the merged span stays
    under ``max_length_ms`` (reference ``merge_vad``: short segments merged
    for efficient batching; gap time counts toward the span).  A segment
    longer than ``max_length_ms`` is kept whole, never split."""
    if max_length_ms <= 0 or not segments:
        return [list(s) for s in segments]
    merged: List[List[int]] = []
    for seg in segments:
        if merged and seg[1] - merged[-1][0] <= max_length_ms:
            merged[-1][1] = seg[1]
        else:
            merged.append(list(seg))
    return merged
