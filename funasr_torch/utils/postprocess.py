"""Text postprocessing (copy of ``sentence_postprocess`` and
``join_segment_texts`` from funasr_tpu/utils/postprocess.py; reference
funasr/utils/postprocess_utils.py:144).

``sentence_postprocess`` joins CJK chars without spaces and ascii words with
spaces, merging BPE pieces ("@@" continuation); ``join_segment_texts``
joins the long-audio pipeline's per-segment texts by the same rule.
"""

from __future__ import annotations

from typing import List, Optional, Tuple


def _is_cjk(ch: str) -> bool:
    return (
        "一" <= ch <= "鿿"
        or "㐀" <= ch <= "䶿"
        or "豈" <= ch <= "﫿"
    )


_CJK_ONLY = None  # lazily-compiled regex, see sentence_postprocess


def sentence_postprocess(
    tokens: List[str], timestamps: Optional[List] = None
) -> Tuple:
    """Join tokens into a sentence: CJK without spaces, ascii words with
    spaces, "@@"-suffixed BPE pieces merged; drops <s>/</s>/<unk>-style
    special tokens.  Returns (text, kept_tokens[, timestamps])."""
    # Fast path for the dominant long-audio case — every token a single
    # CJK char (no specials, no BPE merges, no drops): one C-level regex
    # over the joined string replaces the per-token Python loop
    # (BENCH_PIPELINE asr_host hot spot).  Output-identical to the loop:
    # CJK tokens join bare and keep their own timestamp rows.
    global _CJK_ONLY
    joined = "".join(tokens)
    if len(joined) == len(tokens) and joined:
        if _CJK_ONLY is None:
            import re

            # exactly the _is_cjk ranges
            _CJK_ONLY = re.compile(
                "[一-鿿㐀-䶿豈-﫿]+\\Z")
        if _CJK_ONLY.match(joined):
            words = list(tokens)
            if timestamps is not None:
                return joined, list(timestamps[: len(tokens)]), words
            return joined, words
    words = []
    kept_ts: List = []
    merge_prev = False
    for i, tok in enumerate(tokens):
        t = tok.strip()
        if not t or (t.startswith("<") and t.endswith(">")):
            merge_prev = False
            continue
        piece_cont = t.endswith("@@")
        core = t[:-2] if piece_cont else t
        if merge_prev and words:
            words[-1] = words[-1] + core
            # the merged word ends when its LAST piece ends (reference
            # postprocess_utils.py:174-192 extends end per continuation)
            if kept_ts and timestamps is not None and i < len(timestamps):
                kept_ts[-1] = [kept_ts[-1][0], timestamps[i][1]]
        else:
            words.append(core)
            if timestamps is not None and i < len(timestamps):
                kept_ts.append(timestamps[i])
        merge_prev = piece_cont

    out = ""
    for w in words:
        if not w:
            continue
        if _is_cjk(w[0]):
            out += w
        else:
            out = (out + " " + w) if out and not out.endswith(" ") else out + w
    text = out.strip()
    if timestamps is not None:
        return text, kept_ts, words
    return text, words


def join_segment_texts(texts: List[str]) -> str:
    """Join per-VAD-segment texts with sentence_postprocess semantics
    (reference postprocess_utils.py:144): an ascii word is preceded by a
    space, a CJK char is not, decided at every boundary."""
    out = ""
    for t in texts:
        if not t:
            continue
        if out and not _is_cjk(t[0]) and not out.endswith(" "):
            out += " "
        out += t
    return out
