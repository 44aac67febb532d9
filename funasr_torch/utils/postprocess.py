"""Text postprocessing (copy of ``sentence_postprocess``,
``join_segment_texts`` and the SenseVoice rich-tag decoding
``rich_transcription_postprocess`` from funasr_tpu/utils/postprocess.py;
reference funasr/utils/postprocess_utils.py:144, :399).

``sentence_postprocess`` joins CJK chars without spaces and ascii words with
spaces, merging BPE pieces ("@@" continuation); ``join_segment_texts``
joins the long-audio pipeline's per-segment texts by the same rule;
``rich_transcription_postprocess`` turns SenseVoice's language, emotion,
event and text-norm tags into plain text and emoji (the tag tables are
part of SenseVoice's output protocol, reproduced verbatim).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

EMO_DICT = {
    "<|HAPPY|>": "😊", "<|SAD|>": "😔", "<|ANGRY|>": "😡", "<|NEUTRAL|>": "",
    "<|FEARFUL|>": "😰", "<|DISGUSTED|>": "🤢", "<|SURPRISED|>": "😮",
}

EVENT_DICT = {
    "<|BGM|>": "🎼", "<|Speech|>": "", "<|Applause|>": "👏",
    "<|Laughter|>": "😀", "<|Cry|>": "😭", "<|Sneeze|>": "🤧",
    "<|Breath|>": "", "<|Cough|>": "🤧",
}

LANG_DICT = {
    "<|zh|>": "<|lang|>", "<|en|>": "<|lang|>", "<|yue|>": "<|lang|>",
    "<|ja|>": "<|lang|>", "<|ko|>": "<|lang|>", "<|nospeech|>": "<|lang|>",
}

EMOJI_DICT = {
    "<|nospeech|><|Event_UNK|>": "❓", "<|zh|>": "", "<|en|>": "",
    "<|yue|>": "", "<|ja|>": "", "<|ko|>": "", "<|nospeech|>": "",
    "<|HAPPY|>": "😊", "<|SAD|>": "😔", "<|ANGRY|>": "😡", "<|NEUTRAL|>": "",
    "<|BGM|>": "🎼", "<|Speech|>": "", "<|Applause|>": "👏",
    "<|Laughter|>": "😀", "<|FEARFUL|>": "😰", "<|DISGUSTED|>": "🤢",
    "<|SURPRISED|>": "😮", "<|Cry|>": "😭", "<|EMO_UNKNOWN|>": "",
    "<|Sneeze|>": "🤧", "<|Breath|>": "", "<|Cough|>": "😷", "<|Sing|>": "",
    "<|Speech_Noise|>": "", "<|withitn|>": "", "<|woitn|>": "",
    "<|GBG|>": "", "<|Event_UNK|>": "",
}

EMO_SET = {"😊", "😔", "😡", "😰", "🤢", "😮"}
EVENT_SET = {"🎼", "👏", "😀", "😭", "🤧", "😷"}


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


def format_str_v2(s: str) -> str:
    """One-language-span normalization (postprocess_utils.py:379)."""
    counts = {}
    for tag in EMOJI_DICT:
        counts[tag] = s.count(tag)
        s = s.replace(tag, "")
    emo = "<|NEUTRAL|>"
    for e in EMO_DICT:
        if counts.get(e, 0) > counts.get(emo, 0):
            emo = e
    for e in EVENT_DICT:
        if counts.get(e, 0) > 0:
            s = EVENT_DICT[e] + s
    s = s + EMO_DICT[emo]
    for emoji in EMO_SET | EVENT_SET:
        s = s.replace(" " + emoji, emoji).replace(emoji + " ", emoji)
    return s.strip()


def rich_transcription_postprocess(s: str) -> str:
    """Decode SenseVoice rich-tag output (postprocess_utils.py:399)."""

    def get_emo(x):
        return x[-1] if x and x[-1] in EMO_SET else None

    def get_event(x):
        return x[0] if x and x[0] in EVENT_SET else None

    s = s.replace("<|nospeech|><|Event_UNK|>", "❓")
    for lang in LANG_DICT:
        s = s.replace(lang, "<|lang|>")
    parts = [format_str_v2(p).strip(" ") for p in s.split("<|lang|>")]
    new_s = " " + parts[0] if parts else ""
    cur_event = get_event(new_s)
    for p in parts[1:]:
        if not p:
            continue
        if get_event(p) == cur_event and get_event(p) is not None:
            p = p[1:]
        cur_event = get_event(p)
        if get_emo(p) is not None and get_emo(p) == get_emo(new_s):
            new_s = new_s[:-1]
        new_s += p.strip().lstrip()
    new_s = new_s.replace("The.", " ")
    return new_s.strip()
