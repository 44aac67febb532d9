"""Inverse text normalization (ITN), rule-based.

The port's own copy of funasr_tpu/text/itn.py, its lazy imports pointed
at ``funasr_torch.text``: the same rules and the same output, except on
a text that ends in a connector word ("... and", "... y", "... 't"),
where the original's number scans (en, de, es/fr/pt, vi/tl) read one
token past the end and raise IndexError; here they emit the connector
and stop.

The reference ships a ~39k-LoC pynini grammar package
(fun_text_processing/inverse_text_normalization) compiled to FSTs consumed
by the C++ runtime's itn-processor.  This module provides the serving-path
capability (the websocket `itn` flag / AutoModel `use_itn`) as readable
rules per semiotic class (mirroring the reference's tagger set,
fun_text_processing/inverse_text_normalization/*/taggers/): cardinal,
decimal, percent/permille, fraction, ordinal, date, time, and money for
Chinese and English (inline below), and cardinal + decimal + ordinal +
date + time + money (+fraction where the reference has it) for the other
ten languages via funasr_torch.text.itn_classes.  Unknown patterns pass
through unchanged.
"""

from __future__ import annotations

import re
from typing import List

_ZH_DIGITS = {"零": 0, "一": 1, "二": 2, "两": 2, "三": 3, "四": 4, "五": 5,
              "六": 6, "七": 7, "八": 8, "九": 9,
              # 幺 is the spoken 1 of digit sequences (phone numbers,
              # zh taggers/telephone.py reads 幺 -> 1)
              "幺": 1}
_ZH_UNITS = {"十": 10, "百": 100, "千": 1000}
_ZH_BIG = {"万": 10**4, "亿": 10**8}
_ZH_NUM_CHARS = "".join(_ZH_DIGITS) + "".join(_ZH_UNITS) + "".join(_ZH_BIG)


def _zh_section_to_int(s: str) -> int:
    """Parse a section below 万: e.g. 三千五百二十一 -> 3521, 十五 -> 15."""
    total, cur = 0, 0
    for ch in s:
        if ch in _ZH_DIGITS:
            cur = _ZH_DIGITS[ch]
        elif ch in _ZH_UNITS:
            total += (cur if cur else 1) * _ZH_UNITS[ch]
            cur = 0
    return total + cur


def _zh_to_int(s: str) -> int:
    """Full cardinal incl. 万/亿 sections: value = head * big + rest."""
    for big_char in ("亿", "万"):
        if big_char in s:
            head, rest = s.split(big_char, 1)
            return (_zh_to_int(head) if head else 1) * _ZH_BIG[big_char] \
                + _zh_to_int(rest)
    return _zh_section_to_int(s)


def _zh_digits_seq(s: str) -> str:
    return "".join(str(_ZH_DIGITS[c]) for c in s)


def _zh_number_repl(m: re.Match) -> str:
    s = m.group(0)
    if len(s) == 1 and s in ("零",):
        return s
    # pure digit strings (e.g. phone-like 一三五...) read digit-by-digit
    if all(c in _ZH_DIGITS for c in s) and len(s) >= 4 and "零" not in s[:1]:
        # only if no unit chars; 4+ digits-in-a-row means a digit sequence
        return _zh_digits_seq(s)
    if all(c in _ZH_DIGITS for c in s) and len(s) > 1:
        return _zh_digits_seq(s)
    try:
        return str(_zh_to_int(s))
    except Exception:
        return s


def _itn_zh(text: str) -> str:
    from funasr_torch.text.itn_semiotic import (
        apply_electronic_zh, apply_measure_zh, apply_whitelist)

    text = apply_whitelist(text)
    text = apply_electronic_zh(text)
    num = f"[{_ZH_NUM_CHARS}]+"
    digits = "".join(_ZH_DIGITS)
    # permille / percent: 千分之X -> X‰, 百分之X -> X% (sign folds in:
    # 负百分之五 -> -5%), fraction X分之Y -> Y/X — ordered so the
    # percent/permille heads are consumed before the generic fraction
    text = re.sub(f"(负?)千分之({num}(?:点[{digits}]+)?)",
                  lambda m: f"{'-' if m.group(1) else ''}"
                            f"{_fmt_zh_value(m.group(2))}‰", text)
    text = re.sub(f"(负?)百分之({num}(?:点[{digits}]+)?)",
                  lambda m: f"{'-' if m.group(1) else ''}"
                            f"{_fmt_zh_value(m.group(2))}%", text)
    text = re.sub(f"({num})分之(负?)({num}(?:点[{digits}]+)?)",
                  lambda m: f"{'-' if m.group(2) else ''}"
                            f"{_fmt_zh_value(m.group(3))}/"
                            f"{_zh_to_int(m.group(1))}", text)
    # dates: digit-read years (一九九八年 -> 1998年), 月/日 pairs
    text = re.sub(f"([{digits}]{{2,4}})年",
                  lambda m: f"{_zh_digits_seq(m.group(1))}年", text)
    text = re.sub(
        f"([{_ZH_NUM_CHARS}]{{1,3}})月([{_ZH_NUM_CHARS}]{{1,3}})([日号])",
        lambda m: f"{_zh_to_int(m.group(1))}月{_zh_to_int(m.group(2))}"
                  f"{m.group(3)}", text)
    # times: only with an explicit 半/钟/分/秒 tail so decimals (三点一四)
    # stay decimals
    text = re.sub(f"([{_ZH_NUM_CHARS}]{{1,3}})点半",
                  lambda m: f"{_zh_to_int(m.group(1))}:30", text)
    text = re.sub(f"([{_ZH_NUM_CHARS}]{{1,3}})点钟",
                  lambda m: f"{_zh_to_int(m.group(1))}:00", text)
    text = re.sub(
        f"([{_ZH_NUM_CHARS}]{{1,3}})点([{_ZH_NUM_CHARS}]{{1,3}})分"
        f"(?:([{_ZH_NUM_CHARS}]{{1,3}})秒)?",
        lambda m: f"{_zh_to_int(m.group(1))}:{_zh_to_int(m.group(2)):02d}"
                  + (f":{_zh_to_int(m.group(3)):02d}" if m.group(3) else ""),
        text)
    # money: X块五 / X元五 -> X.5元 (sub-unit digit without 角/分 tail);
    # 三块五毛[二[分]] -> 3.5元 / 3.52元 (optional 分-digit consumed too)
    text = re.sub(f"({num})[块元]([{digits}])(?![{_ZH_NUM_CHARS}角毛分])",
                  lambda m: f"{_zh_to_int(m.group(1))}."
                            f"{_ZH_DIGITS[m.group(2)]}元", text)
    text = re.sub(f"({num})[块元]({num})[角毛](?:([{digits}])分?)?",
                  lambda m: f"{_zh_to_int(m.group(1))}."
                            f"{_zh_to_int(m.group(2))}"
                            f"{_ZH_DIGITS[m.group(3)] if m.group(3) else ''}"
                            f"元", text)
    # decimal: X点YZ (before the 第-ordinal rule so 第三点五名 -> 第3.5名)
    text = re.sub(
        f"({num})点([{digits}]+)",
        lambda m: f"{_zh_to_int(m.group(1))}.{_zh_digits_seq(m.group(2))}",
        text,
    )
    # ordinal: 第X -> 第N (converts single digits too: 第三 -> 第3)
    text = re.sub(f"第({num})",
                  lambda m: f"第{_zh_to_int(m.group(1))}", text)
    # negative (incl. decimals already converted above: 负3.5 -> -3.5)
    text = re.sub(f"负({num})", lambda m: f"-{_zh_to_int(m.group(1))}", text)
    text = re.sub(r"负(\d)", r"-\1", text)
    # plain cardinals (3+ chars or containing units, to leave 一个/二人 alone)
    def card(m):
        s = m.group(0)
        if len(s) == 1:
            return s
        return _zh_number_repl(m)
    text = re.sub(num, card, text)
    return apply_measure_zh(text)


def _fmt_zh_value(s: str) -> str:
    if "点" in s:
        a, b = s.split("点", 1)
        return f"{_zh_to_int(a)}.{_zh_digits_seq(b)}"
    return str(_zh_to_int(s))


_EN_ONES = {w: i for i, w in enumerate(
    ["zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
     "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
     "sixteen", "seventeen", "eighteen", "nineteen"])}
_EN_TENS = {"twenty": 20, "thirty": 30, "forty": 40, "fifty": 50,
            "sixty": 60, "seventy": 70, "eighty": 80, "ninety": 90}
_EN_SCALE = {"hundred": 100, "thousand": 1000, "million": 10**6,
             "billion": 10**9}
_EN_WORDS = set(_EN_ONES) | set(_EN_TENS) | set(_EN_SCALE) | {"and"}

# ordinal words close a cardinal span: "twenty first" -> 21st
_EN_ORD_ONES = {"first": 1, "second": 2, "third": 3, "fourth": 4,
                "fifth": 5, "sixth": 6, "seventh": 7, "eighth": 8,
                "ninth": 9, "tenth": 10, "eleventh": 11, "twelfth": 12,
                "thirteenth": 13, "fourteenth": 14, "fifteenth": 15,
                "sixteenth": 16, "seventeenth": 17, "eighteenth": 18,
                "nineteenth": 19}
_EN_ORD_TENS = {"twentieth": 20, "thirtieth": 30, "fortieth": 40,
                "fiftieth": 50, "sixtieth": 60, "seventieth": 70,
                "eightieth": 80, "ninetieth": 90}
_EN_ORD_SCALE = {"hundredth": 100, "thousandth": 1000,
                 "millionth": 10**6, "billionth": 10**9}
_EN_ORDS = {**_EN_ORD_ONES, **_EN_ORD_TENS, **_EN_ORD_SCALE}

_EN_CURRENCY = {"dollar": "$", "dollars": "$", "euro": "€", "euros": "€",
                "pound": "£", "pounds": "£", "yuan": "¥"}
_EN_CENTS = {"cent", "cents", "penny", "pence"}


def _en_ordinal_suffix(n: int) -> str:
    if 10 <= n % 100 <= 13:
        return "th"
    return {1: "st", 2: "nd", 3: "rd"}.get(n % 10, "th")


def _en_words_to_int(words: List[str]) -> int:
    total, cur = 0, 0
    for w in words:
        if w == "and":
            continue
        if w in _EN_ONES:
            cur += _EN_ONES[w]
        elif w in _EN_TENS:
            cur += _EN_TENS[w]
        elif w == "hundred":
            cur = max(cur, 1) * 100
        else:  # thousand/million/billion
            total += max(cur, 1) * _EN_SCALE[w]
            cur = 0
    return total + cur


def _itn_en(text: str) -> str:
    from funasr_torch.text.itn_semiotic import (
        apply_electronic_en, apply_measure_en, apply_telephone_en,
        apply_time_en, apply_whitelist, apply_year_en)

    text = apply_whitelist(text)
    text = apply_electronic_en(text)
    text = apply_telephone_en(text)
    text = apply_time_en(text)
    text = apply_year_en(text)
    # hyphenated tens-ones compounds ("twenty-one", "forty-second") split
    # into their word parts; anything else ("fifty-fifty", "one-two") is
    # an idiom, not a numeral, and stays joined
    def _split_hyphen(m):
        a, b = m.group(1).lower(), m.group(2).lower()
        tens_ones = (a in _EN_TENS
                     and ((b in _EN_ONES and 1 <= _EN_ONES[b] <= 9)
                          or (b in _EN_ORD_ONES and _EN_ORD_ONES[b] <= 9)))
        scale_pair = a in _EN_ONES and (b in _EN_SCALE or b in _EN_ORD_SCALE)
        return f"{m.group(1)} {m.group(2)}" if tens_ones or scale_pair \
            else m.group(0)

    text = re.sub(r"\b([a-zA-Z]+)-([a-zA-Z]+)\b", _split_hyphen, text)
    tokens = text.split(" ")
    out: List[str] = []
    i = 0
    while i < len(tokens):
        j = i
        span: List[str] = []
        while j < len(tokens) and tokens[j].lower() in _EN_WORDS:
            span.append(tokens[j].lower())
            j += 1
        # trim leading/trailing 'and' (leading ones are emitted, not
        # swallowed: "rock and roll" keeps its "and")
        while span and span[0] == "and":
            span.pop(0)
            out.append(tokens[i])
            i += 1
        while span and span[-1] == "and":
            span.pop(); j -= 1
        meaningful = [w for w in span if w != "and"]

        # ordinal tail closes the span: "twenty first" -> 21st,
        # "hundredth" -> 100th (lone small ordinals like "first" stay
        # spoken, matching the conservative lone-cardinal policy).  A
        # single bridging "and" is allowed: "two thousand and tenth".
        jo = j
        if (meaningful and jo < len(tokens) and tokens[jo].lower() == "and"
                and jo + 1 < len(tokens)
                and tokens[jo + 1].lower() in _EN_ORDS):
            jo += 1
        ord_word = (tokens[jo].lower()
                    if jo < len(tokens) and tokens[jo].lower() in _EN_ORDS
                    else None)
        # an ordinal-ONES tail only compounds with a tens/scale head
        # ("twenty first" -> 21st, "hundred and second" -> 102nd); after a
        # ones/teens head it is its own word ("one second" is a duration,
        # not 3rd)
        if (ord_word and ord_word in _EN_ORD_ONES and meaningful
                and meaningful[-1] in _EN_ONES):
            ord_word = None
        if ord_word and (meaningful
                         or _EN_ORDS[ord_word] >= 20):
            val = _en_words_to_int(span) if span else 0
            o = _EN_ORDS[ord_word]
            if o >= 100 and val:
                val *= o
            else:
                val += o
            out.append(f"{val}{_en_ordinal_suffix(val)}")
            i = jo + 1
            continue

        # a strong tail cue (percent / currency / "point <digit>")
        # licenses converting even a lone small cardinal: "five percent"
        # -> 5%, "three point one four" -> 3.14
        cue = False
        if len(meaningful) == 1 and j < len(tokens):
            from funasr_torch.text.itn_semiotic import _en_unit_abbr

            nxt = tokens[j].lower()
            cue = (nxt == "percent" or nxt in _EN_CURRENCY
                   or nxt in ("degree", "degrees")
                   or _en_unit_abbr(nxt) is not None
                   or (nxt == "point" and j + 1 < len(tokens)
                       and tokens[j + 1].lower() in _EN_ONES
                       and _EN_ONES[tokens[j + 1].lower()] <= 9))
        if len(meaningful) >= 2 or (len(meaningful) == 1
                                    and (meaningful[0] in _EN_TENS or cue)):
            val = _en_words_to_int(span)
            sign = ""
            if out and out[-1].lower() in ("minus", "negative"):
                out.pop()
                sign = "-"
            rendered = f"{sign}{val}"

            # decimal tail: "three point one four" -> 3.14
            if (j < len(tokens) and tokens[j].lower() == "point"
                    and j + 1 < len(tokens)
                    and tokens[j + 1].lower() in _EN_ONES
                    and _EN_ONES[tokens[j + 1].lower()] <= 9):
                frac = []
                j += 1
                while (j < len(tokens) and tokens[j].lower() in _EN_ONES
                       and _EN_ONES[tokens[j].lower()] <= 9):
                    frac.append(str(_EN_ONES[tokens[j].lower()]))
                    j += 1
                rendered = f"{rendered}.{''.join(frac)}"

            if j < len(tokens) and tokens[j].lower() == "percent":
                out.append(rendered + "%")
                i = j + 1
                continue

            # money: "<N> dollars [and <M> cents]" -> $N[.MM]
            if j < len(tokens) and tokens[j].lower() in _EN_CURRENCY:
                cur = _EN_CURRENCY[tokens[j].lower()]
                j += 1
                k = j
                if k < len(tokens) and tokens[k].lower() == "and":
                    k += 1
                cs: List[str] = []
                while k < len(tokens) and tokens[k].lower() in _EN_WORDS:
                    cs.append(tokens[k].lower())
                    k += 1
                if (cs and "." not in rendered and k < len(tokens)
                        and tokens[k].lower() in _EN_CENTS):
                    # cents merge only for whole-dollar heads; a decimal
                    # head ("two point five dollars") keeps its fraction
                    # and leaves the cents phrase as text
                    cents = _en_words_to_int(cs)
                    out.append(f"{sign}{cur}{val}.{cents:02d}")
                    i = k + 1
                else:
                    out.append(f"{sign}{cur}{rendered.lstrip('-')}")
                    i = j
                continue

            out.append(rendered)
            i = j
        elif i < len(tokens):  # a trailing connector already emitted
            out.append(tokens[i])
            i += 1
    return apply_measure_en(" ".join(out))


# --------------------------------------------------------------- Japanese
# Kanji numerals share the Chinese structure; map the JP-specific forms
# onto the zh tables (億 = 亿, 萬 = 万).
_JA_TRANS = str.maketrans({"億": "亿", "萬": "万", "兩": "两"})


def _itn_ja(text: str) -> str:
    return _itn_zh(text.translate(_JA_TRANS))


# ----------------------------------------------------------------- Korean
# Sino-Korean numerals follow the same positional structure as Chinese.
_KO_DIGITS = {"영": 0, "공": 0, "일": 1, "이": 2, "삼": 3, "사": 4,
              "오": 5, "육": 6, "칠": 7, "팔": 8, "구": 9}
_KO_UNITS = {"십": 10, "백": 100, "천": 1000}
_KO_BIG = {"만": 10**4, "억": 10**8}
_KO_CHARS = "".join(_KO_DIGITS) + "".join(_KO_UNITS) + "".join(_KO_BIG)


def _ko_section(s: str) -> int:
    total, cur = 0, 0
    for ch in s:
        if ch in _KO_DIGITS:
            cur = _KO_DIGITS[ch]
        elif ch in _KO_UNITS:
            total += (cur if cur else 1) * _KO_UNITS[ch]
            cur = 0
    return total + cur


def _ko_to_int(s: str) -> int:
    for big in ("억", "만"):
        if big in s:
            head, rest = s.split(big, 1)
            return (_ko_to_int(head) if head else 1) * _KO_BIG[big] \
                + _ko_to_int(rest)
    return _ko_section(s)


def _itn_ko(text: str) -> str:
    num = f"[{_KO_CHARS}]+"

    def card(m):
        s = m.group(0)
        if len(s) == 1 and s in _KO_DIGITS:
            return s
        try:
            return str(_ko_to_int(s))
        except Exception:
            return s

    text = re.sub(f"({num})\\s*퍼센트", lambda m: f"{_ko_to_int(m.group(1))}%",
                  text)
    return re.sub(num, card, text)


# ------------------------------------------------- Western word cardinals
# Additive space-separated parsers for es / fr / de (cardinals + percents).
_ES_VOCAB = {
    "cero": 0, "uno": 1, "una": 1, "un": 1, "dos": 2, "tres": 3,
    "cuatro": 4, "cinco": 5, "seis": 6, "siete": 7, "ocho": 8, "nueve": 9,
    "diez": 10, "once": 11, "doce": 12, "trece": 13, "catorce": 14,
    "quince": 15, "dieciséis": 16, "dieciseis": 16, "diecisiete": 17,
    "dieciocho": 18, "diecinueve": 19, "veinte": 20, "veintiuno": 21,
    "veintidós": 22, "veintidos": 22, "veintitrés": 23, "veintitres": 23,
    "treinta": 30, "cuarenta": 40, "cincuenta": 50, "sesenta": 60,
    "setenta": 70, "ochenta": 80, "noventa": 90, "cien": 100,
    "ciento": 100, "doscientos": 200, "trescientos": 300,
    "cuatrocientos": 400, "quinientos": 500, "seiscientos": 600,
    "setecientos": 700, "ochocientos": 800, "novecientos": 900,
}
_ES_SCALE = {"mil": 1000, "millón": 10**6, "millon": 10**6,
             "millones": 10**6}

_FR_VOCAB = {
    "zéro": 0, "zero": 0, "un": 1, "une": 1, "deux": 2, "trois": 3,
    "quatre": 4, "cinq": 5, "six": 6, "sept": 7, "huit": 8, "neuf": 9,
    "dix": 10, "onze": 11, "douze": 12, "treize": 13, "quatorze": 14,
    "quinze": 15, "seize": 16, "vingt": 20, "trente": 30, "quarante": 40,
    "cinquante": 50, "soixante": 60, "cent": 100, "cents": 100,
}
_FR_SCALE = {"mille": 1000, "million": 10**6, "millions": 10**6}

_DE_ATOMS = {
    "null": 0, "ein": 1, "eins": 1, "eine": 1, "zwei": 2, "drei": 3,
    "vier": 4, "fünf": 5, "fuenf": 5, "sechs": 6, "sieben": 7, "acht": 8,
    "neun": 9, "zehn": 10, "elf": 11, "zwölf": 12, "zwoelf": 12,
    "dreizehn": 13, "vierzehn": 14, "fünfzehn": 15, "sechzehn": 16,
    "siebzehn": 17, "achtzehn": 18, "neunzehn": 19, "zwanzig": 20,
    "dreißig": 30, "dreissig": 30, "vierzig": 40, "fünfzig": 50,
    "fuenfzig": 50, "sechzig": 60, "siebzig": 70, "achtzig": 80,
    "neunzig": 90, "hundert": 100, "tausend": 1000, "und": -1,
}


def _western_span_to_int(words, vocab, scale) -> int:
    total, cur = 0, 0
    for w in words:
        if w in vocab:
            v = vocab[w]
            if v == 100 and cur:
                cur *= 100
            elif v == 100:
                cur = 100
            else:
                cur += v
        elif w in scale:
            total += max(cur, 1) * scale[w]
            cur = 0
    return total + cur


def _make_western_itn(vocab, scale, pct_words, connectors=()):
    connectors = set(connectors)
    keys = set(vocab) | set(scale) | connectors

    def run(text: str) -> str:
        tokens = text.split(" ")
        out: List[str] = []
        i = 0
        while i < len(tokens):
            j = i
            span: List[str] = []
            while j < len(tokens) and tokens[j].lower() in keys:
                span.append(tokens[j].lower())
                j += 1
            # leading connectors are emitted, not swallowed ("perros y
            # gatos" keeps its "y")
            while span and span[0] in connectors:
                span.pop(0)
                out.append(tokens[i])
                i += 1
            while span and span[-1] in connectors:
                span.pop()
                j -= 1
            meaningful = [w for w in span if w not in connectors]
            # a percent tail licenses even a lone small cardinal
            # ("doze por cento" -> 12%), like the en cue policy
            pct_cue = False
            if len(meaningful) == 1 and j < len(tokens):
                one = tokens[j].lower()
                two = (one + " " + tokens[j + 1].lower()
                       if j + 1 < len(tokens) else "")
                pct_cue = one in pct_words or two in pct_words
            if len(meaningful) >= 2 or (
                    len(meaningful) == 1
                    and (vocab.get(meaningful[0], 0) >= 20
                         or meaningful[0] in scale or pct_cue)):
                val = _western_span_to_int(
                    [w for w in span if w not in connectors],
                    vocab, scale)
                suffix = ""
                # multiword percent phrases ("por ciento", "por cento")
                # must consume BOTH tokens — a bare first word would leave
                # the tail ("ciento" = 100) to be re-parsed as a number
                pair = (tokens[j].lower() + " " + tokens[j + 1].lower()
                        if j + 1 < len(tokens) else "")
                if pair and pair in pct_words:
                    suffix = "%"
                    j += 2
                elif j < len(tokens) and tokens[j].lower() in pct_words:
                    suffix = "%"
                    j += 1
                out.append(str(val) + suffix)
                i = j
            elif i < len(tokens):  # a trailing connector already emitted
                out.append(tokens[i])
                i += 1
        return " ".join(out)

    return run


_itn_es = _make_western_itn(_ES_VOCAB, _ES_SCALE,
                            {"porciento", "por ciento", "por cien", "percent"},
                            connectors={"y"})
_itn_fr = _make_western_itn(_FR_VOCAB, _FR_SCALE, {"pourcent"},
                            connectors={"et"})


def _de_compound_to_int(word: str):
    """Greedy segmentation of a German compound numeral, evaluated with
    the 'einundzwanzig' (ones-before-tens) rule."""
    w = word.lower()
    parts: List[int] = []
    while w:
        for k in sorted(_DE_ATOMS, key=len, reverse=True):
            if w.startswith(k):
                parts.append(_DE_ATOMS[k])
                w = w[len(k):]
                break
        else:
            return None
    parts = [p for p in parts if p >= 0]  # drop 'und'
    total, cur, pending_ones = 0, 0, 0
    for v in parts:
        if v == 100 or v == 1000:
            cur = (cur + pending_ones) or 1
            if v == 1000:
                total += cur * 1000
                cur = 0
            else:
                cur *= 100
            pending_ones = 0
        elif v < 10:
            pending_ones += v
        else:
            cur += v + pending_ones
            pending_ones = 0
    return total + cur + pending_ones


def _itn_de(text: str) -> str:
    # spaced number spans first ("zwei tausend dreizehn" -> 2013, the
    # spoken form in the reference de/taggers/date.py examples): join
    # consecutive numeral-parsable tokens into one compound
    tokens = text.split(" ")
    out: List[str] = []
    i = 0
    while i < len(tokens):
        j = i
        span: List[str] = []
        while j < len(tokens):
            low = tokens[j].lower()
            if low == "und" or _de_compound_to_int(low) is not None:
                span.append(low)
                j += 1
            else:
                break
        while span and span[0] == "und":
            span.pop(0)
            out.append(tokens[i])
            i += 1
        while span and span[-1] == "und":
            span.pop()
            j -= 1
        if len(span) >= 2:
            out.append(str(_de_compound_to_int("".join(span))))
            i = j
        elif i < len(tokens):  # a trailing connector already emitted
            out.append(tokens[i])
            i += 1
    text = " ".join(out)

    def repl(m):
        v = _de_compound_to_int(m.group(0))
        return str(v) if v is not None and len(m.group(0)) > 4 else m.group(0)

    return re.sub(r"[A-Za-zäöüß]+", repl, text)


# -------------------------------------------- Portuguese / Russian (additive)
_PT_VOCAB = {
    "zero": 0, "um": 1, "uma": 1, "dois": 2, "duas": 2, "três": 3,
    "tres": 3, "quatro": 4, "cinco": 5, "seis": 6, "sete": 7, "oito": 8,
    "nove": 9, "dez": 10, "onze": 11, "doze": 12, "treze": 13,
    "catorze": 14, "quatorze": 14, "quinze": 15, "dezesseis": 16,
    "dezessete": 17, "dezoito": 18, "dezenove": 19, "vinte": 20,
    "trinta": 30, "quarenta": 40, "cinquenta": 50, "sessenta": 60,
    "setenta": 70, "oitenta": 80, "noventa": 90, "cem": 100, "cento": 100,
    "duzentos": 200, "trezentos": 300, "quatrocentos": 400,
    "quinhentos": 500, "seiscentos": 600, "setecentos": 700,
    "oitocentos": 800, "novecentos": 900,
}
_PT_SCALE = {"mil": 1000, "milhão": 10**6, "milhao": 10**6,
             "milhões": 10**6, "milhoes": 10**6}

_RU_VOCAB = {
    "ноль": 0, "один": 1, "одна": 1, "одно": 1, "два": 2, "две": 2,
    "три": 3, "четыре": 4, "пять": 5, "шесть": 6, "семь": 7,
    "восемь": 8, "девять": 9, "десять": 10, "одиннадцать": 11,
    "двенадцать": 12, "тринадцать": 13, "четырнадцать": 14,
    "пятнадцать": 15, "шестнадцать": 16, "семнадцать": 17,
    "восемнадцать": 18, "девятнадцать": 19, "двадцать": 20,
    "тридцать": 30, "сорок": 40, "пятьдесят": 50, "шестьдесят": 60,
    "семьдесят": 70, "восемьдесят": 80, "девяносто": 90, "сто": 100,
    "двести": 200, "триста": 300, "четыреста": 400, "пятьсот": 500,
    "шестьсот": 600, "семьсот": 700, "восемьсот": 800, "девятьсот": 900,
}
_RU_SCALE = {"тысяча": 1000, "тысячи": 1000, "тысяч": 1000,
             "миллион": 10**6, "миллиона": 10**6, "миллионов": 10**6}

_itn_pt = _make_western_itn(_PT_VOCAB, _PT_SCALE,
                            {"porcento", "por cento"},
                            connectors={"e"})
_itn_ru = _make_western_itn(_RU_VOCAB, _RU_SCALE,
                            {"процент", "процента", "процентов"})


# ---------------------------------- Indonesian / Vietnamese / Tagalog
# These grammars build numbers with unit-multiplier words ("dua puluh" =
# 2 x 10, "hai mươi ba" = 2 x 10 + 3), so the additive western parser
# would misread them; this positional parser closes a section on each
# multiplier, exactly like the CJK positional grammar above.
def _positional_span_to_int(words, digits, units, bigs,
                            standalones) -> int:
    total, section, cur, has_cur = 0, 0, 0, False
    for w in words:
        if w in digits:
            cur += digits[w]
            has_cur = True
        elif w in standalones:
            # self-contained section values ("seratus" = 100): close into
            # the section so a following unit can't re-multiply them
            section += cur + standalones[w]
            cur, has_cur = 0, False
        elif w in units:
            # explicit zero counts ("không trăm" = zero hundreds) — only
            # default to 1 when no digit preceded the unit
            section += (cur if has_cur else 1) * units[w]
            cur, has_cur = 0, False
        elif w in bigs:
            total += max(section + cur, 1) * bigs[w]
            section, cur, has_cur = 0, 0, False
    return total + section + cur


def _make_positional_itn(digits, units, bigs, pct_phrases, connectors=(),
                         standalones=None):
    connectors = set(connectors)
    standalones = standalones or {}
    keys = (set(digits) | set(units) | set(bigs) | set(standalones)
            | connectors)
    pct_phrases = [tuple(p.split(" ")) for p in pct_phrases]

    def run(text: str) -> str:
        tokens = text.split(" ")
        out: List[str] = []
        i = 0
        while i < len(tokens):
            j = i
            span: List[str] = []
            while j < len(tokens) and tokens[j].lower() in keys:
                span.append(tokens[j].lower())
                j += 1
            # leading connectors are emitted, not swallowed
            while span and span[0] in connectors:
                span.pop(0)
                out.append(tokens[i])
                i += 1
            while span and span[-1] in connectors:
                span.pop()
                j -= 1
            meaningful = [w for w in span if w not in connectors]
            if len(meaningful) >= 2 or (
                    len(meaningful) == 1
                    and (digits.get(meaningful[0], 0) >= 10
                         or meaningful[0] in units or meaningful[0] in bigs
                         or meaningful[0] in standalones)):
                if (len(meaningful) >= 3
                        and all(w in digits and digits[w] <= 9
                                for w in meaningful)):
                    # digit-sequence reading ("một chín chín chín" ->
                    # 1999, reference vi year tagger)
                    val = int("".join(str(digits[w]) for w in meaningful))
                else:
                    val = _positional_span_to_int(meaningful, digits,
                                                  units, bigs, standalones)
                suffix = ""
                for ph in pct_phrases:
                    nxt = tuple(t.lower() for t in tokens[j: j + len(ph)])
                    if nxt == ph:
                        suffix = "%"
                        j += len(ph)
                        break
                out.append(str(val) + suffix)
                i = j
            elif i < len(tokens):  # a trailing connector already emitted
                out.append(tokens[i])
                i += 1
        return " ".join(out)

    return run


_ID_DIGITS = {
    "nol": 0, "kosong": 0, "satu": 1, "dua": 2, "tiga": 3, "empat": 4,
    "lima": 5, "enam": 6, "tujuh": 7, "delapan": 8, "sembilan": 9,
    "sepuluh": 10, "sebelas": 11, "belas": 10,  # "dua belas" = 2 + 10
}
_ID_UNITS = {"puluh": 10, "ratus": 100}
_ID_BIGS = {"seribu": 1000, "ribu": 1000, "juta": 10**6}
_ID_STANDALONE = {"seratus": 100}

_VI_DIGITS = {
    "không": 0, "một": 1, "mốt": 1, "hai": 2, "ba": 3, "bốn": 4, "tư": 4,
    "năm": 5, "lăm": 5, "sáu": 6, "bảy": 7, "tám": 8, "chín": 9,
    "mười": 10,
}
_VI_UNITS = {"mươi": 10, "trăm": 100}
_VI_BIGS = {"nghìn": 1000, "ngàn": 1000, "triệu": 10**6}

_TL_DIGITS = {
    "isa": 1, "isang": 1, "dalawa": 2, "dalawang": 2, "tatlo": 3,
    "tatlong": 3, "apat": 4, "lima": 5, "limang": 5, "anim": 6, "pito": 7,
    "pitong": 7, "walo": 8, "walong": 8, "siyam": 9, "sampu": 10,
    "dalawampu": 20, "tatlumpu": 30, "apatnapu": 40, "limampu": 50,
    "animnapu": 60, "pitumpu": 70, "walumpu": 80, "siyamnapu": 90,
    # labing- teens (common spaced/joined spoken forms)
    "labing-isa": 11, "labingisa": 11, "labindalawa": 12, "labintatlo": 13,
    "labing-apat": 14, "labing-lima": 15, "labinlima": 15, "labing-anim": 16,
    "labimpito": 17, "labing-walo": 18, "labinsiyam": 19,
}
_TL_UNITS = {"daan": 100, "raan": 100}
_TL_BIGS = {"libo": 1000, "libong": 1000, "milyon": 10**6}

_itn_id = _make_positional_itn(_ID_DIGITS, _ID_UNITS, _ID_BIGS, {"persen"},
                               standalones=_ID_STANDALONE)
_itn_vi = _make_positional_itn(_VI_DIGITS, _VI_UNITS, _VI_BIGS,
                               {"phần trăm"}, connectors={"linh", "lẻ"})
_itn_tl = _make_positional_itn(_TL_DIGITS, _TL_UNITS, _TL_BIGS,
                               {"porsyento"}, connectors={"at", "'t"},
                               standalones={"sandaan": 100, "sanlibo": 1000})


def inverse_normalize(text: str, lang: str = "zh") -> str:
    """Spoken-form -> written-form for numbers/decimals/percents.

    Language coverage matches the reference fun_text_processing set (zh en
    ja ko de es fr id pt ru tl vi, inverse_text_normalization/ dirs): zh/en
    are the deepest; ja/ko share the CJK positional grammar; es/fr/de/pt/ru
    cover additive cardinals + percents; id/vi/tl use the unit-multiplier
    positional parser.  Unknown languages pass through unchanged.
    """
    lang = lang.lower()
    cardinal = {
        "zh": _itn_zh, "en": _itn_en, "ja": _itn_ja, "ko": _itn_ko,
        "es": _itn_es, "fr": _itn_fr, "de": _itn_de, "pt": _itn_pt,
        "ru": _itn_ru, "id": _itn_id, "vi": _itn_vi, "tl": _itn_tl,
    }
    key = next((k for k in cardinal if lang.startswith(k)), None)
    if key is None:
        return text
    # class rules (date/time/money/ordinal/decimal/fraction) around the
    # cardinal pass: word-context pre-rules first, digit-context
    # post-rules after (funasr_torch.text.itn_classes; zh/en carry their
    # class rules inline in _itn_zh/_itn_en)
    from funasr_torch.text import itn_classes, itn_semiotic

    if key not in ("zh", "en"):
        # telephone/electronic word-level classes (zh/en run theirs
        # inline); measure runs after digits exist
        text = itn_semiotic.secondary_pre(key, text)
    pre = itn_classes.PRE.get(key)
    post = itn_classes.POST.get(key)
    if pre is not None:
        text = pre(text)
    if key not in ("zh", "en"):
        # word-level measure AFTER the time/money/date classes (the
        # reference classify weights put time above measure: "два часа
        # пятнадцать минут" is a clock, not 2 ч + 15 мин)
        text = itn_semiotic.secondary_measure_words(key, text)
    text = cardinal[key](text)
    if post is not None:
        text = post(text)
    if key not in ("zh", "en"):
        text = itn_semiotic.secondary_post(key, text)
    return text
