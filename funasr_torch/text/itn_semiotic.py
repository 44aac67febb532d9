"""Measure / telephone / electronic / whitelist ITN classes for zh and en.

The port's own copy of funasr_tpu/text/itn_semiotic.py, its lazy imports pointed
at ``funasr_torch.text``: the same rules and the same output.

The reference's flagship-language grammars carry four semiotic classes
beyond the date/time/money/ordinal/decimal set implemented in itn.py /
itn_classes.py:

- measure  (inverse_text_normalization/{en,zh}/taggers/measure.py:
  "minus twelve kilograms" -> "-12 kg"; zh units map through
  data/measurements_en.tsv, e.g. 摄氏度 -> °C)
- telephone (taggers/telephone.py: digit-word runs incl. double/triple
  and o/oh for 0; 10-digit US numbers group 123-123-5678, "dot" makes IPs)
- electronic (taggers/electronic.py + data/electronic/*: spelled
  user "at" server "dot" domain -> user@server.domain)
- whitelist (taggers/whitelist.py + data/whitelist.tsv inverted:
  "misses" -> "mrs.", "a t m" -> "ATM"; highest classify priority)

These run as pre-passes (word-level classes, before cardinal spans merge)
and post-passes (measure, after numbers are digits) from itn._itn_en /
itn._itn_zh.
"""

from __future__ import annotations

import re

# ------------------------------------------------------------- whitelist
# data/whitelist.tsv (written<TAB>spoken), inverted for ITN: spoken ->
# written.  zh shares the en table verbatim (zh/data/whitelist.tsv).
_WHITELIST = [
    ("for example", "e.g."),
    ("mister", "mr."),
    ("misses", "mrs."),
    ("a s a p", "ASAP"),
    ("a t and t", "AT&T"),
    ("a t m", "ATM"),
    ("s and p", "S&P"),
    ("seven eleven", "7-eleven"),
    ("e s three", "es3"),
    ("l l p", "LLP"),
]
_WHITELIST_RE = [
    (re.compile(rf"\b{re.escape(sp)}\b", re.IGNORECASE), wr)
    for sp, wr in _WHITELIST
]


def apply_whitelist(text: str) -> str:
    for pat, written in _WHITELIST_RE:
        text = pat.sub(written, text)
    return text


# ------------------------------------------------------------- telephone
_TEL_DIGIT = {"zero": "0", "oh": "0", "o": "0", "one": "1", "two": "2",
              "three": "3", "four": "4", "five": "5", "six": "6",
              "seven": "7", "eight": "8", "nine": "9"}
_TEL_MULT = {"double": 2, "triple": 3}


def _tel_span_digits(tokens, i):
    """Consume a digit-word run starting at i; returns (digits, next_i,
    saw_dot).  Supports double/triple X and 'dot' separators (IPs)."""
    digits = []
    dots = []  # positions (in digits) where a '.' goes
    j = i
    while j < len(tokens):
        w = tokens[j].lower()
        if w in _TEL_MULT and j + 1 < len(tokens) \
                and tokens[j + 1].lower() in _TEL_DIGIT:
            digits.append(_TEL_DIGIT[tokens[j + 1].lower()] * _TEL_MULT[w])
            j += 2
        elif w in _TEL_DIGIT:
            digits.append(_TEL_DIGIT[w])
            j += 1
        elif w == "dot" and digits and j + 1 < len(tokens) and (
                tokens[j + 1].lower() in _TEL_DIGIT
                or tokens[j + 1].lower() in _TEL_MULT):
            dots.append(len("".join(digits)))
            j += 1
        else:
            break
    return "".join(digits), j, dots


def apply_telephone_en(text: str) -> str:
    """Digit-word runs -> digit strings (reference telephone.py).

    10 digits group US-style 123-123-5678; a run with 'dot' separators
    becomes a dotted number (IP); other runs of >= 7 digits concatenate.
    Shorter pure-digit runs are left for the cardinal grammar ("twenty
    one" etc. must not be eaten here).
    """
    tokens = text.split(" ")
    out = []
    i = 0
    while i < len(tokens):
        w = tokens[i].lower()
        if w in _TEL_DIGIT or (w in _TEL_MULT and i + 1 < len(tokens)
                               and tokens[i + 1].lower() in _TEL_DIGIT):
            digits, j, dots = _tel_span_digits(tokens, i)
            # 'o'/'oh' alone are words, not zeros: require a real digit
            has_real = any(tokens[k].lower() in _TEL_DIGIT
                           and tokens[k].lower() not in ("o", "oh")
                           for k in range(i, j))
            if dots and len(digits) >= 3 and has_real:
                s, prev = "", 0
                for p in dots:
                    s += digits[prev:p] + "."
                    prev = p
                out.append(s + digits[prev:])
                i = j
                continue
            if len(digits) == 10 and has_real:
                out.append(f"{digits[:3]}-{digits[3:6]}-{digits[6:]}")
                i = j
                continue
            if len(digits) >= 7 and has_real:
                out.append(digits)
                i = j
                continue
        out.append(tokens[i])
        i += 1
    return " ".join(out)


# ------------------------------------------------------------ electronic
_EN_SERVERS = {"g mail": "gmail", "gmail": "gmail", "n vidia": "nvidia",
               "nvidia": "nvidia", "outlook": "outlook",
               "hotmail": "hotmail", "yahoo": "yahoo", "aol": "aol",
               "gmx": "gmx", "msn": "msn", "live": "live",
               "yandex": "yandex"}
_DOMAINS = ("com", "net", "org", "edu", "gov", "io", "ai", "cn", "uk",
            "de", "fr", "ru", "in", "br", "it", "co")

_EMAIL_RE = re.compile(
    r"\b((?:[a-z0-9]+ )*[a-z0-9]+) at ((?:[a-z0-9]+ )*[a-z0-9]+)"
    r"((?: dot (?:" + "|".join(_DOMAINS) + r"))+)\b", re.IGNORECASE)
_URL_RE = re.compile(
    r"\b(w w w|www)((?: dot (?:[a-z0-9]+))+ dot (?:"
    + "|".join(_DOMAINS) + r"))\b", re.IGNORECASE)


def _collapse_dots(s: str) -> str:
    return s.replace(" dot ", ".").replace(" ", "")


def apply_electronic_en(text: str) -> str:
    """Spelled emails/URLs (reference electronic.py + data/electronic/):
    "j o h n at g mail dot com" -> john@gmail.com,
    "w w w dot example dot com" -> www.example.com."""
    def email(m):
        user = m.group(1).replace(" ", "")
        server = m.group(2).lower()
        server = _EN_SERVERS.get(server, server.replace(" ", ""))
        return f"{user}@{server}{_collapse_dots(m.group(3))}"

    text = _EMAIL_RE.sub(email, text)
    text = _URL_RE.sub(
        lambda m: "www" + _collapse_dots(m.group(2)), text)
    return text


_ZH_URL_RE = re.compile(
    r"([A-Za-z0-9]+)((?:点(?:[A-Za-z0-9]+))*点(?:"
    + "|".join(_DOMAINS) + r"))(?![A-Za-z])")


def apply_electronic_zh(text: str) -> str:
    """zh electronic: 点 between latin labels is the spoken '.'
    (zh/data/electronic/symbols.tsv '.'->点): baidu点com -> baidu.com."""
    return _ZH_URL_RE.sub(
        lambda m: m.group(1) + m.group(2).replace("点", "."), text)


# --------------------------------------------------------------- measure
# en: data/measurements.tsv (abbr<TAB>spoken singular), inverted; output
# "<N> <abbr>" (verbalizers/measure.py inserts the space).  Plurals fold
# via get_singulars.
_EN_UNITS = {
    "kilogram": "kg", "gram": "g", "milligram": "mg", "ton": "t",
    "tonne": "t", "kilometer": "km", "kilometre": "km", "meter": "m",
    "metre": "m", "centimeter": "cm", "centimetre": "cm",
    "millimeter": "mm", "millimetre": "mm", "nanometer": "nm",
    "micrometer": "μm", "mile": "mi", "foot": "ft", "feet": "ft",
    "hectare": "ha", "hertz": "hz", "kilohertz": "khz",
    "megahertz": "mhz", "gigahertz": "ghz", "kilowatt": "kw",
    "megawatt": "mw", "horsepower": "hp", "volt": "v", "millivolt": "mv",
    "ampere": "a", "second": "s", "minute": "min", "hour": "h",
    "terabyte": "tb", "gigabyte": "gb", "megabyte": "mb",
    "liter": "l", "litre": "l", "milliliter": "ml", "millilitre": "ml",
    "bar": "bar", "decibel": "db",
}
_EN_DEGREE = {"celsius": "°C", "fahrenheit": "°F"}


def _en_unit_abbr(word: str):
    w = word.lower()
    if w in _EN_UNITS:
        return _EN_UNITS[w]
    if w.endswith("s") and w[:-1] in _EN_UNITS:
        return _EN_UNITS[w[:-1]]
    if w == "feet":
        return "ft"
    return None


_EN_MEASURE_RE = re.compile(r"(-?\d+(?:\.\d+)?) ([a-zA-Z]+)"
                            r"(?: per ([a-zA-Z]+))?")
_EN_DEGREE_RE = re.compile(
    r"(-?\d+(?:\.\d+)?) degrees? (celsius|fahrenheit)", re.IGNORECASE)


def apply_measure_en(text: str) -> str:
    """Post-pass (numbers already digits): "12 kilograms" -> "12 kg",
    "100 kilometers per hour" -> "100 km/h", "35 degrees celsius" ->
    "35 °C" (taggers/measure.py unit_misc handles the 'per' compound)."""
    text = _EN_DEGREE_RE.sub(
        lambda m: f"{m.group(1)} {_EN_DEGREE[m.group(2).lower()]}", text)

    def repl(m):
        abbr = _en_unit_abbr(m.group(2))
        if abbr is None:
            return m.group(0)
        if m.group(3):
            per = _en_unit_abbr(m.group(3))
            if per is None:
                return f"{m.group(1)} {abbr} per {m.group(3)}"
            if abbr == "mi" and per == "h":
                return f"{m.group(1)} mph"
            return f"{m.group(1)} {abbr}/{per}"
        return f"{m.group(1)} {abbr}"

    return _EN_MEASURE_RE.sub(repl, text)


# zh: data/measurements_en.tsv maps the zh unit word to the latin abbr
# (摄氏度 -> °C); the zh verbalizer emits no space before the unit.
_ZH_UNITS = {
    "摄氏度": "°C", "华氏度": "°F", "千克": "kg", "公斤": "kg", "克": "g",
    "毫克": "mg", "千米": "km", "公里": "km", "厘米": "cm", "毫米": "mm",
    "纳米": "nm", "微米": "μm", "平方米": "m²", "立方米": "m³",
    "平方千米": "km²", "平方公里": "km²", "公顷": "ha", "赫兹": "hz",
    "千瓦": "kw", "兆瓦": "mw", "马力": "hp", "伏特": "v", "安培": "a",
    "分贝": "db", "毫升": "ml", "升": "l", "巴": "bar", "吨": "t",
}
_ZH_MEASURE_RE = re.compile(
    r"(-?\d+(?:\.\d+)?)("
    + "|".join(sorted(_ZH_UNITS, key=len, reverse=True)) + r")")


def apply_measure_zh(text: str) -> str:
    """Post-pass: 35摄氏度 -> 35°C, 3.5千克 -> 3.5kg (zh taggers/measure.py
    via measurements_en.tsv)."""
    return _ZH_MEASURE_RE.sub(
        lambda m: f"{m.group(1)}{_ZH_UNITS[m.group(2)]}", text)


# ------------------------------------------------------------ time / year
# en/taggers/time.py: "twelve thirty" -> 12:30, "two o eight" -> 2:08,
# "half past two" -> 2:30, "quarter to two" -> 1:45, "quarter past two"
# -> 2:15, am/pm suffixes.  en/taggers/date.py year graph: "twenty
# twenty" -> 2020, "nineteen eighty four" -> 1984, "twenty oh nine" ->
# 2009, "nineteen hundred" -> 1900.
_HOURS = {"one": 1, "two": 2, "three": 3, "four": 4, "five": 5, "six": 6,
          "seven": 7, "eight": 8, "nine": 9, "ten": 10, "eleven": 11,
          "twelve": 12}
_MIN_TENS = {"twenty": 20, "thirty": 30, "forty": 40, "fifty": 50}
_ONES = {"one": 1, "two": 2, "three": 3, "four": 4, "five": 5, "six": 6,
         "seven": 7, "eight": 8, "nine": 9}
_TEENS = {"ten": 10, "eleven": 11, "twelve": 12, "thirteen": 13,
          "fourteen": 14, "fifteen": 15, "sixteen": 16, "seventeen": 17,
          "eighteen": 18, "nineteen": 19}


def _minutes_at(tokens, i):
    """Parse a minutes group at i -> (value, next_i) or None."""
    if i >= len(tokens):
        return None
    w = tokens[i].lower()
    if w in _MIN_TENS:
        if i + 1 < len(tokens) and tokens[i + 1].lower() in _ONES:
            return _MIN_TENS[w] + _ONES[tokens[i + 1].lower()], i + 2
        return _MIN_TENS[w], i + 1
    if w in ("fifteen", "sixteen", "seventeen", "eighteen", "nineteen",
             "thirteen", "fourteen"):
        return _TEENS[w], i + 1
    if w in ("o", "oh") and i + 1 < len(tokens) \
            and tokens[i + 1].lower() in _ONES:
        return _ONES[tokens[i + 1].lower()], i + 2
    return None


def _ampm_at(tokens, i):
    if i + 1 < len(tokens) and tokens[i].lower() in ("a", "p") \
            and tokens[i + 1].lower() in ("m", "m."):
        return (" a.m." if tokens[i].lower() == "a" else " p.m."), i + 2
    return "", i


# spans followed by one of these belong to the money/percent grammar
# (itn.py _EN_CURRENCY branch) — the reference classify weights rank
# money above date/time, so the time/year pre-passes must not steal
# "two fifteen dollars" / "nineteen hundred dollars" style spans.
_MONEY_CUES = {"dollar", "dollars", "euro", "euros", "pound", "pounds",
               "yuan", "cent", "cents", "penny", "pence", "percent"}


def _money_cue_at(tokens, j) -> bool:
    return j < len(tokens) and tokens[j].lower() in _MONEY_CUES


def apply_time_en(text: str) -> str:
    """Spoken clock times -> H:MM (reference en/taggers/time.py).  Runs
    BEFORE the cardinal span merge, which would otherwise read "five
    thirty" as the (invalid) cardinal 35."""
    tokens = text.split(" ")
    out = []
    i = 0
    while i < len(tokens):
        w = tokens[i].lower()
        # half/quarter past|to H
        if w in ("half", "quarter") and i + 2 < len(tokens) \
                and tokens[i + 1].lower() in ("past", "to") \
                and tokens[i + 2].lower() in _HOURS:
            h = _HOURS[tokens[i + 2].lower()]
            rel = tokens[i + 1].lower()
            if rel == "past":
                m = 30 if w == "half" else 15
            else:
                if w == "half":  # "half to" is not a time reading
                    out.append(tokens[i]); i += 1; continue
                h, m = (h - 1) or 12, 45
            suf, j = _ampm_at(tokens, i + 3)
            if not suf and _money_cue_at(tokens, j):
                out.append(tokens[i]); i += 1; continue
            out.append(f"{h}:{m:02d}{suf}")
            i = j
            continue
        # M past H ("twelve past one" -> 1:12)
        mm = _minutes_at(tokens, i) or (
            (w in _ONES and (_ONES[w], i + 1))
            or (w in _TEENS and (_TEENS[w], i + 1)) or None)
        if mm and mm[1] < len(tokens) \
                and tokens[mm[1]].lower() == "past" \
                and mm[1] + 1 < len(tokens) \
                and tokens[mm[1] + 1].lower() in _HOURS:
            h = _HOURS[tokens[mm[1] + 1].lower()]
            suf, j = _ampm_at(tokens, mm[1] + 2)
            if not suf and _money_cue_at(tokens, j):
                out.append(tokens[i]); i += 1; continue
            out.append(f"{h}:{mm[0]:02d}{suf}")
            i = j
            continue
        # H MM ("five thirty [p m]" -> 5:30 [p.m.])
        if w in _HOURS:
            got = _minutes_at(tokens, i + 1)
            if got is not None:
                suf, j = _ampm_at(tokens, got[1])
                # require am/pm OR a tens/oh minutes form; "five fifteen"
                # without suffix stays ambiguous with cardinals? the
                # reference tags it as time — follow the reference.
                # EXCEPT when a currency/percent word follows: money
                # outranks time ("two fifteen dollars" is not 2:15).
                if not suf and _money_cue_at(tokens, j):
                    out.append(tokens[i]); i += 1; continue
                out.append(f"{_HOURS[w]}:{got[0]:02d}{suf}")
                i = j
                continue
        out.append(tokens[i])
        i += 1
    return " ".join(out)


_YEAR_HEADS = {**{k: v for k, v in _TEENS.items() if v >= 13},
               "twenty": 20}


def apply_year_en(text: str) -> str:
    """Two-group year readings (en/taggers/date.py year graph):
    "nineteen eighty four" -> 1984, "twenty twenty" -> 2020, "twenty oh
    nine" -> 2009, "nineteen hundred" -> 1900.  Runs after the time pass
    (so "twelve thirty" is already 12:30) and before cardinal spans."""
    tokens = text.split(" ")
    out = []
    i = 0
    # words that continue a cardinal phrase: "nineteen hundred and eighty
    # four" is the single number 1984, not the year 1900 + "and 84" — the
    # hundred-branch must yield to the cardinal grammar in that case
    cardinal_cont = (set(_ONES) | set(_TEENS)
                     | {"twenty", "thirty", "forty", "fifty", "sixty",
                        "seventy", "eighty", "ninety", "hundred",
                        "thousand", "million", "billion", "and"})
    while i < len(tokens):
        w = tokens[i].lower()
        head = _YEAR_HEADS.get(w)
        if head is not None and i + 1 < len(tokens):
            nxt = tokens[i + 1].lower()
            if nxt == "hundred" and (
                    i + 2 >= len(tokens)
                    or tokens[i + 2].lower() not in cardinal_cont) \
                    and not _money_cue_at(tokens, i + 2):
                # money outranks date: "nineteen hundred dollars" stays
                # for the cardinal+money grammar -> $1900
                out.append(str(head * 100))
                i += 2
                continue
            if nxt in ("o", "oh") and i + 2 < len(tokens) \
                    and tokens[i + 2].lower() in _ONES:
                out.append(str(head * 100 + _ONES[tokens[i + 2].lower()]))
                i += 3
                continue
            if nxt in _MIN_TENS or (nxt in _TEENS and _TEENS[nxt] >= 13) \
                    or nxt in ("twenty", "thirty", "forty", "fifty",
                               "sixty", "seventy", "eighty", "ninety"):
                tens = {"sixty": 60, "seventy": 70, "eighty": 80,
                        "ninety": 90, **_MIN_TENS}.get(nxt)
                if tens is not None:
                    if i + 2 < len(tokens) and tokens[i + 2].lower() in _ONES:
                        out.append(str(head * 100 + tens
                                       + _ONES[tokens[i + 2].lower()]))
                        i += 3
                    else:
                        out.append(str(head * 100 + tens))
                        i += 2
                    continue
                out.append(str(head * 100 + _TEENS[nxt]))
                i += 2
                continue
        out.append(tokens[i])
        i += 1
    return " ".join(out)


# ----------------------------------------- secondary-language classes
# The reference carries measure/telephone/electronic taggers for every
# language dir (inverse_text_normalization/<lang>/taggers/).  These
# generic passes are parameterized by each language's word tables
# (unit tables from the per-language data/measurements*.tsv).

# telephone digit words (0-9 only; runs of >=7 digits concatenate — the
# US 3-3-4 grouping is en-specific)
SECONDARY_TEL_DIGITS = {
    "de": {"null": "0", "eins": "1", "zwei": "2", "zwo": "2", "drei": "3",
           "vier": "4", "fünf": "5", "sechs": "6", "sieben": "7",
           "acht": "8", "neun": "9"},
    "es": {"cero": "0", "uno": "1", "una": "1", "dos": "2", "tres": "3",
           "cuatro": "4", "cinco": "5", "seis": "6", "siete": "7",
           "ocho": "8", "nueve": "9"},
    "fr": {"zéro": "0", "zero": "0", "un": "1", "une": "1", "deux": "2",
           "trois": "3", "quatre": "4", "cinq": "5", "six": "6",
           "sept": "7", "huit": "8", "neuf": "9"},
    "pt": {"zero": "0", "um": "1", "uma": "1", "dois": "2", "duas": "2",
           "três": "3", "tres": "3", "quatro": "4", "cinco": "5",
           "seis": "6", "meia": "6", "sete": "7", "oito": "8", "nove": "9"},
    "ru": {"ноль": "0", "нуль": "0", "один": "1", "одна": "1", "два": "2",
           "две": "2", "три": "3", "четыре": "4", "пять": "5",
           "шесть": "6", "семь": "7", "восемь": "8", "девять": "9"},
    "id": {"nol": "0", "kosong": "0", "satu": "1", "dua": "2", "tiga": "3",
           "empat": "4", "lima": "5", "enam": "6", "tujuh": "7",
           "delapan": "8", "sembilan": "9"},
    "vi": {"không": "0", "một": "1", "mốt": "1", "hai": "2", "ba": "3",
           "bốn": "4", "tư": "4", "năm": "5", "lăm": "5", "sáu": "6",
           "bảy": "7", "tám": "8", "chín": "9"},
    "tl": {"zero": "0", "siyero": "0", "isa": "1", "dalawa": "2",
           "tatlo": "3", "apat": "4", "lima": "5", "anim": "6",
           "pito": "7", "walo": "8", "siyam": "9"},
}

# electronic: per-language spoken "." and "@" (taggers/electronic.py +
# data/electronic/symbols.tsv per dir)
SECONDARY_ELECTRONIC = {
    "de": ("punkt", ("at",)),
    "es": ("punto", ("arroba",)),
    "fr": ("point", ("arobase", "arrobase")),
    "pt": ("ponto", ("arroba",)),
    "ru": ("точка", ("собака",)),
    "id": ("titik", ("at",)),
    "vi": ("chấm", ("a còng",)),
    "tl": ("tuldok", ("at",)),
    "ja": ("ドット", ("アットマーク", "アット")),
    "ko": ("점", ("골뱅이",)),
}

# measure unit words -> abbreviations (reference data/measurements*.tsv
# per language; latin languages fold plural 's'/'es' via the matcher,
# other declensions are listed explicitly)
SECONDARY_UNITS = {
    "de": {"kilometer": "km", "meter": "m", "zentimeter": "cm",
           "millimeter": "mm", "mikrometer": "μm", "kilogramm": "kg",
           "gramm": "g", "milligramm": "mg", "tonne": "t", "tonnen": "t",
           "hektar": "ha", "liter": "l", "milliliter": "ml",
           "sekunde": "s", "sekunden": "s", "minute": "min",
           "minuten": "min", "stunde": "h", "stunden": "h",
           "grad celsius": "°C", "grad fahrenheit": "°F",
           "kilowatt": "kw", "hertz": "hz", "prozent": "%"},
    "es": {"centímetro": "cm", "gramo": "g", "hora": "h", "kilo": "kg",
           "kilogramo": "kg", "kilómetro": "km",
           "kilómetro cuadrado": "km²", "litro": "l", "metro": "m",
           "metro cuadrado": "m²", "metro cubico": "m³",
           "milla por hora": "mph", "mililitro": "ml", "milímetro": "mm",
           "milisegundo": "ms", "minuto": "min", "segundo": "s",
           "grado celsius": "°C", "grados celsius": "°C"},
    "fr": {"mètre": "m", "mètre carré": "m²", "mètre cube": "m³",
           "seconde": "s", "minute": "min", "heure": "h",
           "degré celsius": "°C", "degrés celsius": "°C", "gramme": "g",
           "litre": "l", "kilo": "kg", "kilogramme": "kg",
           "kilomètre": "km", "centimètre": "cm", "millimètre": "mm",
           "livre": "lb", "tonne": "t"},
    "pt": {"hora": "h", "minuto": "min", "segundo": "s",
           "milissegundo": "ms", "tonelada": "t", "quilo": "kg",
           "quilograma": "kg", "grama": "g", "miligrama": "mg",
           "micrômetro": "μm", "milímetro": "mm", "centímetro": "cm",
           "centímetro quadrado": "cm²", "metro": "m",
           "metro quadrado": "m²", "metro cúbico": "m³",
           "quilômetro": "km", "quilômetro quadrado": "km²",
           "hectare": "ha", "litro": "l", "mililitro": "ml",
           "grau celsius": "°C", "graus celsius": "°C"},
    "ru": {"килограмм": "кг", "килограмма": "кг", "килограммов": "кг",
           "грамм": "г", "грамма": "г", "граммов": "г",
           "километр": "км", "километра": "км", "километров": "км",
           "метр": "м", "метра": "м", "метров": "м",
           "сантиметр": "см", "сантиметра": "см", "сантиметров": "см",
           "миллиметр": "мм", "миллиметра": "мм", "миллиметров": "мм",
           "тонна": "т", "тонны": "т", "тонн": "т",
           "литр": "л", "литра": "л", "литров": "л",
           "секунда": "с", "секунды": "с", "секунд": "с",
           "минута": "мин", "минуты": "мин", "минут": "мин",
           "час": "ч", "часа": "ч", "часов": "ч",
           "градус цельсия": "°C", "градуса цельсия": "°C",
           "градусов цельсия": "°C"},
    "id": {"kilometer": "km", "meter": "m", "sentimeter": "cm",
           "milimeter": "mm", "hektar": "ha", "mil": "mi",
           "meter persegi": "m²", "kilometer persegi": "km²",
           "kaki": "ft", "kilogram": "kg", "gram": "g", "liter": "l",
           "detik": "s", "menit": "min", "jam": "h",
           "derajat celsius": "°C"},
    "tl": {"kilometer": "km", "meter": "m", "centimeter": "cm",
           "millimeter": "mm", "hectare": "ha", "kilogram": "kg",
           "gramo": "g", "litro": "l", "segundo": "s", "minuto": "min",
           "oras": "h"},
    "vi": {"kilomet": "km", "ki lô met": "km", "ki lô mét": "km",
           "kilô mét": "km", "kilo mét": "km", "met": "m", "mét": "m",
           "centimet": "cm", "cen ti mét": "cm", "xen ti mét": "cm",
           "xăng ti mét": "cm", "millimet": "mm", "mi li mét": "mm",
           "mili mét": "mm", "hecta": "ha", "héc ta": "ha",
           "kilogam": "kg", "ki lô gam": "kg", "gam": "g", "lít": "l",
           "giây": "s", "phút": "min", "giờ": "h", "độ c": "°C",
           "độ f": "°F"},
    "ja": {"キロメートル": "km", "メートル": "m", "センチメートル": "cm",
           "ミリメートル": "mm", "ヘクタール": "ha", "マイル": "mi",
           "平方メートル": "m²", "平方キロメートル": "km²",
           "ヘルツ": "hz", "キロワット": "kw", "キログラム": "kg",
           "グラム": "g", "リットル": "l", "ミリリットル": "ml",
           "秒": "s", "分": "min", "時間": "h", "摂氏": "°C", "度": "°"},
    "ko": {"마이크로미터": "μm", "밀리미터": "mm", "센치미터": "cm",
           "센티미터": "cm", "킬로미터": "km", "미터": "m",
           "평방밀리미터": "mm²", "평방센치미터": "cm²",
           "평방미터": "m²", "평방킬로미터": "km²", "킬로그램": "kg",
           "그램": "g", "리터": "l", "밀리리터": "ml", "헥타르": "ha",
           "초": "s", "분": "min", "시간": "h", "퍼센트": "%"},
}

# CJK output attaches the unit directly; latin keeps the space
_NO_SPACE_LANGS = {"ja", "ko"}

# ko telephone digit readings (공일이... runs; zh/ja kanji runs are
# handled by the shared positional engine already)
_KO_TEL = {"공": "0", "영": "0", "일": "1", "이": "2", "삼": "3",
           "사": "4", "오": "5", "육": "6", "칠": "7", "팔": "8",
           "구": "9"}
_KO_TEL_RE = re.compile("[" + "".join(_KO_TEL) + "]{7,}")


def _make_tel_pass(table):
    words = set(table)

    def run(text: str) -> str:
        tokens = text.split(" ")
        out, i = [], 0
        while i < len(tokens):
            j = i
            while j < len(tokens) and tokens[j].lower() in words:
                j += 1
            if j - i >= 7:
                out.append("".join(table[tokens[k].lower()]
                                   for k in range(i, j)))
                i = j
            else:
                out.append(tokens[i])
                i += 1
        return " ".join(out)

    return run


_TEL_PASSES = {k: _make_tel_pass(v) for k, v in SECONDARY_TEL_DIGITS.items()}


def _make_electronic_pass(dot_word, at_words):
    dom = "|".join(_DOMAINS)
    url = re.compile(
        rf"\b([a-z0-9]+)((?: {dot_word} [a-z0-9]+)* {dot_word} (?:{dom}))\b",
        re.IGNORECASE)
    ats = "|".join(re.escape(a) for a in at_words)
    email = re.compile(
        rf"\b((?:[a-z0-9]+ )*[a-z0-9]+) (?:{ats}) ((?:[a-z0-9]+ )*[a-z0-9]+)"
        rf"((?: {dot_word} (?:{dom}))+)\b", re.IGNORECASE)
    cjk_url = re.compile(
        rf"([A-Za-z0-9]+)((?:{dot_word}[A-Za-z0-9]+)*{dot_word}(?:{dom}))"
        rf"(?![A-Za-z])")

    def collapse(s):
        return s.replace(f" {dot_word} ", ".").replace(dot_word, ".") \
            .replace(" ", "")

    def run(text: str) -> str:
        text = email.sub(
            lambda m: (m.group(1).replace(" ", "") + "@"
                       + m.group(2).replace(" ", "")
                       + collapse(m.group(3))), text)
        text = url.sub(lambda m: m.group(1) + collapse(m.group(2)), text)
        if not dot_word.isascii():
            text = cjk_url.sub(
                lambda m: m.group(1) + m.group(2).replace(dot_word, "."),
                text)
        return text

    return run


_ELECTRONIC_PASSES = {k: _make_electronic_pass(d, a)
                      for k, (d, a) in SECONDARY_ELECTRONIC.items()}


def _make_measure_pass(units, spaced: bool):
    # longest-first so multiword units win ("metro cuadrado" before "metro")
    alt = "|".join(re.escape(u) for u in sorted(units, key=len,
                                                reverse=True))
    sep = " " if spaced else ""
    if spaced:
        pat = re.compile(rf"(-?\d+(?:[.,]\d+)?) ({alt})(e?s)?\b",
                         re.IGNORECASE)
    else:
        pat = re.compile(rf"(-?\d+(?:[.,]\d+)?)({alt})")

    def repl(m):
        unit = units.get(m.group(2).lower() if spaced else m.group(2))
        if unit is None:
            return m.group(0)
        return f"{m.group(1)}{sep}{unit}"

    def run(text: str) -> str:
        return pat.sub(repl, text)

    return run


_MEASURE_PASSES = {
    k: _make_measure_pass(v, spaced=(k not in _NO_SPACE_LANGS))
    for k, v in SECONDARY_UNITS.items()
}


def secondary_pre(lang: str, text: str) -> str:
    """Word-level classes (whitelist, telephone, electronic) for the
    non-zh/en languages; runs before the cardinal pass."""
    # every reference language grammar carries the whitelist tagger, and
    # each <lang>/data/whitelist.tsv mirrors the en table
    text = apply_whitelist(text)
    e = _ELECTRONIC_PASSES.get(lang)
    if e is not None:
        text = e(text)
    t = _TEL_PASSES.get(lang)
    if t is not None:
        text = t(text)
    if lang == "ko":
        text = _KO_TEL_RE.sub(
            lambda m: "".join(_KO_TEL[c] for c in m.group(0)), text)
    return text


def secondary_measure_words(lang: str, text: str) -> str:
    """Word-level measure for the conservative western cardinal engines;
    runs after the time/money/date classes (their readings win)."""
    wm = _word_measure(lang)
    return wm(text) if wm is not None else text


def secondary_post(lang: str, text: str) -> str:
    """Digit-context classes (measure) after the cardinal pass."""
    p = _MEASURE_PASSES.get(lang)
    return p(text) if p is not None else text


_MINUS_WORDS = {"de": {"minus"}, "es": {"menos"}, "fr": {"moins"},
                "pt": {"menos"}, "ru": {"минус"}}


def _word_measure_tables(lang):
    """(parse_span, units) for the western languages whose cardinal pass
    is conservative about lone small numbers — the unit word is the
    conversion cue (reference measure taggers compose cardinal+unit in
    one grammar, so "doce kilómetros" converts even though bare "doce"
    would not)."""
    from funasr_torch.text import itn

    if lang == "de":
        from funasr_torch.text.itn import _de_compound_to_int

        def parse(words):
            if len(words) != 1:
                return None
            return _de_compound_to_int(words[0])
    else:
        vocab, scale = {
            "es": (itn._ES_VOCAB, itn._ES_SCALE),
            "fr": (itn._FR_VOCAB, itn._FR_SCALE),
            "pt": (itn._PT_VOCAB, itn._PT_SCALE),
            "ru": (itn._RU_VOCAB, itn._RU_SCALE),
        }[lang]

        keys = frozenset(vocab) | frozenset(scale)

        def parse(words):
            if not words or any(w not in keys for w in words):
                return None
            return itn._western_span_to_int(words, vocab, scale)
    return parse, SECONDARY_UNITS[lang]


def _make_measure_word_pass(lang):
    parse, units = _word_measure_tables(lang)
    unit_seqs = {tuple(k.split()): v for k, v in units.items()}
    max_ul = max(len(k) for k in unit_seqs)
    minus = _MINUS_WORDS.get(lang, set())

    def lookup_unit(tokens, j):
        for L in range(min(max_ul, len(tokens) - j), 0, -1):
            seq = tuple(t.lower() for t in tokens[j:j + L])
            if seq in unit_seqs:
                return unit_seqs[seq], L
            last = seq[-1]
            for suf in ("es", "s"):
                if last.endswith(suf):
                    folded = seq[:-1] + (last[: -len(suf)],)
                    if folded in unit_seqs:
                        return unit_seqs[folded], L
        return None, 0

    def run(text: str) -> str:
        tokens = text.split(" ")
        out, i = [], 0
        while i < len(tokens):
            neg = tokens[i].lower() in minus
            base = i + 1 if neg else i
            hit = False
            for L in range(min(6, len(tokens) - base), 0, -1):
                val = parse([t.lower() for t in tokens[base:base + L]])
                if val is None:
                    continue
                abbr, ul = lookup_unit(tokens, base + L)
                if ul:
                    out.append(f"{'-' if neg else ''}{val} {abbr}")
                    i = base + L + ul
                    hit = True
                break  # longest number span decides; shorter re-parses alias
            if not hit:
                out.append(tokens[i])
                i += 1
        return " ".join(out)

    return run


_WORD_MEASURE_CACHE = {}


def _word_measure(lang):
    if lang not in _WORD_MEASURE_CACHE and lang in _MINUS_WORDS:
        _WORD_MEASURE_CACHE[lang] = _make_measure_word_pass(lang)
    return _WORD_MEASURE_CACHE.get(lang)
