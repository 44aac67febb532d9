"""Per-language semiotic class rules for ITN beyond cardinals/percents.

The port's own copy of funasr_tpu/text/itn_classes.py, its lazy imports pointed
at ``funasr_torch.text``: the same rules and the same output.

The reference implements these as pynini tagger+verbalizer FSTs per
language (fun_text_processing/inverse_text_normalization/<lang>/taggers/:
date, time, money, ordinal, decimal, fraction).  This module provides the
same class coverage as readable rules.  Output conventions follow the
reference verbalizers:

- money: currency symbol + amount, no space (de money verbalizer:
  ``money { integer_part: "12" fractional_part: "05" currency: "$" } ->
  $12.05``); locale decimal separator (de/es/fr/pt comma).
- time: ``H:MM`` (+" Uhr" for German per de/verbalizers/time.py; Russian
  zero-padded per ru verbalizer ``02:15``).
- date: German ``24. Jul. 2013`` / ``02.03.`` (de/taggers/date.py
  examples); Romance day digits with month words (es/taggers/date.py
  ``primero de enero -> day "1" month "enero"``); Russian day + genitive
  month.
- ordinal: ``3.`` (de), ``1.º/2.ª`` (es ordinal docstring), ``1er/2ème``
  (fr), ``1º/2ª`` (pt), bare digits (ru verbalizer), ``ke-2`` (id),
  ``thứ 2`` (vi), ``ika-2`` (tl), digits (ja/ko).

Class rules run at WORD level (``pre``, before the cardinal pass — a
"la una y diez" must become "la 1:10" before the cardinal pass merges
"una y diez" into 11) with per-language number resolvers that accept
digits or number words; CJK languages add digit-level ``post`` rules
after the kanji/hangul number pass.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Optional


def _sub_all(text: str, rules) -> str:
    for pat, repl in rules:
        text = pat.sub(repl, text)
    return text


def _two(n: int) -> str:
    return f"{n:02d}"


def _numpat(words) -> str:
    alts = sorted({re.escape(w) for w in words}, key=len, reverse=True)
    return r"(?:\d+|" + "|".join(alts) + r")"


def _mkres(table, fallback=None):
    def rv(tok: str) -> Optional[int]:
        t = tok.lower()
        if t.isdigit():
            return int(t)
        if t in table:
            return table[t]
        return fallback(t) if fallback else None

    return rv


def _digitseq(tokens, rv) -> str:
    return "".join(str(rv(t)) for t in tokens.split(" ") if t)


# =====================================================================
# German
# =====================================================================

def _de_table():
    from funasr_torch.text.itn import _DE_ATOMS, _de_compound_to_int

    words = [w for w in _DE_ATOMS if w != "und"]
    return words, _mkres({}, _de_compound_to_int)


_DE_MONTH_ABBR = {
    "januar": "Jan.", "februar": "Feb.", "märz": "März", "april": "Apr.",
    "mai": "Mai", "juni": "Jun.", "juli": "Jul.", "august": "Aug.",
    "september": "Sep.", "oktober": "Okt.", "november": "Nov.",
    "dezember": "Dez.",
}

_DE_ORD_SPECIAL = {"erste": 1, "dritte": 3, "siebte": 7, "achte": 8}


def _de_ordinal_value(word: str) -> Optional[int]:
    """German ordinal word -> int (cardinal stem + ter/te/tes/ten/tem or
    ster/... for >=20; irregular erste/dritte/siebte/achte)."""
    from funasr_torch.text.itn import _de_compound_to_int

    w = word.lower()
    for base, val in _DE_ORD_SPECIAL.items():
        if w.startswith(base) and len(w) - len(base) <= 1:
            return val
    for suf in ("sten", "stem", "ster", "stes", "ste"):
        if w.endswith(suf):
            stem = w[: -len(suf)]
            for guess in (stem + "zig", stem + "ßig", stem):
                v = _de_compound_to_int(guess)
                if v is not None and v >= 20:
                    return v
            v = _de_compound_to_int(stem)
            if v is not None:
                return v
    for suf in ("ten", "tem", "ter", "tes", "te"):
        if w.endswith(suf):
            v = _de_compound_to_int(w[: -len(suf)])
            if v is not None:
                return v
    return None


_DE_FRACTION_DEN = {
    "halb": 2, "halbe": 2, "halbes": 2, "drittel": 3, "fünftel": 5,
    "sechstel": 6, "siebtel": 7, "achtel": 8, "neuntel": 9, "zehntel": 10,
    "zwanzigstel": 20, "hundertstel": 100, "tausendstel": 1000,
}


def _de_pre(text: str) -> str:
    words, rv = _de_table()
    N = _numpat(words)
    D = _numpat([w for w in words
                 if rv(w) is not None and 0 <= rv(w) <= 9])

    # --- ordinals / dates (word-context)
    tokens = text.split(" ")
    out = []
    i = 0
    while i < len(tokens):
        t = tokens[i]
        val = _de_ordinal_value(t)
        if val is not None:
            nxt = tokens[i + 1].lower() if i + 1 < len(tokens) else ""
            nval = _de_ordinal_value(nxt)
            if nxt in _DE_MONTH_ABBR:
                # "vierzehnter januar" -> "14. Jan." (de/taggers/date.py)
                out.append(f"{val}. {_DE_MONTH_ABBR[nxt]}")
                i += 2
                continue
            if nval is not None and 1 <= nval <= 12:
                # "zweiter dritter" -> "02.03."
                out.append(f"{_two(val)}.{_two(nval)}.")
                i += 2
                continue
            out.append(f"{val}.")
            i += 1
            continue
        out.append(t)
        i += 1
    text = " ".join(out)

    def g(m, k=1):
        return rv(m.group(k))

    rules = [
        # decimal: "elf komma zwei null null sechs" -> 11,2006
        (re.compile(rf"\b({N}) komma ((?:{D} )*{D})\b"),
         lambda m: f"{g(m)},{_digitseq(m.group(2), rv)}"),
        # time (de/taggers/time.py examples; verbalizers/time.py output)
        (re.compile(rf"\bviertel vor ({N})\b"),
         lambda m: f"{(g(m) - 1) or 12}:45 Uhr"),
        (re.compile(rf"\bviertel nach ({N})\b"),
         lambda m: f"{g(m)}:15 Uhr"),
        (re.compile(rf"\bhalb ({N})\b"),
         lambda m: f"{(g(m) - 1) or 12}:30 Uhr"),
        (re.compile(rf"\b({N}) vor ({N})\b"),
         lambda m: f"{(g(m, 2) - 1) or 12}:{_two(60 - g(m))} Uhr"),
        (re.compile(rf"\b({N}) nach ({N})\b"),
         lambda m: f"{g(m, 2)}:{_two(g(m))} Uhr"),
        (re.compile(rf"\b({N}) uhr ({N}) minuten ({N}) sekunden\b"),
         lambda m: f"{_two(g(m))}:{_two(g(m, 2))}:{_two(g(m, 3))} Uhr"),
        (re.compile(rf"\b({N}) uhr ({N})\b"),
         lambda m: f"{_two(g(m))}:{_two(g(m, 2))} Uhr"),
        (re.compile(rf"\b({N}) uhr\b"), lambda m: f"{g(m)} Uhr"),
        # money: "elf euro und vier cent" -> €11,04 (verbalizer format)
        (re.compile(rf"\b({N}|\d+,\d+) euros?(?: und ({N}) cents?)?\b"),
         lambda m: "€" + (m.group(1) if "," in m.group(1)
                          else str(g(m)))
         + ("," + _two(g(m, 2)) if m.group(2) else "")),
        (re.compile(rf"\b({N}|\d+,\d+) dollars?(?: und ({N}) cents?)?\b"),
         lambda m: "$" + (m.group(1) if "," in m.group(1)
                          else str(g(m)))
         + ("," + _two(g(m, 2)) if m.group(2) else "")),
        (re.compile(rf"\b({N}|\d+,\d+) pfund\b"),
         lambda m: "£" + (m.group(1) if "," in m.group(1)
                          else str(g(m)))),
        # fraction: "ein halb" -> 1/2, "ein ein halb" -> 1 1/2,
        # "drei zwei ein hundertstel" -> 3 2/100 (de/taggers/fraction.py)
        (re.compile(rf"\b({N}) ({N}) ({'|'.join(_DE_FRACTION_DEN)})\b"),
         lambda m: f"{g(m)} {g(m, 2)}/{_DE_FRACTION_DEN[m.group(3)]}"),
        (re.compile(rf"\b({N}) ({'|'.join(_DE_FRACTION_DEN)})\b"),
         lambda m: f"{g(m)}/{_DE_FRACTION_DEN[m.group(2)]}"),
    ]
    return _sub_all(text, rules)


# =====================================================================
# Spanish
# =====================================================================

_ES_MONTHS = ("enero", "febrero", "marzo", "abril", "mayo", "junio",
              "julio", "agosto", "septiembre", "octubre", "noviembre",
              "diciembre")

_ES_ORD = {
    "primero": 1, "primer": 1, "primera": 1, "segundo": 2, "segunda": 2,
    "tercero": 3, "tercer": 3, "tercera": 3, "cuarto": 4, "cuarta": 4,
    "quinto": 5, "quinta": 5, "sexto": 6, "sexta": 6, "séptimo": 7,
    "séptima": 7, "septimo": 7, "octavo": 8, "octava": 8, "noveno": 9,
    "novena": 9, "décimo": 10, "décima": 10, "decimo": 10,
    "undécimo": 11, "duodécimo": 12, "vigésimo": 20, "vigésima": 20,
    "trigésimo": 30, "trigésima": 30, "cuadragésimo": 40,
    "quincuagésimo": 50, "sexagésimo": 60, "septuagésimo": 70,
    "octogésimo": 80, "nonagésimo": 90, "centésimo": 100,
}


def _es_pre(text: str) -> str:
    from funasr_torch.text.itn import _ES_VOCAB

    rv = _mkres(_ES_VOCAB)
    N = _numpat(_ES_VOCAB)
    D = _numpat([w for w, v in _ES_VOCAB.items() if v <= 9])

    def g(m, k=1):
        return rv(m.group(k))

    rules = [
        (re.compile(rf"\b({N}) coma ((?:{D} )*{D})\b"),
         lambda m: f"{g(m)},{_digitseq(m.group(2), rv)}"),
        (re.compile(rf"\b({N}) punto ((?:{D} )*{D})\b"),
         lambda m: f"{g(m)}.{_digitseq(m.group(2), rv)}"),
        # time (es/taggers/time.py: la una y diez -> la 1:10;
        # las dos menos cuarto -> la 1:45)
        (re.compile(rf"\bla(?:s)? ({N}) menos cuarto\b"),
         lambda m: f"la {(g(m) - 1) or 12}:45"),
        (re.compile(rf"\bla(?:s)? ({N}) menos ({N})\b"),
         lambda m: f"la {(g(m) - 1) or 12}:{_two(60 - g(m, 2))}"),
        (re.compile(rf"\bla(?:s)? ({N}) y cuarto\b"),
         lambda m: f"la {g(m)}:15"),
        (re.compile(rf"\bla(?:s)? ({N}) y media\b"),
         lambda m: f"la {g(m)}:30"),
        (re.compile(rf"\bla(?:s)? ({N}) (?:y|con) ({N})\b"),
         lambda m: f"la {g(m)}:{_two(g(m, 2))}"),
        # money: "doce dólares y cinco céntimos" -> $12,05
        (re.compile(rf"\b({N}|\d+[.,]\d+) (?:dólar(?:es)?|dolar(?:es)?|"
                    rf"pesos?)(?: y ({N}) (?:céntimos?|centimos?|"
                    rf"centavos?))?\b"),
         lambda m: "$" + (m.group(1) if not m.group(1).isalpha()
                          else str(g(m)))
         + ("," + _two(g(m, 2)) if m.group(2) else "")),
        (re.compile(rf"\b({N}|\d+[.,]\d+) euros?"
                    rf"(?: y ({N}) (?:céntimos?|centimos?))?\b"),
         lambda m: "€" + (m.group(1) if not m.group(1).isalpha()
                          else str(g(m)))
         + ("," + _two(g(m, 2)) if m.group(2) else "")),
        (re.compile(rf"\b({N}|\d+[.,]\d+) libras?\b"),
         lambda m: "£" + (m.group(1) if not m.group(1).isalpha()
                          else str(g(m)))),
    ]
    text = _sub_all(text, rules)


    tokens = text.split(" ")
    out = []
    i = 0
    while i < len(tokens):
        t = tokens[i].lower()
        if t in _ES_ORD:
            if (i + 2 < len(tokens) and tokens[i + 1] == "de"
                    and tokens[i + 2].lower() in _ES_MONTHS):
                # date: "primero de enero" -> "1 de enero"
                out.append(f"{_ES_ORD[t]} de {tokens[i + 2].lower()}")
                i += 3
                continue
            # "primero" -> 1.º, "segunda" -> 2.ª (taggers/ordinal.py)
            out.append(f"{_ES_ORD[t]}.{'ª' if t.endswith('a') else 'º'}")
            i += 1
            continue
        if (t in _ES_VOCAB and i + 2 < len(tokens)
                and tokens[i + 1] == "de"
                and tokens[i + 2].lower() in _ES_MONTHS):
            out.append(f"{_ES_VOCAB[t]} de {tokens[i + 2].lower()}")
            i += 3
            continue
        out.append(tokens[i])
        i += 1
    return " ".join(out)

# =====================================================================
# French
# =====================================================================

_FR_ORD_IRREG = {"premier": "1er", "première": "1re", "premiere": "1re",
                 "second": "2nd", "seconde": "2nde"}

_FR_ORD_STEM = {
    "deux": 2, "trois": 3, "quatr": 4, "cinqu": 5, "six": 6, "sept": 7,
    "huit": 8, "neuv": 9, "dix": 10, "onz": 11, "douz": 12, "treiz": 13,
    "quatorz": 14, "quinz": 15, "seiz": 16, "vingt": 20, "trent": 30,
    "quarant": 40, "cinquant": 50, "soixant": 60, "cent": 100,
    "mill": 1000,
}


def _fr_pre(text: str) -> str:
    from funasr_torch.text.itn import (_FR_SCALE, _FR_VOCAB,
                                     _western_span_to_int)

    rv = _mkres(_FR_VOCAB)
    N = _numpat(_FR_VOCAB)
    D = _numpat([w for w, v in _FR_VOCAB.items() if v <= 9])

    tokens = text.split(" ")
    out = []
    for t in tokens:
        low = t.lower()
        if low in _FR_ORD_IRREG:
            out.append(_FR_ORD_IRREG[low])
            continue
        m = re.fullmatch(r"([a-zàâçéèêëîïôûùüÿ-]+)ième(s?)", low)
        if m:
            stem = m.group(1)
            val = _FR_ORD_STEM.get(stem.replace("-", ""))
            if val is None:
                parts = [p for p in stem.split("-") if p]
                tailv = _FR_ORD_STEM.get(parts[-1]) if parts else None
                if tailv is not None:
                    base = parts[:-1]
                    if all(p in _FR_VOCAB or p in _FR_SCALE
                           for p in base):
                        val = _western_span_to_int(base, _FR_VOCAB,
                                                   _FR_SCALE) + tailv
            if val is not None:
                out.append(f"{val}ème")
                continue
        out.append(t)
    text = " ".join(out)

    def g(m, k=1):
        return rv(m.group(k))

    rules = [
        (re.compile(rf"\b({N}) virgule ((?:{D} )*{D})\b"),
         lambda m: f"{g(m)},{_digitseq(m.group(2), rv)}"),
        # time: "trois heures vingt" -> 3 h 20
        (re.compile(rf"\b({N}) heures? moins le quart\b"),
         lambda m: f"{(g(m) - 1) or 12} h 45"),
        (re.compile(rf"\b({N}) heures? moins ({N})\b"),
         lambda m: f"{(g(m) - 1) or 12} h {_two(60 - g(m, 2))}"),
        (re.compile(rf"\b({N}) heures? et quart\b"),
         lambda m: f"{g(m)} h 15"),
        (re.compile(rf"\b({N}) heures? et demie?\b"),
         lambda m: f"{g(m)} h 30"),
        (re.compile(rf"\b({N}) heures? ({N})\b"),
         lambda m: f"{g(m)} h {_two(g(m, 2))}"),
        (re.compile(rf"\b({N}) heures?\b"), lambda m: f"{g(m)} h"),
        # money
        (re.compile(rf"\b({N}|\d+,\d+) euros?"
                    rf"(?: (?:et )?({N}) centimes?)?\b"),
         lambda m: "€" + (m.group(1) if not m.group(1).isalpha()
                          else str(g(m)))
         + ("," + _two(g(m, 2)) if m.group(2) else "")),
        (re.compile(rf"\b({N}|\d+,\d+) dollars?"
                    rf"(?: (?:et )?({N}) (?:cents?|centimes?))?\b"),
         lambda m: "$" + (m.group(1) if not m.group(1).isalpha()
                          else str(g(m)))
         + ("," + _two(g(m, 2)) if m.group(2) else "")),
        # fraction: "demi" -> 1/2, "un et demi" -> 1 1/2
        # (fr/taggers/fraction.py)
        (re.compile(rf"\b({N}) et demie?\b"), lambda m: f"{g(m)} 1/2"),
        (re.compile(r"\bdemie?\b"), "1/2"),
        (re.compile(rf"\b({N}) ({N}) centièmes?\b"),
         lambda m: f"{g(m)} {g(m, 2)}/100"),
        (re.compile(rf"\b({N}) centièmes?\b"), lambda m: f"{g(m)}/100"),
        (re.compile(rf"\b({N}) millièmes?\b"), lambda m: f"{g(m)}/1000"),
    ]
    return _sub_all(text, rules)


# =====================================================================
# Portuguese
# =====================================================================

_PT_MONTHS = ("janeiro", "fevereiro", "março", "marco", "abril", "maio",
              "junho", "julho", "agosto", "setembro", "outubro",
              "novembro", "dezembro")

_PT_ORD = {
    "primeiro": 1, "primeira": 1, "segundo": 2, "segunda": 2,
    "terceiro": 3, "terceira": 3, "quarto": 4, "quarta": 4, "quinto": 5,
    "quinta": 5, "sexto": 6, "sexta": 6, "sétimo": 7, "sétima": 7,
    "setimo": 7, "oitavo": 8, "oitava": 8, "nono": 9, "nona": 9,
    "décimo": 10, "décima": 10, "decimo": 10, "vigésimo": 20,
    "trigésimo": 30, "centésimo": 100,
}


def _pt_pre(text: str) -> str:
    from funasr_torch.text.itn import _PT_VOCAB

    rv = _mkres(_PT_VOCAB)
    N = _numpat(_PT_VOCAB)
    D = _numpat([w for w, v in _PT_VOCAB.items() if v <= 9])

    tokens = text.split(" ")
    out = []
    i = 0
    while i < len(tokens):
        t = tokens[i].lower()
        if t in _PT_ORD:
            if (i + 2 < len(tokens) and tokens[i + 1] == "de"
                    and tokens[i + 2].lower() in _PT_MONTHS):
                # "primeiro de janeiro" -> "1 de janeiro"
                out.append(f"{_PT_ORD[t]} de {tokens[i + 2].lower()}")
                i += 3
                continue
            out.append(f"{_PT_ORD[t]}{'ª' if t.endswith('a') else 'º'}")
            i += 1
            continue
        if (t in _PT_VOCAB and i + 2 < len(tokens)
                and tokens[i + 1] == "de"
                and tokens[i + 2].lower() in _PT_MONTHS):
            out.append(f"{_PT_VOCAB[t]} de {tokens[i + 2].lower()}")
            i += 3
            continue
        out.append(tokens[i])
        i += 1
    text = " ".join(out)

    def g(m, k=1):
        return rv(m.group(k))

    rules = [
        (re.compile(rf"\b({N}) v[ií]rgula ((?:{D} )*{D})\b"),
         lambda m: f"{g(m)},{_digitseq(m.group(2), rv)}"),
        (re.compile(rf"\b({N}) ponto ((?:{D} )*{D})\b"),
         lambda m: f"{g(m)}.{_digitseq(m.group(2), rv)}"),
        # time (pt/taggers/time.py: quinze pras duas -> 1:45 — minutes-to)
        (re.compile(rf"\b({N}) pr[ao]s? meio dia\b"),
         lambda m: f"11:{_two(60 - g(m))}"),
        (re.compile(rf"\b({N}) pr[ao]s? meia noite\b"),
         lambda m: f"23:{_two(60 - g(m))}"),
        (re.compile(rf"\b({N}) pr[ao]s? ({N})\b"),
         lambda m: f"{(g(m, 2) - 1) or 12}:{_two(60 - g(m))}"),
        (re.compile(rf"\b({N}) horas? e ({N})\b"),
         lambda m: f"{g(m)}:{_two(g(m, 2))}"),
        (re.compile(rf"\b({N}) e (quinze|trinta|meia)\b"),
         lambda m: f"{g(m)}:" + {"quinze": "15", "trinta": "30",
                                 "meia": "30"}[m.group(2)]),
        # money: "doze dólares e cinco centavos" -> $12,05
        (re.compile(rf"\b({N}|\d+[.,]\d+) (?:dólar(?:es)?|dolar(?:es)?)"
                    rf"(?: e ({N}) centavos?)?\b"),
         lambda m: "$" + (m.group(1) if not m.group(1).isalpha()
                          else str(g(m)))
         + ("," + _two(g(m, 2)) if m.group(2) else "")),
        (re.compile(rf"\b({N}|\d+[.,]\d+) (?:reais|real)"
                    rf"(?: e ({N}) centavos?)?\b"),
         lambda m: "R$" + (m.group(1) if not m.group(1).isalpha()
                           else str(g(m)))
         + ("," + _two(g(m, 2)) if m.group(2) else "")),
        (re.compile(rf"\b({N}|\d+[.,]\d+) euros?"
                    rf"(?: e ({N}) (?:cêntimos?|centimos?|centavos?))?\b"),
         lambda m: "€" + (m.group(1) if not m.group(1).isalpha()
                          else str(g(m)))
         + ("," + _two(g(m, 2)) if m.group(2) else "")),
    ]
    return _sub_all(text, rules)


# =====================================================================
# Russian
# =====================================================================

_RU_MONTHS = ("января", "февраля", "марта", "апреля", "мая", "июня",
              "июля", "августа", "сентября", "октября", "ноября",
              "декабря")

_RU_ORD_STEMS = {
    "перв": 1, "втор": 2, "трет": 3, "четверт": 4, "четвёрт": 4,
    "пят": 5, "шест": 6, "седьм": 7, "восьм": 8, "девят": 9, "десят": 10,
    "одиннадцат": 11, "двенадцат": 12, "тринадцат": 13,
    "четырнадцат": 14, "пятнадцат": 15, "шестнадцат": 16,
    "семнадцат": 17, "восемнадцат": 18, "девятнадцат": 19,
    "двадцат": 20, "тридцат": 30, "сороков": 40, "пятидесят": 50,
    "шестидесят": 60, "семидесят": 70, "восьмидесят": 80,
    "девяност": 90, "сот": 100, "тысячн": 1000,
}
_RU_ORD_ENDINGS = ("ыми", "ими", "ого", "его", "ому", "ему", "ая", "яя",
                   "ое", "ее", "ый", "ий", "ой", "ые", "ие", "ых", "их",
                   "ым", "им", "ом", "ем", "ье", "ья", "ей", "ую", "юю")

_RU_FRAC_DEN = {"десятых": 10, "десятая": 10, "сотых": 100, "сотая": 100,
                "тысячных": 1000, "тысячная": 1000}


def _ru_ordinal_value(word: str) -> Optional[int]:
    w = word.lower()
    for end in sorted(_RU_ORD_ENDINGS, key=len, reverse=True):
        if w.endswith(end):
            stem = w[: -len(end)]
            if stem in _RU_ORD_STEMS:
                return _RU_ORD_STEMS[stem]
    return None


def _ru_pre(text: str) -> str:
    from funasr_torch.text.itn import _RU_VOCAB

    rv = _mkres(_RU_VOCAB)
    N = _numpat(_RU_VOCAB)
    D = _numpat([w for w, v in _RU_VOCAB.items() if v <= 9])

    def g(m, k=1):
        return rv(m.group(k))

    def dec_frac(m):
        # "три целых две десятых" -> 3,2 (ru/taggers/decimals.py)
        den = _RU_FRAC_DEN[m.group(3)]
        width = len(str(den)) - 1
        return f"{g(m)},{g(m, 2):0{width}d}"

    rules = [
        (re.compile(rf"\b({N}) (?:целых|целая) ({N}) "
                    rf"({'|'.join(_RU_FRAC_DEN)})\b"), dec_frac),
        (re.compile(rf"\b({N}) запятая ((?:{D} )*{D})\b"),
         lambda m: f"{g(m)},{_digitseq(m.group(2), rv)}"),
        # time: "два часа пятнадцать минут" -> 02:15 (ru verbalizer pads)
        (re.compile(rf"\b({N}) час(?:а|ов)? ({N}) минут[аы]?\b"),
         lambda m: f"{_two(g(m))}:{_two(g(m, 2))}"),
        (re.compile(rf"\b({N}) час(?:а|ов)?\b"),
         lambda m: f"{_two(g(m))}:00"),
        # money: "два рубля" -> 2 руб. (ru verbalizer "2 руб.")
        (re.compile(rf"\b({N}|\d+,\d+) рубл(?:ь|я|ей)"
                    rf"(?: ({N}) копе(?:йка|йки|ек))?\b"),
         lambda m: (m.group(1) if not m.group(1).isalpha()
                    else str(g(m))) + " руб."
         + (f" {_two(g(m, 2))} коп." if m.group(2) else "")),
        (re.compile(rf"\b({N}) копе(?:йка|йки|ек)\b"),
         lambda m: f"{g(m)} коп."),
        (re.compile(rf"\b({N}|\d+,\d+) доллар(?:ов|а)?\b"),
         lambda m: "$" + (m.group(1) if not m.group(1).isalpha()
                          else str(g(m)))),
        (re.compile(rf"\b({N}|\d+,\d+) евро\b"),
         lambda m: "€" + (m.group(1) if not m.group(1).isalpha()
                          else str(g(m)))),
    ]
    text = _sub_all(text, rules)


    tokens = text.split(" ")
    out = []
    i = 0
    while i < len(tokens):
        val = _ru_ordinal_value(tokens[i])
        if val is not None:
            if i + 1 < len(tokens) and tokens[i + 1].lower() in _RU_MONTHS:
                # date: "пятое января" -> "5 января"
                out.append(f"{val} {tokens[i + 1].lower()}")
                i += 2
                continue
            out.append(str(val))
            i += 1
            continue
        out.append(tokens[i])
        i += 1
    return " ".join(out)

# =====================================================================
# Japanese (post: runs after the kanji-number pass, which yields digits)
# =====================================================================

_JA_POST_RULES = [
    # time: 3時20分 -> 3:20, 3時20分10秒 -> 3:20:10, 3時半 -> 3:30
    (re.compile(r"(\d+)時(\d{1,2})分(\d{1,2})秒"),
     lambda m: f"{m.group(1)}:{_two(int(m.group(2)))}:"
     f"{_two(int(m.group(3)))}"),
    (re.compile(r"(\d+)時(\d{1,2})分"),
     lambda m: f"{m.group(1)}:{_two(int(m.group(2)))}"),
    (re.compile(r"(\d+)時半"), lambda m: f"{m.group(1)}:30"),
    # money (ja/data/currency.tsv: ドル -> $, ユーロ -> €)
    (re.compile(r"(\d+(?:\.\d+)?)円"), lambda m: f"¥{m.group(1)}"),
    (re.compile(r"(\d+(?:\.\d+)?)ドル"), lambda m: f"${m.group(1)}"),
    (re.compile(r"(\d+(?:\.\d+)?)ユーロ"), lambda m: f"€{m.group(1)}"),
]

_JA_KANJI_DIGIT = {"一": 1, "二": 2, "三": 3, "四": 4, "五": 5, "六": 6,
                   "七": 7, "八": 8, "九": 9, "十": 10, "十一": 11,
                   "十二": 12}


def _ja_pre(text: str) -> str:
    # single-kanji clock/ordinal digits the conservative cardinal pass
    # leaves alone: 三時 -> 3時, 第三 -> 第3
    def clock(m):
        return f"{_JA_KANJI_DIGIT[m.group(1)]}{m.group(2)}"

    text = re.sub(
        r"(?<![一二三四五六七八九十百千万億])"
        r"(十一|十二|[一二三四五六七八九十])(時|月|日|円|ドル|ユーロ)",
        clock, text)
    text = re.sub(r"第(十一|十二|[一二三四五六七八九十])",
                  lambda m: f"第{_JA_KANJI_DIGIT[m.group(1)]}", text)
    return text


def _ja_post(text: str) -> str:
    return _sub_all(text, _JA_POST_RULES)


# =====================================================================
# Korean
# =====================================================================

_KO_NATIVE_HOURS = {
    "한시": "1시", "두시": "2시", "세시": "3시", "네시": "4시",
    "다섯시": "5시", "여섯시": "6시", "일곱시": "7시", "여덟시": "8시",
    "아홉시": "9시", "열시": "10시", "열한시": "11시", "열두시": "12시",
}

_KO_NATIVE_ORD = {
    "첫": 1, "두": 2, "세": 3, "네": 4, "다섯": 5, "여섯": 6, "일곱": 7,
    "여덟": 8, "아홉": 9, "열": 10,
}

_KO_SINO_DIGIT = {"일": 1, "이": 2, "삼": 3, "사": 4, "오": 5, "육": 6,
                  "칠": 7, "팔": 8, "구": 9, "십": 10}


def _ko_pre(text: str) -> str:
    # native-korean clock hours (ko/data/time/hours.tsv); longest
    # first so 열두시 is not eaten by the 두시 rule
    for k in sorted(_KO_NATIVE_HOURS, key=len, reverse=True):
        text = text.replace(k, _KO_NATIVE_HOURS[k])
    # ordinals: "두 번째" -> "2번째"
    text = re.sub(r"(첫|두|세|네|다섯|여섯|일곱|여덟|아홉|열) ?번째",
                  lambda m: f"{_KO_NATIVE_ORD[m.group(1)]}번째", text)
    # single sino-korean digits before 분/초/월/일 ("이분" -> 2분)
    text = re.sub(r"(?<![\d가-힣])([일이삼사오육칠팔구십]) ?(분|초|월|일)",
                  lambda m: f"{_KO_SINO_DIGIT[m.group(1)]}{m.group(2)}",
                  text)
    return text


_KO_POST_RULES = [
    (re.compile(r"(\d+)시 ?(\d{1,2})분 ?(\d{1,2})초"),
     lambda m: f"{m.group(1)}:{_two(int(m.group(2)))}:"
     f"{_two(int(m.group(3)))}"),
    (re.compile(r"(\d+)시 ?(\d{1,2})분"),
     lambda m: f"{m.group(1)}:{_two(int(m.group(2)))}"),
    (re.compile(r"(\d+)시 ?반"), lambda m: f"{m.group(1)}:30"),
    # money (ko/data/currency.tsv: 원 -> ₩, 달러 -> $)
    (re.compile(r"(\d+(?:\.\d+)?) ?원"), lambda m: f"₩{m.group(1)}"),
    (re.compile(r"(\d+(?:\.\d+)?) ?달러"), lambda m: f"${m.group(1)}"),
    (re.compile(r"(\d+(?:\.\d+)?) ?유로"), lambda m: f"€{m.group(1)}"),
    # decimal: "3점5" / "3 점 5" -> 3.5
    (re.compile(r"(\d+) ?점 ?(\d+)"),
     lambda m: f"{m.group(1)}.{m.group(2)}"),
]


def _ko_post(text: str) -> str:
    return _sub_all(text, _KO_POST_RULES)


# =====================================================================
# Indonesian
# =====================================================================

_ID_ORD_IRREG = {"pertama": 1, "kesatu": 1}


def _id_pre(text: str) -> str:
    from funasr_torch.text.itn import (_ID_BIGS, _ID_DIGITS, _ID_STANDALONE,
                                     _ID_UNITS, _positional_span_to_int)

    all_words = dict(_ID_DIGITS)
    rv = _mkres(all_words)
    N = _numpat(set(_ID_DIGITS) - {"belas"})
    # multi-token numbers for hours ("dua belas" = 12)
    NN = rf"(?:{N}(?: belas)?)"

    def rvv(span: str) -> int:
        toks = span.split(" ")
        if toks[0].isdigit():
            return int(toks[0])
        return _positional_span_to_int(toks, _ID_DIGITS, _ID_UNITS,
                                       _ID_BIGS, _ID_STANDALONE)

    tokens = text.split(" ")
    out = []
    i = 0
    while i < len(tokens):
        t = tokens[i].lower()
        if t in _ID_ORD_IRREG:
            out.append(f"ke-{_ID_ORD_IRREG[t]}")
            i += 1
            continue
        if t.startswith("ke") and t[2:] in _ID_DIGITS:
            # "kedua" -> ke-2, "kedua puluh" -> ke-20 (ke + cardinal)
            span = [t[2:]]
            j = i + 1
            keys = (set(_ID_DIGITS) | set(_ID_UNITS) | set(_ID_BIGS)
                    | set(_ID_STANDALONE))
            while j < len(tokens) and tokens[j].lower() in keys:
                span.append(tokens[j].lower())
                j += 1
            val = _positional_span_to_int(span, _ID_DIGITS, _ID_UNITS,
                                          _ID_BIGS, _ID_STANDALONE)
            out.append(f"ke-{val}")
            i = j
            continue
        out.append(tokens[i])
        i += 1
    text = " ".join(out)

    def g(m, k=1):
        return rvv(m.group(k))

    rules = [
        # time: "jam dua lewat lima belas" -> 2:15, kurang -> minutes-to,
        # "setengah delapan" -> 7:30
        (re.compile(rf"\bjam ({NN}) lewat ({NN})\b"),
         lambda m: f"{g(m)}:{_two(g(m, 2))}"),
        (re.compile(rf"\bjam ({NN}) kurang ({NN})\b"),
         lambda m: f"{(g(m) - 1) or 12}:{_two(60 - g(m, 2))}"),
        (re.compile(rf"\b(?:jam )?setengah ({NN})\b"),
         lambda m: f"{(g(m) - 1) or 12}:30"),
        (re.compile(rf"\bjam ({NN}) ({NN})\b"),
         lambda m: f"{g(m)}:{_two(g(m, 2))}"),
    ]
    return _sub_all(text, rules)


_ID_POST_RULES = [
    (re.compile(r"(\d+) koma ((?:\d+ )*\d+)"),
     lambda m: f"{m.group(1)},{m.group(2).replace(' ', '')}"),
    # money: rupiah -> Rp (prefix, id convention)
    (re.compile(r"\b(\d+(?:,\d+)?) rupiah\b"), lambda m: f"Rp{m.group(1)}"),
    (re.compile(r"\b(\d+(?:,\d+)?) dolar\b"), lambda m: f"${m.group(1)}"),
    (re.compile(r"\b(\d+(?:,\d+)?) euro\b"), lambda m: f"€{m.group(1)}"),
]


def _id_post(text: str) -> str:
    return _sub_all(text, _ID_POST_RULES)


# =====================================================================
# Vietnamese
# =====================================================================

_VI_ORD_SPECIAL = {"nhất": 1, "nhì": 2, "tư": 4}


def _vi_pre(text: str) -> str:
    from funasr_torch.text.itn import _VI_DIGITS

    rv = _mkres(_VI_DIGITS)
    N = _numpat(_VI_DIGITS)
    NN = rf"(?:{N}(?: mươi(?: {N})?)?)"

    def rvv(span: str) -> int:
        from funasr_torch.text.itn import (_VI_BIGS, _VI_UNITS,
                                         _positional_span_to_int)

        toks = span.split(" ")
        if toks[0].isdigit():
            return int(toks[0])
        return _positional_span_to_int(toks, _VI_DIGITS, _VI_UNITS,
                                       _VI_BIGS, {})

    def ord_repl(m):
        w = m.group(1)
        if w in _VI_ORD_SPECIAL:
            return f"thứ {_VI_ORD_SPECIAL[w]}"
        if w in _VI_DIGITS:
            return f"thứ {_VI_DIGITS[w]}"
        return m.group(0)

    text = re.sub(r"thứ (\S+)", ord_repl, text)

    def g(m, k=1):
        return rvv(m.group(k))

    rules = [
        # time: "ba giờ hai mươi phút" -> 3:20, "ba giờ rưỡi" -> 3:30
        (re.compile(rf"\b({NN}) giờ ({NN}) phút\b"),
         lambda m: f"{g(m)}:{_two(g(m, 2))}"),
        (re.compile(rf"\b({NN}) giờ rưỡi\b"), lambda m: f"{g(m)}:30"),
        (re.compile(rf"\b({NN}) giờ kém ({NN})\b"),
         lambda m: f"{(g(m) - 1) or 12}:{_two(60 - g(m, 2))}"),
        # fraction: "hai phần ba" -> 2/3 (vi/taggers/fraction.py)
        (re.compile(rf"\b({NN}) (?:phần|trên|chia) ({NN})\b"),
         lambda m: f"{g(m)}/{g(m, 2)}"),
    ]
    return _sub_all(text, rules)


_VI_POST_RULES = [
    (re.compile(r"(\d+) phẩy ((?:\d+ )*\d+)"),
     lambda m: f"{m.group(1)},{m.group(2).replace(' ', '')}"),
    (re.compile(r"(\d+) chấm ((?:\d+ )*\d+)"),
     lambda m: f"{m.group(1)}.{m.group(2).replace(' ', '')}"),
    (re.compile(r"\b(\d+) giờ (\d{1,2}) phút\b"),
     lambda m: f"{m.group(1)}:{_two(int(m.group(2)))}"),
    (re.compile(r"\b(\d+) giờ rưỡi\b"), lambda m: f"{m.group(1)}:30"),
    # money (vi/taggers: đô la mỹ -> $, đồng -> đ; symbol prefixed like
    # the shared money verbalizer)
    (re.compile(r"\b(\d+(?:[.,]\d+)?) đô la(?: mỹ)?\b"),
     lambda m: f"${m.group(1)}"),
    (re.compile(r"\b(\d+(?:[.,]\d+)?) đồng\b"), lambda m: f"đ{m.group(1)}"),
    (re.compile(r"\b(\d+(?:[.,]\d+)?) euro\b"), lambda m: f"€{m.group(1)}"),
    (re.compile(r"\b(\d+) (?:phần|trên|chia) (\d+)\b"),
     lambda m: f"{m.group(1)}/{m.group(2)}"),
]


def _vi_post(text: str) -> str:
    return _sub_all(text, _VI_POST_RULES)


# =====================================================================
# Tagalog
# =====================================================================

_TL_MONTHS = ("enero", "pebrero", "marso", "abril", "mayo", "hunyo",
              "hulyo", "agosto", "setyembre", "oktubre", "nobyembre",
              "disyembre")

_TL_ORD = {
    "una": 1, "ikalawa": 2, "pangalawa": 2, "ikatlo": 3, "pangatlo": 3,
    "ikaapat": 4, "ikalima": 5, "ikaanim": 6, "ikapito": 7, "ikawalo": 8,
    "ikasiyam": 9, "ikasampu": 10,
}

# Spanish-derived clock hours ("alas dos" = 2 o'clock)
_TL_ALAS = {"una": 1, "dos": 2, "tres": 3, "kuwatro": 4, "singko": 5,
            "sais": 6, "seis": 6, "siyete": 7, "otso": 8, "nuwebe": 9,
            "diyes": 10, "onse": 11, "dose": 12}


def _tl_pre(text: str) -> str:
    tokens = text.split(" ")
    out = []
    i = 0
    while i < len(tokens):
        t = tokens[i].lower()
        if t in _TL_ORD:
            out.append(f"ika-{_TL_ORD[t]}")
            i += 1
            continue
        if t == "alas" and i + 1 < len(tokens) \
                and tokens[i + 1].lower() in _TL_ALAS:
            h = _TL_ALAS[tokens[i + 1].lower()]
            rest = [w.lower() for w in tokens[i + 2:i + 4]]
            if rest[:2] == ["y", "medya"]:
                out.append(f"{h}:30")
                i += 4
                continue
            out.append(f"{h}:00")
            i += 2
            continue
        out.append(tokens[i])
        i += 1
    return " ".join(out)


_TL_POST_RULES = [
    (re.compile(r"(\d+) punto ((?:\d+ )*\d+)"),
     lambda m: f"{m.group(1)}.{m.group(2).replace(' ', '')}"),
    (re.compile(r"\b(\d+(?:\.\d+)?) piso\b"), lambda m: f"₱{m.group(1)}"),
    (re.compile(r"\b(\d+(?:\.\d+)?) (?:dolyares|dolyar)\b"),
     lambda m: f"${m.group(1)}"),
]


def _tl_post(text: str) -> str:
    return _sub_all(text, _TL_POST_RULES)


# ---------------------------------------------------------------- registry

PRE: Dict[str, Callable[[str], str]] = {
    "de": _de_pre, "es": _es_pre, "fr": _fr_pre, "pt": _pt_pre,
    "ru": _ru_pre, "ja": _ja_pre, "ko": _ko_pre, "id": _id_pre,
    "vi": _vi_pre, "tl": _tl_pre,
}

POST: Dict[str, Callable[[str], str]] = {
    "ja": _ja_post, "ko": _ko_post, "id": _id_post, "vi": _vi_post,
    "tl": _tl_post,
}
