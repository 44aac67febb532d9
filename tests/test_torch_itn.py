"""The port's inverse text normalization (``funasr_torch/text``) against the
JAX package's (``funasr_tpu/text``) on the CPU.

Every input of the JAX package's ITN tests (``tests/test_itn_classes.py``,
``tests/test_itn_aligner.py``) is collected from their source: the
``inv``/``_inv``/``inverse_normalize`` calls with literal arguments, the
values of their ``parametrize`` lists, and, for the TN round trips, the
JAX package's TN output of the written form.  Each language's inputs, and a
seeded random corpus of 300 strings of number words of that language (its
numerals, scales and connectors, from the JAX rules' own tables, mixed with
plain words), must give the same output in both packages (``expected``).
Where the JAX rules raise IndexError (a text ending in a connector word, in
seven languages), the port's copy is guarded and must give the JAX output
of the text before those trailing words, followed by them.  One case per
language, so each counts.
"""

import ast
import inspect
from pathlib import Path

import numpy as np
import pytest

import funasr_tpu.text.itn as JI
from funasr_tpu.text.itn import inverse_normalize as jax_itn
from funasr_torch.text import inverse_normalize as port_itn
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent
SOURCES = ("test_itn_classes.py", "test_itn_aligner.py")
ITN_NAMES = {"inv", "_inv", "inverse_normalize", "_itn_rt"}
TN_NAMES = {"normalize", "_tn"}
LANGS = ("zh", "en", "ja", "ko", "de", "es", "fr", "pt", "ru", "id", "vi", "tl")


def _literal(node, env):
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, ast.Name) and node.id in env:
        return env[node.id]
    if (isinstance(node, ast.Call) and getattr(node.func, "id", None) in TN_NAMES
            and len(node.args) >= 2):
        from funasr_tpu.text.tn import normalize

        written, lang = (_literal(a, env) for a in node.args[:2])
        if isinstance(written, str) and isinstance(lang, str):
            return normalize(written, lang)
    return None


def _param_rows(fn, module_consts):
    """The argument dicts of a test's ``parametrize`` decorators."""
    rows = [{}]
    for dec in fn.decorator_list:
        if not (isinstance(dec, ast.Call) and getattr(dec.func, "attr", None) == "parametrize"):
            continue
        names = [n.strip() for n in ast.literal_eval(dec.args[0]).split(",")]
        values = dec.args[1]
        values = (module_consts.get(values.id) if isinstance(values, ast.Name)
                  else ast.literal_eval(values))
        new = []
        for row in rows:
            for v in values:
                v = v if len(names) > 1 else (v,)
                new.append({**row, **dict(zip(names, v))})
        rows = new
    return rows


def jax_test_inputs():
    """(lang, text) of every ITN call in the JAX package's ITN tests."""
    out = []
    for name in SOURCES:
        tree = ast.parse((ROOT / name).read_text(encoding="utf-8"))
        consts = {}
        for node in tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                try:
                    consts[node.targets[0].id] = ast.literal_eval(node.value)
                except (ValueError, AttributeError):
                    pass
        for fn in (n for n in tree.body if isinstance(n, ast.FunctionDef)):
            for env in _param_rows(fn, consts):
                for call in (n for n in ast.walk(fn) if isinstance(n, ast.Call)):
                    if getattr(call.func, "id", None) not in ITN_NAMES or not call.args:
                        continue
                    text = _literal(call.args[0], env)
                    lang = _literal(call.args[1], env) if len(call.args) > 1 else "zh"
                    if isinstance(text, str) and isinstance(lang, str):
                        out.append((lang, text))
    return out


def _vocab(lang):
    """Number words of ``lang`` from the JAX rules' tables, and connectors."""
    keys = lambda *names: [w for n in names for w in getattr(JI, n)]
    return {
        "zh": list(JI._ZH_NUM_CHARS) + list("点负第分之百年月日号块毛个人的") + ["百分之"],
        "ja": list(JI._ZH_NUM_CHARS) + list("億萬兩点パーセント円年月日時分"),
        "ko": list(JI._KO_CHARS) + ["퍼센트", "원", "년", "월", "일", "시", "분", " "],
        "en": keys("_EN_ONES", "_EN_TENS", "_EN_SCALE", "_EN_ORD_ONES", "_EN_ORD_TENS")
        + list(JI._EN_CURRENCY) + ["and", "point", "percent", "minus", "a", "half", "past",
                                   "quarter", "to", "o", "oh", "p", "m", "dot", "at"],
        "es": keys("_ES_VOCAB", "_ES_SCALE") + ["y", "por", "ciento", "coma", "menos",
                                                "euros", "de"],
        "fr": keys("_FR_VOCAB", "_FR_SCALE") + ["et", "pour", "cent", "virgule", "moins",
                                                "euros", "heures"],
        "de": keys("_DE_ATOMS") + ["und", "prozent", "komma", "minus", "euro", "uhr",
                                   "hundert", "tausend"],
        "pt": keys("_PT_VOCAB", "_PT_SCALE") + ["e", "por", "cento", "vírgula", "menos",
                                                "reais", "de"],
        "ru": keys("_RU_VOCAB", "_RU_SCALE") + ["процентов", "запятая", "минус", "рублей",
                                                "и"],
        "id": keys("_ID_DIGITS", "_ID_UNITS", "_ID_BIGS", "_ID_STANDALONE")
        + ["persen", "koma", "minus", "rupiah", "dan"],
        "vi": keys("_VI_DIGITS", "_VI_UNITS", "_VI_BIGS") + ["linh", "lẻ", "phần", "trăm",
                                                             "phẩy", "đồng"],
        "tl": keys("_TL_DIGITS", "_TL_UNITS", "_TL_BIGS") + ["at", "'t", "porsyento",
                                                             "piso", "alas"],
    }[lang]


def random_corpus(lang, n=300, seed=0):
    rng = np.random.default_rng([seed, LANGS.index(lang)])
    words = _vocab(lang)
    plain = {"zh": list("我们今天有人在这里"), "ja": list("私はここにいます")}.get(
        lang, ["word", "the", "x", "hello"])
    sep = "" if lang in ("zh", "ja") else " "
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 9))
        toks = [str(words[int(rng.integers(len(words)))]) if rng.random() < 0.8
                else plain[int(rng.integers(len(plain)))] for _ in range(k)]
        out.append(sep.join(toks))
    return out


INPUTS = jax_test_inputs()


def test_collects_every_jax_itn_case():
    import tests.test_itn_classes as TC

    langs = {lang for lang, _ in INPUTS}
    assert set(LANGS) <= langs and {"sw", "xx"} <= langs
    assert {(lang, src) for lang, src, _ in TC.CASES} <= set(INPUTS)
    assert len(INPUTS) >= len(TC.CASES) + 100
    assert inspect.getsource(port_itn) == inspect.getsource(jax_itn).replace(
        "funasr_tpu.text", "funasr_torch.text")


@pytest.mark.parametrize("lang", LANGS + ("other",))
def test_itn_matches_jax(lang):
    cases = [(lg, t) for lg, t in INPUTS if lg == lang or (lang == "other" and lg not in LANGS)]
    if lang != "other":
        cases += [(lang, t) for t in random_corpus(lang)] + [(lang.upper(), t) for t in
                                                             random_corpus(lang, 20, 1)]
    else:
        cases += [(lg, t) for lg in ("auto", "yue", "nospeech", "")
                  for t in ("三十五", "twenty one", "百分之五十")]
    assert len(cases) >= 3
    got = [port_itn(t, lg) for lg, t in cases]
    want = [expected(t, lg) for lg, t in cases]
    assert got == want
    if lang != "other":  # the corpus exercises the rules, not only the pass-through
        assert sum(g != t for g, (_, t) in zip(got, cases)) >= 10


def expected(text, lang):
    """The JAX package's output.  Its rules for en, de, es, fr, pt, vi and tl
    read one token past the end of a text that ends in a connector word
    ("... and", "... y", "... 't") and raise IndexError; the port's copy
    emits the connector instead, so there the JAX output of the text
    before the trailing words that make it raise, followed by those words."""
    toks = text.split(" ")
    for k in range(len(toks) + 1):
        head = " ".join(toks[:len(toks) - k])
        try:
            out = jax_itn(head, lang)
        except IndexError:
            continue
        return " ".join([out] * bool(head) + toks[len(toks) - k:])
    raise AssertionError(text)


@pytest.mark.parametrize("lang,text,want", [
    ("en", "twenty one and", "21 and"), ("en", "and", "and"), ("de", "eins und", "eins und"),
    ("es", "veinte y", "20 y"), ("fr", "un et", "un et"), ("pt", "um e", "um e"),
    ("vi", "một lẻ", "một lẻ"), ("tl", "isa 't", "isa 't")])
def test_itn_trailing_connector(lang, text, want):
    """A text ending in a connector word, where the JAX rules raise."""
    with pytest.raises(IndexError):
        jax_itn(text, lang)
    assert port_itn(text, lang) == want
