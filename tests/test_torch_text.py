"""The port's text normalization (``funasr_tpu_torch/text``) against the JAX package's.

Every case of ``tests/test_itn.py``, ``test_itn_electronic.py``,
``test_itn_multilingual.py``, ``test_multilingual_itn.py`` and
``test_multilingual_tn.py`` runs through both packages and must give the same result
(or raise the same exception type); a hypothesis sweep of integers through ``num2zh`` /
``num2en`` / ``InverseNormalizer``; the grammar archive equal as JSON, with
``load_grammar`` round-tripping.
"""

import json
import os
import tempfile
import types

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import funasr_tpu.text.electronic
import funasr_tpu.text.en_numbers
import funasr_tpu.text.export_grammar
import funasr_tpu.text.inverse_normalize
import funasr_tpu.text.multilingual
import funasr_tpu.text.zh_en_tn
import funasr_tpu.text.zh_numbers
import funasr_tpu_torch.text.electronic
import funasr_tpu_torch.text.en_numbers
import funasr_tpu_torch.text.export_grammar
import funasr_tpu_torch.text.inverse_normalize
import funasr_tpu_torch.text.multilingual
import funasr_tpu_torch.text.zh_en_tn
import funasr_tpu_torch.text.zh_numbers

_MODULES = ("electronic", "en_numbers", "export_grammar", "inverse_normalize",
            "multilingual", "zh_en_tn", "zh_numbers")


def _ns(pkg):
    return types.SimpleNamespace(**{m: getattr(pkg.text, m) for m in _MODULES})


JAX = _ns(funasr_tpu)
PORT = _ns(funasr_tpu_torch)


def _run(fn, t):
    try:
        return fn(t)
    except Exception as e:  # noqa: BLE001 - the exception's type is the result
        return ("raises", type(e).__name__)


def itn(lang, text):
    return lambda t: t.inverse_normalize.InverseNormalizer(lang=lang).inverse_normalize(text)


def tn(lang, text):
    return lambda t: t.inverse_normalize.Normalizer(lang=lang).normalize(text)


def call(module, name, *args):
    return lambda t: getattr(getattr(t, module), name)(*args)


def roundtrip(lang, n):
    def fn(t):
        spoken = t.inverse_normalize.Normalizer(lang=lang).normalize(str(n))
        return spoken, t.inverse_normalize.InverseNormalizer(lang=lang).inverse_normalize(spoken)
    return fn


CASES = []


def _add(group, fns):
    CASES.extend(pytest.param(fn, id=f"{group}-{i}") for i, fn in enumerate(fns))


# tests/test_itn.py
_add("parse_cn_number", [call("zh_numbers", "parse_cn_number", s) for s in (
    "三百二十五", "一千零二十四", "两万三千", "一亿二千万", "十五", "二零二三", "三点一四",
    "幺三九")])
_add("verbalize_zh", [call("zh_numbers", "verbalize_number_zh", s) for s in (
    "325", "1024", "15", "3.14", "100000000")])
_add("itn_zh_sentences", [itn("zh", s) for s in (
    "百分之五十", "今年是二零二三年五月二十号", "现在是下午三点三十分", "这个东西五十块钱",
    "我们一起去")])
_add("itn_en_sentences", [itn("en", s) for s in (
    "i have twenty five apples", "fifty percent of the time",
    "three hundred and forty two thousand", "one and two")])
_add("tn_zh", [tn("zh", s) for s in ("我有325个苹果", "涨了12%")])
_add("unknown_language", [itn("xx", "三"), itn("ja", "こんにちは")])
_add("itn_zh_dates_times_money", [call("zh_numbers", "inverse_normalize_zh", s) for s in (
    "十二月三十一日", "二零二三年五月一号", "十月一号国庆节", "三点十五分", "两点半",
    "下午四点零五分二十秒开会", "三点一四", "五块钱", "三百万日元")])
_add("itn_en_ordinals_money", [call("en_numbers", "inverse_normalize_en", s) for s in (
    "three dollars fifty", "three dollars and fifty cents", "fifty cents",
    "two hundred dollars", "twenty first", "january third", "one hundred and first",
    "second place", "the twenty second of may")])

# tests/test_itn_electronic.py
_EMAIL_URL = [
    ("en", "c d f at a b c dot e d u"), ("en", "my email is john at gmail dot com"),
    ("en", "j o h n at g mail dot co dot uk"), ("de", "hans at gmail punkt de"),
    ("es", "c d f arroba a b c punto e d u"), ("fr", "dupont arobase orange point fr"),
    ("pt", "silva arroba uol ponto com ponto br"), ("vi", "a b c a còng d e f chấm com"),
    ("id", "user at gmail titik com"), ("ja", "abcアットマークdefドットcom"),
    ("ko", "abc골뱅이def닷com"), ("zh", "abc艾特gmail点com"),
    ("en", "www a b c dot com"), ("en", "www open a i dot com"),
    ("en", "www dot example dot org please"), ("fr", "www point le monde point fr")]
_GUARD = [("en", "at the house"), ("en", "meet me at noon dot"),
          ("en", "i will be at home later"), ("en", "www is short for world wide web"),
          ("de", "wir treffen uns at punkt")]
_WHITELIST = [("en", "doctor smith"), ("en", "for example this"),
              ("en", "mister and misses jones"), ("fr", "monsieur dupont"),
              ("de", "doktor schmidt"), ("pt", "senhora silva"), ("ru", "то есть да"),
              ("ja", "セブンイレブンです")]
_add("electronic", [call("electronic", "apply_electronic", lang, s)
                    for lang, s in _EMAIL_URL + _GUARD])
_add("whitelist", [call("electronic", "apply_whitelist", lang, s) for lang, s in
                   _WHITELIST + [("en", "doctors orders"), ("en", "the saintly one")]])
_add("full_pipeline", [itn(lang, s) for lang, s in (
    ("en", "doctor smith wrote john at gmail dot com"),
    ("de", "doktor schmidt hat fünfzig prozent"), ("ko", "abc골뱅이def닷com"),
    ("zh", "我的邮箱是abc艾特gmail点com"), ("zh", "三点十五分"))])

# tests/test_itn_multilingual.py
_add("zh_tn_classes", [call("zh_en_tn", "num2zh", n) for n in (10500, 12345, 205, 10)]
     + [call("zh_en_tn", "normalize_zh", s) for s in (
         "占12%", "3/4的人", "2024年10月1日", "8:30开会", "¥3.5", "花了25块",
         "电话13812345678", "3.14")])
_add("en_tn_classes", [call("zh_en_tn", "num2en_ordinal", n) for n in (21, 30)]
     + [call("zh_en_tn", "normalize_en", s) for s in (
         "$3.50", "12%", "the 3rd time", "in 1984", "in 2007", "2.5 miles",
         "123 things")])
_add("normalizer_full_grammars", [tn("zh", "占12%"), tn("en", "$5")])
_add("class_rules", [itn(lang, s) for lang, s in (
    ("de", "dreizehn uhr zehn"), ("de", "fünf euro zwanzig"), ("de", "drei komma eins vier"),
    ("de", "vierundzwanzigster juli zweitausenddreizehn"), ("de", "fünfzig prozent"),
    ("de", "halb zwölf"),
    ("es", "tres coma catorce"), ("es", "cinco euros con veinte céntimos"),
    ("es", "tercero"), ("es", "cincuenta por ciento"),
    ("fr", "trois virgule quatorze"), ("fr", "cinq euros vingt"), ("fr", "premier"),
    ("fr", "cinquième"), ("fr", "treize heures dix"), ("fr", "cinquante pour cent"),
    ("pt", "primeiro"), ("pt", "cinquenta por cento"), ("ru", "пять рублей"),
    ("ru", "третий"), ("ru", "пятьдесят процентов"), ("ru", "три запятая один четыре"),
    ("id", "lima puluh persen"), ("id", "tiga koma satu empat"),
    ("vi", "năm mươi phần trăm"),
    ("ja", "三時十五分"), ("ja", "三点一四"), ("ja", "五十パーセント"), ("ko", "삼점일사"),
    ("ko", "세시 삼십분"), ("ko", "오십퍼센트"),
    ("de", "null sieben eins drei"), ("es", "uno cuatro"))])

# tests/test_multilingual_itn.py
_add("multilingual_itn", [itn(lang, s) for lang, s in (
    ("zh", "一共三百二十五元"), ("en", "twenty three dollars"), ("ja", "価格は三千五百円です"),
    ("ja", "二〇二三年"), ("ko", "삼만 오천 원"), ("ko", "이십일"),
    ("de", "ich habe dreiundzwanzig Katzen"), ("de", "zweitausendvierundzwanzig"),
    ("es", "tengo veintitrés gatos"), ("es", "quinientos treinta y dos"),
    ("fr", "quatre-vingt-dix-sept"), ("fr", "deux cents euros"),
    ("pt", "duzentos e cinquenta"), ("ru", "двести пятьдесят три"), ("ru", "пять тысяч"),
    ("id", "dua puluh tiga ribu"), ("vi", "hai mươi ba nghìn"), ("vi", "một trăm lẻ năm"),
    ("tl", "dalawampu at lima"))])
_add("multilingual_class_rules", [itn(lang, s) for lang, s in (
    ("de", "drei fünftel"), ("de", "ein viertel"), ("fr", "deux tiers"),
    ("fr", "trois quarts"), ("pt", "dois terços"), ("id", "tiga per empat"),
    ("vi", "ba phần tư"), ("ja", "三分の一"), ("ko", "삼분의 일"),
    ("de", "fünf kilometer"), ("de", "zwei komma fünf kilogramm"),
    ("es", "cinco kilómetros"), ("fr", "cinq kilomètres"), ("pt", "cinco quilômetros"),
    ("ru", "пять километров"), ("ru", "сто граммов"), ("id", "lima kilometer"),
    ("vi", "năm ki-lô-mét"), ("ja", "五キロメートル"), ("ko", "오 킬로미터"), ("ko", "오미터"),
    ("de", "null sieben drei drei eins acht neun vier"), ("ja", "ゼロ三の一二三四の五六七八"),
    ("vi", "hai giờ rưỡi"), ("vi", "chín giờ kém hai mươi"),
    ("vi", "mười giờ chín phút bốn mươi lăm giây"), ("vi", "mười hai đô la mỹ"),
    ("vi", "hai mươi euro"),
    ("vi", "ngày hai mươi tháng tư năm hai nghìn không trăm hai mươi"),
    ("vi", "một hai ba một hai ba năm sáu bảy tám"),
    ("tl", "labinlima"), ("tl", "tatlo libo labintatlo"), ("tl", "ikalimang hakbang"),
    ("tl", "sampu porsyento"), ("tl", "lima piso"), ("tl", "lima kilometro"),
    ("ja", "価格は三千五百円です"), ("ja", "十二ドル"), ("ko", "삼만 오천 원"),
    ("ko", "십이 달러"), ("id", "dua ribu tiga belas"),
    ("id", "dua puluh empat januari dua ribu tiga belas"), ("id", "kelima"),
    ("id", "pertama"), ("id", "jam setengah lima"), ("id", "lima ribu rupiah"))])
_add("non_number_text", [itn(lang, "hello world") for lang in (
    "ja", "ko", "de", "es", "fr", "pt", "ru", "id", "vi", "tl")])
_add("tn_itn_roundtrip", [roundtrip(lang, n) for lang, n in (
    ("de", 23), ("de", 2024), ("de", 1000000), ("es", 532), ("es", 150), ("es", 21),
    ("ru", 253), ("ru", 5000), ("ru", 1001))])

# tests/test_multilingual_tn.py
_GOLDEN_TN = {
    "de": ("um 02:15 Uhr", "um 1 Uhr", "14:00 Uhr", "am 4. Mai 2002", "am 24.07.2013", "€5",
           "1,40 £", "$12,05", "3,406", "5 km", "2,5 kg", "12%", "der 3.", "3/4",
           "030 1234567", "243", "-5"),
    "es": ("a las 02:15", "02:30", "03:40", "02:45", "31 de marzo de 2000", "1 de mayo", "$5",
           "€1", "£1,40", "3,14", "5 km", "12%", "el 3º", "la 2ª", "91 1234567", "243"),
    "ru": ("в 02:15", "01:00", "05:02", "1 мая", "23 апреля 2002 года", "5 ₽", "2 руб.",
           "21 ₽", "5,02 ₽", "3,14", "2 кг", "5 км", "1 л", "12%", "21%", "2%",
           "495 1234567", "243"),
}
_add("tn_class_matrix", [tn(lang, s) for lang, cases in _GOLDEN_TN.items() for s in cases])
_add("tn_itn_roundtrip_cardinal", [roundtrip(lang, n) for lang in sorted(_GOLDEN_TN)
                                   for n in (7, 21, 99, 110, 243, 1999, 2024)])


@pytest.mark.parametrize("fn", CASES)
def test_case_equal(fn):
    want = _run(fn, JAX)
    assert _run(fn, PORT) == want


def test_extensible_whitelist():
    """A dict whitelist, a TSV whitelist and ``add_whitelist`` in both packages."""
    fd, path = tempfile.mkstemp(suffix=".tsv")
    with os.fdopen(fd, "w", encoding="utf-8") as f:
        f.write("AT&T\ta t and t\n7-eleven\tseven eleven\n")
    try:
        got = {}
        for name, t in (("jax", JAX), ("port", PORT)):
            inv = t.inverse_normalize.InverseNormalizer
            out = [inv(lang="en", whitelist={"as soon as possible": "ASAP"})
                   .inverse_normalize("reply as soon as possible"),
                   inv(lang="en", whitelist=path).inverse_normalize("i work at a t and t")]
            t.electronic.add_whitelist("en", {"et cetera": "etc."})
            try:
                out.append(inv(lang="en").inverse_normalize("pens pencils et cetera"))
            finally:
                t.electronic.WHITELIST["en"].pop("et cetera")
            got[name] = out
    finally:
        os.unlink(path)
    assert got["port"] == got["jax"] == ["reply ASAP", "i work at AT&T", "pens pencils etc."]


def test_grammar_archive_equal_and_roundtrips(tmp_path):
    """``export_grammar`` gives the same JSON in both packages (GRAMMAR_VERSION 6), and
    the port's ``load_grammar`` rebuilds functions equal to the module lexicons."""
    assert PORT.export_grammar.GRAMMAR_VERSION == JAX.export_grammar.GRAMMAR_VERSION == 6
    path = str(tmp_path / "itn_grammar.json")
    archive = PORT.export_grammar.export_grammar(path)
    assert json.dumps(archive, sort_keys=True, ensure_ascii=False) == json.dumps(
        JAX.export_grammar.export_grammar(), sort_keys=True, ensure_ascii=False)
    with open(path, encoding="utf-8") as f:
        assert json.load(f) == json.loads(json.dumps(archive))
    funcs = PORT.export_grammar.load_grammar(path)
    jax_funcs = JAX.export_grammar.load_grammar(path)
    samples = {"de": "zweihundert dreiundvierzig", "es": "doscientos cuarenta y tres",
               "fr": "deux cents quarante trois", "pt": "duzentos e quarenta e tres",
               "ru": "двести сорок три", "id": "dua ratus empat puluh tiga",
               "vi": "hai trăm bốn ba", "tl": "dalawang daan", "ja": "三百二十五",
               "ko": "삼백이십오", "zh": "三百二十五"}
    for lang, text in samples.items():
        rebuilt = funcs[lang](text)
        assert rebuilt == jax_funcs[lang](text), lang
        if lang in PORT.multilingual.ITN_FUNCS:
            assert rebuilt == PORT.multilingual.ITN_FUNCS[lang](text), lang
        assert any(ch.isdigit() for ch in rebuilt), (lang, rebuilt)


@settings(max_examples=200, deadline=None)
@given(st.integers(min_value=0, max_value=10 ** 12))
def test_numbers_sweep(n):
    """num2zh / num2en and the ITN of their outputs agree between the packages."""
    for t_name in ("num2zh", "num2en"):
        spoken = getattr(PORT.zh_en_tn, t_name)(n)
        assert spoken == getattr(JAX.zh_en_tn, t_name)(n)
        lang = "zh" if t_name == "num2zh" else "en"
        assert (PORT.inverse_normalize.InverseNormalizer(lang=lang).inverse_normalize(spoken)
                == JAX.inverse_normalize.InverseNormalizer(lang=lang).inverse_normalize(spoken))
