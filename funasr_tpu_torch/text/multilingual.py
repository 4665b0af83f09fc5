"""Multilingual spoken-number ITN (ja, ko, de, es, fr, pt, ru, id, vi, tl).

Counterpart of the per-language pynini grammar dirs in FunASR
``fun_text_processing/inverse_text_normalization/{de,es,fr,id,ja,ko,pt,ru,tl,
vi}/`` as deterministic rules. Two engines:

- CJK positional (ja, ko): digit/unit characters with 10^4-grouped big units —
  the same algorithm as :mod:`funasr_tpu_torch.text.zh_numbers` with per-language
  character maps;
- word-lexicon (European/SEA languages): ones/tens/hundreds/scale lexicons with
  language quirks handled up front (German und-compounds, French
  quatre-vingt/soixante-dix, Spanish "y", Russian inflections, Vietnamese
  lẻ/linh, Tagalog na/'t ligatures).

Each ``inverse_normalize_<lang>(text)`` replaces maximal spoken-number spans
with digit strings and leaves everything else untouched.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

# ----------------------------------------------------------------------
# CJK positional engine (ja / ko)
# ----------------------------------------------------------------------

_JA_DIGITS = {"零": 0, "〇": 0, "一": 1, "二": 2, "三": 3, "四": 4, "五": 5,
              "六": 6, "七": 7, "八": 8, "九": 9}
_JA_UNITS = {"十": 10, "百": 100, "千": 1000}
_JA_BIG = {"万": 10 ** 4, "億": 10 ** 8, "兆": 10 ** 12}

_KO_DIGITS = {"영": 0, "공": 0, "일": 1, "이": 2, "삼": 3, "사": 4, "오": 5,
              "육": 6, "칠": 7, "팔": 8, "구": 9}
_KO_UNITS = {"십": 10, "백": 100, "천": 1000}
_KO_BIG = {"만": 10 ** 4, "억": 10 ** 8, "조": 10 ** 12}


def _parse_cjk(text: str, digits: Dict, units: Dict, big: Dict) -> Optional[str]:
    if not text:
        return None
    if all(ch in digits for ch in text):
        if len(text) == 1:
            return str(digits[text])
        return "".join(str(digits[ch]) for ch in text)
    total = 0
    section = 0
    current = 0
    for ch in text:
        if ch in digits:
            current = digits[ch]
        elif ch in units:
            section += (current if current else 1) * units[ch]
            current = 0
        elif ch in big:
            contribution = section + current
            if contribution:
                total += contribution * big[ch]
            elif total:
                total *= big[ch]
            else:
                total = big[ch]
            section = current = 0
        else:
            return None
    return str(total + section + current)


def _cjk_itn(text: str, digits: Dict, units: Dict, big: Dict) -> str:
    chars = "".join(digits) + "".join(units) + "".join(big)
    c = re.escape(chars)
    # groups may be space-separated (Korean: "삼만 오천")
    pat = re.compile(f"[{c}]+(?:[ ]+[{c}]+)*")

    def repl(m):
        out = _parse_cjk(m.group(0).replace(" ", ""), digits, units, big)
        return out if out is not None else m.group(0)

    return pat.sub(repl, text)


def inverse_normalize_ja(text: str) -> str:
    return _cjk_itn(text, _JA_DIGITS, _JA_UNITS, _JA_BIG)


def inverse_normalize_ko(text: str) -> str:
    return _cjk_itn(text, _KO_DIGITS, _KO_UNITS, _KO_BIG)


# ----------------------------------------------------------------------
# word-lexicon engine
# ----------------------------------------------------------------------

class _Lex:
    """ones: word -> 0..19 (or any additive value); tens: word -> 20..90;
    hundreds_word multiplies the current figure by 100; scales: word -> 10^n."""

    def __init__(self, ones: Dict[str, int], tens: Dict[str, int],
                 hundred_words: List[str], scales: Dict[str, int],
                 joiners: List[str] = (), hundreds_direct: Dict[str, int] = None,
                 x10_words: List[str] = ()):
        self.ones = ones
        self.tens = tens
        self.hundred_words = set(hundred_words)
        self.scales = scales
        self.joiners = set(joiners)
        self.hundreds_direct = hundreds_direct or {}
        self.x10_words = set(x10_words)  # "<digit> puluh/mươi" tens pattern
        self.vocab = (set(ones) | set(tens) | self.hundred_words | set(scales)
                      | self.joiners | set(self.hundreds_direct)
                      | self.x10_words)


def _parse_words(tokens: List[str], lex: _Lex) -> Optional[int]:
    # digit-sequence reading ("eins vier" -> 14, "null sieben" -> "07"): all
    # tokens single digits -> concatenate, keeping leading zeros (mirrors the
    # CJK all-digit rule; returned as str, callers stringify anyway)
    toks = [t for t in tokens if t not in lex.joiners]
    if len(toks) > 1 and all(t in lex.ones and lex.ones[t] <= 9 for t in toks):
        return "".join(str(lex.ones[t]) for t in toks)
    total = 0
    current = 0
    any_number = False
    explicit_zero = False  # "không trăm hai mươi" = 020, not 100+20
    for tok in tokens:
        if tok in lex.joiners:
            continue
        if tok in lex.hundreds_direct:
            current += lex.hundreds_direct[tok]
        elif tok in lex.ones:
            current += lex.ones[tok]
            explicit_zero = explicit_zero or lex.ones[tok] == 0
        elif tok in lex.tens:
            current += lex.tens[tok]
        elif tok in lex.x10_words:
            current = (current if current or explicit_zero else 1) * 10
        elif tok in lex.hundred_words:
            current = (current if current or explicit_zero else 1) * 100
        elif tok in lex.scales:
            scale = lex.scales[tok]
            total += (current if current else 1) * scale
            current = 0
        else:
            return None
        any_number = True
    return total + current if any_number else None


def _word_itn(text: str, lex: _Lex, pre=None) -> str:
    raw_words = text.split()
    out: List[str] = []
    span: List[str] = []
    span_raw: List[str] = []

    def flush():
        if not span_raw:
            return
        val = _parse_words(span, lex)
        # a bare joiner span ("and") is not a number
        if val is not None and any(w not in lex.joiners for w in span):
            out.append(str(val))
        else:
            out.extend(span_raw)
        span.clear()
        span_raw.clear()

    for raw in raw_words:
        w = raw.lower().strip(",.!?;:")
        expanded = pre(w) if pre else None
        toks = expanded if expanded is not None else [w]
        if all(t in lex.vocab for t in toks):
            span.extend(toks)
            span_raw.append(raw)
        else:
            flush()
            out.append(raw)
    flush()
    return " ".join(out)


# --- German: compounds like "dreiundzwanzig", scales as separate words --------

_DE_ONES = {"null": 0, "ein": 1, "eins": 1, "eine": 1, "zwei": 2, "drei": 3,
            "vier": 4, "fünf": 5, "sechs": 6, "sieben": 7, "acht": 8,
            "neun": 9, "zehn": 10, "elf": 11, "zwölf": 12, "dreizehn": 13,
            "vierzehn": 14, "fünfzehn": 15, "sechzehn": 16, "siebzehn": 17,
            "achtzehn": 18, "neunzehn": 19}
_DE_TENS = {"zwanzig": 20, "dreißig": 30, "dreissig": 30, "vierzig": 40,
            "fünfzig": 50, "sechzig": 60, "siebzig": 70, "achtzig": 80,
            "neunzig": 90}
_DE_SCALES = {"tausend": 1000, "million": 10 ** 6, "millionen": 10 ** 6,
              "milliarde": 10 ** 9, "milliarden": 10 ** 9}
_DE_LEX = _Lex(_DE_ONES, _DE_TENS, ["hundert"], _DE_SCALES, joiners=["und"])


def _de_pre(word: str):
    """Split German compounds: dreiundzwanzig -> [drei, und, zwanzig];
    zweihundertfünf -> [zwei, hundert, fünf] (greedy longest-piece split)."""
    if word in _DE_LEX.vocab:
        return None
    pieces = []
    rest = word
    vocab = sorted(_DE_LEX.vocab, key=len, reverse=True)
    while rest:
        for v in vocab:
            if rest.startswith(v):
                pieces.append(v)
                rest = rest[len(v):]
                break
        else:
            return None
    return pieces if len(pieces) > 1 else None


def inverse_normalize_de(text: str) -> str:
    return _word_itn(text, _DE_LEX, pre=_de_pre)


# --- Spanish -------------------------------------------------------------------

_ES_ONES = {"cero": 0, "un": 1, "uno": 1, "una": 1, "dos": 2, "tres": 3,
            "cuatro": 4, "cinco": 5, "seis": 6, "siete": 7, "ocho": 8,
            "nueve": 9, "diez": 10, "once": 11, "doce": 12, "trece": 13,
            "catorce": 14, "quince": 15, "dieciséis": 16, "dieciseis": 16,
            "diecisiete": 17, "dieciocho": 18, "diecinueve": 19,
            "veintiuno": 21, "veintidós": 22, "veintidos": 22,
            "veintitrés": 23, "veintitres": 23, "veinticuatro": 24,
            "veinticinco": 25, "veintiséis": 26, "veintiseis": 26,
            "veintisiete": 27, "veintiocho": 28, "veintinueve": 29}
_ES_TENS = {"veinte": 20, "treinta": 30, "cuarenta": 40, "cincuenta": 50,
            "sesenta": 60, "setenta": 70, "ochenta": 80, "noventa": 90}
_ES_HUNDREDS = {"cien": 100, "ciento": 100, "doscientos": 200,
                "trescientos": 300, "cuatrocientos": 400, "quinientos": 500,
                "seiscientos": 600, "setecientos": 700, "ochocientos": 800,
                "novecientos": 900}
_ES_SCALES = {"mil": 1000, "millón": 10 ** 6, "millon": 10 ** 6,
              "millones": 10 ** 6}
_ES_LEX = _Lex(_ES_ONES, _ES_TENS, [], _ES_SCALES, joiners=["y"],
               hundreds_direct=_ES_HUNDREDS)


def inverse_normalize_es(text: str) -> str:
    return _word_itn(text, _ES_LEX)


# --- French (with quatre-vingt / soixante-dix handling) -------------------------

_FR_ONES = {"zéro": 0, "zero": 0, "un": 1, "une": 1, "deux": 2, "trois": 3,
            "quatre": 4, "cinq": 5, "six": 6, "sept": 7, "huit": 8, "neuf": 9,
            "dix": 10, "onze": 11, "douze": 12, "treize": 13, "quatorze": 14,
            "quinze": 15, "seize": 16}
_FR_TENS = {"vingt": 20, "trente": 30, "quarante": 40, "cinquante": 50,
            "soixante": 60}
_FR_SCALES = {"mille": 1000, "million": 10 ** 6, "millions": 10 ** 6,
              "milliard": 10 ** 9, "milliards": 10 ** 9}
_FR_LEX = _Lex(_FR_ONES, _FR_TENS, ["cent", "cents"], _FR_SCALES,
               joiners=["et"])


def _fr_pre(word: str):
    # hyphenated compounds: dix-sept, quatre-vingt(-dix), soixante-dix...
    if "-" in word:
        parts = word.split("-")
        if all(p in _FR_LEX.vocab or p in ("vingts",) for p in parts):
            out = []
            i = 0
            while i < len(parts):
                p = parts[i]
                if p == "quatre" and i + 1 < len(parts) and \
                        parts[i + 1] in ("vingt", "vingts"):
                    # quatre-vingt = 80 (as a tens value: inject 20*4 via ones)
                    out.append("__80__")
                    i += 2
                else:
                    out.append(p)
                    i += 1
            return out
    if word in ("dix-sept",):
        return ["dix", "sept"]
    return None


_FR_LEX.ones["__80__"] = 80
_FR_LEX.vocab.add("__80__")
# soixante-dix / quatre-vingt-dix decompose naturally: 60 + 10 (+ ones)


def inverse_normalize_fr(text: str) -> str:
    return _word_itn(text, _FR_LEX, pre=_fr_pre)


# --- Portuguese ------------------------------------------------------------------

_PT_ONES = {"zero": 0, "um": 1, "uma": 1, "dois": 2, "duas": 2, "três": 3,
            "tres": 3, "quatro": 4, "cinco": 5, "seis": 6, "sete": 7,
            "oito": 8, "nove": 9, "dez": 10, "onze": 11, "doze": 12,
            "treze": 13, "catorze": 14, "quatorze": 14, "quinze": 15,
            "dezesseis": 16, "dezessete": 17, "dezoito": 18, "dezenove": 19}
_PT_TENS = {"vinte": 20, "trinta": 30, "quarenta": 40, "cinquenta": 50,
            "sessenta": 60, "setenta": 70, "oitenta": 80, "noventa": 90}
_PT_HUNDREDS = {"cem": 100, "cento": 100, "duzentos": 200, "trezentos": 300,
                "quatrocentos": 400, "quinhentos": 500, "seiscentos": 600,
                "setecentos": 700, "oitocentos": 800, "novecentos": 900}
_PT_SCALES = {"mil": 1000, "milhão": 10 ** 6, "milhao": 10 ** 6,
              "milhões": 10 ** 6, "milhoes": 10 ** 6}
_PT_LEX = _Lex(_PT_ONES, _PT_TENS, [], _PT_SCALES, joiners=["e"],
               hundreds_direct=_PT_HUNDREDS)


def inverse_normalize_pt(text: str) -> str:
    return _word_itn(text, _PT_LEX)


# --- Russian (nominative + common inflections) ----------------------------------

_RU_ONES = {"ноль": 0, "нуль": 0, "один": 1, "одна": 1, "одно": 1, "два": 2,
            "две": 2, "три": 3, "четыре": 4, "пять": 5, "шесть": 6, "семь": 7,
            "восемь": 8, "девять": 9, "десять": 10, "одиннадцать": 11,
            "двенадцать": 12, "тринадцать": 13, "четырнадцать": 14,
            "пятнадцать": 15, "шестнадцать": 16, "семнадцать": 17,
            "восемнадцать": 18, "девятнадцать": 19}
_RU_TENS = {"двадцать": 20, "тридцать": 30, "сорок": 40, "пятьдесят": 50,
            "шестьдесят": 60, "семьдесят": 70, "восемьдесят": 80,
            "девяносто": 90}
_RU_HUNDREDS = {"сто": 100, "двести": 200, "триста": 300, "четыреста": 400,
                "пятьсот": 500, "шестьсот": 600, "семьсот": 700,
                "восемьсот": 800, "девятьсот": 900}
_RU_SCALES = {"тысяча": 1000, "тысячи": 1000, "тысяч": 1000,
              "миллион": 10 ** 6, "миллиона": 10 ** 6, "миллионов": 10 ** 6,
              "миллиард": 10 ** 9, "миллиарда": 10 ** 9, "миллиардов": 10 ** 9}
_RU_LEX = _Lex(_RU_ONES, _RU_TENS, [], _RU_SCALES,
               hundreds_direct=_RU_HUNDREDS)


def inverse_normalize_ru(text: str) -> str:
    return _word_itn(text, _RU_LEX)


# --- Indonesian ------------------------------------------------------------------

_ID_ONES = {"nol": 0, "satu": 1, "dua": 2, "tiga": 3, "empat": 4, "lima": 5,
            "enam": 6, "tujuh": 7, "delapan": 8, "sembilan": 9, "sepuluh": 10,
            "sebelas": 11}
_ID_TENS: Dict[str, int] = {}
_ID_SCALES = {"ribu": 1000, "seribu": 1000, "juta": 10 ** 6,
              "miliar": 10 ** 9}
_ID_LEX = _Lex(_ID_ONES, _ID_TENS, ["ratus", "seratus"], _ID_SCALES,
               x10_words=["puluh"])
# teens: "tiga belas" = 13 (additive ten, also spelled as one word below)
_ID_LEX.ones["belas"] = 10
_ID_LEX.vocab.add("belas")


def _id_pre(word: str):
    # tujuhbelas = tujuh + belas (10)
    if word.endswith("belas") and word[:-5] in _ID_ONES:
        return [word[:-5], "belas"]
    return None


def inverse_normalize_id(text: str) -> str:
    return _word_itn(text, _ID_LEX, pre=_id_pre)


# --- Vietnamese ------------------------------------------------------------------

_VI_ONES = {"không": 0, "một": 1, "mốt": 1, "hai": 2, "ba": 3, "bốn": 4,
            "tư": 4, "năm": 5, "lăm": 5, "sáu": 6, "bảy": 7, "tám": 8,
            "chín": 9, "mười": 10}
_VI_SCALES = {"nghìn": 1000, "ngàn": 1000, "triệu": 10 ** 6, "tỷ": 10 ** 9}
_VI_LEX = _Lex(_VI_ONES, {}, ["trăm"], _VI_SCALES, joiners=["lẻ", "linh"],
               x10_words=["mươi"])

_VI_YEAR_GUARD = "\x00năm\x00"


def inverse_normalize_vi(text: str) -> str:
    # "năm" is both 5 and the year marker: in "tháng <X> năm <number...>"
    # protect the marker so the cardinal pass doesn't fuse it into the year
    # (reference vi date tagger consumes the marker structurally)
    words = text.split()
    for j, w in enumerate(words):
        if w == "năm" and j + 1 < len(words):
            nxt = words[j + 1].lower().strip(",.!?;:")
            near_month = ("tháng" in words[max(0, j - 3): j])
            if near_month and (nxt in _VI_LEX.vocab or nxt.isdigit()):
                words[j] = _VI_YEAR_GUARD
    out = _word_itn(" ".join(words), _VI_LEX)
    return out.replace(_VI_YEAR_GUARD, "năm")


# --- Tagalog ---------------------------------------------------------------------

_TL_ONES = {"sero": 0, "isa": 1, "dalawa": 2, "tatlo": 3, "apat": 4,
            "lima": 5, "anim": 6, "pito": 7, "walo": 8, "siyam": 9,
            "sampu": 10, "labing-isa": 11, "labindalawa": 12}
_TL_TENS = {"dalawampu": 20, "tatlumpu": 30, "apatnapu": 40, "limampu": 50,
            "animnapu": 60, "pitumpu": 70, "walumpu": 80, "siyamnapu": 90}
_TL_SCALES = {"libo": 1000, "milyon": 10 ** 6}
_TL_LEX = _Lex(_TL_ONES, _TL_TENS, ["daan", "raan"], _TL_SCALES,
               joiners=["at", "na", "'t"])


def _tl_pre(word: str):
    """Tagalog teens: productive labing-/labin-/labim- prefix = 10 + base
    (reference tl/data/numbers/teen.tsv: labintatlo 13, labing-apat 14,
    labinlima 15...)."""
    if word in _TL_LEX.vocab:
        return None
    if word.endswith("'t") and word[:-2] in _TL_LEX.vocab:
        return [word[:-2], "'t"]  # dalawampu't lima = 20 and 5
    for pre in ("labing-", "labing", "labin", "labim"):
        if word.startswith(pre):
            base = word[len(pre):]
            if base in _TL_ONES:
                return ["sampu", base]
            # labimpito: the prefix nasalizes p<-b etc.; try common mutations
            for fix in ("p" + base[1:], "b" + base[1:]):
                if base and fix in _TL_ONES:
                    return ["sampu", fix]
    return None


def inverse_normalize_tl(text: str) -> str:
    return _word_itn(text, _TL_LEX, pre=_tl_pre)


def _with_classes(lang: str, cardinal_fn):
    """Chain the cardinal pass with the per-language class rules
    (decimals/money/times/ordinals/dates,
    funasr_tpu/text/multilingual_classes.py)."""
    def fn(text: str) -> str:
        from funasr_tpu_torch.text.multilingual_classes import apply_classes
        return apply_classes(lang, cardinal_fn(text))
    fn.__name__ = cardinal_fn.__name__
    return fn


ITN_FUNCS = {
    lang: _with_classes(lang, fn) for lang, fn in {
        "ja": inverse_normalize_ja,
        "ko": inverse_normalize_ko,
        "de": inverse_normalize_de,
        "es": inverse_normalize_es,
        "fr": inverse_normalize_fr,
        "pt": inverse_normalize_pt,
        "ru": inverse_normalize_ru,
        "id": inverse_normalize_id,
        "vi": inverse_normalize_vi,
        "tl": inverse_normalize_tl,
    }.items()
}


# ----------------------------------------------------------------------
# TN direction: number verbalizers (reference text_normalization langs de/es/ru)
# ----------------------------------------------------------------------

def _verbalize_de(n: int) -> str:
    if n == 0:
        return "null"
    inv_ones = {v: k for k, v in _DE_ONES.items() if k not in ("eins", "eine")}
    inv_tens = {v: k for k, v in _DE_TENS.items() if k != "dreissig"}
    out = ""
    if n >= 10 ** 6:
        m, n = divmod(n, 10 ** 6)
        out += (_verbalize_de(m) if m > 1 else "eine") + \
            (" millionen " if m > 1 else " million ")
    if n >= 1000:
        t, n = divmod(n, 1000)
        out += (_verbalize_de(t) if t > 1 else "ein") + "tausend"
    if n >= 100:
        h, n = divmod(n, 100)
        out += (inv_ones[h] if h > 1 else "ein") + "hundert"
    if n >= 20:
        t, o = divmod(n, 10)
        out += (inv_ones[o] + "und" if o else "") + inv_tens[t * 10]
    elif n > 0:
        out += "eins" if n == 1 and not out else inv_ones.get(n, "eins")
    return out.strip()


def _verbalize_es(n: int) -> str:
    if n == 0:
        return "cero"
    inv_ones = {v: k for k, v in _ES_ONES.items()
                if k not in ("un", "una", "dieciseis", "veintidos",
                             "veintitres", "veintiseis")}
    inv_tens = {v: k for k, v in _ES_TENS.items()}
    inv_hundreds = {v: k for k, v in _ES_HUNDREDS.items() if k != "cien"}
    parts = []
    if n >= 10 ** 6:
        m, n = divmod(n, 10 ** 6)
        parts.append(("un millón" if m == 1
                      else _verbalize_es(m) + " millones"))
    if n >= 1000:
        t, n = divmod(n, 1000)
        parts.append("mil" if t == 1 else _verbalize_es(t) + " mil")
    if n >= 100:
        h, n = divmod(n, 100)
        parts.append("cien" if h == 1 and n == 0
                     else ("ciento" if h == 1 else inv_hundreds[h * 100]))
    if n >= 30:
        t, o = divmod(n, 10)
        parts.append(inv_tens[t * 10] + (f" y {inv_ones[o]}" if o else ""))
    elif n > 0:
        parts.append(inv_ones[n])
    return " ".join(parts)


def _verbalize_ru(n: int) -> str:
    if n == 0:
        return "ноль"
    inv_ones = {v: k for k, v in _RU_ONES.items()
                if k not in ("нуль", "одна", "одно", "две")}
    inv_tens = {v: k for k, v in _RU_TENS.items()}
    inv_hundreds = {v: k for k, v in _RU_HUNDREDS.items()}
    parts = []
    if n >= 10 ** 6:
        m, n = divmod(n, 10 ** 6)
        word = "миллион" if m % 10 == 1 and m % 100 != 11 else \
            "миллиона" if 2 <= m % 10 <= 4 and not 12 <= m % 100 <= 14 else \
            "миллионов"
        parts.append(_verbalize_ru(m) + " " + word)
    if n >= 1000:
        t, n = divmod(n, 1000)
        word = "тысяча" if t % 10 == 1 and t % 100 != 11 else \
            "тысячи" if 2 <= t % 10 <= 4 and not 12 <= t % 100 <= 14 else \
            "тысяч"
        head = "одна" if t == 1 else ("две" if t == 2 else _verbalize_ru(t))
        parts.append(head + " " + word)
    if n >= 100:
        h, n = divmod(n, 100)
        parts.append(inv_hundreds[h * 100])
    if n >= 20:
        t, o = divmod(n, 10)
        parts.append(inv_tens[t * 10])
        n = o
    if 0 < n < 20:
        parts.append(inv_ones[n])
    return " ".join(parts)


TN_FUNCS = {"de": _verbalize_de, "es": _verbalize_es, "ru": _verbalize_ru}
