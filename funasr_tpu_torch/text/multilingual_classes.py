"""Per-language ITN class rules beyond cardinals: decimals, percents, money,
times, ordinals, dates.

Counterpart of the non-cardinal taggers in FunASR
``fun_text_processing/inverse_text_normalization/{de,es,fr,pt,ru,id,vi,ja,ko}/
taggers/{decimal,money,time,ordinal,date}.py`` (pynini WFSTs), rebuilt as
deterministic regex passes that run AFTER the cardinal pass of
:mod:`funasr_tpu_torch.text.multilingual` (so number words are already digits).

Output formats follow the reference verbalizers where documented:
- money: currency-symbol prefix ("€12,05" — de money verbalizer docstring);
- time: "HH:MM" with language clock word kept for German ("13:10 Uhr" — de
  time verbalizer docstring);
- dates: "24. Jul. 2013" for German (de date tagger docstring); ja/ko keep
  their native 年月日 / 년월일 markers with digits.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional

# ---------------------------------------------------------------------------
# ordinal word -> cardinal value (irregulars + suffix stripping per language)
# ---------------------------------------------------------------------------

_DE_ORD_IRREGULAR = {"erste": 1, "erster": 1, "ersten": 1, "erstes": 1,
                     "dritte": 3, "dritter": 3, "dritten": 3, "drittes": 3,
                     "siebte": 7, "siebter": 7, "siebten": 7,
                     "achte": 8, "achter": 8, "achten": 8}
_ES_ORDINALS = {"primero": 1, "primer": 1, "primera": 1, "segundo": 2,
                "segunda": 2, "tercero": 3, "tercer": 3, "tercera": 3,
                "cuarto": 4, "cuarta": 4, "quinto": 5, "quinta": 5,
                "sexto": 6, "sexta": 6, "séptimo": 7, "septimo": 7,
                "octavo": 8, "noveno": 9, "décimo": 10, "decimo": 10,
                "vigésimo": 20, "vigesimo": 20}
_FR_ORD_IRREGULAR = {"premier": 1, "première": 1, "premiere": 1, "second": 2,
                     "seconde": 2}
_PT_ORDINALS = {"primeiro": 1, "primeira": 1, "segundo": 2, "segunda": 2,
                "terceiro": 3, "terceira": 3, "quarto": 4, "quarta": 4,
                "quinto": 5, "quinta": 5, "sexto": 6, "sexta": 6,
                "sétimo": 7, "setimo": 7, "oitavo": 8, "nono": 9,
                "décimo": 10, "decimo": 10}
_RU_ORDINALS = {"первый": 1, "первая": 1, "первое": 1, "второй": 2,
                "вторая": 2, "третий": 3, "третья": 3, "четвёртый": 4,
                "четвертый": 4, "пятый": 5, "шестой": 6, "седьмой": 7,
                "восьмой": 8, "девятый": 9, "десятый": 10,
                "двадцатый": 20, "тридцатый": 30, "сотый": 100}


def _de_ordinal_value(word: str) -> Optional[int]:
    from funasr_tpu_torch.text.multilingual import _DE_LEX, _de_pre, _parse_words
    w = word.lower()
    if w in _DE_ORD_IRREGULAR:
        return _DE_ORD_IRREGULAR[w]
    for suf in ("sten", "ster", "stes", "ste", "ten", "ter", "tes", "te"):
        if w.endswith(suf):
            base = w[: -len(suf)]
            # "dreißigste" strips to "dreißig"; "vierte" strips to "vier"
            if base in _DE_LEX.vocab:
                return _parse_words([base], _DE_LEX)
            toks = _de_pre(base)
            if toks:
                return _parse_words(toks, _DE_LEX)
    return None


def _fr_ordinal_value(word: str) -> Optional[int]:
    from funasr_tpu_torch.text.multilingual import _FR_LEX, _fr_pre, _parse_words
    w = word.lower()
    if w in _FR_ORD_IRREGULAR:
        return _FR_ORD_IRREGULAR[w]
    for suf in ("ièmes", "ième", "iemes", "ieme"):
        if w.endswith(suf):
            base = w[: -len(suf)]
            # quatrième->quatr(+e), cinquième->cinqu(-u), neuvième->neuf
            for cand in (base, base + "e", base.rstrip("u"),
                         {"neuv": "neuf"}.get(base, base)):
                if cand in _FR_LEX.vocab:
                    return _parse_words([cand], _FR_LEX)
            toks = _fr_pre(base)
            if toks:
                return _parse_words(toks, _FR_LEX)
    return None


def _lookup_ordinal(table: Dict[str, int]) -> Callable[[str], Optional[int]]:
    return lambda w: table.get(w.lower())


_TL_ORD_IRREGULAR = {"una": 1, "unang": 1, "pangalawa": 2, "pangalawang": 2,
                     "ikalawa": 2, "ikalawang": 2, "pangatlo": 3,
                     "pangatlong": 3, "ikatlo": 3, "ikatlong": 3}


def _tl_ordinal_value(word: str) -> Optional[int]:
    """Tagalog ordinals: irregular una/pangalawa/pangatlo plus the productive
    ``ika-`` prefix (reference tl/taggers/ordinal.py + data/ordinals/*.tsv:
    ikaapat -> apat, ikalimang -> lima)."""
    from funasr_tpu_torch.text.multilingual import _TL_LEX, _parse_words, _tl_pre
    w = word.lower()
    if w in _TL_ORD_IRREGULAR:
        return _TL_ORD_IRREGULAR[w]
    for pre in ("ika-", "ika"):
        if w.startswith(pre):
            base = w[len(pre):]
            if base.endswith("ng"):
                base = base[:-2]
            for cand in (base, base + "a", base + "o"):
                if cand in _TL_LEX.vocab:
                    v = _parse_words([cand], _TL_LEX)
                    if v is not None:
                        return int(v)
                toks = _tl_pre(cand)
                if toks:
                    v = _parse_words(toks, _TL_LEX)
                    if v is not None:
                        return int(v)
    return None


def _id_ordinal_value(word: str) -> Optional[int]:
    """Indonesian ordinals: "pertama" = 1, productive ``ke-`` prefix
    (reference id/taggers/ordinal.py: kedua -> dua, kelima -> lima)."""
    from funasr_tpu_torch.text.multilingual import _ID_LEX, _parse_words
    w = word.lower()
    if w in ("pertama", "kesatu"):
        return 1
    for pre in ("ke-", "ke"):
        if w.startswith(pre):
            base = w[len(pre):]
            if base in _ID_LEX.vocab and base not in ("", "ribu", "juta"):
                v = _parse_words([base], _ID_LEX)
                if v is not None:
                    return int(v)
    return None


# ---------------------------------------------------------------------------
# per-language class config
# ---------------------------------------------------------------------------

class LangClasses:
    """decimal_words: spoken decimal separators; decimal_mark: output char.
    currencies: spoken unit -> symbol; minor_per_major=100 assumed.
    ordinal_value: word -> int (None = not an ordinal); ordinal_fmt: int->str.
    extra passes run last (times, dates, percents)."""

    def __init__(self, decimal_words: List[str] = (), decimal_mark: str = ",",
                 currencies: Dict[str, str] = None,
                 minor_units: List[str] = (),
                 ordinal_value: Callable[[str], Optional[int]] = None,
                 ordinal_fmt: Callable[[int], str] = None,
                 extra: List = ()):
        self.decimal_words = list(decimal_words)
        self.decimal_mark = decimal_mark
        self.currencies = currencies or {}
        self.minor_units = list(minor_units)
        self.ordinal_value = ordinal_value
        self.ordinal_fmt = ordinal_fmt or (lambda n: f"{n}.")
        self.extra = list(extra)

    # -- passes ------------------------------------------------------------

    def _decimals(self, text: str) -> str:
        if not self.decimal_words:
            return text
        sep = "|".join(map(re.escape, self.decimal_words))
        # "3 komma 14" / "3 komma 1 4" -> 3,14
        pat = re.compile(rf"\b(\d+) (?:{sep}) (\d+(?: \d+)*)\b")
        return pat.sub(
            lambda m: m.group(1) + self.decimal_mark + m.group(2).replace(" ", ""),
            text)

    def _money(self, text: str) -> str:
        if not self.currencies:
            return text
        cur = "|".join(map(re.escape, sorted(self.currencies, key=len,
                                             reverse=True)))
        minor = "|".join(map(re.escape, self.minor_units))
        mark = re.escape(self.decimal_mark)

        # "5 euro 20 (cent)" -> €5,20 ; "5 euro" -> €5 ; "5,20 euro" -> €5,20
        def repl(m):
            sym = self.currencies[m.group("cur").lower()]
            amount = m.group("int")
            if m.group("minor"):
                amount += self.decimal_mark + f"{int(m.group('minor')):02d}"
            return sym + amount + (m.group("tail") or "")

        pat = re.compile(
            rf"\b(?P<int>\d+(?:{mark}\d+)?) (?P<cur>{cur})"
            rf"(?: (?:con |com )?(?P<minor>\d{{1,2}})(?: (?:{minor}))?)?"
            rf"(?P<tail>)\b"
            if minor else
            rf"\b(?P<int>\d+(?:{mark}\d+)?) (?P<cur>{cur})(?P<minor>)(?P<tail>)\b",
            re.IGNORECASE)
        return pat.sub(repl, text)

    def _ordinals(self, text: str) -> str:
        if self.ordinal_value is None:
            return text
        out = []
        for raw in text.split(" "):
            core = raw.strip(",.!?;:")
            val = self.ordinal_value(core) if core else None
            if val is not None:
                out.append(raw.replace(core, self.ordinal_fmt(val)))
            else:
                out.append(raw)
        return " ".join(out)

    def apply(self, text: str) -> str:
        text = self._ordinals(text)
        text = self._decimals(text)
        text = self._money(text)
        for pat, repl in self.extra:
            text = pat.sub(repl, text)
        return text


def _hhmm(h: str, m: Optional[str], suffix: str = "") -> str:
    if m is None:
        return f"{h}{suffix}"
    return f"{int(h)}:{int(m):02d}{suffix}"


_DE_MONTHS = {"januar": "Jan.", "februar": "Feb.", "märz": "März",
              "april": "Apr.", "mai": "Mai", "juni": "Juni", "juli": "Juli",
              "august": "Aug.", "september": "Sep.", "oktober": "Okt.",
              "november": "Nov.", "dezember": "Dez."}

# ---------------------------------------------------------------------------
# declarative time/date rules — the single source of truth shared with the
# C++ grammar-archive interpreter (itn-grammar.cc applies the SAME rules via
# std::regex, so patterns must stay in the Python-re ∩ ECMAScript dialect:
# \b, \d, (?:...), {m,n}, alternation; byte-exact multibyte literals).
#
# Template language (render_template / C++ RenderTdTemplate):
#   {N}          raw group text ("" if unmatched)
#   {N:i}        int-parse (strips leading zeros)
#   {N:02}       int-parse, zero-pad to 2
#   {N:m1mod24}  (int-1) mod 24  ("halb zwölf" -> 11:30 style)
#   {N:map:NAME} lookup in _TD_MAPS[NAME] (key lowercased)
#   [ ... ]      segment emitted only if every group inside matched non-empty
# ---------------------------------------------------------------------------

_DE_UNITS = {"kilometern": "km", "kilometer": "km", "zentimetern": "cm",
             "zentimeter": "cm", "millimetern": "mm", "millimeter": "mm",
             "metern": "m", "meter": "m", "kilogramm": "kg", "gramm": "g",
             "tonnen": "t", "tonne": "t", "litern": "l", "liter": "l"}
_ES_UNITS = {"kilómetros": "km", "kilómetro": "km", "centímetros": "cm",
             "centímetro": "cm", "metros": "m", "metro": "m",
             "kilogramos": "kg", "kilogramo": "kg", "gramos": "g",
             "gramo": "g", "litros": "l", "litro": "l"}
_FR_UNITS = {"kilomètres": "km", "kilomètre": "km", "centimètres": "cm",
             "centimètre": "cm", "mètres": "m", "mètre": "m",
             "kilogrammes": "kg", "kilogramme": "kg", "grammes": "g",
             "gramme": "g", "litres": "l", "litre": "l"}
_PT_UNITS = {"quilômetros": "km", "quilômetro": "km", "quilómetros": "km",
             "quilómetro": "km", "centímetros": "cm", "centímetro": "cm",
             "metros": "m", "metro": "m", "quilogramas": "kg",
             "quilograma": "kg", "gramas": "g", "grama": "g",
             "litros": "l", "litro": "l"}
_RU_UNITS = {"километров": "км", "километра": "км", "километр": "км",
             "сантиметров": "см", "сантиметра": "см", "сантиметр": "см",
             "метров": "м", "метра": "м", "метр": "м",
             "килограммов": "кг", "килограмма": "кг", "килограмм": "кг",
             "граммов": "г", "грамма": "г", "грамм": "г",
             "литров": "л", "литра": "л", "литр": "л"}
_ID_UNITS = {"kilometer": "km", "sentimeter": "cm", "meter": "m",
             "kilogram": "kg", "gram": "g", "liter": "l"}
_TL_UNITS = {"kilometro": "km", "sentimetro": "cm", "metro": "m",
             "kilo": "kg", "kilogramo": "kg", "gramo": "g", "litro": "l"}
_ID_MONTHS = {"januari": "Januari", "februari": "Februari", "maret": "Maret",
              "april": "April", "mei": "Mei", "juni": "Juni", "juli": "Juli",
              "agustus": "Agustus", "september": "September",
              "oktober": "Oktober", "november": "November",
              "desember": "Desember"}
_VI_UNITS = {"ki-lô-mét": "km", "kilômét": "km", "xăng-ti-mét": "cm",
             "xentimét": "cm", "mét": "m", "ki-lô-gam": "kg",
             "kilôgam": "kg", "gam": "g", "lít": "l"}
_JA_UNITS = {"キロメートル": "km", "センチメートル": "cm", "ミリメートル": "mm",
             "メートル": "m", "キログラム": "kg", "ミリグラム": "mg",
             "グラム": "g", "ミリリットル": "ml", "リットル": "l",
             "センチ": "cm"}
_KO_UNITS = {"킬로미터": "km", "센티미터": "cm", "밀리미터": "mm",
             "미터": "m", "킬로그램": "kg", "밀리그램": "mg", "그램": "g",
             "밀리리터": "ml", "리터": "l"}

# fraction denominator words -> denominator digits (reference fraction
# taggers, e.g. ja/taggers/fraction.py "X分のY" -> numerator Y / denominator X)
_DE_FRACS = {"halbe": "2", "halbes": "2", "drittel": "3", "viertel": "4",
             "fünftel": "5", "sechstel": "6", "siebtel": "7", "achtel": "8",
             "neuntel": "9", "zehntel": "10", "zwanzigstel": "20",
             "hundertstel": "100"}
_ES_FRACS = {"medios": "2", "medio": "2", "tercios": "3", "tercio": "3",
             "cuartos": "4", "quintos": "5", "sextos": "6", "octavos": "8",
             "décimos": "10"}
_FR_FRACS = {"demis": "2", "demi": "2", "tiers": "3", "quarts": "4",
             "quart": "4"}
_PT_FRACS = {"meios": "2", "meio": "2", "terços": "3", "quartos": "4",
             "quintos": "5", "oitavos": "8", "décimos": "10"}

_TD_MAPS: Dict[str, Dict[str, str]] = {
    "de_months": _DE_MONTHS, "id_months": _ID_MONTHS,
    "de_units": _DE_UNITS, "es_units": _ES_UNITS, "fr_units": _FR_UNITS,
    "pt_units": _PT_UNITS, "ru_units": _RU_UNITS, "id_units": _ID_UNITS,
    "vi_units": _VI_UNITS, "ja_units": _JA_UNITS, "ko_units": _KO_UNITS,
    "tl_units": _TL_UNITS,
    "de_fracs": _DE_FRACS, "es_fracs": _ES_FRACS, "fr_fracs": _FR_FRACS,
    "pt_fracs": _PT_FRACS,
    "ja_cur": {"円": "¥", "ドル": "$", "米ドル": "$", "ユーロ": "€",
               "英国ポンド": "£"},
    "ko_cur": {"원": "₩", "달러": "$", "미국 달러": "$", "유로": "€",
               "영국 파운드": "£"},
    "ko_hours": {"한": "1", "두": "2", "세": "3", "네": "4", "다섯": "5",
                 "여섯": "6", "일곱": "7", "여덟": "8", "아홉": "9",
                 "열": "10", "열한": "11", "열두": "12"},
    "ru_months": {"января": "января", "февраля": "февраля",
                  "марта": "марта", "апреля": "апреля", "мая": "мая",
                  "июня": "июня", "июля": "июля", "августа": "августа",
                  "сентября": "сентября", "октября": "октября",
                  "ноября": "ноября", "декабря": "декабря"},
}

_ID_MONTH_ALT = "|".join(_ID_MONTHS)
_ES_MONTH_ALT = ("enero|febrero|marzo|abril|mayo|junio|julio|agosto|"
                 "septiembre|octubre|noviembre|diciembre")
_FR_MONTH_ALT = ("janvier|février|mars|avril|mai|juin|juillet|août|"
                 "septembre|octobre|novembre|décembre")
_PT_MONTH_ALT = ("janeiro|fevereiro|março|abril|maio|junho|julho|agosto|"
                 "setembro|outubro|novembro|dezembro")
_RU_MONTH_ALT = "|".join(_TD_MAPS["ru_months"])

def _alt(words) -> str:
    """Ordered alternation, longest first (both regex dialects try
    alternatives left to right, so prefixes must come after supersets)."""
    return "|".join(re.escape(w)
                    for w in sorted(words, key=lambda w: (-len(w), w)))


_END = r"(?=\s|$|[,.!?;:])"  # byte-safe word end (no \b after non-ASCII)

# lang -> [(pattern, icase, template), ...]; applied in order after the
# ordinal/decimal/money passes. Despite the name (archive key compat) this
# carries every declarative class: time, date, percent, fraction, measure,
# telephone (reference taggers fraction.py/measure.py/telephone.py per lang).
TIMEDATE_RULES: Dict[str, list] = {
    "de": [
        # dreizehn uhr zehn -> 13:10 Uhr (de time verbalizer docstring)
        (r"\b(\d{1,2}) uhr (\d{1,2})\b", True, "{1:i}:{2:02} Uhr"),
        (r"\b(\d{1,2}) uhr\b", True, "{1} Uhr"),
        (r"\bhalb (\d{1,2})\b", True, "{1:m1mod24}:30"),
        # 24. juli 2013 -> 24. Juli 2013 (de date tagger: month abbreviated)
        (r"\b(\d{1,2}\.) (" + "|".join(_DE_MONTHS) +
         r")( \d{3,4})?(?=\s|$|[,.!?;:])", True, "{1} {2:map:de_months}{3}"),
        (r"\b(\d+) prozent\b", True, "{1} %"),
        # fractions: "3 fünftel" -> 3/5 (de fraction tagger role)
        (r"\b(\d+) (" + _alt(_DE_FRACS) + r")" + _END, True,
         "{1}/{2:map:de_fracs}"),
        # measures: "5 kilometer" -> 5 km (de measure tagger role)
        (r"\b(\d+(?:,\d+)?) (" + _alt(_DE_UNITS) + r")" + _END, True,
         "{1} {2:map:de_units}"),
    ],
    "es": [
        (r"\b(\d{1,2}) y media\b", False, "{1:i}:30"),
        (r"\b(\d{1,2}) y cuarto\b", False, "{1:i}:15"),
        (r"\b(\d{1,2}) menos cuarto\b", False, "{1:m1mod24}:45"),
        # las 3 40 -> las 3:40 (es time tagger "las tres cuarenta"; the
        # article is re-emitted, "la una cuarenta" keeps its singular "la")
        (r"\b(las|la) (\d{1,2}) (\d{2})\b", False, "{1} {2:i}:{3:02}"),
        # "ciento" is a number word; cardinal pass may pre-digitize it
        (r"\b(\d+) por (?:ciento|100)\b", False, "{1} %"),
        # 24 de julio de(l) 2013 stays words+digits (es date verbalizer);
        # normalize "primero de julio" handled by the ordinal pass
        (r"\b(\d+) (" + _alt(_ES_FRACS) + r")" + _END, False,
         "{1}/{2:map:es_fracs}"),
        (r"\b(\d+(?:,\d+)?) (" + _alt(_ES_UNITS) + r")" + _END, False,
         "{1} {2:map:es_units}"),
    ],
    "fr": [
        (r"\b(\d{1,2}) heures? (\d{1,2})\b", True, "{1:i}h{2:02}"),
        (r"\b(\d{1,2}) heures?\b", True, "{1}h"),
        (r"\b(\d{1,2})h et quart\b", True, "{1}h15"),
        (r"\b(\d{1,2})h et demie?\b", True, "{1}h30"),
        (r"\b(\d+) pour (?:cent|100)\b", True, "{1} %"),
        (r"\b(\d+) (" + _alt(_FR_FRACS) + r")" + _END, True,
         "{1}/{2:map:fr_fracs}"),
        (r"\b(\d+(?:,\d+)?) (" + _alt(_FR_UNITS) + r")" + _END, True,
         "{1} {2:map:fr_units}"),
    ],
    "pt": [
        (r"\b(\d{1,2}) horas? e (\d{1,2})\b", True, "{1:i}:{2:02}"),
        # "5 e meia" is half past five — run before the "N meios" fraction
        (r"\b(\d{1,2}) e meia\b", True, "{1:i}:30"),
        (r"\b(\d+) por (?:cento|100)\b", True, "{1} %"),
        (r"\b(\d+) (" + _alt(_PT_FRACS) + r")" + _END, True,
         "{1}/{2:map:pt_fracs}"),
        (r"\b(\d+(?:,\d+)?) (" + _alt(_PT_UNITS) + r")" + _END, True,
         "{1} {2:map:pt_units}"),
    ],
    # NOTE: patterns are shared with the C++ std::regex interpreter, which
    # matches bytes — so no `?` on a multibyte char (spell the alternation
    # out) and no trailing \b after non-ASCII (use an explicit lookahead).
    "ru": [
        (r"\b(\d{1,2}) (?:часов|часа|час) (\d{1,2}) "
         r"(?:минуты|минуту|минут)(?=\s|$|[,.!?;:])", False, "{1:i}:{2:02}"),
        (r"\b(\d+) (?:процентов|процента|процент)(?=\s|$|[,.!?;:])", False,
         "{1} %"),
        # 24 июля 2013 года — day/year already digits from the cardinal pass;
        # the date rule pins the genitive month form (ru date tagger)
        (r"\b(\d{1,2}) (" + _RU_MONTH_ALT + r") (\d{4}) года(?=\s|$|[,.!?;:])",
         False, "{1} {2} {3} года"),
        (r"\b(\d+(?:,\d+)?) (" + _alt(_RU_UNITS) + r")" + _END, False,
         "{1} {2:map:ru_units}"),
    ],
    "id": [
        (r"\bjam (\d{1,2}) lewat (\d{1,2})\b", True, "{1:i}:{2:02}"),
        # "jam setengah lima" = half to five -> 4:30 (id time tagger)
        (r"\bjam setengah (\d{1,2})\b", True, "{1:m1mod24}:30"),
        (r"\bjam (\d{1,2})\b", True, "{1:i}:00"),
        (r"\b(\d+) persen\b", True, "{1} %"),
        # "3 per 4" -> 3/4 (id fraction tagger role)
        (r"\b(\d+) per (\d+)\b", True, "{1}/{2}"),
        # 24 januari 2013 -> 24 Januari 2013 (id months.tsv is capitalized)
        (r"\b(\d{1,2}) (" + _ID_MONTH_ALT + r")( \d{4})?(?=\s|$|[,.!?;:])",
         True, "{1} {2:map:id_months}{3}"),
        # digit-by-digit phone strings starting 0 regroup 0xxx-xxx(x)-xxxx
        # (id telephone tagger emits dash-grouped numbers)
        (r"\b(0\d{2,3})(\d{3,4})(\d{4})\b", True, "{1}-{2}-{3}"),
        (r"\b(\d+(?:,\d+)?) (" + _alt(_ID_UNITS) + r")" + _END, True,
         "{1} {2:map:id_units}"),
    ],
    "vi": [
        # 10 giờ 9 phút 45 giây -> 10:09:45 (vi time tagger hms form)
        (r"\b(\d{1,2}) giờ (\d{1,2}) phút (\d{1,2}) giây(?=\s|$|[,.!?;:])",
         True, "{1:i}:{2:02}:{3:02}"),
        (r"\b(\d{1,2}) giờ (\d{1,2}) phút(?=\s|$|[,.!?;:])", True,
         "{1:i}:{2:02}"),
        # chín giờ kém hai mươi -> 8:40 (vi time tagger "hours_to" form)
        (r"\b(\d{1,2}) giờ kém (\d{1,2})(?=\s|$|[,.!?;:])", True,
         "{1:m1mod24}:{2:sub60}"),
        # hai (giờ) rưỡi -> 2:30 (vi time tagger graph_half)
        (r"\b(\d{1,2}) giờ rưỡi(?=\s|$|[,.!?;:])", True, "{1:i}:30"),
        (r"\b(\d{1,2}) rưỡi(?=\s|$|[,.!?;:])", True, "{1:i}:30"),
        (r"\b(\d{1,2}) giờ (\d{1,2})(?=\s|$|[,.!?;:])", True, "{1:i}:{2:02}"),
        (r"\bngày (\d{1,2}) tháng (\d{1,2}) năm (\d{4})\b", True,
         "ngày {1} tháng {2} năm {3}"),
        (r"\b(\d+) phần (?:trăm|100)\b", True, "{1} %"),
        # percent already consumed "phần trăm"; the rest are fractions
        # ("3 phần 4" -> 3/4, vi fraction tagger role)
        (r"\b(\d+) phần (\d+)\b", True, "{1}/{2}"),
        (r"\b(\d+(?:,\d+)?) (" + _alt(_VI_UNITS) + r")" + _END, True,
         "{1} {2:map:vi_units}"),
    ],
    "tl": [
        # two o'clock forms ride the digit-sequence cardinal pass; am/pm
        # suffixes normalize per the tl time_suffix.tsv data
        (r"\b(\d{1,2}) (\d{2}) ?(?:ng umaga|a ?m)(?=\s|$|[,.!?;:])", True,
         "{1:i}:{2} a.m."),
        (r"\b(\d{1,2}) (\d{2}) ?(?:ng hapon|ng gabi|p ?m)(?=\s|$|[,.!?;:])",
         True, "{1:i}:{2} p.m."),
        (r"\b(\d{1,2}) ?(?:ng umaga|a ?m)(?=\s|$|[,.!?;:])", True,
         "{1:i} a.m."),
        (r"\b(\d{1,2}) ?(?:ng hapon|ng gabi|p ?m)(?=\s|$|[,.!?;:])", True,
         "{1:i} p.m."),
        (r"\b(\d+) (?:porsyento|porsiyento|bahagdan)(?=\s|$|[,.!?;:])", True,
         "{1} %"),
        (r"\b(\d+(?:\.\d+)?) (" + _alt(_TL_UNITS) + r")" + _END, True,
         "{1} {2:map:tl_units}"),
    ],
    "ja": [
        (r"(\d+)点(\d+)", False, "{1}.{2}"),
        # money: unspaced "<amount><currency word>" -> symbol prefix
        # (ja data/currency.tsv: 円 -> ¥, ドル/米ドル -> $, ユーロ -> €)
        (r"(\d+(?:\.\d+)?)(米ドル|英国ポンド|ドル|ユーロ|円)", False,
         "{2:map:ja_cur}{1}"),
        # 3時15分(20秒) -> 3:15(:20)
        (r"(\d{1,2})時(\d{1,2})分(?:(\d{1,2})秒)?", False,
         "{1:i}:{2:02}[:{3:02}]"),
        # 2013年7月24日 -> digits flow from the cardinal pass; keep markers
        (r"(\d+)パーセント", False, "{1}%"),
        # fractions: "3分の1" -> 1/3 — denominator spoken first
        # (ja fraction tagger: denominator + 分の + numerator)
        (r"(\d+)分の(\d+)", False, "{2}/{1}"),
        # measures: "5キロメートル" -> 5km (ja measure tagger role)
        (r"(\d+(?:\.\d+)?)(" + _alt(_JA_UNITS) + r")", False,
         "{1}{2:map:ja_units}"),
        # telephone: spoken ゼロ stays a word through the cardinal pass
        (r"ゼロ(\d)", False, "0{1}"),
        # "03の1234の5678" -> 03-1234-5678 (ja telephone tagger grouping)
        (r"(\d+)の(\d+)の(\d+)", False, "{1}-{2}-{3}"),
    ],
    "ko": [
        (r"(\d+)점(\d+)", False, "{1}.{2}"),
        # money (ko data/currency.tsv: 원 -> ₩, 달러 -> $, 유로 -> €)
        (r"(\d+(?:\.\d+)?) ?(미국 달러|영국 파운드|달러|유로|원)"
         r"(?=\s|$|[,.!?;:])", False, "{2:map:ko_cur}{1}"),
        # native-Korean hour words (한/두/세시...), minutes sino-Korean
        (r"(한|두|세|네|다섯|여섯|일곱|여덟|아홉|열한|열두|열)시", False,
         "{1:map:ko_hours}시"),
        (r"(\d{1,2})시 ?(\d{1,2})분", False, "{1:i}:{2:02}"),
        (r"(\d+)퍼센트", False, "{1}%"),
        # fractions: "3분의 1" -> 1/3 (ko fraction tagger: denom 분의 numer)
        (r"(\d+)분의 ?(\d+)", False, "{2}/{1}"),
        # measures: "5 미터"/"5미터" -> 5m (ko measure tagger role)
        (r"(\d+(?:\.\d+)?) ?(" + _alt(_KO_UNITS) + r")", False,
         "{1}{2:map:ko_units}"),
    ],
}


def render_template(template: str, groups, maps: Dict[str, Dict[str, str]]
                    ) -> str:
    """Expand a time/date rule template against match groups (see the grammar
    above; mirrored by itn-grammar.cc RenderTdTemplate)."""
    out = []
    i = 0
    while i < len(template):
        c = template[i]
        if c == "[":
            end = template.index("]", i)
            seg = template[i + 1: end]
            refs = re.findall(r"\{(\d+)", seg)
            if all(groups[int(r) - 1] for r in refs):
                out.append(render_template(seg, groups, maps))
            i = end + 1
        elif c == "{":
            end = template.index("}", i)
            spec = template[i + 1: end]
            parts = spec.split(":")
            g = groups[int(parts[0]) - 1] or ""
            if len(parts) == 1:
                out.append(g)
            elif parts[1] == "i":
                out.append(str(int(g)) if g else "")
            elif parts[1] == "02":
                out.append(f"{int(g):02d}" if g else "")
            elif parts[1] == "m1mod24":
                out.append(str((int(g) - 1) % 24) if g else "")
            elif parts[1] == "sub60":
                # minutes-to form ("kém hai mươi" = 20 to): 60 - m, pad 2
                out.append(f"{60 - int(g):02d}" if g else "")
            elif parts[1] == "map":
                out.append(maps[parts[2]].get(g.lower(), g))
            else:
                out.append(g)
            i = end + 1
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _td_extras(lang: str) -> list:
    """Compile the declarative rules into (compiled_pattern, repl) passes."""
    rules = []
    for pattern, icase, template in TIMEDATE_RULES.get(lang, []):
        pat = re.compile(pattern, re.IGNORECASE if icase else 0)
        rules.append((pat, (lambda t: lambda m: render_template(
            t, m.groups(), _TD_MAPS))(template)))
    return rules

_CLASSES: Dict[str, LangClasses] = {
    "de": LangClasses(
        decimal_words=["komma"], decimal_mark=",",
        currencies={"euro": "€", "euros": "€", "dollar": "$", "dollars": "$",
                    "pfund": "£"},
        minor_units=["cent", "cents"],
        ordinal_value=_de_ordinal_value,
        extra=_td_extras("de")),
    "es": LangClasses(
        decimal_words=["coma"], decimal_mark=",",
        currencies={"euro": "€", "euros": "€", "dólar": "$", "dólares": "$",
                    "dolar": "$", "dolares": "$", "peso": "$", "pesos": "$"},
        minor_units=["céntimos", "centimos", "centavos"],
        ordinal_value=_lookup_ordinal(_ES_ORDINALS),
        ordinal_fmt=lambda n: f"{n}º",
        extra=_td_extras("es")),
    "fr": LangClasses(
        decimal_words=["virgule"], decimal_mark=",",
        currencies={"euro": "€", "euros": "€", "dollar": "$", "dollars": "$",
                    "livre": "£", "livres": "£"},
        minor_units=["centimes", "centime"],
        ordinal_value=_fr_ordinal_value,
        ordinal_fmt=lambda n: "1er" if n == 1 else f"{n}e",
        extra=_td_extras("fr")),
    "pt": LangClasses(
        decimal_words=["vírgula", "virgula"], decimal_mark=",",
        currencies={"real": "R$", "reais": "R$", "euro": "€", "euros": "€",
                    "dólar": "$", "dólares": "$", "dolar": "$",
                    "dolares": "$"},
        minor_units=["centavos", "centavo"],
        ordinal_value=_lookup_ordinal(_PT_ORDINALS),
        ordinal_fmt=lambda n: f"{n}º",
        extra=_td_extras("pt")),
    "ru": LangClasses(
        decimal_words=["запятая", "целых", "целая"], decimal_mark=",",
        currencies={"рубль": "₽", "рубля": "₽", "рублей": "₽",
                    "доллар": "$", "доллара": "$", "долларов": "$",
                    "евро": "€"},
        minor_units=["копеек", "копейки", "копейка"],
        ordinal_value=_lookup_ordinal(_RU_ORDINALS),
        ordinal_fmt=lambda n: f"{n}-й",
        extra=_td_extras("ru")),
    "id": LangClasses(
        decimal_words=["koma"], decimal_mark=",",
        currencies={"rupiah": "Rp", "dolar amerika serikat": "$",
                    "dolar amerika": "$", "dolar": "$", "euro": "€",
                    "won": "₩", "pound inggris": "£"},
        minor_units=["sen"],
        ordinal_value=_id_ordinal_value,
        ordinal_fmt=lambda n: f"ke-{n}",
        extra=_td_extras("id")),
    "vi": LangClasses(
        decimal_words=["phẩy", "phay"], decimal_mark=",",
        currencies={"đồng": "₫", "dong": "₫", "đô la mỹ": "$",
                    "đô la": "$", "đô": "$", "usd": "$", "euro": "€",
                    "ơ rô": "€", "yên": "¥", "won": "₩", "uôn": "₩"},
        minor_units=["xu"],
        extra=_td_extras("vi")),
    "tl": LangClasses(
        decimal_words=["punto", "tuldok"], decimal_mark=".",
        currencies={"piso": "₱", "pesos": "₱", "peso": "₱", "dolyar": "$",
                    "euro": "€"},
        minor_units=["sentimo", "sentimos"],
        ordinal_value=_tl_ordinal_value,
        ordinal_fmt=lambda n: f"ika-{n}",
        extra=_td_extras("tl")),
    "ja": LangClasses(
        decimal_words=["点"], decimal_mark=".",
        extra=_td_extras("ja")),
    "ko": LangClasses(
        decimal_words=["점"], decimal_mark=".",
        extra=_td_extras("ko")),
}


def apply_classes(lang: str, text: str) -> str:
    """Run the post-cardinal class rules for ``lang`` (no-op when absent),
    then the electronic (email/url) and whitelist classes (reference
    ``taggers/electronic.py`` / ``taggers/whitelist.py`` per language)."""
    from funasr_tpu_torch.text.electronic import apply_electronic, apply_whitelist
    cls = _CLASSES.get(lang)
    out = cls.apply(text) if cls else text
    out = apply_electronic(lang, out)
    return apply_whitelist(lang, out)
