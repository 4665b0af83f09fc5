"""Class-based text normalization (written -> spoken) for de/es/ru.

Counterpart of the reference's pynini TN grammars
(``fun_text_processing/text_normalization/{de,es,ru}/taggers/*.py`` — cardinal,
decimal, ordinal, date, time, money, measure, telephone, fraction), rebuilt as
ordered deterministic regex passes over the written surface. Output formats
follow the reference verbalizer docstrings:

- de time  ``02:15 Uhr`` -> ``zwei uhr fünfzehn``        (de/verbalizers/time.py)
- de date  ``4. Mai 2002`` -> ``vierter mai zweitausendzwei``  (date.py)
- de money ``1,40 £`` -> ``ein pfund vierzig``            (money.py preserve_order)
- es date  ``31 de marzo de 2000`` -> ``treinta y uno de marzo de dos mil``
  with day 1 -> ``primero``                               (es/verbalizers/date.py)
- ru time  ``02:15`` -> ``два часа пятнадцать минут``     (ru/verbalizers/time.py)
- ru date  ``1 мая`` -> ``первое мая``                    (ru/verbalizers/date.py)

Simplifications vs the WFST originals are documented inline (Russian output is
nominative/neuter where the reference's morphology tables carry full case
agreement; German years verbalize through the standard cardinal, i.e.
``zweitausendzwei`` rather than the spaced ``zwei tausend zwei``).
"""

from __future__ import annotations

import re
from typing import Callable, Dict

from funasr_tpu_torch.text.multilingual import TN_FUNCS as _CARDINALS

# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

_DIGIT_WORDS = {
    "de": ["null", "eins", "zwei", "drei", "vier", "fünf", "sechs", "sieben",
           "acht", "neun"],
    "es": ["cero", "uno", "dos", "tres", "cuatro", "cinco", "seis", "siete",
           "ocho", "nueve"],
    "ru": ["ноль", "один", "два", "три", "четыре", "пять", "шесть", "семь",
           "восемь", "девять"],
}


def _spell_digits(lang: str, digits: str) -> str:
    words = _DIGIT_WORDS[lang]
    return " ".join(words[int(c)] for c in digits if c.isdigit())


def _card(lang: str, n: int) -> str:
    return _CARDINALS[lang](n)


def _ru_count(n: int, one: str, few: str, many: str) -> str:
    """Russian count-noun form: 1 рубль / 2 рубля / 5 рублей."""
    if n % 10 == 1 and n % 100 != 11:
        return one
    if 2 <= n % 10 <= 4 and not 12 <= n % 100 <= 14:
        return few
    return many


def _ru_card_fem(n: int) -> str:
    """Cardinal with feminine ones agreement (минута/копейка/тысяча nouns)."""
    out = _card("ru", n)
    out = re.sub(r"\bодин$", "одна", out)
    return re.sub(r"\bдва$", "две", out)


# ---------------------------------------------------------------------------
# German (reference fun_text_processing/text_normalization/de/)
# ---------------------------------------------------------------------------

_DE_MONTH_NUM = {1: "januar", 2: "februar", 3: "märz", 4: "april", 5: "mai",
                 6: "juni", 7: "juli", 8: "august", 9: "september",
                 10: "oktober", 11: "november", 12: "dezember"}
_DE_MONTH_ALT = "|".join(sorted(_DE_MONTH_NUM.values(), key=len, reverse=True))

_DE_ORD_IRREG = {1: "erster", 3: "dritter", 7: "siebter", 8: "achter"}


def _de_ordinal(n: int) -> str:
    """4 -> vierter (de/verbalizers/ordinal.py: -ter/-ster masculine form)."""
    if n in _DE_ORD_IRREG:
        return _DE_ORD_IRREG[n]
    card = _card("de", n)
    if n >= 20:
        return card + "ster"
    return card + "ter"


def _de_card_attr(n: int) -> str:
    """Attributive cardinal: 1 before a noun is "ein" (money verbalizer)."""
    return "ein" if n == 1 else _card("de", n)


_DE_CURR = {"€": ("euro", "euro", "cent"), "$": ("dollar", "dollar", "cent"),
            "£": ("pfund", "pfund", "pence")}
_DE_UNIT_WORDS = {
    "km": "kilometer", "cm": "zentimeter", "mm": "millimeter", "m": "meter",
    "kg": "kilogramm", "mg": "milligramm", "g": "gramm", "t": "tonnen",
    "ml": "milliliter", "l": "liter", "km/h": "kilometer pro stunde",
    "%": "prozent"}


def _de_decimal(int_part: str, frac: str) -> str:
    """3,406 -> drei komma vier null sechs (decimal verbalizer: fractional
    digits spelled one by one)."""
    return f"{_card('de', int(int_part))} komma {_spell_digits('de', frac)}"


def normalize_de(text: str) -> str:
    # time: 02:15(:10) Uhr -> zwei uhr fünfzehn (sekunden only in hms form)
    def _time(m):
        h, mi, s = int(m.group(1)), m.group(2), m.group(3)
        hw = "ein" if h == 1 else _card("de", h)
        out = f"{hw} uhr"
        if mi is not None and int(mi):
            out += f" {_card('de', int(mi))}"
            if s is not None and int(s):
                out = (f"{hw} uhr {_card('de', int(mi))} minuten "
                       f"{_card('de', int(s))} sekunden")
        return out

    text = re.sub(r"\b(\d{1,2}):(\d{2})(?::(\d{2}))? ?[Uu]hr\b", _time, text)
    text = re.sub(r"\b(\d{1,2}) [Uu]hr\b",
                  lambda m: ("ein" if int(m.group(1)) == 1
                             else _card("de", int(m.group(1)))) + " uhr", text)

    # date: 4. Mai 2002 / 04.05.2002 -> vierter mai zweitausendzwei
    def _date_words(m):
        d, mon, y = int(m.group(1)), m.group(2).lower(), m.group(3)
        out = f"{_de_ordinal(d)} {mon}"
        if y:
            out += f" {_card('de', int(y))}"
        return out

    text = re.sub(r"\b(\d{1,2})\. (" + _DE_MONTH_ALT + r")(?: (\d{4}))?",
                  _date_words, text, flags=re.IGNORECASE)
    text = re.sub(
        r"\b(\d{1,2})\.(\d{1,2})\.(\d{4})\b",
        lambda m: (f"{_de_ordinal(int(m.group(1)))} "
                   f"{_DE_MONTH_NUM.get(int(m.group(2)), m.group(2))} "
                   f"{_card('de', int(m.group(3)))}"), text)

    # money: €5 / 5 € / 1,40 £ -> fünf euro / ein pfund vierzig (+minor unit
    # kept implicit, money verbalizer preserve_order form)
    def _money(m):
        sym = m.group("sym")
        maj = int(m.group("int"))
        frac = m.group("frac")
        one, many, _minor = _DE_CURR[sym]
        out = f"{_de_card_attr(maj)} {many if maj != 1 else one}"
        if frac:
            out += f" {_card('de', int(frac))}"
        return out

    for pat in (r"(?P<sym>[€$£]) ?(?P<int>\d+)(?:,(?P<frac>\d{1,2}))?\b",
                r"\b(?P<int>\d+)(?:,(?P<frac>\d{1,2}))? ?(?P<sym>[€$£])"):
        text = re.sub(pat, _money, text)

    # percent + measures: 12% -> zwölf prozent; 5 km -> fünf kilometer
    unit_alt = "|".join(sorted(map(re.escape, _DE_UNIT_WORDS),
                               key=len, reverse=True))
    text = re.sub(
        r"\b(\d+),(\d+) ?(" + unit_alt + r")(?=\s|$|[,.!?;:])",
        lambda m: f"{_de_decimal(m.group(1), m.group(2))} "
                  f"{_DE_UNIT_WORDS[m.group(3)]}", text)
    text = re.sub(
        r"\b(\d+) ?(" + unit_alt + r")(?=\s|$|[,.!?;:])",
        lambda m: f"{_card('de', int(m.group(1)))} "
                  f"{_DE_UNIT_WORDS[m.group(2)]}", text)

    # telephone: 7+ digit groups spoken digit by digit (telephone tagger)
    text = re.sub(r"\b\d[\d ]{6,}\d\b",
                  lambda m: _spell_digits("de", m.group(0)), text)

    # fraction: 3/4 -> drei viertel (de fraction tagger)
    _fracs = {2: "halbe", 3: "drittel", 4: "viertel", 5: "fünftel",
              6: "sechstel", 7: "siebtel", 8: "achtel", 9: "neuntel",
              10: "zehntel"}
    text = re.sub(
        r"\b(\d+)/(\d+)\b",
        lambda m: (f"{_card('de', int(m.group(1)))} "
                   f"{_fracs[int(m.group(2))]}"
                   if int(m.group(2)) in _fracs else m.group(0)), text)

    # leftover ordinal "4." then decimal then plain cardinal
    text = re.sub(r"\b(\d+)\.(?=\s|$)",
                  lambda m: _de_ordinal(int(m.group(1))), text)
    text = re.sub(r"\b(\d+),(\d+)\b",
                  lambda m: _de_decimal(m.group(1), m.group(2)), text)
    text = re.sub(r"(?<![\d\w])-(\d+)\b", lambda m: "minus " + _card("de", int(m.group(1))),
                  text)
    text = re.sub(r"\b(\d+)\b", lambda m: _card("de", int(m.group(1))), text)
    return text


# ---------------------------------------------------------------------------
# Spanish (reference fun_text_processing/text_normalization/es/)
# ---------------------------------------------------------------------------

_ES_MONTHS = ["enero", "febrero", "marzo", "abril", "mayo", "junio", "julio",
              "agosto", "septiembre", "octubre", "noviembre", "diciembre"]
_ES_MONTH_ALT = "|".join(_ES_MONTHS)
_ES_CURR = {"€": ("euro", "euros"), "$": ("dólar", "dólares"),
            "£": ("libra", "libras")}
_ES_UNIT_WORDS = {"km": "kilómetros", "cm": "centímetros", "m": "metros",
                  "kg": "kilogramos", "g": "gramos", "l": "litros",
                  "%": "por ciento"}


def _es_card_money(n: int, fem: bool) -> str:
    out = _card("es", n)
    if n % 10 == 1 and n % 100 != 11:
        out = re.sub(r"\buno$", "una" if fem else "un", out)
    return out


def normalize_es(text: str) -> str:
    # time: las 02:15 -> las dos y cuarto (es time verbalizer: y media/cuarto)
    def _time(m):
        h, mi = int(m.group(1)), int(m.group(2))
        hw = "una" if h == 1 else _card("es", h)
        if mi == 0:
            return f"{hw} en punto"
        if mi == 15:
            return f"{hw} y cuarto"
        if mi == 30:
            return f"{hw} y media"
        if mi == 45:
            nxt = 1 if h in (12, 24) else h + 1
            return (f"{'una' if nxt == 1 else _card('es', nxt)} menos cuarto")
        return f"{hw} y {_card('es', mi)}"

    text = re.sub(r"\b(\d{1,2}):(\d{2})\b", _time, text)

    # date: 31 de marzo de 2000 -> treinta y uno de marzo de dos mil;
    # day 1 -> primero (es date verbalizer)
    def _date(m):
        d, mon, y = int(m.group(1)), m.group(2).lower(), m.group(3)
        dw = "primero" if d == 1 else _card("es", d)
        out = f"{dw} de {mon}"
        if y:
            out += f" de {_card('es', int(y))}"
        return out

    text = re.sub(r"\b(\d{1,2}) de (" + _ES_MONTH_ALT + r")(?: del? (\d{4}))?",
                  _date, text, flags=re.IGNORECASE)

    # money: $5 / €1 / 1,40 libras-style with symbol
    def _money(m):
        sym, maj, frac = m.group("sym"), int(m.group("int")), m.group("frac")
        one, many = _ES_CURR[sym]
        fem = sym == "£"
        out = f"{_es_card_money(maj, fem)} {one if maj == 1 else many}"
        if frac:
            out += f" con {_card('es', int(frac))}"
        return out

    for pat in (r"(?P<sym>[€$£]) ?(?P<int>\d+)(?:,(?P<frac>\d{1,2}))?\b",
                r"\b(?P<int>\d+)(?:,(?P<frac>\d{1,2}))? ?(?P<sym>[€$£])"):
        text = re.sub(pat, _money, text)

    # percent + measures
    unit_alt = "|".join(sorted(map(re.escape, _ES_UNIT_WORDS),
                               key=len, reverse=True))
    text = re.sub(
        r"\b(\d+) ?(" + unit_alt + r")(?=\s|$|[,.!?;:])",
        lambda m: f"{_card('es', int(m.group(1)))} "
                  f"{_ES_UNIT_WORDS[m.group(2)]}", text)

    # telephone digit-by-digit
    text = re.sub(r"\b\d[\d ]{6,}\d\b",
                  lambda m: _spell_digits("es", m.group(0)), text)

    # ordinal 3º/3ª (es ordinal tagger suffix forms)
    _ord = {1: "primero", 2: "segundo", 3: "tercero", 4: "cuarto",
            5: "quinto", 6: "sexto", 7: "séptimo", 8: "octavo", 9: "noveno",
            10: "décimo"}
    text = re.sub(r"\b(\d+)º",
                  lambda m: _ord.get(int(m.group(1)),
                                     _card("es", int(m.group(1)))), text)
    text = re.sub(
        r"\b(\d+)ª",
        lambda m: re.sub(r"o$", "a", _ord.get(int(m.group(1)),
                                              _card("es", int(m.group(1))))),
        text)

    # decimal: 3,14 -> tres coma uno cuatro (es decimals verbalizer spells
    # fractional digits)
    text = re.sub(
        r"\b(\d+),(\d+)\b",
        lambda m: f"{_card('es', int(m.group(1)))} coma "
                  f"{_spell_digits('es', m.group(2))}", text)
    text = re.sub(r"(?<![\d\w])-(\d+)\b",
                  lambda m: "menos " + _card("es", int(m.group(1))), text)
    text = re.sub(r"\b(\d+)\b", lambda m: _card("es", int(m.group(1))), text)
    return text


# ---------------------------------------------------------------------------
# Russian (reference fun_text_processing/text_normalization/ru/)
# Simplification: nominative forms (the reference's number_names.py carries
# full case tables); count-noun agreement (рубль/рубля/рублей) is kept.
# ---------------------------------------------------------------------------

_RU_MONTHS_GEN = ["января", "февраля", "марта", "апреля", "мая", "июня",
                  "июля", "августа", "сентября", "октября", "ноября",
                  "декабря"]
_RU_MONTH_ALT = "|".join(_RU_MONTHS_GEN)

_RU_ORD_NEUT = {1: "первое", 2: "второе", 3: "третье", 4: "четвёртое",
                5: "пятое", 6: "шестое", 7: "седьмое", 8: "восьмое",
                9: "девятое", 10: "десятое", 11: "одиннадцатое",
                12: "двенадцатое", 13: "тринадцатое", 14: "четырнадцатое",
                15: "пятнадцатое", 16: "шестнадцатое", 17: "семнадцатое",
                18: "восемнадцатое", 19: "девятнадцатое", 20: "двадцатое",
                30: "тридцатое"}


def _ru_date_day(d: int) -> str:
    """1 -> первое (ru date verbalizer: neuter ordinal day)."""
    if d in _RU_ORD_NEUT:
        return _RU_ORD_NEUT[d]
    tens, ones = divmod(d, 10)
    return f"{_card('ru', tens * 10)} {_RU_ORD_NEUT[ones]}"


_RU_UNIT_WORDS = {
    "км": ("километр", "километра", "километров"),
    "см": ("сантиметр", "сантиметра", "сантиметров"),
    "м": ("метр", "метра", "метров"),
    "кг": ("килограмм", "килограмма", "килограммов"),
    "г": ("грамм", "грамма", "граммов"),
    "л": ("литр", "литра", "литров"),
}


def normalize_ru(text: str) -> str:
    # time: 02:15 -> два часа пятнадцать минут (ru/verbalizers/time.py)
    def _time(m):
        h, mi = int(m.group(1)), int(m.group(2))
        hw = f"{_card('ru', h)} {_ru_count(h, 'час', 'часа', 'часов')}"
        if h % 10 == 1 and h % 100 != 11:
            hw = re.sub(r"^один ", "", hw)
        if mi == 0:
            return hw
        mw = (f"{_ru_card_fem(mi)} "
              f"{_ru_count(mi, 'минута', 'минуты', 'минут')}")
        return f"{hw} {mw}"

    text = re.sub(r"\b(\d{1,2}):(\d{2})\b", _time, text)

    # date: 1 мая (2002 года) -> первое мая (две тысячи два года)
    def _date(m):
        d, mon, y = int(m.group(1)), m.group(2), m.group(3)
        out = f"{_ru_date_day(d)} {mon}"
        if y:
            out += f" {_card('ru', int(y))} года"
        return out

    text = re.sub(r"\b(\d{1,2}) (" + _RU_MONTH_ALT + r")(?: (\d{4}) года)?",
                  _date, text)

    # money: 5 ₽ / ₽5 / 5 руб. -> пять рублей (ru money verbalizer)
    def _money(m):
        n = int(m.group("int"))
        frac = m.group("frac")
        head = _card("ru", n)
        out = f"{head} {_ru_count(n, 'рубль', 'рубля', 'рублей')}"
        if frac:
            k = int(frac)
            out += (f" {_ru_card_fem(k)} "
                    f"{_ru_count(k, 'копейка', 'копейки', 'копеек')}")
        return out

    for pat in (r"₽ ?(?P<int>\d+)(?:,(?P<frac>\d{1,2}))?\b",
                r"\b(?P<int>\d+)(?:,(?P<frac>\d{1,2}))? ?(?:₽|руб\.?)"):
        text = re.sub(pat, _money, text)

    # percent: 12% -> двенадцать процентов
    text = re.sub(
        r"\b(\d+) ?%",
        lambda m: f"{_card('ru', int(m.group(1)))} "
                  f"{_ru_count(int(m.group(1)), 'процент', 'процента', 'процентов')}",
        text)

    # measures: 2 кг -> два килограмма (ru measure verbalizer + count form)
    unit_alt = "|".join(sorted(map(re.escape, _RU_UNIT_WORDS),
                               key=len, reverse=True))
    def _measure(m):
        n = int(m.group(1))
        one, few, many = _RU_UNIT_WORDS[m.group(2)]
        return f"{_card('ru', n)} {_ru_count(n, one, few, many)}"

    text = re.sub(r"\b(\d+) ?(" + unit_alt + r")(?=\s|$|[,.!?;:])",
                  _measure, text)

    # telephone digit-by-digit
    text = re.sub(r"\b\d[\d ]{6,}\d\b",
                  lambda m: _spell_digits("ru", m.group(0)), text)

    # decimal: 3,14 -> три запятая один четыре (symmetric with the ITN
    # decimal words "запятая|целых")
    text = re.sub(
        r"\b(\d+),(\d+)\b",
        lambda m: f"{_card('ru', int(m.group(1)))} запятая "
                  f"{_spell_digits('ru', m.group(2))}", text)
    text = re.sub(r"(?<![\d\w])-(\d+)\b",
                  lambda m: "минус " + _card("ru", int(m.group(1))), text)
    text = re.sub(r"\b(\d+)\b", lambda m: _card("ru", int(m.group(1))), text)
    return text


TN_CLASS_FUNCS: Dict[str, Callable[[str], str]] = {
    "de": normalize_de, "es": normalize_es, "ru": normalize_ru}
