"""Text normalization (written -> spoken) for zh and en.

Counterpart of the reference's Chinese TN module
(``funasr/models/fun_asr_nano/tools/cn_tn.py``, NeMo lineage) and the en TN
grammars in ``fun_text_processing/text_normalization/en``: rule passes over
class patterns (date, percent, fraction, money, decimal, range, digit strings,
cardinal) that verbalize Arabic digits into spoken words, so TTS-style or
LLM-training text matches ASR transcripts.
"""

from __future__ import annotations

import re

# -- Chinese number reading ----------------------------------------------------

_ZH_DIGITS = "零一二三四五六七八九"
_ZH_UNITS = ["", "十", "百", "千"]
_ZH_BIG = ["", "万", "亿", "兆"]


def num2zh(n: int, digit_by_digit: bool = False) -> str:
    """Arabic integer -> Chinese reading with standard zero-insertion
    (10500 -> 一万零五百; ref cn_tn.py num2chn semantics, 二 variant)."""
    if digit_by_digit:
        return "".join(_ZH_DIGITS[int(c)] for c in str(n))
    if n < 0:
        return "负" + num2zh(-n)
    if n == 0:
        return "零"
    # split into 4-digit groups, big-endian
    groups = []
    while n > 0:
        groups.append(n % 10000)
        n //= 10000
    parts = []
    for gi in range(len(groups) - 1, -1, -1):
        g = groups[gi]
        if g == 0:
            continue
        s = ""
        zero_pending = False
        for pos in range(3, -1, -1):
            d = (g // 10 ** pos) % 10
            if d == 0:
                if s:
                    zero_pending = True
                continue
            if zero_pending:
                s += "零"
                zero_pending = False
            s += _ZH_DIGITS[d] + _ZH_UNITS[pos]
        # a group smaller than the previous group's span needs a leading 零
        if parts and groups[gi] < 1000:
            s = "零" + s
        parts.append(s + _ZH_BIG[gi])
    out = "".join(parts)
    # 一十X -> 十X at the very front (cn_tn alt_one convention)
    if out.startswith("一十"):
        out = out[1:]
    return out


def _zh_decimal(s: str) -> str:
    int_part, _, frac = s.partition(".")
    out = num2zh(int(int_part)) if int_part else "零"
    if frac:
        out += "点" + "".join(_ZH_DIGITS[int(c)] for c in frac)
    return out


def normalize_zh(text: str) -> str:
    """Chinese TN passes (class order mirrors cn_tn: date > percent >
    fraction > money > range > decimal > phone > cardinal)."""
    def dec(m):
        return _zh_decimal(m.group(0))

    # dates: 2024年 reads digit-wise; 10月 / 1日 read as cardinals
    text = re.sub(r"(\d{4})年",
                  lambda m: num2zh(int(m.group(1)), digit_by_digit=True)
                  + "年", text)
    text = re.sub(r"(\d{1,2})月(\d{1,2})[日号]",
                  lambda m: num2zh(int(m.group(1))) + "月"
                  + num2zh(int(m.group(2))) + "日", text)
    text = re.sub(r"(\d{1,2})月",
                  lambda m: num2zh(int(m.group(1))) + "月", text)
    # time 8:30 -> 八点三十分
    text = re.sub(r"(\d{1,2}):(\d{2})",
                  lambda m: num2zh(int(m.group(1))) + "点"
                  + (num2zh(int(m.group(2))) + "分"
                     if int(m.group(2)) else "整"), text)
    # percent
    text = re.sub(r"(\d+(?:\.\d+)?)%",
                  lambda m: "百分之" + _zh_decimal(m.group(1)), text)
    # fraction a/b -> b分之a
    text = re.sub(r"(\d+)/(\d+)",
                  lambda m: num2zh(int(m.group(2))) + "分之"
                  + num2zh(int(m.group(1))), text)
    # money
    text = re.sub(r"[¥￥](\d+(?:\.\d+)?)",
                  lambda m: _zh_decimal(m.group(1)) + "元", text)
    text = re.sub(r"(\d+(?:\.\d+)?)([元块])",
                  lambda m: _zh_decimal(m.group(1)) + m.group(2), text)
    # ranges 5-10 (between digits) -> 五到十
    text = re.sub(r"(?<=\D)(\d+)-(\d+)(?=\D|$)",
                  lambda m: num2zh(int(m.group(1))) + "到"
                  + num2zh(int(m.group(2))), text)
    # long digit strings (phone numbers, ids): digit-by-digit
    text = re.sub(r"\d{7,}",
                  lambda m: num2zh(int(m.group(0)), digit_by_digit=True), text)
    # decimals then cardinals
    text = re.sub(r"\d+\.\d+", dec, text)
    text = re.sub(r"\d+", lambda m: num2zh(int(m.group(0))), text)
    return text


# -- English number reading -----------------------------------------------------

_EN_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven",
            "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
            "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_EN_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
            "eighty", "ninety"]
_EN_SCALES = [(10 ** 9, "billion"), (10 ** 6, "million"), (1000, "thousand"),
              (100, "hundred")]
_EN_ORD = {"one": "first", "two": "second", "three": "third", "five": "fifth",
           "eight": "eighth", "nine": "ninth", "twelve": "twelfth"}


def num2en(n: int) -> str:
    if n < 0:
        return "minus " + num2en(-n)
    if n < 20:
        return _EN_ONES[n]
    if n < 100:
        t, r = divmod(n, 10)
        return _EN_TENS[t] + (" " + _EN_ONES[r] if r else "")
    for scale, word in _EN_SCALES:
        if n >= scale:
            head, rest = divmod(n, scale)
            out = num2en(head) + " " + word
            if rest:
                out += " " + num2en(rest)
            return out
    return _EN_ONES[0]


def num2en_ordinal(n: int) -> str:
    words = num2en(n)
    head, _, last = words.rpartition(" ")
    if last in _EN_ORD:
        last = _EN_ORD[last]
    elif last.endswith("y"):
        last = last[:-1] + "ieth"
    else:
        last += "th"
    return (head + " " + last).strip()


def _en_year(y: int) -> str:
    if 1000 <= y <= 1999 or (2010 <= y <= 2099 and y % 100 >= 10):
        hi, lo = divmod(y, 100)
        return num2en(hi) + " " + (num2en(lo) if lo >= 10 else
                                   ("hundred" if lo == 0
                                    else "oh " + num2en(lo)))
    return num2en(y)


def normalize_en(text: str) -> str:
    """English TN passes: money > percent > ordinal > decimal > year >
    cardinal (ref fun_text_processing/text_normalization/en grammar set)."""
    text = re.sub(r"\$(\d+)\.(\d{2})",
                  lambda m: num2en(int(m.group(1))) + " dollars "
                  + num2en(int(m.group(2))) + " cents", text)
    text = re.sub(r"\$(\d+)",
                  lambda m: num2en(int(m.group(1)))
                  + (" dollar" if m.group(1) == "1" else " dollars"), text)
    text = re.sub(r"(\d+(?:\.\d+)?)%",
                  lambda m: re.sub(r"\d+\.\d+|\d+", lambda mm: _en_number(
                      mm.group(0)), m.group(1)) + " percent", text)
    text = re.sub(r"(\d+)(st|nd|rd|th)\b",
                  lambda m: num2en_ordinal(int(m.group(1))), text)
    text = re.sub(r"\b(1[0-9]{3}|20[0-9]{2})\b",
                  lambda m: _en_year(int(m.group(0))), text)
    text = re.sub(r"\d+\.\d+", lambda m: _en_number(m.group(0)), text)
    text = re.sub(r"\d+", lambda m: num2en(int(m.group(0))), text)
    return text


def _en_number(s: str) -> str:
    int_part, _, frac = s.partition(".")
    out = num2en(int(int_part)) if int_part else "zero"
    if frac:
        out += " point " + " ".join(_EN_ONES[int(c)] for c in frac)
    return out


TN_FUNCS = {"zh": normalize_zh, "en": normalize_en}
