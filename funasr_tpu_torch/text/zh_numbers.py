"""Chinese spoken-number parsing/verbalization (core of zh ITN/TN).

Counterpart of the grammars in FunASR ``fun_text_processing/inverse_text_normalization/
zh/`` (pynini WFSTs) as deterministic Python rules: cardinal, decimal, percent, date,
time, money. Pure functions; used by :mod:`funasr_tpu_torch.text.inverse_normalize`.
"""

from __future__ import annotations

import re

DIGITS = {"零": 0, "〇": 0, "一": 1, "幺": 1, "二": 2, "两": 2, "三": 3, "四": 4,
          "五": 5, "六": 6, "七": 7, "八": 8, "九": 9}
UNITS = {"十": 10, "百": 100, "千": 1000}
BIG_UNITS = {"万": 10 ** 4, "亿": 10 ** 8}
_NUM_CHARS = "".join(DIGITS) + "".join(UNITS) + "".join(BIG_UNITS) + "点"


def parse_cn_number(text: str):
    """Spoken zh number -> numeric string, or None if not a number."""
    if not text:
        return None
    if "点" in text:
        parts = text.split("点")
        if len(parts) != 2:
            return None
        int_part = parse_cn_number(parts[0]) if parts[0] else "0"
        if int_part is None:
            return None
        frac = ""
        for ch in parts[1]:
            if ch not in DIGITS:
                return None
            frac += str(DIGITS[ch])
        return f"{int_part}.{frac}" if frac else None

    # pure digit string reading ("二零二三" -> 2023, "幺三九" -> 139)
    if all(ch in DIGITS for ch in text):
        if len(text) > 1:
            return "".join(str(DIGITS[ch]) for ch in text)
        return str(DIGITS[text])

    total = 0
    section = 0  # value below the current big unit
    current = 0
    seen_unit = False
    for ch in text:
        if ch in DIGITS:
            current = DIGITS[ch]
        elif ch in UNITS:
            seen_unit = True
            unit = UNITS[ch]
            section += (current if current else 1) * unit
            current = 0
        elif ch in BIG_UNITS:
            seen_unit = True
            contribution = section + current
            if contribution:
                total += contribution * BIG_UNITS[ch]
            elif total:
                total *= BIG_UNITS[ch]  # stacked big units ("万亿")
            section = 0
            current = 0
        else:
            return None
    if not seen_unit and len(text) > 1:
        return "".join(str(DIGITS[ch]) for ch in text if ch in DIGITS)
    value = total + section + current
    return str(value)


_NUM_RE = re.compile(f"[{_NUM_CHARS}]+")
_PERCENT_RE = re.compile(f"百分之([{_NUM_CHARS}]+)")
_DATE_RE = re.compile(
    f"([{''.join(DIGITS)}]{{2,4}})年(?:([{_NUM_CHARS}]{{1,3}})月)?"
    f"(?:([{_NUM_CHARS}]{{1,3}})[日号])?")
_TIME_RE = re.compile(
    f"([{_NUM_CHARS}]{{1,3}})点(?:([{_NUM_CHARS}]{{1,3}})分)?"
    f"(?:([{_NUM_CHARS}]{{1,3}})秒)?(半)?")
_MONEY_RE = re.compile(f"([{_NUM_CHARS}]+)(块钱|块|元|美元|欧元|英镑|日元)")
# month-day without a year ("十二月三十一日" -> "12月31日"); bounded to real
# calendar ranges so "三百万日元" never matches
_MONTH_DAY_RE = re.compile(
    f"([{_NUM_CHARS}]{{1,3}})月(?:([{_NUM_CHARS}]{{1,3}})[日号])?")


def inverse_normalize_zh(text: str) -> str:
    """Spoken zh -> written: numbers, percent, dates, times, money."""

    def pct(m):
        v = parse_cn_number(m.group(1))
        return f"{v}%" if v is not None else m.group(0)

    text = _PERCENT_RE.sub(pct, text)

    def date(m):
        y = m.group(1)
        year = "".join(str(DIGITS.get(ch, "")) for ch in y)
        out = f"{year}年"
        if m.group(2):
            mo = parse_cn_number(m.group(2))
            if mo is not None:
                out += f"{mo}月"
        if m.group(3):
            d = parse_cn_number(m.group(3))
            if d is not None:
                out += f"{d}日"
        return out

    text = _DATE_RE.sub(date, text)

    def month_day(m):
        mo = parse_cn_number(m.group(1))
        if mo is None or "." in mo or not 1 <= int(mo) <= 12:
            return m.group(0)
        out = f"{mo}月"
        if m.group(2):
            d = parse_cn_number(m.group(2))
            if d is None or "." in d or not 1 <= int(d) <= 31:
                return m.group(0)
            out += f"{d}日"
        return out

    text = _MONTH_DAY_RE.sub(month_day, text)

    def tm(m):
        # bare "N点" immediately followed by digit chars is a spoken decimal
        # ("三点一四" = 3.14), not a clock time — defer to the number pass
        if m.group(2) is None and m.group(3) is None and m.group(4) is None:
            nxt = m.string[m.end(): m.end() + 1]
            if nxt and nxt in DIGITS:
                return m.group(0)
        h = parse_cn_number(m.group(1))
        if h is None or int(float(h)) > 24:
            return m.group(0)
        if m.group(2):
            mi = parse_cn_number(m.group(2))
            out = f"{h}:{int(mi):02d}" if mi is not None else m.group(0)
        elif m.group(4):
            out = f"{h}:30"
        else:
            out = f"{h}点"
        if m.group(3):
            s = parse_cn_number(m.group(3))
            if s is not None and ":" in out:
                out += f":{int(s):02d}"
        return out

    text = _TIME_RE.sub(tm, text)

    def money(m):
        v = parse_cn_number(m.group(1))
        return f"{v}{m.group(2)}" if v is not None else m.group(0)

    text = _MONEY_RE.sub(money, text)

    def num(m):
        s = m.group(0)
        if len(s) == 1 and s in ("一", "两"):  # leave bare ones alone ("一起")
            return s
        v = parse_cn_number(s)
        return v if v is not None else s

    text = _NUM_RE.sub(num, text)
    from funasr_tpu_torch.text.electronic import apply_electronic
    return apply_electronic("zh", text)


_CN_DIGITS_OUT = "零一二三四五六七八九"


def verbalize_number_zh(num: str) -> str:
    """Written number -> spoken zh (TN direction)."""
    if "." in num:
        int_p, frac = num.split(".", 1)
        return (verbalize_number_zh(int_p) + "点"
                + "".join(_CN_DIGITS_OUT[int(d)] for d in frac if d.isdigit()))
    n = int(num)
    if n == 0:
        return "零"
    units = ["", "十", "百", "千"]
    big = ["", "万", "亿"]
    out = ""
    section_idx = 0
    while n > 0:
        section = n % 10000
        n //= 10000
        if section:
            s = ""
            zero_pending = False
            for i in range(3, -1, -1):
                d = (section // (10 ** i)) % 10
                if d == 0:
                    if s:
                        zero_pending = True
                    continue
                if zero_pending:
                    s += "零"
                    zero_pending = False
                s += _CN_DIGITS_OUT[d] + units[i]
            # "一十X" -> "十X"
            if s.startswith("一十"):
                s = s[1:]
            out = s + big[section_idx] + out
        elif out and not out.startswith("零"):
            out = "零" + out
        section_idx += 1
    return out


def normalize_zh(text: str) -> str:
    """Written -> spoken (TN): digits, percent, units."""
    def pct(m):
        return "百分之" + verbalize_number_zh(m.group(1))

    text = re.sub(r"(\d+(?:\.\d+)?)%", pct, text)

    def num(m):
        return verbalize_number_zh(m.group(0))

    return re.sub(r"\d+(?:\.\d+)?", num, text)
