"""English spoken-number ITN rules (counterpart of FunASR
``fun_text_processing/inverse_text_normalization/en/``)."""

from __future__ import annotations

import re

ONES = {"zero": 0, "one": 1, "two": 2, "three": 3, "four": 4, "five": 5,
        "six": 6, "seven": 7, "eight": 8, "nine": 9, "ten": 10, "eleven": 11,
        "twelve": 12, "thirteen": 13, "fourteen": 14, "fifteen": 15,
        "sixteen": 16, "seventeen": 17, "eighteen": 18, "nineteen": 19}
TENS = {"twenty": 20, "thirty": 30, "forty": 40, "fifty": 50, "sixty": 60,
        "seventy": 70, "eighty": 80, "ninety": 90}
SCALES = {"hundred": 100, "thousand": 1000, "million": 10 ** 6,
          "billion": 10 ** 9}
NUM_WORDS = set(ONES) | set(TENS) | set(SCALES) | {"and"}

# ordinal word -> the cardinal it terminates ("twenty first" = 20 + 1st)
ORDINALS = {"first": 1, "second": 2, "third": 3, "fourth": 4, "fifth": 5,
            "sixth": 6, "seventh": 7, "eighth": 8, "ninth": 9, "tenth": 10,
            "eleventh": 11, "twelfth": 12, "thirteenth": 13,
            "fourteenth": 14, "fifteenth": 15, "sixteenth": 16,
            "seventeenth": 17, "eighteenth": 18, "nineteenth": 19,
            "twentieth": 20, "thirtieth": 30, "fortieth": 40, "fiftieth": 50,
            "sixtieth": 60, "seventieth": 70, "eightieth": 80,
            "ninetieth": 90, "hundredth": 100, "thousandth": 1000,
            "millionth": 10 ** 6}

CURRENCIES = {"dollar": "$", "dollars": "$", "buck": "$", "bucks": "$",
              "euro": "€", "euros": "€", "pound": "£", "pounds": "£"}


def ordinal_suffix(n: int) -> str:
    if n % 100 in (11, 12, 13):
        return "th"
    return {1: "st", 2: "nd", 3: "rd"}.get(n % 10, "th")


def parse_en_number(words):
    """List of number words -> int, or None."""
    total = 0
    current = 0
    seen = False
    for w in words:
        w = w.lower()
        if w in ONES:
            current += ONES[w]
            seen = True
        elif w in TENS:
            current += TENS[w]
            seen = True
        elif w == "hundred":
            current = max(current, 1) * 100
            seen = True
        elif w in SCALES:
            total += max(current, 1) * SCALES[w]
            current = 0
            seen = True
        elif w == "and":
            continue
        else:
            return None
    return total + current if seen else None


def _clean(w: str) -> str:
    return re.sub(r"[^\w']", "", w).lower()


def inverse_normalize_en(text: str) -> str:
    """Spoken en -> written: cardinals, percent, ordinals ("twenty first" ->
    "21st"), money ("three dollars fifty" -> "$3.50"), dates via ordinals
    ("january third" -> "january 3rd"). Counterpart of the reference en
    taggers (``fun_text_processing/inverse_text_normalization/en/taggers/``)."""
    words = text.split()
    out = []
    i = 0

    def span_end(start):
        j = start
        while j < len(words):
            wj = _clean(words[j])
            if wj == "and":
                # "and" joins a number only after a scale word ("hundred and")
                prev = _clean(words[j - 1]) if j > start else ""
                nxt = _clean(words[j + 1]) if j + 1 < len(words) else ""
                if prev in SCALES and nxt in NUM_WORDS and nxt != "and":
                    j += 1
                    continue
                break
            if wj in NUM_WORDS:
                j += 1
            else:
                break
        return j

    while i < len(words):
        w = _clean(words[i])

        # standalone ordinal ("third" -> "3rd")
        if w in ORDINALS:
            v = ORDINALS[w]
            out.append(f"{v}{ordinal_suffix(v)}")
            i += 1
            continue

        if w in NUM_WORDS and w != "and":
            j = span_end(i)
            val = parse_en_number([_clean(x) for x in words[i:j]])
            if val is not None:
                nxt = _clean(words[j]) if j < len(words) else ""
                # "twenty first" / "one hundred and first" -> ordinal
                ord_j, ord_w = j, nxt
                if nxt == "and" and j + 1 < len(words) \
                        and _clean(words[j + 1]) in ORDINALS:
                    ord_j, ord_w = j + 1, _clean(words[j + 1])
                if ord_w in ORDINALS:
                    ov = ORDINALS[ord_w]
                    total = val * ov if ov >= 100 else val + ov
                    out.append(f"{total}{ordinal_suffix(total)}")
                    i = ord_j + 1
                    continue
                if nxt.startswith("percent"):
                    out.append(f"{val}%")
                    i = j + 1
                    continue
                if nxt in ("cent", "cents"):  # "fifty cents" -> "$0.50"
                    if val < 100:
                        out.append(f"$0.{val:02d}")
                        i = j + 1
                        continue
                if nxt in CURRENCIES:
                    sym = CURRENCIES[nxt]
                    k = j + 1
                    if k < len(words) and _clean(words[k]) == "and":
                        k += 1
                    k2 = span_end(k)
                    cents = parse_en_number([_clean(x) for x in words[k:k2]]) \
                        if k2 > k else None
                    if cents is not None and cents < 100:
                        if k2 < len(words) and _clean(words[k2]) in ("cent",
                                                                     "cents"):
                            k2 += 1
                        out.append(f"{sym}{val}.{cents:02d}")
                        i = k2
                    else:
                        out.append(f"{sym}{val}")
                        i = j + 1
                    continue
                out.append(str(val))
                i = j
                continue
        out.append(words[i])
        i += 1
    from funasr_tpu_torch.text.electronic import apply_electronic, apply_whitelist
    return apply_whitelist("en", apply_electronic("en", " ".join(out)))
