"""ITN/TN grammar archive export — the FAR-export role.

Counterpart of the reference ``fun_text_processing/.../export_models.py``
pipeline, which compiles pynini grammars into FAR archives consumed by the
C++ runtime. Here the grammar source of truth is the rule tables in
``funasr_tpu_torch.text`` (lexicons + pattern classes); ``export_grammar`` serializes
them into one versioned JSON archive, and ``load_grammar`` reconstructs
runnable ITN functions from an archive alone — so the artifact, like a FAR, is
a self-contained grammar interchange file (the C++ runtime's hotword/ITN
loaders and third-party tools can consume the same JSON).
"""

from __future__ import annotations

import json
from typing import Dict

GRAMMAR_VERSION = 6  # v6: electronic (email/url) + whitelist classes

# spoken percent spans per language ("<number> <words>" -> "<number> %"; the
# second spelling covers the cardinal pass already digitizing ciento/cent/trăm)
_PERCENT_WORDS = {
    "de": ["prozent"], "es": ["por ciento", "por 100"],
    "fr": ["pour cent", "pour 100"], "pt": ["por cento", "por 100"],
    "ru": ["процентов", "процента", "процент"], "id": ["persen"],
    "vi": ["phần trăm", "phần 100"], "ja": ["パーセント"], "ko": ["퍼센트"],
}


def _gen_ordinal_surfaces(code: str, up_to: int = 31) -> Dict[str, int]:
    """Enumerate de/fr ordinal word surfaces for 1..up_to by inverting the
    cardinal lexicon and appending the language's ordinal suffixes; each
    candidate is validated through the host suffix-stripping parser so only
    true surfaces (and the irregulars) are exported."""
    from funasr_tpu_torch.text import multilingual as ml
    from funasr_tpu_torch.text import multilingual_classes as mc

    lex = ml._DE_LEX if code == "de" else ml._FR_LEX
    value_fn = (mc._de_ordinal_value if code == "de"
                else mc._fr_ordinal_value)
    inv = {}
    for w, v in {**lex.ones, **lex.tens}.items():
        inv.setdefault(v, w)
    cardinals: Dict[int, str] = {}
    for n in range(1, up_to + 1):
        if n in inv:
            cardinals[n] = inv[n]
        elif code == "de" and n > 20 and n % 10 in inv and (n // 10) * 10 in inv:
            one = "ein" if n % 10 == 1 else inv[n % 10]
            cardinals[n] = f"{one}und{inv[(n // 10) * 10]}"
        elif code == "fr" and n > 20 and n % 10 in inv and (n // 10) * 10 in inv:
            joiner = " et " if n % 10 == 1 else "-"
            cardinals[n] = f"{inv[(n // 10) * 10]}{joiner}{inv[n % 10]}"
    out: Dict[str, int] = {}
    irregular = (mc._DE_ORD_IRREGULAR if code == "de"
                 else mc._FR_ORD_IRREGULAR)
    out.update(irregular)
    suffixes = (("te", "ter", "ten", "tes", "ste", "ster", "sten", "stes")
                if code == "de" else ("ième", "ièmes", "ieme", "iemes"))
    for n, word in cardinals.items():
        bases = [word]
        if code == "fr":
            bases += [word[:-1]] if word.endswith("e") else []
            bases += [word + "u"] if word.endswith("q") else []  # cinq->cinqu
            bases += [word[:-1] + "v"] if word.endswith("f") else []  # neuf
        for base in bases:
            for suf in suffixes:
                cand = base + suf
                if value_fn(cand) == n:
                    out[cand] = n
    return out


def export_grammar(path: str | None = None) -> Dict:
    """Serialize every language's ITN lexicons + class-pattern inventory."""
    from funasr_tpu_torch.text import en_numbers, multilingual, zh_numbers

    langs: Dict[str, Dict] = {}
    # word-lexicon languages (de/es/fr/pt/ru/id/vi/tl …)
    for code, lex_name in (("de", "_DE_LEX"), ("es", "_ES_LEX"),
                           ("fr", "_FR_LEX"), ("pt", "_PT_LEX"),
                           ("ru", "_RU_LEX"), ("id", "_ID_LEX"),
                           ("vi", "_VI_LEX"), ("tl", "_TL_LEX")):
        lex = getattr(multilingual, lex_name, None)
        if lex is None:
            continue
        langs[code] = {
            "type": "word_lexicon",
            "ones": lex.ones, "tens": lex.tens,
            "hundred_words": sorted(lex.hundred_words),
            "scales": lex.scales,
            "joiners": sorted(lex.joiners),
            "hundreds_direct": lex.hundreds_direct,
            "x10_words": sorted(lex.x10_words),
            "pre": {"de": "de", "id": "id", "tl": "tl"}.get(code),
        }
    # CJK positional systems
    langs["ja"] = {"type": "cjk", "digits": multilingual._JA_DIGITS,
                   "units": multilingual._JA_UNITS,
                   "big": multilingual._JA_BIG}
    langs["ko"] = {"type": "cjk", "digits": multilingual._KO_DIGITS,
                   "units": multilingual._KO_UNITS,
                   "big": multilingual._KO_BIG}
    langs["zh"] = {"type": "cjk",
                   "digits": zh_numbers.DIGITS, "units": zh_numbers.UNITS,
                   "big": zh_numbers.BIG_UNITS,
                   "classes": ["number", "percent", "date", "time", "money",
                               "month_day", "decimal"],
                   "currency": ["块钱", "块", "元", "美元", "欧元", "英镑",
                                "日元"]}
    langs["en"] = {"type": "word_lexicon",
                   "ones": en_numbers.ONES, "tens": en_numbers.TENS,
                   "hundreds": ["hundred"], "scales": en_numbers.SCALES,
                   "joiners": ["and"],
                   "ordinals": en_numbers.ORDINALS,
                   "classes": ["number", "ordinal", "date", "money",
                               "decimal", "percent"]}
    # class-rule specs (decimals/money/percent/ordinal lookups) from the
    # post-cardinal overlays — data-driven so the C++ interpreter can apply
    # the same classes
    from funasr_tpu_torch.text.multilingual_classes import (_CLASSES, _TD_MAPS,
                                                      TIMEDATE_RULES)
    for code, cls in _CLASSES.items():
        spec = {
            "decimal_words": list(cls.decimal_words),
            "decimal_mark": cls.decimal_mark,
            "currencies": dict(cls.currencies),
            "minor_units": list(cls.minor_units),
            "percent_words": _PERCENT_WORDS.get(code, []),
        }
        if cls.ordinal_value is not None and code in ("es", "pt", "ru"):
            from funasr_tpu_torch.text.multilingual_classes import (
                _ES_ORDINALS, _PT_ORDINALS, _RU_ORDINALS)
            table = {"es": _ES_ORDINALS, "pt": _PT_ORDINALS,
                     "ru": _RU_ORDINALS}[code]
            spec["ordinals"] = {w: cls.ordinal_fmt(v) for w, v in table.items()}
        elif cls.ordinal_value is not None and code in ("de", "fr"):
            # de/fr ordinals are suffix-stripping code host-side; for the
            # archive, enumerate day-range surfaces (1..31) by generating
            # candidates and validating them back through the host parser —
            # enough for the date rules the C++ interpreter applies
            spec["ordinals"] = {
                w: cls.ordinal_fmt(v)
                for w, v in _gen_ordinal_surfaces(code).items()}
        elif cls.ordinal_value is not None and code in ("id", "tl"):
            # prefix ordinals (ke-/ika-): enumerate surfaces by prefixing
            # every ones/tens word, validated through the host parser
            from funasr_tpu_torch.text import multilingual as _ml
            from funasr_tpu_torch.text.multilingual_classes import \
                _TL_ORD_IRREGULAR
            lex_w = _ml._ID_LEX if code == "id" else _ml._TL_LEX
            prefixes = (("ke", "ke-") if code == "id"
                        else ("ika", "ika-", "ikang"))
            surfaces = (["pertama", "kesatu"] if code == "id"
                        else list(_TL_ORD_IRREGULAR))
            for base in list(lex_w.ones) + list(lex_w.tens):
                for pre in prefixes:
                    surfaces.append(pre + base)
                    if code == "tl":
                        surfaces.append(pre + base + "ng")
            spec["ordinals"] = {}
            for w in surfaces:
                v = cls.ordinal_value(w)
                if v is not None:
                    spec["ordinals"][w] = cls.ordinal_fmt(v)
        # v4: declarative time/date regex rules (Python-re ∩ ECMAScript
        # dialect) + lookup maps — the C++ interpreter applies the SAME rules
        # via std::regex (itn-grammar.cc ApplyTimedateRules)
        spec["timedate_rules"] = [
            {"pattern": p, "icase": bool(ic), "template": t}
            for p, ic, t in TIMEDATE_RULES.get(code, [])]
        langs.setdefault(code, {"type": "classes_only"})["classes"] = spec
    archive_maps = {name: dict(table) for name, table in _TD_MAPS.items()}

    # v6: electronic (email/url) at/dot word tables + whitelist
    # (spoken -> written abbreviation) per language, at the language top
    # level (zh's "classes" key is a legacy list). Reference:
    # fun_text_processing/inverse_text_normalization/<lang>/taggers/
    # electronic.py + whitelist.py.
    from funasr_tpu_torch.text.electronic import ELECTRONIC_WORDS, WHITELIST
    for code, words in ELECTRONIC_WORDS.items():
        if code in langs:
            langs[code]["electronic"] = {"at": list(words["at"]),
                                         "dot": list(words["dot"])}
    for code, table in WHITELIST.items():
        if code in langs:
            langs[code]["whitelist"] = dict(table)

    archive = {"format": "funasr_tpu_itn_grammar",
               "version": GRAMMAR_VERSION, "languages": langs,
               "maps": archive_maps}
    if path:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(archive, f, ensure_ascii=False, indent=1)
    return archive


def load_grammar(path_or_dict) -> Dict[str, object]:
    """Archive -> {lang: itn_fn}. Word-lexicon and CJK languages are rebuilt
    purely from the archive tables (no module lexicons consulted), proving the
    artifact is self-contained."""
    from funasr_tpu_torch.text.multilingual import _cjk_itn, _Lex, _word_itn

    archive = path_or_dict
    if isinstance(path_or_dict, str):
        with open(path_or_dict, encoding="utf-8") as f:
            archive = json.load(f)
    assert archive.get("format") == "funasr_tpu_itn_grammar", "bad archive"
    funcs: Dict[str, object] = {}
    for code, g in archive["languages"].items():
        if g["type"] == "word_lexicon" and code != "en":
            lex = _Lex({k: int(v) for k, v in g["ones"].items()},
                       {k: int(v) for k, v in g["tens"].items()},
                       list(g.get("hundred_words", [])),
                       {k: int(v) for k, v in g["scales"].items()},
                       joiners=list(g.get("joiners", [])),
                       hundreds_direct={k: int(v) for k, v in
                                        g.get("hundreds_direct", {}).items()},
                       x10_words=list(g.get("x10_words", [])))
            from funasr_tpu_torch.text import multilingual as _ml
            pre = {"de": getattr(_ml, "_de_pre", None),
                   "id": getattr(_ml, "_id_pre", None)}.get(g.get("pre"))
            funcs[code] = (lambda lx, pr:
                           lambda text: _word_itn(text, lx, pr))(lex, pre)
        elif g["type"] == "cjk":
            digits = {k: int(v) for k, v in g["digits"].items()}
            units = {k: int(v) for k, v in g["units"].items()}
            big = {k: int(v) for k, v in g["big"].items()}
            funcs[code] = (lambda d, u, b:
                           lambda text: _cjk_itn(text, d, u, b))(digits, units,
                                                                 big)
    return funcs
