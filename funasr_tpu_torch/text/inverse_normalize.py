"""Inverse text normalization API (counterpart of FunASR
``fun_text_processing/inverse_text_normalization/inverse_normalize.py:13-40``).

The reference builds pynini WFST taggers/verbalizers per language; this rebuild uses
deterministic rule engines per language (all 12 reference languages: zh/en full
grammars, ja/ko CJK positional numbers, de/es/fr/pt/ru/id/vi/tl word-lexicon
cardinals via :mod:`funasr_tpu_torch.text.multilingual`). Same class surface:
``InverseNormalizer(lang="zh").inverse_normalize(text, verbose=False)``.
"""

from __future__ import annotations

import logging

from funasr_tpu_torch.text.en_numbers import inverse_normalize_en
from funasr_tpu_torch.text.multilingual import ITN_FUNCS
from funasr_tpu_torch.text.zh_numbers import inverse_normalize_zh, normalize_zh

_SUPPORTED = {"zh", "en"} | set(ITN_FUNCS)
_KNOWN = {"de", "en", "es", "fr", "id", "ja", "ko", "pt", "ru", "tl", "vi", "zh"}


class InverseNormalizer:
    def __init__(self, lang: str = "zh", cache_dir: str = None,
                 overwrite_cache: bool = False, whitelist=None, **kwargs):
        """``whitelist``: extra spoken->written entries applied after the
        language grammar — a dict, or a path to a TSV in the reference's
        ``data/whitelist.tsv`` format (``written<TAB>spoken`` rows). This is
        the user-extensible whitelist role of the reference's per-language
        data files (they are data, not grammar code)."""
        if lang not in _KNOWN:
            raise ValueError(f"unknown language {lang}; known: {sorted(_KNOWN)}")
        if lang not in _SUPPORTED:
            logging.warning("ITN rules for '%s' not yet implemented; "
                            "passing text through unchanged", lang)
        self.lang = lang
        self.whitelist = {}
        if whitelist is not None:
            from funasr_tpu_torch.text.electronic import parse_whitelist_tsv
            self.whitelist = (dict(whitelist) if isinstance(whitelist, dict)
                              else parse_whitelist_tsv(whitelist))

    def inverse_normalize(self, text: str, verbose: bool = False) -> str:
        if self.lang == "zh":
            out = inverse_normalize_zh(text)
        elif self.lang == "en":
            out = inverse_normalize_en(text)
        elif self.lang in ITN_FUNCS:
            out = ITN_FUNCS[self.lang](text)
        else:
            out = text
        if self.whitelist:
            from funasr_tpu_torch.text.electronic import (_CJK_LANGS,
                                                    apply_whitelist_table)
            out = apply_whitelist_table(out, self.whitelist,
                                        cjk=self.lang in _CJK_LANGS)
        if verbose:
            print(out)
        return out

    def inverse_normalize_list(self, texts, verbose: bool = False):
        return [self.inverse_normalize(t, verbose) for t in texts]


class Normalizer:
    """Text normalization (written -> spoken), reference
    ``fun_text_processing/text_normalization/normalize.py``."""

    def __init__(self, input_case: str = "cased", lang: str = "zh", **kwargs):
        self.lang = lang

    def normalize(self, text: str, verbose: bool = False) -> str:
        from funasr_tpu_torch.text.zh_en_tn import TN_FUNCS as _FULL_TN
        if self.lang in _FULL_TN:
            # full class-based grammars (date/time/percent/fraction/money/
            # ordinal/decimal/phone; ref cn_tn.py + en TN grammar set)
            out = _FULL_TN[self.lang](text)
        elif self.lang in ("de", "es", "ru"):
            # class-based grammars: time/date/money/measure/percent/decimal/
            # ordinal/telephone/cardinal (reference
            # fun_text_processing/text_normalization/{de,es,ru}/taggers/)
            from funasr_tpu_torch.text.multilingual_tn import TN_CLASS_FUNCS
            out = TN_CLASS_FUNCS[self.lang](text)
        else:
            import re
            from funasr_tpu_torch.text.en_numbers import ONES, TENS

            def spell(m):
                n = int(m.group(0))
                inv_ones = {v: k for k, v in ONES.items()}
                inv_tens = {v: k for k, v in TENS.items()}
                if n < 20:
                    return inv_ones[n]
                if n < 100:
                    t, o = divmod(n, 10)
                    return inv_tens[t * 10] + (f" {inv_ones[o]}" if o else "")
                return m.group(0)
            out = re.sub(r"\d+", spell, text)
        if verbose:
            print(out)
        return out

    def normalize_list(self, texts, verbose: bool = False):
        return [self.normalize(t, verbose) for t in texts]
