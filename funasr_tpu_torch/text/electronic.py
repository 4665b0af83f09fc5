"""Electronic (email/URL) + whitelist ITN classes, all languages.

Counterpart of the reference per-language taggers
``fun_text_processing/inverse_text_normalization/<lang>/taggers/electronic.py``
("c d f 1 at a b c dot e d u" -> "cdf1@abc.edu"; "www a b c dot com" ->
"www.abc.com") and ``.../taggers/whitelist.py`` (spoken phrase -> written
abbreviation, e.g. en "doctor" -> "dr.").

The algorithm is deliberately word-for-word identical to the C++
grammar-archive interpreter (``itn-grammar.cc`` ElectronicPass /
WhitelistPass) so the exported archive yields byte-identical output in both
runtimes:

* email: an at-word with a username before it (either a run of single-char
  spelled tokens, or one whole word) and ``domain (dot segment)+`` after it;
* url: a ``www`` token followed by ``(dot segment)+``;
* unspaced (CJK) text: the same shapes matched on byte literals.

Usernames/domains are lowercased ASCII ``[a-z0-9]`` tokens that are not
themselves at/dot words.
"""

from __future__ import annotations

import re
from typing import Dict, List

# spoken at/dot words per language (reference electronic taggers: de uses
# "at"/"punkt", es "arroba"/"punto", fr arobase|chez|at|à / "point",
# pt "arroba"/"ponto", ru "собака"/"точка", id/ja/ko borrow "at"/"dot" with
# native dot words ドット/점; vi "a còng"/"chấm")
ELECTRONIC_WORDS: Dict[str, Dict[str, List[str]]] = {
    "en": {"at": ["at"], "dot": ["dot"]},
    "de": {"at": ["at"], "dot": ["punkt"]},
    "es": {"at": ["arroba"], "dot": ["punto"]},
    "fr": {"at": ["arobase", "chez", "at", "à"], "dot": ["point"]},
    "pt": {"at": ["arroba"], "dot": ["ponto"]},
    "ru": {"at": ["собака"], "dot": ["точка"]},
    "id": {"at": ["at"], "dot": ["dot", "titik"]},
    "vi": {"at": ["a còng", "at"], "dot": ["chấm", "dot"]},
    "ja": {"at": ["アットマーク", "アット", "at"], "dot": ["ドット", "dot"]},
    # 골뱅2 = deterministic image of 골뱅이 after the ko cardinal pass (이->2)
    "ko": {"at": ["골뱅이", "골뱅2", "at"], "dot": ["닷", "dot"]},
    "zh": {"at": ["艾特", "at"], "dot": ["点", "dot"]},
}

# spoken phrase -> written form (reference data/whitelist.tsv per language;
# curated to the unambiguous entries)
WHITELIST: Dict[str, Dict[str, str]] = {
    "en": {"misses": "mrs.", "mister": "mr.", "doctor": "dr.",
           "saint": "st.", "for example": "e.g.",
           "seven eleven": "7-eleven"},
    "es": {"usted": "ud.", "ustedes": "uds."},
    "fr": {"monsieur": "M.", "messieurs": "MM.", "madame": "Mme",
           "mesdames": "Mmes", "mademoiselle": "Mlle", "docteur": "Dr"},
    "de": {"doktor": "Dr.", "das heißt": "d. h."},
    "pt": {"senhor": "sr.", "senhora": "sra.", "doutor": "dr.",
           "doutora": "dra."},
    "ru": {"то есть": "т. е.", "так далее": "т. д."},
    "ja": {"セブンイレブン": "7-eleven", "例えば": "e.g."},
    "ko": {"세븐일레븐": "7-eleven"},
    # id/data/whitelist.tsv rows (reference column order written<TAB>spoken)
    "id": {"misalnya": "e.g.", "dokter": "dr.", "tuan": "mr.",
           "santo": "st."},
    "vi": {"tiến sĩ": "TS.", "bác sĩ": "BS."},
    "tl": {"doktor": "dr.", "ginoo": "g.", "ginang": "gng."},
}

_CJK_LANGS = ("ja", "ko", "zh")


def add_whitelist(lang: str, mapping: Dict[str, str]) -> None:
    """Extend a language's whitelist with ``{spoken: written}`` entries
    (reference role: the per-language ``data/whitelist.tsv`` files are
    user-extensible data, not code)."""
    WHITELIST.setdefault(lang, {}).update(mapping)


def parse_whitelist_tsv(path: str) -> Dict[str, str]:
    """Read a whitelist TSV in the reference's column order —
    ``written<TAB>spoken`` per row (see
    FunASR's ``fun_text_processing/inverse_text_normalization/<lang>/
    data/whitelist.tsv``: "e.g.\\tfor example") — into {spoken: written}."""
    table: Dict[str, str] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            parts = line.split("\t")
            if len(parts) >= 2 and parts[0] and parts[1]:
                table[parts[1]] = parts[0]
    return table


def load_whitelist_tsv(lang: str, path: str) -> None:
    """Load a reference-format whitelist TSV into the global table."""
    add_whitelist(lang, parse_whitelist_tsv(path))


def apply_whitelist_table(text: str, table: Dict[str, str],
                          cjk: bool = False) -> str:
    """Apply one spoken->written table (longest-phrase-first; token-boundary
    + case-insensitive for spaced scripts, substring for CJK)."""
    if not table:
        return text
    if cjk:
        for spoken in sorted(table, key=lambda s: (-len(s), s)):
            text = text.replace(spoken, table[spoken])
        return text
    for spoken in sorted(table,
                         key=lambda s: (-len(s.split()), -len(s), s)):
        pat = re.compile(r"(?<![A-Za-z0-9])" + re.escape(spoken)
                         + r"(?![A-Za-z0-9])", re.IGNORECASE)
        text = pat.sub(table[spoken], text)
    return text


def _wordy(tok: str, reserved) -> bool:
    # ASCII-only by spec (usernames/domains are [a-z0-9]) — keeps the pass
    # byte-portable to the C++ interpreter
    return (bool(tok) and tok.isascii() and tok.isalnum()
            and tok.lower() not in reserved)


def _seg_end(tokens, k: int, reserved) -> int:
    """A FINAL segment is EITHER a run of single-char spelled tokens
    ("a b c" -> abc) OR exactly one multi-char word ("gmail") — never a
    greedy multi-word run (so trailing prose is not swallowed into a
    domain). Middle segments (terminated by an explicit dot word) ARE
    greedy — see :func:`_parse_chain`."""
    n = len(tokens)
    if k >= n or not _wordy(tokens[k], reserved):
        return k
    if len(tokens[k]) == 1:
        j = k
        while j < n and len(tokens[j]) == 1 and _wordy(tokens[j], reserved):
            j += 1
        return j
    return k + 1


def _parse_chain(tokens, k: int, reserved, dot, allow_empty_first=False):
    """Parse a ``seg (DOT seg)+`` chain at ``k``: middle segments are greedy
    runs of wordy tokens ("g mail dot com" -> gmail.com — safe because they
    terminate at an explicit dot word), the final segment stays conservative
    (:func:`_seg_end`). ``allow_empty_first`` admits ``(DOT seg)+`` with no
    initial segment ("www dot abc ..."). Returns the last VALID state
    ``(segments, end_index)`` — a trailing dot word with no segment after it
    is left unconsumed — or ``None`` when no ``seg dot seg`` core exists."""
    n = len(tokens)
    segs: List[str] = []
    best = None
    ndots = 0
    first = True
    while True:
        j = k
        while j < n and _wordy(tokens[j], reserved):
            j += 1
        if j == k and not (first and allow_empty_first and j < n
                           and tokens[j].lower() in dot):
            break
        first = False
        if j < n and tokens[j].lower() in dot:
            if j > k:
                segs.append("".join(t.lower() for t in tokens[k:j]))
                if ndots >= 1:
                    best = (list(segs), j)
            k = j + 1
            ndots += 1
        else:
            k2 = _seg_end(tokens, k, reserved)
            if k2 > k:
                segs.append("".join(t.lower() for t in tokens[k:k2]))
                if ndots >= 1:
                    best = (list(segs), k2)
            break
    return best


def _electronic_spaced(text: str, at_words, dot_words) -> str:
    at = {w.lower() for w in at_words}
    dot = {w.lower() for w in dot_words}
    reserved = at | dot
    tokens = text.split(" ")
    n = len(tokens)
    out: List[str] = []
    i = 0
    while i < n:
        low = tokens[i].lower()
        # email: ... user AT seg (DOT seg)+
        if low in at:
            # username: run of single-char spelled tokens, else one word
            j = len(out)
            while j > 0 and len(out[j - 1]) == 1 and _wordy(out[j - 1],
                                                           reserved):
                j -= 1
            if j == len(out) and out and _wordy(out[-1], reserved):
                j = len(out) - 1
            user = [t.lower() for t in out[j:]]
            chain = _parse_chain(tokens, i + 1, reserved, dot)
            if user and chain is not None:
                domain, k = chain
                del out[j:]
                out.append("".join(user) + "@" + ".".join(domain))
                i = k
                continue
        # url: www [seg] (DOT seg)+
        if low == "www":
            chain = _parse_chain(tokens, i + 1, reserved, dot,
                                 allow_empty_first=True)
            if chain is not None:
                segs, k = chain
                out.append(".".join(["www"] + segs))
                i = k
                continue
        out.append(tokens[i])
        i += 1
    return " ".join(out)


def _electronic_unspaced(text: str, at_words, dot_words) -> str:
    # CJK byte-literal shapes: user AT domain (DOT seg)+ with latin segments
    at_alt = "|".join(re.escape(w) for w in at_words if not w.isascii())
    dot_alt = "|".join(re.escape(w) for w in dot_words if not w.isascii())
    if not at_alt or not dot_alt:
        return text
    pat = re.compile(r"([a-zA-Z0-9]+)(?:" + at_alt + r")([a-zA-Z0-9]+)"
                     r"((?:(?:" + dot_alt + r")[a-zA-Z0-9]+)+)")

    def repl(m):
        tail = m.group(3)
        for w in dot_words:
            tail = tail.replace(w, ".")
        return (m.group(1).lower() + "@" + m.group(2).lower()
                + tail.lower())

    return pat.sub(repl, text)


def apply_electronic(lang: str, text: str) -> str:
    words = ELECTRONIC_WORDS.get(lang)
    if not words:
        return text
    # multi-word at/dot phrases ("a còng") become single tokens for the
    # token-level pass (same pre-join in the C++ interpreter)
    at, dot = list(words["at"]), list(words["dot"])
    for bucket in (at, dot):
        for idx, w in enumerate(bucket):
            if " " in w:
                joined = w.replace(" ", "▁")
                text = text.replace(w, joined)
                bucket[idx] = joined
    out = _electronic_spaced(text, at, dot)
    if lang in ("ja", "ko", "zh"):
        out = _electronic_unspaced(out, at, dot)
    return out.replace("▁", " ")


def apply_whitelist(lang: str, text: str) -> str:
    return apply_whitelist_table(text, WHITELIST.get(lang) or {},
                                 cjk=lang in _CJK_LANGS)
