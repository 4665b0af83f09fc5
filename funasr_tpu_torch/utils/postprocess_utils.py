"""Text detokenization / postprocessing.

Behavioral port of the reference rules (FunASR ``funasr/utils/postprocess_utils.py``:
``sentence_postprocess:165`` — zh chars joined bare, en BPE '@@' merge + space join,
mixed-script handling; ``abbr_dispose:71`` — single-letter runs "i b m" -> "IBM").
Fresh implementation structured around an explicit word/timestamp zip.

Framework-free copy of ``funasr_tpu/utils/postprocess_utils.py`` (the
``sentence_postprocess`` text join and its helpers, held to the original by
``tests/test_torch_frontend.py``; SenseVoice's ``rich_transcription_postprocess`` with its
tag tables, held by ``tests/test_torch_ctc_family.py``).
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

_DROP_TOKENS = {"<s>", "</s>", "<unk>", "<OOV>"}


def is_chinese_char(ch: str) -> bool:
    # The reference treats CJK, ASCII digits and '@' as "Chinese" for script routing.
    return "一" <= ch <= "鿿" or "0" <= ch <= "9" or ch == "@"


def _clean(tok: str) -> str:
    out = tok.replace(" ", "")
    for t in _DROP_TOKENS:
        out = out.replace(t, "")
    return out


def is_all_chinese(tokens) -> bool:
    cleaned = [_clean(t) for t in tokens]
    if not cleaned:
        return False
    return all(all(is_chinese_char(c) for c in t) or t == "" for t in cleaned) and all(
        is_chinese_char(c) for t in cleaned for c in t
    ) if any(cleaned) else False


def is_all_alpha(tokens) -> bool:
    cleaned = [_clean(t) for t in tokens]
    if not cleaned:
        return False
    for t in cleaned:
        for c in t:
            if not (c.isalpha() or c == "'"):
                return False
            if c.isalpha() and is_chinese_char(c):
                return False
    return True


def abbr_dispose(words: List[str], time_stamp: Optional[List[List[int]]] = None):
    """Merge spelled-out abbreviations: runs of >=2 single ASCII letters separated by
    single spaces become one uppercased word ("i b m" -> "IBM")."""
    n = len(words)
    # map word index -> timestamp index (spaces don't consume a timestamp)
    ts_num = []
    ti = 0
    for w in words:
        ts_num.append(ti)
        if w != " ":
            ti += 1

    def is_single_alpha(i):
        return i < n and len(words[i]) == 1 and words[i].encode("utf-8").isalpha()

    out: List[str] = []
    out_ts: List[List[int]] = []
    i = 0
    while i < n:
        if is_single_alpha(i) and i + 2 < n and words[i + 1] == " " and is_single_alpha(i + 2):
            # run of single letters
            letters = [i]
            j = i + 2
            while True:
                letters.append(j)
                if j + 2 < n and words[j + 1] == " " and is_single_alpha(j + 2):
                    j += 2
                else:
                    break
            merged = "".join(words[k].upper() for k in letters)
            out.append(merged)
            if time_stamp is not None:
                beg = time_stamp[ts_num[letters[0]]][0]
                end_idx = min(ts_num[letters[-1]], len(time_stamp) - 1)
                out_ts.append([beg, time_stamp[end_idx][1]])
            i = j + 1
        else:
            out.append(words[i])
            if time_stamp is not None and words[i] != " " and ts_num[i] < len(time_stamp):
                out_ts.append(list(time_stamp[ts_num[i]]))
            i += 1
    if time_stamp is not None:
        return out, out_ts
    return out


def sentence_postprocess(words: List[Any], time_stamp: Optional[List[List[int]]] = None):
    """tokens -> (text[, timestamps], word list). Mirrors the reference contract."""
    toks: List[str] = []
    for w in words:
        s = w if isinstance(w, str) else w.decode("utf-8")
        if s in _DROP_TOKENS:
            continue
        toks.append(s)

    word_lists: List[str] = []
    ts_lists: List[List[int]] = []

    if is_all_chinese(toks):
        word_lists = [t.replace(" ", "") for t in toks]
        if time_stamp is not None:
            ts_lists = [list(t) for t in time_stamp[: len(word_lists)]]
    else:
        # en / mixed: merge '@@' BPE pieces; en words get a trailing space marker
        item = ""
        beg = -1
        pending_beg: Optional[int] = None
        alpha_blank = False
        all_alpha = is_all_alpha(toks)
        for i, ch in enumerate(toks):
            ts = time_stamp[i] if (time_stamp is not None and i < len(time_stamp)) else None
            if "@@" in ch:
                if pending_beg is None and ts is not None:
                    pending_beg = ts[0]
                item += ch.replace("@@", "")
                alpha_blank = False
            elif all_alpha or is_all_alpha([ch]):
                if pending_beg is None and ts is not None:
                    pending_beg = ts[0]
                item += ch
                word_lists.append(item)
                word_lists.append(" ")
                item = ""
                alpha_blank = True
                if ts is not None:
                    ts_lists.append([pending_beg, ts[1]])
                    pending_beg = None
            elif is_all_chinese([ch]):
                if alpha_blank:
                    word_lists.pop()  # drop trailing space before zh char
                word_lists.append(ch)
                alpha_blank = False
                if ts is not None:
                    ts_lists.append([ts[0] if pending_beg is None else pending_beg, ts[1]])
                    pending_beg = None
            else:
                word_lists.append(ch)
                alpha_blank = False

    if time_stamp is not None:
        word_lists, ts_lists = abbr_dispose(word_lists, ts_lists)
        real_words = [w for w in word_lists if w != " "]
        sentence = " ".join(real_words).strip()
        return sentence, ts_lists, real_words

    word_lists = abbr_dispose(word_lists)
    real_words = [w for w in word_lists if w != " "]
    sentence = "".join(word_lists).strip()
    return sentence, real_words


# ---------------------------------------------------------------------------
# SenseVoice rich-transcription tags
# ---------------------------------------------------------------------------

EMO_DICT = {
    "<|HAPPY|>": "😊", "<|SAD|>": "😔", "<|ANGRY|>": "😡", "<|NEUTRAL|>": "",
    "<|FEARFUL|>": "😰", "<|DISGUSTED|>": "🤢", "<|SURPRISED|>": "😮",
}
EVENT_DICT = {
    "<|BGM|>": "🎼", "<|Speech|>": "", "<|Applause|>": "👏", "<|Laughter|>": "😀",
    "<|Cry|>": "😭", "<|Sneeze|>": "🤧", "<|Breath|>": "", "<|Cough|>": "🤧",
}
_OTHER_TAGS = {
    "<|zh|>", "<|en|>", "<|yue|>", "<|ja|>", "<|ko|>", "<|nospeech|>",
    "<|quhe|>", "<|unknown|>", "<|interjection|>",
    "<|withitn|>", "<|woitn|>", "<|wo_itn|>", "<|Event_UNK|>", "<|SPECIAL_TOKEN_1|>",
}


def rich_transcription_postprocess(s: str) -> str:
    """Strip/replace SenseVoice ``<|tag|>`` markup with emoji, merging per-segment
    (behavior of reference ``rich_transcription_postprocess:436``)."""

    def replace_tags(text: str) -> str:
        for tag, emoji in {**EMO_DICT, **EVENT_DICT}.items():
            text = text.replace(tag, emoji)
        for tag in _OTHER_TAGS:
            text = text.replace(tag, "")
        return text

    segments = [seg for seg in s.split("<|withitn|>")]
    out = "".join(replace_tags(seg) for seg in segments)
    return out.strip()
