"""Word splitting helpers for punctuation restoration, copied from
``funasr_tpu/models/ct_transformer/utils.py`` (behavioural port of FunASR
``funasr/models/ct_transformer/utils.py``: char-level zh split with ASCII word grouping,
20-word mini-sentence slicing; the jieba user-dict path is taken only when jieba is
installed and a dict is given)."""

from __future__ import annotations

import re
from typing import List


def split_to_mini_sentence(words: list, word_limit: int = 20) -> List[list]:
    assert word_limit > 1
    if len(words) <= word_limit:
        return [words]
    out = [words[i * word_limit: (i + 1) * word_limit]
           for i in range(len(words) // word_limit)]
    if len(words) % word_limit:
        out.append(words[(len(words) // word_limit) * word_limit:])
    return out


_EN_RE = re.compile(r"^[a-zA-Z']+$")


def is_english_word(text: str) -> bool:
    return bool(_EN_RE.search(text))


def split_words(text: str, jieba_usr_dict=None, **kwargs) -> List[str]:
    """Whitespace-split, then: ASCII runs stay words, CJK splits per char.

    With a jieba user dict (optional dependency), Chinese spans are word-segmented
    instead (reference behavior); without jieba we fall back to char-level, which is
    what the shipped zh punc models expect anyway (CharTokenizer vocab).
    """
    if jieba_usr_dict is not None:
        chunks: List[List[str]] = []
        langs: List[str] = []
        cur: List[str] = []
        flag = None
        for token in text.split():
            lang = "English" if is_english_word(token) else "Chinese"
            if flag is not None and lang != flag:
                chunks.append(cur)
                langs.append(flag)
                cur = []
            cur.append(token)
            flag = lang
        if cur:
            chunks.append(cur)
            langs.append(flag)
        result: List[str] = []
        for chunk, lang in zip(chunks, langs):
            if lang == "English":
                result.extend(chunk)
            else:
                joined = ""
                for tok in chunk:
                    joined = (joined + " " + tok) if is_english_word(tok) else joined + tok
                result.extend(jieba_usr_dict.cut(joined.strip(), HMM=False))
        return result

    words: List[str] = []
    for seg in text.split():
        current = ""
        for ch in seg:
            if len(ch.encode()) == 1:
                current += ch
            else:
                if current:
                    words.append(current)
                    current = ""
                words.append(ch)
        if current:
            words.append(current)
    return words
