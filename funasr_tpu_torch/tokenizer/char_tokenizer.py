"""Character tokenizer (zh char-level + seg_dict BPE-for-english hybrid).

Behavioral port of the reference (FunASR ``funasr/tokenizer/char_tokenizer.py:12`` and
``abs_tokenizer.py`` BaseTokenizer: token_list from .txt/.json/iterable, encode/decode
through token<->id maps, seg_dict word->BPE mapping for latin words).

Framework-free copy of ``funasr_tpu/tokenizer/char_tokenizer.py`` registered in the
port's own ``tables``, held to the original by ``tests/test_torch_frontend.py``.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Union

from funasr_tpu_torch.register import tables


class BaseTokenizer:
    def __init__(self, token_list: Union[Path, str, Iterable[str], None] = None,
                 unk_symbol: str = "<unk>", **kwargs):
        self.token_list: List[str] = []
        if token_list is not None:
            if isinstance(token_list, (Path, str)) and str(token_list).endswith(".txt"):
                with open(token_list, "r", encoding="utf-8") as f:
                    self.token_list = [line.rstrip("\n") for line in f]
            elif isinstance(token_list, (Path, str)) and str(token_list).endswith(".json"):
                with open(token_list, "r", encoding="utf-8") as f:
                    self.token_list = json.load(f)
            else:
                self.token_list = list(token_list)
            self.token2id: Dict[str, int] = {}
            for i, t in enumerate(self.token_list):
                if t in self.token2id:
                    raise RuntimeError(f'Symbol "{t}" is duplicated')
                self.token2id[t] = i
            self.unk_symbol = unk_symbol
            if unk_symbol not in self.token2id:
                raise RuntimeError(f"Unknown symbol '{unk_symbol}' not in token_list")
            self.unk_id = self.token2id[unk_symbol]

    def get_vocab_size(self) -> int:
        return len(self.token_list)

    def ids2tokens(self, ids) -> List[str]:
        return [self.token_list[int(i)] for i in ids]

    def tokens2ids(self, tokens: Iterable[str]) -> List[int]:
        return [self.token2id.get(t, self.unk_id) for t in tokens]

    def encode(self, text: str) -> List[int]:
        return self.tokens2ids(self.text2tokens(text))

    def decode(self, ids) -> str:
        return self.tokens2text(self.ids2tokens(ids))

    def text2tokens(self, line: str) -> List[str]:
        raise NotImplementedError

    def tokens2text(self, tokens: Iterable[str]) -> str:
        raise NotImplementedError


def load_seg_dict(seg_dict_file: str) -> Dict[str, str]:
    seg = {}
    with open(seg_dict_file, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split()
            if parts:
                seg[parts[0]] = " ".join(parts[1:])
    return seg


_SEG_PATTERN = re.compile(r"([一-龥A-Za-z0-9])")


def seg_tokenize(words: List[str], seg_dict: Dict[str, str]) -> List[str]:
    """Word list -> BPE pieces via seg_dict; unknown latin words fall back per-char."""
    out = []
    for word in words:
        word = word.lower()
        if word in seg_dict:
            out.extend(seg_dict[word].split())
        elif _SEG_PATTERN.match(word):
            for ch in word:
                out.extend(seg_dict[ch].split() if ch in seg_dict else ["<unk>"])
        else:
            out.append("<unk>")
    return out


@tables.register("tokenizer_classes", "CharTokenizer")
class CharTokenizer(BaseTokenizer):
    def __init__(self, non_linguistic_symbols=None, space_symbol: str = "<space>",
                 remove_non_linguistic_symbols: bool = False,
                 split_with_space: bool = False, seg_dict: Optional[str] = None,
                 **kwargs):
        super().__init__(**kwargs)
        self.space_symbol = space_symbol
        if non_linguistic_symbols is None:
            self.non_linguistic_symbols = set()
        elif isinstance(non_linguistic_symbols, (Path, str)):
            try:
                with open(non_linguistic_symbols, "r", encoding="utf-8") as f:
                    self.non_linguistic_symbols = {line.rstrip() for line in f}
            except FileNotFoundError:
                self.non_linguistic_symbols = set()
        else:
            self.non_linguistic_symbols = set(non_linguistic_symbols)
        self.remove_non_linguistic_symbols = remove_non_linguistic_symbols
        self.split_with_space = split_with_space
        seg_dict = seg_dict or kwargs.get("seg_dict_file")
        self.seg_dict = load_seg_dict(seg_dict) if seg_dict else None

    def text2tokens(self, line: str) -> List[str]:
        if self.seg_dict is not None:
            return seg_tokenize(line.strip().split(" "), self.seg_dict)
        tokens: List[str] = []
        while line:
            for sym in self.non_linguistic_symbols:
                if line.startswith(sym):
                    if not self.remove_non_linguistic_symbols:
                        tokens.append(line[: len(sym)])
                    line = line[len(sym):]
                    break
            else:
                ch, line = line[0], line[1:]
                if ch != " ":
                    tokens.append(ch)
        return tokens

    def tokens2text(self, tokens: Iterable[str]) -> str:
        return "".join(" " if t == self.space_symbol else t for t in tokens)
