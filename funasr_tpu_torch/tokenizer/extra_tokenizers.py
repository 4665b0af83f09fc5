"""Additional tokenizers, a framework-free copy of ``funasr_tpu/tokenizer/extra_tokenizers.py``
(FunASR ``funasr/tokenizer/``: ``phoneme_tokenizer.py:458`` PhonemeTokenizer,
WordTokenizer, TokenIDConverter, ``cleaner.py`` text cleaners, the whisper / SenseVoice
tiktoken tokenizers, gated on ``tiktoken`` or a local Hugging Face tokenizer directory;
``transformers`` and ``tiktoken`` are imported when a tokenizer is built, never at
import)."""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from funasr_tpu_torch.register import tables
from funasr_tpu_torch.tokenizer.char_tokenizer import BaseTokenizer


@tables.register("tokenizer_classes", "WordTokenizer")
class WordTokenizer(BaseTokenizer):
    def __init__(self, delimiter: Optional[str] = None, **kwargs):
        super().__init__(**kwargs)
        self.delimiter = delimiter

    def text2tokens(self, line: str) -> List[str]:
        return line.split(self.delimiter)

    def tokens2text(self, tokens: Iterable[str]) -> str:
        return (self.delimiter or " ").join(tokens)


@tables.register("tokenizer_classes", "PhonemeTokenizer")
class PhonemeTokenizer(BaseTokenizer):
    """Lexicon-based grapheme->phoneme tokenizer: words map through a pronunciation
    dict (word -> space-separated phones); OOV words fall back per-char."""

    def __init__(self, g2p_type: Optional[str] = None,
                 lexicon_file: Optional[str] = None, **kwargs):
        super().__init__(**kwargs)
        self.lexicon: Dict[str, List[str]] = {}
        if lexicon_file:
            with open(lexicon_file, encoding="utf-8") as f:
                for line in f:
                    parts = line.strip().split()
                    if len(parts) >= 2:
                        self.lexicon[parts[0].lower()] = parts[1:]

    def text2tokens(self, line: str) -> List[str]:
        out: List[str] = []
        for word in line.strip().split():
            out.extend(self.lexicon.get(word.lower(), list(word)))
        return out

    def tokens2text(self, tokens: Iterable[str]) -> str:
        return " ".join(tokens)


class TokenIDConverter:
    """token list <-> ids (reference ``token_id_converter.py`` contract)."""

    def __init__(self, token_list, unk_symbol: str = "<unk>"):
        if isinstance(token_list, str):
            with open(token_list, encoding="utf-8") as f:
                token_list = [line.rstrip("\n") for line in f]
        self.token_list = list(token_list)
        self.token2id = {t: i for i, t in enumerate(self.token_list)}
        self.unk_id = self.token2id.get(unk_symbol, 0)

    def get_num_vocabulary_size(self) -> int:
        return len(self.token_list)

    def ids2tokens(self, ids) -> List[str]:
        return [self.token_list[int(i)] for i in ids]

    def tokens2ids(self, tokens: Iterable[str]) -> List[int]:
        return [self.token2id.get(t, self.unk_id) for t in tokens]


@tables.register("tokenizer_classes", "WhisperTokenizer")
@tables.register("tokenizer_classes", "SenseVoiceTokenizer")
class WhisperTokenizer:
    """tiktoken-based whisper/SenseVoice tokenizer (reference
    ``whisper_tokenizer.py:4,30``); requires the optional ``tiktoken`` package or a
    local HF tokenizer directory via ``hf_tokenizer_path``."""

    def __init__(self, vocab_path: Optional[str] = None, is_multilingual: bool = True,
                 num_languages: int = 100, hf_tokenizer_path: Optional[str] = None,
                 **kwargs):
        self._hf = None
        if hf_tokenizer_path:
            from transformers import AutoTokenizer
            self._hf = AutoTokenizer.from_pretrained(hf_tokenizer_path)
            return
        try:
            import tiktoken  # noqa: F401
        except ImportError as exc:
            raise ImportError(
                "WhisperTokenizer needs 'tiktoken' or pass hf_tokenizer_path") from exc

    def encode(self, text: str) -> List[int]:
        return self._hf.encode(text, add_special_tokens=False)

    def decode(self, ids) -> str:
        return self._hf.decode([int(i) for i in ids])

    def ids2tokens(self, ids) -> List[str]:
        return self._hf.convert_ids_to_tokens([int(i) for i in ids])

    def get_vocab_size(self) -> int:
        return len(self._hf)


# text cleaners (reference ``cleaner.py`` contract)
def basic_cleaner(text: str) -> str:
    return " ".join(text.strip().split())


def whisper_basic_cleaner(text: str) -> str:
    import re
    text = re.sub(r"[<\[][^>\]]*[>\]]", "", text)  # drop bracketed tags
    text = re.sub(r"\s+", " ", text)
    return text.strip().lower()
