"""Hugging Face tokenizer wrapper (a framework-free copy of
``funasr_tpu/tokenizer/hf_tokenizer.py``; FunASR ``funasr/tokenizer/hf_tokenizer.py:4``),
used by the LLM-ASR models. ``transformers`` is imported when the class is built, never
at import, so the package imports where ``transformers`` is absent."""

from __future__ import annotations

from typing import Iterable, List

from funasr_tpu_torch.register import tables


@tables.register("tokenizer_classes", "HuggingfaceTokenizer")
class HuggingfaceTokenizer:
    def __init__(self, init_param_path: str = None, pretrained_model_name_or_path: str = None,
                 **kwargs):
        from transformers import AutoTokenizer
        path = init_param_path or pretrained_model_name_or_path
        self.tokenizer = AutoTokenizer.from_pretrained(path, trust_remote_code=True)

    def get_vocab_size(self) -> int:
        return len(self.tokenizer)

    def encode(self, text: str) -> List[int]:
        return self.tokenizer.encode(text, add_special_tokens=False)

    def decode(self, ids) -> str:
        return self.tokenizer.decode([int(i) for i in ids])

    def ids2tokens(self, ids) -> List[str]:
        return self.tokenizer.convert_ids_to_tokens([int(i) for i in ids])

    def tokens2text(self, tokens: Iterable[str]) -> str:
        return self.tokenizer.convert_tokens_to_string(list(tokens))

    def text2tokens(self, line: str) -> List[str]:
        return self.tokenizer.tokenize(line)
