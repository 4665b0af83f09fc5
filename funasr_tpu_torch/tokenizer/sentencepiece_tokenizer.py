"""SentencePiece tokenizer (counterpart of FunASR
``funasr/tokenizer/sentencepiece_tokenizer.py:12``; gated on the optional
``sentencepiece`` dependency, imported when the tokenizer is built).

Framework-free copy of ``funasr_tpu/tokenizer/sentencepiece_tokenizer.py``, registered
in the port's own ``tables``; SenseVoice's published config names it
(``chn_jpn_yue_eng_ko_spectok.bpe.model``). Held by ``tests/test_torch_ctc_family.py``,
which can only check the registration and the missing-package error while neither the
package nor a ``.model`` file is in the environment.
"""

from __future__ import annotations

from typing import Iterable, List

from funasr_tpu_torch.register import tables
from funasr_tpu_torch.tokenizer.char_tokenizer import BaseTokenizer


@tables.register("tokenizer_classes", "SentencepiecesTokenizer")
class SentencepiecesTokenizer(BaseTokenizer):
    def __init__(self, bpemodel: str, **kwargs):
        super().__init__(**kwargs)
        try:
            import sentencepiece as spm
        except ImportError as exc:  # pragma: no cover
            raise ImportError(
                "SentencepiecesTokenizer requires the 'sentencepiece' package") from exc
        self.bpemodel = bpemodel
        self.sp = spm.SentencePieceProcessor()
        self.sp.load(bpemodel)

    def text2tokens(self, line: str) -> List[str]:
        return self.sp.EncodeAsPieces(line)

    def tokens2text(self, tokens: Iterable[str]) -> str:
        return self.sp.DecodePieces(list(tokens))

    def encode(self, text: str) -> List[int]:
        if self.token_list:
            return super().encode(text)
        return self.sp.EncodeAsIds(text)

    def decode(self, ids) -> str:
        if self.token_list:
            return super().decode(ids)
        return self.sp.DecodeIds([int(i) for i in ids])
