"""LCB-Net in PyTorch: long-context biasing AED ASR (counterpart of
``funasr_tpu/models/lcbnet/model.py``; FunASR ``funasr/models/lcbnet/model.py:28``).

A Conformer AED (the ``Transformer`` model, ``ConformerEncoder`` by default) plus the
biasing stack: ``ocr_text`` (a string through the tokenizer, or ids; non-zero ids shifted
by 1 under ``insert_blank``, FunASR ``inference:520``) runs through
``TransformerTextEncoder``; ``FusionSANEncoder`` fuses it into the encoder output, which
takes the sum (``fuse_ocr``, FunASR ``inference:517-533``) before the beam search.
``bias_scores`` gives ``ConvBiasPredictor``'s per-OCR-token logits; neither the decode
nor the loss reads them, and ``forward`` is ``Transformer.forward`` (FunASR's loss does not
touch the bias stack). The beam search takes ``beam_size`` and the length ratios; JAX's
``LCBNet.inference`` passes no ``lm`` or ``hotword``, and neither does this one.
"""

from __future__ import annotations

from typing import Optional

import torch

import funasr_tpu_torch.models.conformer.encoder  # noqa: F401 (registers ConformerEncoder)
import funasr_tpu_torch.models.lcbnet.encoder  # noqa: F401 (registers the aux encoders)
from funasr_tpu_torch.core.module import init_weights
from funasr_tpu_torch.models.transformer.model import Transformer
from funasr_tpu_torch.register import tables


@tables.register("model_classes", "LCBNet")
class LCBNet(Transformer):
    """-> {"key", "text"}: the beam-searched transcript, biased toward ``ocr_text``."""

    def __init__(self, encoder: str = "ConformerEncoder", encoder_conf=None,
                 text_encoder: str = "TransformerTextEncoder", text_encoder_conf=None,
                 fusion_encoder: str = "FusionSANEncoder", fusion_encoder_conf=None,
                 bias_predictor: str = "ConvBiasPredictor", bias_predictor_conf=None,
                 select_num: int = 2, select_length: int = 3, insert_blank: bool = True,
                 device=None, generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__(encoder=encoder, encoder_conf=encoder_conf, device=device, **kwargs)
        enc_out = self.encoder.output_size()
        tconf = dict(text_encoder_conf or {})
        tconf.setdefault("output_size", enc_out)
        self.text_encoder = tables.encoder_classes[text_encoder](
            vocab_size=self.vocab_size, device=device, **tconf)
        fconf = dict(fusion_encoder_conf or {})
        fconf.setdefault("size", enc_out)
        fconf.setdefault("attention_dim", enc_out)
        self.fusion_encoder = tables.encoder_classes[fusion_encoder](device=device, **fconf)
        bconf = dict(bias_predictor_conf or {})
        bconf.setdefault("size", enc_out)
        self.bias_predictor = tables.encoder_classes[bias_predictor](device=device, **bconf)
        self.select_num = select_num
        self.select_length = select_length
        self.insert_blank = insert_blank
        if generator is not None:
            init_weights(self, generator)

    def _text_memory(self, ocr_ids, ocr_lengths=None):
        if ocr_lengths is None:
            ocr_lengths = torch.full((ocr_ids.shape[0],), ocr_ids.shape[1],
                                     dtype=torch.int32, device=ocr_ids.device)
        return self.text_encoder(ocr_ids, ocr_lengths)[0]

    def fuse_ocr(self, encoder_out, ocr_ids, ocr_lengths=None):
        """encoder_out (B, T, D) + SelfSrcAttention(encoder_out, text memory)."""
        return encoder_out + self.fusion_encoder(encoder_out,
                                                 self._text_memory(ocr_ids, ocr_lengths))

    def bias_scores(self, encoder_out, ocr_ids, ocr_lengths=None):
        """Per-OCR-token presence logits (B, L) (``ConvBiasPredictor``)."""
        return self.bias_predictor(self._text_memory(ocr_ids, ocr_lengths), encoder_out)

    def decode_memory(self, encoder_out, tokenizer=None, ocr_text=None, **kwargs):
        """The encoder output with ``ocr_text`` fused in (unchanged without one)."""
        if not ocr_text or tokenizer is None:
            return encoder_out
        ids = tokenizer.encode(ocr_text) if isinstance(ocr_text, str) else list(ocr_text)
        if self.insert_blank:
            ids = [x + 1 if x != 0 else x for x in ids]
        ocr_ids = torch.tensor([ids], dtype=torch.long, device=encoder_out.device)
        return self.fuse_ocr(encoder_out, ocr_ids.expand(encoder_out.shape[0], -1))

    def inference(self, data_in, data_lengths=None, key=None, tokenizer=None, frontend=None,
                  **kwargs):
        kwargs = {k: v for k, v in kwargs.items() if k not in ("lm", "hotword")}
        return super().inference(data_in, data_lengths, key=key, tokenizer=tokenizer,
                                 frontend=frontend, **kwargs)
