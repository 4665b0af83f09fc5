"""Pure-CTC ASR in PyTorch (counterpart of ``funasr_tpu/models/ctc/model.py``; FunASR
``funasr/models/ctc/model.py:17``, registered as model "CTC"): any registered encoder,
the CTC head and the greedy collapse. As in the JAX package the features are not
bucketed, and the path is the argmax of the logits, blank past each row's length; it
comes to the host in one copy. ``forward`` is the training loss (``forward_jit``,
``model.py:44-51``): SpecAug, the encoder with its dropout, the mean CTC loss.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from funasr_tpu_torch.core.layers import make_pad_mask
from funasr_tpu_torch.core.module import init_weights
from funasr_tpu_torch.models.ctc.ctc import CTC
from funasr_tpu_torch.register import tables
from funasr_tpu_torch.utils import postprocess_utils
from funasr_tpu_torch.utils.load_utils import extract_fbank, load_audio_text_image_video


@tables.register("model_classes", "CTC")
class CTCModel(nn.Module):
    def __init__(self, specaug: Optional[str] = None, specaug_conf: Optional[Dict] = None,
                 encoder: str = "SANMEncoder", encoder_conf: Optional[Dict] = None,
                 ctc_conf: Optional[Dict] = None, input_size: int = 80, vocab_size: int = -1,
                 ignore_id: int = -1, blank_id: int = 0, sos: int = 1, eos: int = 2,
                 device=None, generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__()
        self.specaug = (tables.specaug_classes[specaug](**(specaug_conf or {}))
                        if specaug else None)
        self.ignore_id = ignore_id
        self.encoder = tables.encoder_classes[encoder](
            input_size=input_size, device=device, **(encoder_conf or {}))
        self.ctc = CTC(odim=vocab_size, encoder_output_size=self.encoder.output_size(),
                       device=device, **(ctc_conf or {}))
        self.blank_id = blank_id
        self.sos, self.eos = sos, eos
        if generator is not None:
            init_weights(self, generator)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return next(self.parameters()).dtype

    def forward(self, speech, speech_lengths, text, text_lengths, generator=None, **kwargs):
        """One batch's training loss -> (loss, stats ``loss``, ``loss_ctc``,
        ``batch_size``, weight B). ``generator`` draws SpecAug and the encoder's dropout
        (``train()`` mode)."""
        if self.specaug is not None and self.training and generator is not None:
            speech, speech_lengths = self.specaug(speech, speech_lengths, generator)
        enc, enc_lens = self.encoder(speech, speech_lengths, generator=generator)
        loss = self.ctc.loss(enc, enc_lens, text, text_lengths)
        b = speech.shape[0]
        return loss, dict(loss=loss, loss_ctc=loss, batch_size=torch.tensor(b)), b

    def infer(self, speech, speech_lengths):
        """(B, T, D) features -> (greedy path (B, T) int32, blank past each length,
        encoder lengths) (``infer_jit``)."""
        enc, enc_lens = self.encoder(speech, speech_lengths)
        path = self.ctc.logits(enc).argmax(dim=-1).to(torch.int32)
        valid = make_pad_mask(enc_lens, enc.shape[1])
        return torch.where(valid, path, self.blank_id), enc_lens

    def inference(self, data_in, data_lengths=None, key: Optional[List] = None,
                  tokenizer=None, frontend=None, **kwargs):
        audio_list = load_audio_text_image_video(
            data_in, fs=frontend.fs if frontend else 16000, audio_fs=kwargs.get("fs", 16000))
        speech, speech_lengths = extract_fbank(audio_list, frontend=frontend)
        with torch.inference_mode():
            path, _ = self.infer(torch.from_numpy(speech).to(self.device, self.dtype),
                                 torch.from_numpy(speech_lengths).to(self.device))
            path = path.cpu().numpy()
        if key is None:
            key = [f"rand_key_{i}" for i in range(path.shape[0])]
        results = []
        for i in range(path.shape[0]):
            out, prev = [], self.blank_id
            for t in path[i]:
                t = int(t)
                if t != self.blank_id and t != prev:
                    out.append(t)
                prev = t
            if tokenizer is not None:
                text, _ = postprocess_utils.sentence_postprocess(tokenizer.ids2tokens(out))
                results.append({"key": key[i], "text": text})
            else:
                results.append({"key": key[i], "token_int": out})
        return results, {}
