"""Transformer AED in PyTorch: hybrid CTC / attention ASR, the base of the Conformer and
Branchformer models (counterpart of ``funasr_tpu/models/transformer/model.py``; FunASR
``funasr/models/transformer/model.py:23+``).

``forward(speech, speech_lengths, text, text_lengths, generator=)`` is the training loss
(``forward_jit``, ``model.py:85-108``): ctc_weight x CTC + (1 - ctc_weight) x the
label-smoothed CE of the teacher-forced decoder over sos / eos -> (loss, stats, weight).
The generator draws SpecAug (``train()`` mode) and is handed to the encoder, which
ignores it unless it has dropout (the SAN-M encoder of ``SANM``). ``inference`` is the
attention beam search per utterance (``model.py:110-161``) over a batch encode, with the
``lm=`` / ``hotword=`` fusion of ``search.py``. ``SANM`` is the AED over the SAN-M encoder
(``model.py:164``), so on CUDA its encoder runs the flash and FSMN kernels.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch
from torch import nn

from funasr_tpu_torch.core.layers import make_pad_mask
from funasr_tpu_torch.core.module import init_weights
from funasr_tpu_torch.losses.label_smoothing_loss import label_smoothing_loss, th_accuracy
from funasr_tpu_torch.models.ctc.ctc import CTC
from funasr_tpu_torch.models.normalize.normalize import build_normalize
from funasr_tpu_torch.models.transformer.search import beam_search
from funasr_tpu_torch.register import tables
from funasr_tpu_torch.utils import postprocess_utils
from funasr_tpu_torch.utils.load_utils import extract_fbank, load_audio_text_image_video


def add_sos_eos(ys_pad, ys_lens, sos: int, eos: int, ignore_id: int = -1):
    """-> (ys_in (B, L + 1) starting with sos, ys_out (B, L + 1) ending with eos)."""
    b, l = ys_pad.shape
    valid = make_pad_mask(ys_lens, l)
    ys_clean = torch.where(valid, ys_pad, 0)
    ys_in = torch.cat([torch.full((b, 1), sos, dtype=ys_pad.dtype, device=ys_pad.device),
                       ys_clean], dim=1)
    ys_out = torch.full((b, l + 1), ignore_id, dtype=ys_pad.dtype, device=ys_pad.device)
    ys_out[:, :l] = torch.where(valid, ys_pad, ignore_id)
    ys_out[torch.arange(b, device=ys_pad.device), ys_lens.long()] = eos
    return ys_in, ys_out


@tables.register("model_classes", "Transformer")
class Transformer(nn.Module):
    def __init__(self, specaug: Optional[str] = None, specaug_conf: Optional[Dict] = None,
                 normalize: Optional[str] = None, normalize_conf: Optional[Dict] = None,
                 encoder: str = "TransformerEncoder", encoder_conf: Optional[Dict] = None,
                 decoder: str = "TransformerDecoder", decoder_conf: Optional[Dict] = None,
                 ctc: str = "CTC", ctc_conf: Optional[Dict] = None, ctc_weight: float = 0.5,
                 input_size: int = 80, vocab_size: int = -1, ignore_id: int = -1,
                 blank_id: int = 0, sos: int = 1, eos: int = 2, lsm_weight: float = 0.0,
                 length_normalized_loss: bool = False, device=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        """``generator``: when given, every weight is drawn from it (the JAX package's init
        rules, ``core/module.py::init_weights``). ``ctc_weight > 0`` builds the CTC head."""
        super().__init__()
        self.encoder = tables.encoder_classes[encoder](input_size=input_size, device=device,
                                                       **(encoder_conf or {}))
        enc_out = self.encoder.output_size()
        self.decoder = tables.decoder_classes[decoder](
            vocab_size=vocab_size, encoder_output_size=enc_out, device=device,
            **(decoder_conf or {}))
        self.ctc = (CTC(odim=vocab_size, encoder_output_size=enc_out, device=device,
                        **(ctc_conf or {})) if ctc_weight > 0 else None)
        self.specaug = (tables.specaug_classes[specaug](**(specaug_conf or {}))
                        if specaug else None)
        self.normalize = build_normalize(normalize, normalize_conf)
        self.vocab_size = vocab_size
        self.ignore_id = ignore_id
        self.blank_id = blank_id
        self.sos = sos
        self.eos = eos
        self.ctc_weight = ctc_weight
        self.lsm_weight = lsm_weight
        self.length_normalized_loss = length_normalized_loss
        if generator is not None:
            init_weights(self, generator)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return next(self.parameters()).dtype

    def encode(self, speech, speech_lengths, generator=None):
        """SpecAug (``train()`` mode with a generator), normalize, encoder."""
        if self.specaug is not None and self.training and generator is not None:
            speech, speech_lengths = self.specaug(speech, speech_lengths, generator)
        if self.normalize is not None:
            speech, speech_lengths = self.normalize(speech, speech_lengths)
        return self.encoder(speech, speech_lengths, generator=generator)

    def forward(self, speech, speech_lengths, text, text_lengths, generator=None):
        """One batch's training loss -> (loss, stats, weight); stats holds 0-d tensors
        (``loss``, ``loss_att``, ``acc``; ``loss_ctc`` with CTC)."""
        encoder_out, encoder_out_lens = self.encode(speech, speech_lengths, generator)
        stats: Dict = {}
        loss_ctc = 0.0
        if self.ctc is not None:
            loss_ctc = self.ctc.loss(encoder_out, encoder_out_lens, text, text_lengths)
            stats["loss_ctc"] = loss_ctc
        ys_in, ys_out = add_sos_eos(text, text_lengths, self.sos, self.eos, self.ignore_id)
        logits, _ = self.decoder(encoder_out, encoder_out_lens, ys_in, text_lengths + 1)
        loss_att = label_smoothing_loss(logits, ys_out, self.ignore_id, self.lsm_weight,
                                        self.vocab_size, self.length_normalized_loss)
        stats["acc"] = th_accuracy(logits, ys_out, self.ignore_id)
        if self.ctc is not None:
            loss = self.ctc_weight * loss_ctc + (1 - self.ctc_weight) * loss_att
        else:
            loss = loss_att
        stats.update(loss_att=loss_att, loss=loss)
        return loss, stats, speech.shape[0]

    def decode_memory(self, encoder_out, tokenizer=None, **kwargs):
        """The memory the beam search reads: the encoder output (``LCBNet`` fuses its OCR
        context in)."""
        return encoder_out

    def inference(self, data_in, data_lengths=None, key: Optional[List] = None,
                  tokenizer=None, frontend=None, **kwargs):
        """waveforms -> text: one batch encode, then the beam search per utterance
        (``beam_size`` 10 by default, ``maxlenratio`` / ``minlenratio``, ``lm`` /
        ``lm_weight``, ``hotword`` / ``hotword_weight``). Returns (results, meta): one
        ``{"key", "text"}`` per input (``{"key", "token_int"}`` without a tokenizer)."""
        meta: Dict = {}
        t0 = time.perf_counter()
        audio_list = load_audio_text_image_video(
            data_in, fs=frontend.fs, audio_fs=kwargs.get("fs", 16000),
            data_type=kwargs.get("data_type", "sound"))
        meta["load_data"] = f"{time.perf_counter() - t0:0.3f}"
        speech, speech_lengths = extract_fbank(audio_list, frontend=frontend,
                                               device=self.device)
        # the frontend pads the frames to its bucket; the subsampled lengths
        # min((len + 3) // 4, T') and the unmasked convolutions see the padding, so the
        # batch is cut back to its longest utterance, as the JAX package batches it
        speech = speech[:, : int(speech_lengths.max())]
        meta["batch_data_time"] = (float(speech_lengths.sum()) * frontend.frame_shift_ms
                                   * getattr(frontend, "lfr_n", 1) / 1000)
        hotword_scorer = None
        if kwargs.get("hotword") and tokenizer is not None:
            from funasr_tpu_torch.models.transformer.hotword_scorer import \
                build_hotword_scorer
            hotword_scorer = build_hotword_scorer(kwargs["hotword"], tokenizer,
                                                  weight=kwargs.get("hotword_weight", 3.0))
        results = []
        with torch.inference_mode():
            encoder_out, encoder_out_lens = self.encode(speech.to(self.dtype), speech_lengths)
            encoder_out = self.decode_memory(encoder_out, tokenizer=tokenizer, **kwargs)
            b = encoder_out.shape[0]
            if key is None:
                key = [f"rand_key_{i}" for i in range(b)]
            for i in range(b):
                mem = encoder_out[i: i + 1]
                mmask = make_pad_mask(encoder_out_lens[i: i + 1], mem.shape[1])
                hyps = beam_search(self.decoder, mem, mmask, self.sos, self.eos,
                                   beam_size=kwargs.get("beam_size", 10),
                                   maxlenratio=kwargs.get("maxlenratio", 0.0),
                                   minlenratio=kwargs.get("minlenratio", 0.0),
                                   lm=kwargs.get("lm"), lm_weight=kwargs.get("lm_weight", 0.3),
                                   hotword_scorer=hotword_scorer)
                token_int = [t for t in hyps[0].yseq[1:-1]
                             if t not in (self.sos, self.eos, self.blank_id)]
                if tokenizer is not None:
                    text, _ = postprocess_utils.sentence_postprocess(
                        tokenizer.ids2tokens(token_int))
                    results.append({"key": key[i], "text": text})
                else:
                    results.append({"key": key[i], "token_int": token_int})
        return results, meta


@tables.register("model_classes", "SANM")
class SANM(Transformer):
    """SAN-M CTC / attention AED (FunASR ``funasr/models/sanm/model.py:14``): a
    Transformer whose encoder defaults to ``SANMEncoder``."""

    def __init__(self, encoder: str = "SANMEncoder", **kwargs):
        super().__init__(encoder=encoder, **kwargs)
