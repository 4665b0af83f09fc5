"""UniASR in PyTorch: unified 2-pass ASR, a low-latency pass and an accurate pass
(counterpart of ``funasr_tpu/models/uniasr/model.py``; FunASR ``funasr/models/uniasr/
model.py:26``), over the SCAMA parts (``models/scama``).

Pass 1: the overlap-chunk SAN-M encoder -> CIF -> the SCAMA-masked FSMN decoder. Pass 2:
the stride conv (pad (0, 1), kernel 2, stride 2, ReLU; lengths (len - 1) // 2 + 1) over
[features || the de-chunked pass-1 states], a second overlap-chunk encoder -> CIF2 -> the
SCAMA-masked ``decoder2``. The stride conv is plain PyTorch (``core/layers.py::conv1d``):
the JAX package computes it outside any Pallas kernel. Both encoders run the flash
kernels' chunk mode and the FSMN kernel, both decoders the FSMN kernel.

``forward`` is the training loss (``forward_jit``): each pass's label-smoothed attention
CE plus its weighted predictor MAE (over sos / eos when its ``predictor_bias`` is 1, over
the bare targets at 0), mixed by ``loss_weight_model1``. As JAX's trainer calls
``forward_jit`` (no masks), each encoder takes config ``chunk_index`` (0)'s masks at its
padded input length, every row that length's chunked length; no config is drawn.

``inference`` takes ``decoding_model``: "fast" decodes pass 1, "normal" pass 2, and
"offline" pass 2 under the last chunk config; ``decoding_ind`` picks the config
otherwise. Each pass decodes with ``scama/model.py::greedy_decode`` (the fixed-shape
step; JAX's ``_decode_pass`` grows its buffer a step at a time, the same logits at the
step's row). Text from ``ids2tokens`` + ``sentence_postprocess``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch
from torch import nn

from funasr_tpu_torch.core.layers import conv1d
from funasr_tpu_torch.core.module import init_weights
from funasr_tpu_torch.models.normalize.normalize import build_normalize
from funasr_tpu_torch.models.scama.chunk_utils import remove_chunk
from funasr_tpu_torch.models.scama.model import ChunkAttentionModel
from funasr_tpu_torch.models.transformer.model import add_sos_eos
from funasr_tpu_torch.register import tables
from funasr_tpu_torch.utils import postprocess_utils
from funasr_tpu_torch.utils.load_utils import extract_fbank, load_audio_text_image_video


class StrideConv(nn.Module):
    """FunASR's ``Conv1dSubsampling`` (``subsampling.py:332-388``): zero padding, a full
    conv1d with a stride, ReLU; the weights under ``conv``."""

    def __init__(self, idim: int, odim: int, kernel_size: int = 2, stride: int = 2,
                 pad=(0, 1), device=None):
        super().__init__()
        self.conv = nn.Conv1d(idim, odim, kernel_size, stride=stride, device=device)
        self.stride = stride
        self.pad = tuple(pad) if not isinstance(pad, int) else (pad, pad)

    def forward(self, x, lens):
        h = conv1d(x, self.conv.weight, self.conv.bias, left_pad=self.pad[0],
                   right_pad=self.pad[1], stride=self.stride)
        return torch.relu(h), (lens - 1) // self.stride + 1


@tables.register("model_classes", "UniASR")
class UniASR(ChunkAttentionModel):
    def __init__(self, specaug=None, specaug_conf=None, normalize=None, normalize_conf=None,
                 encoder: str = "SANMEncoderChunkOpt", encoder_conf=None,
                 encoder2: str = "SANMEncoderChunkOpt", encoder2_conf=None,
                 decoder: str = "FsmnDecoderSCAMAOpt", decoder_conf=None,
                 decoder2: str = "FsmnDecoderSCAMAOpt", decoder2_conf=None,
                 predictor: str = "CifPredictorV2", predictor_conf=None,
                 predictor2: str = "CifPredictorV2", predictor2_conf=None,
                 stride_conv: str = "stride_conv1d", stride_conv_conf=None,
                 input_size: int = 560, vocab_size: int = -1, ignore_id: int = -1,
                 blank_id: int = 0, sos: int = 1, eos: int = 2, lsm_weight: float = 0.0,
                 predictor_weight: float = 1.0, predictor2_weight: float = 1.0,
                 predictor_bias: int = 0, predictor2_bias: int = 0,
                 ctc_weight: float = 0.0, ctc_weight2: float = 0.0,
                 loss_weight_model1: float = 0.5,
                 decoder_attention_chunk_type: str = "chunk",
                 decoder_attention_chunk_type2: str = "chunk",
                 length_normalized_loss: bool = False, device=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        """``generator``: when given, every weight is drawn from it (the JAX package's init
        rules). The CTC weights are accepted and unused, as in the JAX package."""
        super().__init__()
        self.encoder = tables.encoder_classes[encoder](input_size=input_size, device=device,
                                                       **(encoder_conf or {}))
        enc1_out = self.encoder.output_size()
        self.decoder = tables.decoder_classes[decoder](
            vocab_size=vocab_size, encoder_output_size=enc1_out, device=device,
            **(decoder_conf or {}))
        pred_conf = dict(predictor_conf or {})
        pred_conf.setdefault("idim", enc1_out)
        self.predictor = tables.predictor_classes[predictor](device=device, **pred_conf)
        # the pass-2 front over [features || de-chunked pass-1 states], idim = odim
        # (FunASR model.py:148-155)
        sc_conf = dict(stride_conv_conf or {})
        width = input_size + enc1_out
        self.stride_conv = StrideConv(width, width, sc_conf.get("kernel_size", 2),
                                      sc_conf.get("stride", 2), sc_conf.get("pad", (0, 1)),
                                      device=device)
        self.encoder2 = tables.encoder_classes[encoder2](input_size=width, device=device,
                                                         **(encoder2_conf or {}))
        enc2_out = self.encoder2.output_size()
        self.decoder2 = tables.decoder_classes[decoder2](
            vocab_size=vocab_size, encoder_output_size=enc2_out, device=device,
            **(decoder2_conf or {}))
        pred2_conf = dict(predictor2_conf or predictor_conf or {})
        pred2_conf.setdefault("idim", enc2_out)
        self.predictor2 = tables.predictor_classes[predictor2](device=device, **pred2_conf)
        self.specaug = (tables.specaug_classes[specaug](**(specaug_conf or {}))
                        if specaug else None)
        self.normalize = build_normalize(normalize, normalize_conf)
        self.vocab_size = vocab_size
        self.ignore_id = ignore_id
        self.blank_id = blank_id
        self.sos, self.eos = sos, eos
        self.lsm_weight = lsm_weight
        self.predictor_weight = predictor_weight
        self.predictor2_weight = predictor2_weight
        self.predictor_bias = predictor_bias
        self.predictor2_bias = predictor2_bias
        self.loss_weight_model1 = loss_weight_model1
        self.decoder_attention_chunk_type = decoder_attention_chunk_type
        self.decoder_attention_chunk_type2 = decoder_attention_chunk_type2
        self.length_normalized_loss = length_normalized_loss
        if generator is not None:
            init_weights(self, generator)

    def _pass(self, which: str):
        """(encoder, predictor, decoder, attention chunk type) of pass "1" or "2"."""
        if which == "1":
            return (self.encoder, self.predictor, self.decoder,
                    self.decoder_attention_chunk_type)
        return (self.encoder2, self.predictor2, self.decoder2,
                self.decoder_attention_chunk_type2)

    def pass2_input(self, speech, speech_lengths, enc1, enc1_lens, masks):
        """[features || de-chunked pass-1 states] through the stride conv -> (strided,
        lengths)."""
        enc1_rm = remove_chunk(enc1, enc1_lens, masks["tables"])[:, : speech.shape[1]]
        fused = torch.cat([speech.to(enc1_rm.dtype), enc1_rm], dim=-1)
        return self.stride_conv(fused, speech_lengths)

    def _pass_loss(self, which: str, enc, enc_lens, text, text_lengths, masks, ind: int):
        encoder, predictor, decoder, att_type = self._pass(which)
        bias = self.predictor_bias if which == "1" else self.predictor2_bias
        pw = self.predictor_weight if which == "1" else self.predictor2_weight
        if bias == 0:
            ys_in, ys_out, ys_in_lens = text, text, text_lengths
        else:
            ys_in, ys_out = add_sos_eos(text, text_lengths, self.sos, self.eos,
                                        self.ignore_id)
            ys_in_lens = text_lengths + 1
        loss_att, acc, loss_pre = self.pass_loss(
            predictor, decoder, encoder.overlap_chunk_cls, enc, enc_lens, masks, ind,
            att_type, ys_in, ys_out, ys_in_lens)
        return loss_att + pw * loss_pre, loss_att, loss_pre, acc

    def forward(self, speech, speech_lengths, text, text_lengths, generator=None,
                chunk_index: int = 0):
        """One batch's training loss (``forward_jit``) -> (loss, stats, weight); stats
        holds 0-d tensors (``loss_att`` / ``loss_pre`` / ``acc`` of pass 1 and
        ``loss_att2`` / ``loss_pre2`` / ``acc2`` of pass 2, each pass that runs;
        ``loss1``, ``loss2``, ``loss``)."""
        if self.specaug is not None and self.training and generator is not None:
            speech, speech_lengths = self.specaug(speech, speech_lengths, generator)
        if self.normalize is not None:
            speech, speech_lengths = self.normalize(speech, speech_lengths)
        b, t = speech.shape[:2]
        ind = chunk_index
        masks = self.encoder_masks(self.encoder, t, ind,
                                   torch.full((b,), t, device=speech.device))
        enc1, enc1_lens = self.encoder.forward_train_chunk(speech, speech_lengths, masks)
        stats: Dict = {}
        loss1 = loss2 = 0.0
        if self.loss_weight_model1 > 0.0:
            loss1, att1, pre1, acc1 = self._pass_loss("1", enc1, enc1_lens, text,
                                                      text_lengths, masks, ind)
            stats.update(loss_att=att1, loss_pre=pre1, acc=acc1)
        if self.loss_weight_model1 < 1.0:
            strided, lens2 = self.pass2_input(speech, speech_lengths, enc1, enc1_lens, masks)
            t2 = strided.shape[1]
            masks2 = self.encoder_masks(self.encoder2, t2, ind,
                                        torch.full((b,), t2, device=speech.device))
            enc2, enc2_lens = self.encoder2.forward_train_chunk(strided, lens2, masks2)
            loss2, att2, pre2, acc2 = self._pass_loss("2", enc2, enc2_lens, text,
                                                      text_lengths, masks2, ind)
            stats.update(loss_att2=att2, loss_pre2=pre2, acc2=acc2)
        loss = loss1 * self.loss_weight_model1 + loss2 * (1 - self.loss_weight_model1)
        stats.update(loss1=loss1, loss2=loss2, loss=loss)
        return loss, stats, b

    def decode_features(self, speech, lengths, ind: int = 0, mode: str = "normal"):
        """Features (B, T, D) and lengths (B,) on the model's device -> (ids (B,
        max_tokens) on the device, token_num (B,) on the host) of pass 1 (``mode`` "fast")
        or pass 2 ("normal"; "offline" under the last chunk config, whatever ``ind``)."""
        if mode == "offline":
            ind = len(self.encoder.overlap_chunk_cls.chunk_size) - 1
        masks = self.encoder_masks(self.encoder, speech.shape[1], ind, lengths)
        enc, enc_lens = self.encoder.forward_train_chunk(speech, lengths, masks)
        which = "1" if mode == "fast" else "2"
        if which == "2":
            strided, lens2 = self.pass2_input(speech, lengths, enc, enc_lens, masks)
            masks = self.encoder_masks(self.encoder2, int(lens2.max()), ind, lens2)
            enc, enc_lens = self.encoder2.forward_train_chunk(strided, lens2, masks)
        encoder, predictor, decoder, att_type = self._pass(which)
        return self.decode_pass(encoder, predictor, decoder, enc, enc_lens, masks, ind,
                                att_type)

    def inference(self, data_in, data_lengths=None, key: Optional[List] = None,
                  tokenizer=None, frontend=None, **kwargs):
        """waveforms -> text: ``decoding_model`` "fast" (pass 1), "normal" (pass 2, the
        default) or "offline" (pass 2 under the last chunk config) -> ([{"key", "text"}]
        ({"key", "token_int"} without a tokenizer), meta)."""
        meta: Dict = {}
        t0 = time.perf_counter()
        audio_list = load_audio_text_image_video(data_in, fs=frontend.fs,
                                                 audio_fs=kwargs.get("fs", 16000))
        meta["load_data"] = f"{time.perf_counter() - t0:0.3f}"
        with torch.inference_mode():
            speech, lengths = extract_fbank(audio_list, frontend=frontend, device=self.device)
            speech = speech[:, : int(lengths.max())].to(self.dtype)
            meta["batch_data_time"] = (float(lengths.sum()) * frontend.frame_shift_ms
                                       * frontend.lfr_n / 1000)
            ids, tok_num = self.decode_features(
                speech, lengths, int(kwargs.get("decoding_ind", 0) or 0),
                kwargs.get("decoding_model", "normal"))
            yseq = ids.cpu()
        if key is None:
            key = [f"rand_key_{i}" for i in range(yseq.shape[0])]
        results = []
        for i in range(yseq.shape[0]):
            token_int = [int(x) for x in yseq[i, : int(tok_num[i])]
                         if int(x) not in (self.blank_id, self.sos, self.eos)]
            if tokenizer is not None:
                text, _ = postprocess_utils.sentence_postprocess(
                    tokenizer.ids2tokens(token_int))
                results.append({"key": key[i], "text": text})
            else:
                results.append({"key": key[i], "token_int": token_int})
        return results, meta
