"""SCAMA in PyTorch: streaming chunk-aware multihead attention ASR, autoregressive
(counterpart of ``funasr_tpu/models/scama/model.py``; FunASR ``funasr/models/scama/
model.py:44``; arXiv 2006.01712).

The overlap-chunk SAN-M encoder (``SANMEncoderChunkOpt.forward_train_chunk``: every
self-attention on the flash kernels' chunk mode, every FSMN on the FSMN kernel) runs under
one chunk config's masks; the CIF predictor, restricted to the stride rows
(``mask_chunk_predictor``), counts the tokens and gives each frame's fired tokens
(``utils.gen_frame_alignments``); the FSMN decoder (``FsmnDecoderSCAMAOpt``)
cross-attends through each token's SCAMA window
(``utils.build_scama_mask_for_cross_attention_decoder``), so a decode sees the attention
pattern streaming has.

``forward`` is the training loss (``forward_jit``): label-smoothed attention CE over
sos / eos, CTC on the de-chunked encoder output (``ctc_weight`` > 0) and the predictor's
MAE, -> (loss, stats, weight). As JAX's trainer calls ``forward_jit`` (no masks), the
masks are config ``chunk_index`` (0)'s at the batch's padded length and every row takes
that length's chunked length.

``inference`` decodes offline through the streaming graph: the masks at each
utterance's length (``decoding_ind``), the chunked encoder, the CIF token count
floor(sum(alphas)), then the greedy decode at a fixed shape (``greedy_decode``, JAX's
``_scama_greedy_step_jit``): the decoder over the ``max_tokens`` buffer padded with eos,
with step + 1 valid rows, and the argmax at ``step``; no K / V cache, as in JAX. Pad rows
are masked out of the FSMN (its input and output) and carry their own cross-attention
rows only, so each step's logits are those of the prefix alone. The ids stay on the
device until the last step. Text from ``tokenizer.decode`` and ``token_num``.

Chunk mode is the fp32 flash kernels' only: a model cast to another dtype on CUDA raises
``NotImplementedError`` when cast (``ROADMAP.md`` queue 2, "bf16 chunk mode").
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
from funasr_tpu_torch.models.paraformer import cif_predictor as _cif  # noqa: F401 (registers)
from funasr_tpu_torch.models.paraformer.cif_predictor import mae_token_loss
from funasr_tpu_torch.models.scama import decoder as _decoder  # noqa: F401 (registers)
from funasr_tpu_torch.models.scama import encoder as _encoder  # noqa: F401 (registers)
from funasr_tpu_torch.models.scama.chunk_utils import remove_chunk
from funasr_tpu_torch.models.scama.utils import (
    build_scama_mask_for_cross_attention_decoder, gen_frame_alignments)
from funasr_tpu_torch.models.transformer.model import add_sos_eos
from funasr_tpu_torch.register import tables
from funasr_tpu_torch.utils.load_utils import extract_fbank, load_audio_text_image_video

BF16_CHUNK_ITEM = "ROADMAP.md queue 2, item 11: bf16 chunk mode"


class ChunkAttentionModel(nn.Module):
    """What SCAMA and UniASR share: the fp32-only check of the chunk-mode kernels, the
    masks of one chunk config on the model's device, one pass's SCAMA windows and the
    fixed-shape greedy decode."""

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return next(self.parameters()).dtype

    def _apply(self, fn, *args, **kwargs):
        out = super()._apply(fn, *args, **kwargs)
        if self.device.type == "cuda" and self.dtype != torch.float32:
            raise NotImplementedError(
                f"{type(self).__name__} runs its encoders' self-attention on the flash "
                f"kernels' chunk mode, which is fp32 only; got {self.dtype} on CUDA "
                f"({BF16_CHUNK_ITEM})")
        return out

    @staticmethod
    def encoder_masks(encoder, l_max: int, ind: int, lengths):
        """Config ``ind``'s masks at the padded length ``l_max`` with the chunked lengths
        of ``lengths`` (B,) as "x_len_chunk"."""
        masks = dict(encoder.chunk_masks(l_max, ind, lengths.device))
        masks["x_len_chunk"] = encoder.chunk_lengths(lengths, masks)
        return masks

    @staticmethod
    def pass_inputs(enc, enc_lens, masks):
        """The chunked encoder output with its FSMN shift rows zeroed, the predictor's
        mask (pad and stride rows) and the (Tc,) float hop and shift rows."""
        t_chunk = enc.shape[1]
        hop = masks["mask_chunk_predictor"][:t_chunk]
        shift = masks["mask_shfit_chunk"][:t_chunk]
        enc = enc * shift[None, :, None].to(enc.dtype)
        pred_mask = make_pad_mask(enc_lens, t_chunk) & hop[None]
        return enc, pred_mask, hop.float(), shift.float()

    @staticmethod
    def scama_windows(alignments, enc_lens, max_tokens: int, chunk_cfg, ind: int,
                      att_type: str, hop, shift, target_length=None, training=True):
        enc_chunk_size = chunk_cfg.chunk_size[ind] + chunk_cfg.shfit_fsmn
        return build_scama_mask_for_cross_attention_decoder(
            alignments, enc_lens, max_target_length=max_tokens, chunk_size=1,
            encoder_chunk_size=enc_chunk_size, attention_chunk_size=enc_chunk_size,
            attention_chunk_type=att_type, predictor_mask_chunk_hopping=hop,
            decoder_att_look_back_factor=chunk_cfg.dec_look_back[ind],
            mask_shift_att_chunk_decoder=shift, target_length=target_length,
            is_training=training)

    def decode_pass(self, encoder, predictor, decoder, enc, enc_lens, masks, ind: int,
                    att_type: str):
        """One pass's decode: CIF token count, alignments, SCAMA windows, the greedy decode
        -> (ids (B, max_tokens) on the device, token_num (B,) on the host)."""
        enc, pred_mask, hop, shift = self.pass_inputs(enc, enc_lens, masks)
        alphas = predictor.alphas(enc, pred_mask)
        token_num = torch.floor(alphas.sum(dim=1)).to(torch.int32)
        token_num_host = token_num.cpu()
        max_tokens = max(int(token_num_host.max()), 1) + 1
        alignments, _ = gen_frame_alignments(alphas, enc_lens, max_tokens, training=False)
        scama_mask = self.scama_windows(alignments, enc_lens, max_tokens,
                                        encoder.overlap_chunk_cls, ind, att_type, hop, shift,
                                        training=False)
        return greedy_decode(decoder, enc, enc_lens, scama_mask, max_tokens, self.sos,
                             self.eos), token_num_host

    def pass_loss(self, predictor, decoder, chunk_cfg, enc, enc_lens, masks, ind: int,
                  att_type: str, ys_in, ys_out, ys_in_lens):
        """One pass's attention and predictor losses under its SCAMA windows -> (loss_att,
        acc, loss_pre)."""
        enc, pred_mask, hop, shift = self.pass_inputs(enc, enc_lens, masks)
        max_tokens = ys_in.shape[1]
        acoustic_embeds, pre_token_length, pre_alphas, _ = predictor(
            enc, pred_mask, max_tokens, target_length=ys_in_lens)
        alignments, _ = gen_frame_alignments(pre_alphas[:, : enc.shape[1]], enc_lens,
                                             max_tokens, training=True)
        scama_mask = self.scama_windows(alignments, enc_lens, max_tokens, chunk_cfg, ind,
                                        att_type, hop, shift, target_length=ys_in_lens)
        logits, _ = decoder(enc, enc_lens, ys_in, ys_in_lens, chunk_mask=scama_mask,
                            pre_acoustic_embeds=acoustic_embeds)
        loss_att = label_smoothing_loss(logits, ys_out, self.ignore_id, self.lsm_weight,
                                        self.vocab_size, self.length_normalized_loss)
        acc = th_accuracy(logits, ys_out, self.ignore_id)
        loss_pre = mae_token_loss(ys_in_lens.float(), pre_token_length,
                                  self.length_normalized_loss)
        return loss_att, acc, loss_pre


def greedy_decode(decoder, enc, enc_lens, scama_mask, max_tokens: int, sos: int, eos: int):
    """The greedy decode at a fixed shape (``_scama_greedy_step_jit``): ids (B,
    max_tokens + 1) start as sos then eos; step s runs the decoder over the first
    max_tokens ids with s + 1 valid and writes the argmax at s into slot s + 1 ->
    (B, max_tokens) ids on the device."""
    b = enc.shape[0]
    ys = torch.full((b, max_tokens + 1), eos, dtype=torch.long, device=enc.device)
    ys[:, 0] = sos
    for step in range(max_tokens):
        lens = torch.full((b,), step + 1, dtype=torch.int32, device=enc.device)
        logits, _ = decoder(enc, enc_lens, ys[:, :max_tokens], lens, chunk_mask=scama_mask)
        ys[:, step + 1] = logits[:, step].argmax(dim=-1)
    return ys[:, 1:]


@tables.register("model_classes", "SCAMA")
class SCAMA(ChunkAttentionModel):
    def __init__(self, specaug: Optional[str] = None, specaug_conf=None,
                 normalize: Optional[str] = None, normalize_conf=None,
                 encoder: str = "SANMEncoderChunkOpt", encoder_conf=None,
                 decoder: str = "FsmnDecoderSCAMAOpt", decoder_conf=None,
                 ctc: str = "CTC", ctc_conf=None, ctc_weight: float = 0.5,
                 predictor: str = "CifPredictorV2", predictor_conf=None,
                 predictor_bias: int = 0, predictor_weight: float = 0.0,
                 input_size: int = 80, vocab_size: int = -1, ignore_id: int = -1,
                 blank_id: int = 0, sos: int = 1, eos: int = 2, lsm_weight: float = 0.0,
                 length_normalized_loss: bool = False,
                 decoder_attention_chunk_type: str = "chunk", device=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        """``generator``: when given, every weight is drawn from it (the JAX package's init
        rules, ``core/module.py::init_weights``). ``ctc_weight`` > 0 builds the CTC head."""
        super().__init__()
        self.specaug = (tables.specaug_classes[specaug](**(specaug_conf or {}))
                        if specaug else None)
        self.normalize = build_normalize(normalize, normalize_conf)
        self.encoder = tables.encoder_classes[encoder](input_size=input_size, device=device,
                                                       **(encoder_conf or {}))
        enc_out = self.encoder.output_size()
        self.decoder = tables.decoder_classes[decoder](
            vocab_size=vocab_size, encoder_output_size=enc_out, device=device,
            **(decoder_conf or {}))
        self.ctc = (CTC(odim=vocab_size, encoder_output_size=enc_out, device=device,
                        **(ctc_conf or {})) if ctc_weight > 0 else None)
        pred_conf = dict(predictor_conf or {})
        pred_conf.setdefault("idim", enc_out)
        self.predictor = tables.predictor_classes[predictor](device=device, **pred_conf)
        self.vocab_size = vocab_size
        self.ignore_id = ignore_id
        self.blank_id = blank_id
        self.sos, self.eos = sos, eos
        self.ctc_weight = ctc_weight
        self.predictor_bias = predictor_bias
        self.predictor_weight = predictor_weight
        self.lsm_weight = lsm_weight
        self.length_normalized_loss = length_normalized_loss
        self.decoder_attention_chunk_type = decoder_attention_chunk_type
        if generator is not None:
            init_weights(self, generator)

    def forward(self, speech, speech_lengths, text, text_lengths, generator=None,
                chunk_index: int = 0):
        """One batch's training loss (``forward_jit``) -> (loss, stats, weight); stats
        holds 0-d tensors (``loss``, ``loss_att``, ``acc``, ``loss_pre``; ``loss_ctc`` with
        CTC). SpecAug runs in ``train()`` mode with a generator."""
        b, t = speech.shape[:2]
        masks = self.encoder_masks(self.encoder, t, chunk_index,
                                   torch.full((b,), t, device=speech.device))
        if self.specaug is not None and self.training and generator is not None:
            speech, speech_lengths = self.specaug(speech, speech_lengths, generator)
        if self.normalize is not None:
            speech, speech_lengths = self.normalize(speech, speech_lengths)
        enc, enc_lens = self.encoder.forward_train_chunk(speech, speech_lengths, masks)
        stats: Dict = {}
        loss_ctc = 0.0
        if self.ctc is not None:
            enc_ctc = remove_chunk(enc, enc_lens, masks["tables"])[:, :t]
            loss_ctc = self.ctc.loss(enc_ctc, speech_lengths, text, text_lengths)
            stats["loss_ctc"] = loss_ctc
        ys_in, ys_out = add_sos_eos(text, text_lengths, self.sos, self.eos, self.ignore_id)
        loss_att, acc, loss_pre = self.pass_loss(
            self.predictor, self.decoder, self.encoder.overlap_chunk_cls, enc, enc_lens,
            masks, chunk_index, self.decoder_attention_chunk_type, ys_in, ys_out,
            text_lengths + 1)
        if self.ctc is not None:
            loss = (self.ctc_weight * loss_ctc + (1 - self.ctc_weight) * loss_att
                    + self.predictor_weight * loss_pre)
        else:
            loss = loss_att + self.predictor_weight * loss_pre
        stats.update(loss_att=loss_att, acc=acc, loss_pre=loss_pre, loss=loss)
        return loss, stats, b

    def decode_features(self, speech, lengths, ind: int = 0):
        """Features (B, T, D) and lengths (B,) on the model's device -> (ids (B,
        max_tokens) on the device, token_num (B,) on the host), under chunk config
        ``ind``."""
        masks = self.encoder_masks(self.encoder, speech.shape[1], ind, lengths)
        enc, enc_lens = self.encoder.forward_train_chunk(speech, lengths, masks)
        return self.decode_pass(self.encoder, self.predictor, self.decoder, enc, enc_lens,
                                masks, ind, self.decoder_attention_chunk_type)

    def inference(self, data_in, data_lengths=None, key: Optional[List] = None,
                  tokenizer=None, frontend=None, **kwargs):
        """waveforms -> text through the streaming graph (``decoding_ind`` picks the chunk
        config, 0 by default) -> ([{"key", "text", "token_num"}], meta)."""
        meta: Dict = {}
        t0 = time.perf_counter()
        audio_list = load_audio_text_image_video(data_in, fs=frontend.fs,
                                                 audio_fs=kwargs.get("fs", 16000))
        meta["load_data"] = f"{time.perf_counter() - t0:0.3f}"
        ind = int(kwargs.get("decoding_ind", 0) or 0)
        with torch.inference_mode():
            speech, lengths = extract_fbank(audio_list, frontend=frontend, device=self.device)
            l_max = int(lengths.max())
            speech = speech[:, :l_max].to(self.dtype)
            meta["batch_data_time"] = (float(lengths.sum()) * frontend.frame_shift_ms
                                       * getattr(frontend, "lfr_n", 1) / 1000)
            ids, token_num = self.decode_features(speech, lengths, ind)
            hyps = ids.cpu()
        if key is None:
            key = [f"rand_key_{i}" for i in range(hyps.shape[0])]
        results = []
        for i in range(hyps.shape[0]):
            ids_i = [int(x) for x in hyps[i][: int(token_num[i])]
                     if int(x) not in (self.sos, self.eos, self.blank_id)]
            text = tokenizer.decode(ids_i) if tokenizer is not None else \
                " ".join(map(str, ids_i))
            results.append({"key": key[i], "text": text, "token_num": int(token_num[i])})
        return results, meta
