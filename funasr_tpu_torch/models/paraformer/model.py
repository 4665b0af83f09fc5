"""Paraformer offline decode in PyTorch (counterpart of
``funasr_tpu/models/paraformer/model.py::Paraformer``).

SAN-M encoder -> CIF predictor -> SAN-M NAR decoder -> greedy argmax, with the JAX
package's bucketing: (B, T) padded to (next pow2, next multiple of 128), a decoder
token budget of T_bucket/2 + 16 and a re-decode at the full T+1 budget when any row
saturates it (``model.py:306-331``). Features are cast to the weights' dtype, as
``bench.py`` casts them for its bf16 decode. ``inference`` is the dispatch / fetch pair
of the JAX package; ``pred_timestamp=True`` adds CIF timestamps, whose alphas and peaks
ride in the fetch's one device-to-host copy. Subclasses change the decode's outputs
(``decode_outputs``), its per-call inputs beyond the audio (``decode_context``: the
hotword models' biasing lists, made once per call) and each row's result
(``transcript``), so the pair serves them too. A config with ``ctc_weight > 0`` builds
the CTC head (``self.ctc``), so its checkpoints load; the decode does not use it.
Paraformer-v2 and E-Paraformer (``models/{paraformer_v2,e_paraformer}``) keep the pair
through ``infer_core`` and ``decode_outputs``.

``forward(speech, speech_lengths, text, text_lengths)`` is the training loss
(``forward_jit``, ``model.py:203-284``) -> (loss, stats, weight): SpecAug and the
encoder's dropout (``train()`` mode with a generator), the normalize layer, the CIF
predictor rescaled to the target lengths (``predictor_bias`` 1 appends eos, 2 wraps the
text in sos / eos), the glancing sampler (``sampling_ratio > 0``: a first decoder pass
under ``torch.no_grad()`` counts each row's errors and target embeddings replace that
share of the acoustic embeddings), the decoder, and label-smoothed CE (``lsm_weight``,
``length_normalized_loss``) + ``predictor_weight`` x the MAE token loss (+ CTC at
``ctc_weight``). Every random draw comes from the ``generator`` it is given; the sampler's
uniform draws can be passed in (``sampler_uniform``) so a test can feed JAX's.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from funasr_tpu_torch.core.layers import embedding, make_pad_mask
from funasr_tpu_torch.core.module import init_weights
from funasr_tpu_torch.losses.label_smoothing_loss import label_smoothing_loss, th_accuracy
from funasr_tpu_torch.models.ctc.ctc import CTC
from funasr_tpu_torch.models.normalize.normalize import build_normalize
from funasr_tpu_torch.models.paraformer.cif_predictor import mae_token_loss
from funasr_tpu_torch.register import tables
from funasr_tpu_torch.utils import postprocess_utils
from funasr_tpu_torch.utils.bucket import pad_feats_bucketed
from funasr_tpu_torch.utils.load_utils import extract_fbank, load_audio_text_image_video
from funasr_tpu_torch.utils.timestamp_tools import ts_prediction_lfr6_standard


def add_sos_eos_out(ys_pad, ys_lens, eos: int, ignore_id: int = -1):
    """ys_out = [text, eos, ignore ...] (B, L + 1) (``add_sos_eos_out``)."""
    b, l = ys_pad.shape
    valid = make_pad_mask(ys_lens, l)
    out = torch.full((b, l + 1), ignore_id, dtype=ys_pad.dtype, device=ys_pad.device)
    out[:, :l] = torch.where(valid, ys_pad, ignore_id)
    out[torch.arange(b, device=ys_pad.device), ys_lens.long()] = eos
    return out


def add_sos_and_eos(ys_pad, ys_lens, sos: int, eos: int, ignore_id: int = -1):
    """[sos] + text + [eos] (B, L + 2), ignore past it (``predictor_bias`` 2)."""
    b, l = ys_pad.shape
    col = torch.full((b, 1), sos, dtype=ys_pad.dtype, device=ys_pad.device)
    ys = torch.cat([col, ys_pad, torch.full_like(col, ignore_id)], dim=1)
    pos = torch.arange(l + 2, device=ys_pad.device)[None]
    eos_pos = (ys_lens + 1)[:, None]
    ys = torch.where(pos == eos_pos, eos, ys)
    return torch.where(pos > eos_pos, ignore_id, ys)


@tables.register("model_classes", "Paraformer")
class Paraformer(nn.Module):
    def __init__(
        self,
        specaug: Optional[str] = None,
        specaug_conf: Optional[Dict] = None,
        normalize: Optional[str] = None,
        normalize_conf: Optional[Dict] = None,
        encoder: str = "SANMEncoder",
        encoder_conf: Optional[Dict] = None,
        decoder: str = "ParaformerSANMDecoder",
        decoder_conf: Optional[Dict] = None,
        predictor: Optional[str] = "CifPredictorV2",
        predictor_conf: Optional[Dict] = None,
        ctc_conf: Optional[Dict] = None,
        ctc_weight: float = 0.0,
        input_size: int = 80,
        vocab_size: int = -1,
        ignore_id: int = -1,
        blank_id: int = 0,
        sos: int = 1,
        eos: int = 2,
        lsm_weight: float = 0.0,
        length_normalized_loss: bool = False,
        predictor_weight: float = 1.0,
        predictor_bias: int = 0,
        sampling_ratio: float = 0.2,
        device=None,
        generator: Optional[torch.Generator] = None,
        **kwargs,
    ):
        """``generator``: when given, every weight is drawn from it (the JAX package's
        init rules, ``core/module.py::init_weights``); otherwise torch's default init.
        ``ctc_weight > 0`` builds the CTC head ``ctc`` (``model.py:107-110``), which
        the training loss reads at ``ctc_weight`` and Paraformer-v2's decode; ``predictor=None``
        builds no predictor (Paraformer-v2). The training keys (specaug, lsm_weight,
        predictor_weight, predictor_bias, sampling_ratio, length_normalized_loss,
        ctc_weight) set ``forward``'s loss; ``normalize`` applies in ``encode``."""
        super().__init__()
        self.specaug = (tables.specaug_classes[specaug](**(specaug_conf or {}))
                        if specaug else None)
        self.normalize = build_normalize(normalize, normalize_conf)
        self.encoder = tables.encoder_classes[encoder](
            input_size=input_size, device=device, **(encoder_conf or {}))
        enc_out = self.encoder.output_size()
        self.decoder = tables.decoder_classes[decoder](
            vocab_size=vocab_size, encoder_output_size=enc_out, device=device,
            **(decoder_conf or {}))
        self.predictor = (None if predictor is None else tables.predictor_classes[predictor](
            device=device, **(predictor_conf or {})))
        self.ctc = (CTC(odim=vocab_size, encoder_output_size=enc_out, device=device,
                        **(ctc_conf or {})) if ctc_weight > 0.0 else None)
        self.vocab_size = vocab_size
        self.ignore_id = ignore_id
        self.blank_id = blank_id
        self.sos = sos if sos is not None else vocab_size - 1
        self.eos = eos if eos is not None else vocab_size - 1
        self.ctc_weight = ctc_weight
        self.lsm_weight = lsm_weight
        self.length_normalized_loss = length_normalized_loss
        self.predictor_weight = predictor_weight
        self.predictor_bias = predictor_bias
        self.sampling_ratio = sampling_ratio
        if generator is not None:
            init_weights(self, generator)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return next(self.parameters()).dtype

    # ------------------------------------------------------------------
    # device path
    # ------------------------------------------------------------------

    def encode(self, speech, speech_lengths, generator=None):
        """SpecAug and the encoder's dropout (``train()`` mode with a ``generator``, the JAX
        package's key), normalize, encoder (``model.py:152-157``)."""
        if self.specaug is not None and self.training and generator is not None:
            speech, speech_lengths = self.specaug(speech, speech_lengths, generator)
        if self.normalize is not None:
            speech, speech_lengths = self.normalize(speech, speech_lengths)
        return self.encoder(speech, speech_lengths, generator=generator)

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def forward(self, speech, speech_lengths, text, text_lengths, generator=None,
                sampler_uniform=None):
        """One batch's training loss (``forward_jit``): features (B, T, D) and their
        lengths, token ids (B, L) padded with ``ignore_id`` -> (loss, stats, weight);
        stats holds 0-d tensors (``loss``, ``loss_att``, ``loss_pre``, ``acc``,
        ``batch_size``; ``loss_ctc`` with CTC). ``generator`` draws SpecAug, dropout and
        the sampler's uniforms; ``sampler_uniform`` (B, L') replaces the latter. The
        subclasses that inherit ``forward_jit`` in JAX (E-Paraformer, Contextual) train
        through it."""
        encoder_out, encoder_out_lens = self.encode(speech, speech_lengths, generator)
        loss_ctc = None
        if self.ctc is not None and self.ctc_weight > 0.0:
            loss_ctc = self.ctc.loss(encoder_out, encoder_out_lens, text, text_lengths)

        ys_pad, ys_pad_lens = text, text_lengths
        if self.predictor_bias == 1:
            ys_pad = add_sos_eos_out(text, text_lengths, self.eos, self.ignore_id)
            ys_pad_lens = text_lengths + 1
        elif self.predictor_bias == 2:
            ys_pad = add_sos_and_eos(text, text_lengths, self.sos, self.eos, self.ignore_id)
            ys_pad_lens = text_lengths + 2

        mask = make_pad_mask(encoder_out_lens, encoder_out.shape[1])
        pre_acoustic_embeds, pre_token_length, _, _ = self.predictor(
            encoder_out, mask, ys_pad.shape[1], target_length=ys_pad_lens)
        return self.decoder_loss(encoder_out, encoder_out_lens, ys_pad, ys_pad_lens,
                                 pre_acoustic_embeds, pre_token_length, loss_ctc, text_lengths,
                                 generator, sampler_uniform)

    def decoder_loss(self, memory, memory_lens, ys_pad, ys_pad_lens, pre_acoustic_embeds,
                     pre_token_length, loss_ctc, text_lengths, generator=None,
                     sampler_uniform=None):
        """The loss's second half (``forward_jit``'s, ``ParaformerStreaming``'s too): the
        glancing sampler and the decoder over ``memory``, label-smoothed CE +
        ``predictor_weight`` x the MAE token loss (+ ``loss_ctc`` at ``ctc_weight``) ->
        (loss, stats, weight)."""
        stats = {} if loss_ctc is None else {"loss_ctc": loss_ctc}
        if self.sampling_ratio > 0.0:
            sematic_embeds, dec_out_1st = self._sampler(
                memory, memory_lens, ys_pad, ys_pad_lens, pre_acoustic_embeds, generator,
                sampler_uniform)
        else:
            sematic_embeds, dec_out_1st = pre_acoustic_embeds, None

        decoder_out, _ = self.decoder(memory, memory_lens, sematic_embeds, ys_pad_lens)
        if dec_out_1st is None:
            dec_out_1st = decoder_out
        loss_att = label_smoothing_loss(
            decoder_out, ys_pad, ignore_id=self.ignore_id, smoothing=self.lsm_weight,
            vocab_size=self.vocab_size, normalize_length=self.length_normalized_loss)
        loss_pre = mae_token_loss(ys_pad_lens, pre_token_length)
        acc_att = th_accuracy(dec_out_1st, ys_pad, self.ignore_id)
        if loss_ctc is not None:
            loss = (self.ctc_weight * loss_ctc + (1 - self.ctc_weight) * loss_att
                    + loss_pre * self.predictor_weight)
        else:
            loss = loss_att + loss_pre * self.predictor_weight
        batch_size = ys_pad.shape[0]
        stats.update(loss_att=loss_att, loss_pre=loss_pre, acc=acc_att, loss=loss,
                     batch_size=torch.tensor(batch_size))
        weight = ((text_lengths + self.predictor_bias).sum() if self.length_normalized_loss
                  else batch_size)
        return loss, stats, weight

    def _sampler(self, encoder_out, encoder_out_lens, ys_pad, ys_pad_lens,
                 pre_acoustic_embeds, generator=None, uniform=None):
        """Glancing sampler (``_sampler``, ``model.py:171-201``): a decoder pass under
        ``torch.no_grad()`` over the acoustic embeddings; in each row, a random
        ``sampling_ratio`` share of its wrong tokens' slots take the target's embedding
        (the ``target_num`` valid slots of lowest uniform draw). -> (semantic embeds,
        the first pass's logits masked to the targets)."""
        b, l = ys_pad.shape
        tgt_mask = make_pad_mask(ys_pad_lens, l)
        ys_masked = torch.where(tgt_mask, ys_pad, 0)
        ys_embed = embedding(ys_masked, self.decoder.embed[0].weight,
                             dtype=pre_acoustic_embeds.dtype)
        with torch.no_grad():
            dec_out, _ = self.decoder(encoder_out, encoder_out_lens, pre_acoustic_embeds,
                                      ys_pad_lens)
        pred = dec_out.argmax(dim=-1)
        nonpad = ys_pad != self.ignore_id
        seq_lens = nonpad.sum(dim=1)
        same = ((pred == ys_pad) & nonpad).sum(dim=1)
        target_num = ((seq_lens - same).float() * self.sampling_ratio).to(torch.int64)
        if uniform is None:
            uniform = torch.rand((b, l), generator=generator, device=ys_pad.device)
        u = torch.where(nonpad, uniform.to(ys_pad.device), torch.inf)
        rank = torch.argsort(torch.argsort(u, dim=1), dim=1)
        replace = (rank < target_num[:, None]) & nonpad
        sematic = torch.where(replace[..., None], ys_embed, pre_acoustic_embeds)
        sematic = sematic * tgt_mask[..., None].to(sematic.dtype)
        return sematic, dec_out * tgt_mask[..., None]

    def calc_predictor(self, encoder_out, encoder_out_lens,
                       max_tokens: Optional[int] = None):
        mask = make_pad_mask(encoder_out_lens, encoder_out.shape[1])
        k = max_tokens if max_tokens is not None else encoder_out.shape[1] + 1
        return self.predictor(encoder_out, mask, k)

    def cal_decoder_with_predictor(self, encoder_out, encoder_out_lens, sematic_embeds,
                                   ys_pad_lens, context=None):
        """fp32 log-probs (B, K, vocab) of the decoder; ``context`` is the hotword models'
        (``decode_context``), None here."""
        logits, olens = self.decoder(encoder_out, encoder_out_lens, sematic_embeds,
                                     ys_pad_lens)
        return torch.log_softmax(logits.float(), dim=-1), olens

    def infer_core(self, speech, speech_lengths, max_tokens: Optional[int] = None,
                   context=None):
        """Batched greedy decode -> (yseq (B,K), token_lens (B,), score (B,),
        alphas (B,T+1), peaks (B,T+1), encoder_out, encoder_out_lens)."""
        encoder_out, encoder_out_lens = self.encode(speech, speech_lengths)
        pre_acoustic_embeds, pre_token_length, alphas, peaks = self.calc_predictor(
            encoder_out, encoder_out_lens, max_tokens)
        k = pre_acoustic_embeds.shape[1]
        token_lens = torch.clamp(torch.round(pre_token_length).to(torch.int32), 0, k)
        decoder_out, _ = self.cal_decoder_with_predictor(
            encoder_out, encoder_out_lens, pre_acoustic_embeds, token_lens, context)
        yseq = decoder_out.argmax(dim=-1).to(torch.int32)
        tok_valid = make_pad_mask(token_lens, k)
        score = (decoder_out.max(dim=-1).values * tok_valid).sum(dim=-1)
        yseq = torch.where(tok_valid, yseq, self.blank_id)
        return (yseq, token_lens, score, alphas, peaks, encoder_out, encoder_out_lens)

    # ------------------------------------------------------------------
    # host orchestration
    # ------------------------------------------------------------------

    # decoder token budget per T-bucket: CIF fires ~T/6 tokens on real speech, so
    # T/2+16 is a ~3x margin (funasr_tpu/models/paraformer/model.py:303-309)
    MAX_TOKENS_RATIO = 0.5

    def _max_tokens_for(self, t_bucket: int) -> int:
        return min(int(t_bucket * self.MAX_TOKENS_RATIO) + 16, t_bucket + 1)

    @torch.inference_mode()
    def infer_bucketed(self, speech, speech_lengths):
        """Pad (B, T) to the bucket grid, decode, slice back to the real batch. If any
        utterance saturates the token budget, re-decode with the full T+1 budget so
        the transcript is never truncated. Returns (yseq, token_lens, score, alphas,
        peaks) as numpy arrays for the real B."""
        dev = self.device
        speech = torch.as_tensor(speech, device=dev)
        speech_lengths = torch.as_tensor(speech_lengths, device=dev)
        sp, ln, b = pad_feats_bucketed(speech, speech_lengths)
        sp = sp.to(self.dtype)
        mt = self._max_tokens_for(sp.shape[1])
        out = self.infer_core(sp, ln, mt)[:5]
        token_lens = out[1].cpu().numpy()
        if mt <= sp.shape[1] and (token_lens[:b] >= mt).any():
            logging.warning("CIF token count hit the %d-token bucket budget; "
                            "re-decoding with the full budget", mt)
            out = self.infer_core(sp, ln, sp.shape[1] + 1)[:5]
        return tuple(x[:b].float().cpu().numpy() if x.is_floating_point()
                     else x[:b].cpu().numpy() for x in out)

    def inference(self, data_in, data_lengths=None, key=None, tokenizer=None,
                  frontend=None, **kwargs):
        """waveforms -> text (reference contract ``model.py:534-697``):
        ``inference_fetch(inference_dispatch(...))``.

        ``data_in``: one input or a list of numpy waveforms (float32 in [-1, 1) or raw
        int16 PCM), ``.wav`` / ``.pcm`` paths and bytes. Returns (results, meta): one
        ``{"key", "text"}`` per input (``{"key", "token_int"}`` without a tokenizer), with
        ``"timestamp"`` (ms per token) under ``pred_timestamp=True``.
        """
        return self.inference_fetch(self.inference_dispatch(
            data_in, data_lengths=data_lengths, key=key, tokenizer=tokenizer,
            frontend=frontend, **kwargs))

    def wants_timestamps(self, kwargs) -> bool:
        return bool(kwargs.get("pred_timestamp", False))

    def decode_context(self, kwargs, tokenizer):
        """What the decode needs of this call beyond the audio: None here; the hotword
        models' biasing lists (``hotword=``)."""
        return None

    def decode_outputs(self, sp, ln, max_tokens: int, timestamps: bool, context=None):
        """One padded batch on the device -> (yseq (B, K), token_lens (B,), enc_lens (B,),
        ts): ts is the CIF's (alphas, peaks), each (B, T + 1), when ``timestamps``, else
        None."""
        yseq, token_lens, _, alphas, peaks, _, enc_lens = self.infer_core(sp, ln, max_tokens,
                                                                         context)
        return yseq, token_lens, enc_lens, ((alphas, peaks) if timestamps else None)

    def inference_dispatch(self, data_in, data_lengths=None, key=None, tokenizer=None,
                           frontend=None, **kwargs):
        """Load, upload and launch the decode without waiting for the device
        (``model.py:357-391``): returns a handle for :meth:`inference_fetch`. Launches
        are asynchronous, so the caller can prepare the next batch while this one runs
        (``AutoModel.inference`` double-buffers with the pair)."""
        meta_data = {}
        t0 = time.perf_counter()
        audio_list = load_audio_text_image_video(
            data_in, fs=frontend.fs, audio_fs=kwargs.get("fs", 16000),
            data_type=kwargs.get("data_type", "sound"))
        t1 = time.perf_counter()
        meta_data["load_data"] = f"{t1 - t0:0.3f}"
        speech, speech_lengths = extract_fbank(
            audio_list, data_type=kwargs.get("data_type", "sound"), frontend=frontend,
            device=self.device)
        meta_data["extract_feat"] = f"{time.perf_counter() - t1:0.3f}"
        timestamps = self.wants_timestamps(kwargs)
        context = self.decode_context(kwargs, tokenizer)
        with torch.inference_mode():
            sp, ln, b = pad_feats_bucketed(speech, speech_lengths)
            sp = sp.to(self.dtype)
            mt = self._max_tokens_for(sp.shape[1])
            out = self.decode_outputs(sp, ln, mt, timestamps, context)
            packed = _pack(ln, out, b)
        return {"packed": packed, "k": out[0].shape[1], "sp": sp, "ln": ln, "mt": mt,
                "b": b, "timestamps": timestamps, "context": context, "key": key,
                "tokenizer": tokenizer,
                "frontend": frontend, "kwargs": kwargs, "meta": meta_data}

    def inference_fetch(self, handle):
        """The blocking half (``model.py:393-438``): one device-to-host copy, the
        token-budget retry, detokenize. Returns (results, meta) as :meth:`inference`."""
        b, sp, mt = handle["b"], handle["sp"], handle["mt"]
        tokenizer, key, frontend = handle["tokenizer"], handle["key"], handle["frontend"]
        meta_data = handle["meta"]
        ints, ts = _unpack(handle["packed"].cpu().numpy(), handle["k"])
        speech_lengths = ints[:, 0]
        if mt <= sp.shape[1] and (ints[:, 1] >= mt).any():
            logging.warning("CIF token count hit the %d-token bucket budget; "
                            "re-decoding with the full budget", mt)
            with torch.inference_mode():
                out = self.decode_outputs(sp, handle["ln"], sp.shape[1] + 1,
                                          handle["timestamps"], handle["context"])
                ints, ts = _unpack(_pack(handle["ln"], out, b).cpu().numpy(),
                                   out[0].shape[1])
        token_lens, enc_lens, yseq = ints[:, 1], ints[:, 2], ints[:, 3:]
        meta_data["batch_data_time"] = (
            float(speech_lengths.sum()) * frontend.frame_shift_ms * frontend.lfr_n / 1000.0)

        if key is None:
            key = [f"rand_key_{i}" for i in range(b)]
        results = []
        for i in range(b):
            token_int = [int(t) for t in yseq[i, : token_lens[i]]
                         if t not in (self.blank_id, self.sos, self.eos)]
            if tokenizer is None:
                results.append({"key": key[i], "token_int": token_int})
                continue
            token = tokenizer.ids2tokens(token_int)
            row_ts = None if ts is None else (ts[0][i], ts[1][i])
            results.append({"key": key[i], **self.transcript(
                token, tokenizer, int(enc_lens[i]), row_ts, handle["kwargs"])})
        return results, meta_data

    def transcript(self, token, tokenizer, enc_len: int, ts, kwargs) -> dict:
        """One row's ``{"text"[, "timestamp"]}`` from its tokens and, under
        ``pred_timestamp``, its CIF (alphas, peaks) (``model.py:420-435``). The JAX
        package passes the peaks in ``ts_prediction_lfr6_standard``'s alphas slot and
        the alphas in its peaks slot; the port copies that order (ROADMAP section 3)."""
        text = tokenizer.tokens2text(token)
        if ts is not None:
            alphas, peaks = ts
            _, timestamp = ts_prediction_lfr6_standard(
                peaks, alphas, list(token), vad_offset=kwargs.get("begin_time", 0),
                upsample_rate=1)
            text, timestamp, _ = postprocess_utils.sentence_postprocess(token, timestamp)
            return {"text": text, "timestamp": timestamp}
        if not hasattr(tokenizer, "bpemodel"):
            text, _ = postprocess_utils.sentence_postprocess(token)
        return {"text": text}


def _pack(ln, out, b: int):
    """The first ``b`` rows of a decode's outputs as one block, for a single
    device-to-host copy: int32 (B, 3 + K) = [speech length, token count, encoder
    length, ids]; with timestamps, that block's bits viewed as fp32 followed by the two
    timestamp arrays, (B, 3 + K + 2 T')."""
    yseq, token_lens, enc_lens, ts = out
    ints = torch.cat([ln[:b, None], token_lens[:b, None], enc_lens[:b, None].to(torch.int32),
                      yseq[:b]], dim=1).to(torch.int32)
    if ts is None:
        return ints
    return torch.cat([ints.view(torch.float32), ts[0][:b].float(), ts[1][:b].float()], dim=1)


def _unpack(block, k: int):
    """``_pack``'s block on the host -> (int32 (B, 3 + K), None or (a, b) fp32 rows)."""
    if block.dtype == np.int32:
        return block, None
    ints = np.ascontiguousarray(block[:, : 3 + k]).view(np.int32)
    rest = block[:, 3 + k:]
    n = rest.shape[1] // 2
    return ints, (rest[:, :n], rest[:, n:])
