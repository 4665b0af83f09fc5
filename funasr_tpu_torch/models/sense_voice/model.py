"""SenseVoiceSmall in PyTorch: non-autoregressive multilingual ASR with language,
emotion and audio-event tags (counterpart of ``funasr_tpu/models/sense_voice/model.py``;
FunASR ``funasr/models/sense_voice/model.py``: ``SenseVoiceEncoderSmall:488-655``,
``SenseVoiceSmall:658-1120``).

Four query frames from a 16-row ``embed`` table, [language | event, emotion | textnorm],
go before the fbank frames; the SAN-M encoder (``encoders0`` -> ``encoders`` ->
``after_norm`` -> ``tp_encoders`` -> ``tp_norm``, its output NOT masked) and the CTC head
give fp32 log-probs, whose argmax the host collapses (repeats merged, blanks dropped).
The encoder reuses the port's ``EncoderLayerSANM``, so every self-attention runs the
flash kernel and every FSMN memory the FSMN kernel on the card.

``inference`` buckets the features as the JAX package does (``pad_feats_bucketed``)
before the prompt, so a 15 s batch encodes at T = 384 + 4. The (B, T, vocab) log-probs
stay on the device; one device-to-host copy a batch carries the speech lengths and the
ids, as the JAX program drops the logits (``_sv_infer_program``). The training loss (CTC
on frames 4+ and CE on the prompt positions) comes with the training slice.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from funasr_tpu_torch.core.layers import LayerNorm, add_sinusoidal_pe, embedding, make_pad_mask
from funasr_tpu_torch.core.module import init_weights
from funasr_tpu_torch.models.ctc.ctc import CTC
from funasr_tpu_torch.models.sanm.encoder import EncoderLayerSANM, SANMEncoderConfig
from funasr_tpu_torch.register import tables
from funasr_tpu_torch.utils.bucket import pad_feats_bucketed
from funasr_tpu_torch.utils.load_utils import extract_fbank, load_audio_text_image_video


@tables.register("encoder_classes", "SenseVoiceEncoderSmall")
class SenseVoiceEncoderSmall(nn.Module):
    def __init__(self, input_size: int, output_size: int = 512, attention_heads: int = 4,
                 linear_units: int = 2048, num_blocks: int = 6, tp_blocks: int = 0,
                 kernel_size: int = 11, sanm_shfit: int = 0, device=None, **kwargs):
        super().__init__()
        self.cfg = cfg = SANMEncoderConfig(
            input_size=input_size, output_size=output_size, attention_heads=attention_heads,
            linear_units=linear_units, num_blocks=num_blocks, kernel_size=kernel_size,
            sanm_shift=sanm_shfit)
        self.tp_blocks = tp_blocks
        self.encoders0 = nn.ModuleList([EncoderLayerSANM(cfg, True, device)])
        self.encoders = nn.ModuleList(
            [EncoderLayerSANM(cfg, False, device) for _ in range(num_blocks - 1)])
        self.after_norm = LayerNorm(output_size, device=device)
        self.tp_encoders = nn.ModuleList(
            [EncoderLayerSANM(cfg, False, device) for _ in range(tp_blocks)])
        self.tp_norm = LayerNorm(output_size, device=device)

    def output_size(self) -> int:
        return self.cfg.output_size

    def forward(self, xs_pad, ilens):
        """xs_pad (B, T, input_size), ilens (B,) -> ((B, T, out) unmasked, ilens)."""
        mask = make_pad_mask(ilens, xs_pad.shape[1])
        x = add_sinusoidal_pe(xs_pad * (self.cfg.output_size ** 0.5))
        for layer in (*self.encoders0, *self.encoders):
            x = layer(x, mask, ilens)
        x = self.after_norm(x)
        for layer in self.tp_encoders:
            x = layer(x, mask, ilens)
        return self.tp_norm(x), ilens


@tables.register("model_classes", "SenseVoiceSmall")
class SenseVoiceSmall(nn.Module):
    LID_DICT = {"auto": 0, "zh": 3, "en": 4, "yue": 7, "ja": 11, "ko": 12, "nospeech": 13}
    LID_INT_DICT = {24884: 3, 24885: 4, 24888: 7, 24892: 11, 24896: 12, 24992: 13}
    TEXTNORM_DICT = {"withitn": 14, "woitn": 15}
    TEXTNORM_INT_DICT = {25016: 14, 25017: 15}
    EMO_UNK = 25009

    def __init__(self, specaug: Optional[str] = None, normalize: Optional[str] = None,
                 encoder: str = "SenseVoiceEncoderSmall", encoder_conf: Optional[dict] = None,
                 ctc_conf: Optional[dict] = None, input_size: int = 80, vocab_size: int = -1,
                 blank_id: int = 0, sos: int = 1, eos: int = 2, device=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        """``generator``: every weight drawn from it (``init_weights``), else torch's
        default init. ``specaug`` and the loss keys are training's and ignored; a
        ``normalize`` layer is not ported."""
        super().__init__()
        if normalize is not None:
            raise NotImplementedError(f"normalize={normalize} is not ported")
        self.encoder = tables.encoder_classes[encoder](
            input_size=input_size, device=device, **(encoder_conf or {}))
        self.ctc = CTC(odim=vocab_size, encoder_output_size=self.encoder.output_size(),
                       device=device, **(ctc_conf or {}))
        self.embed = nn.Embedding(7 + len(self.LID_DICT) + len(self.TEXTNORM_DICT),
                                  input_size, device=device)
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

    def with_prompt(self, speech, speech_lengths, lid_ids, textnorm_ids):
        """Prepend the [language | event, emotion | textnorm] query frames
        (``_with_prompt``, JAX ``:140-153``); lid_ids / textnorm_ids (B,) query-table
        ids. Returns (B, T + 4, D), lengths + 4."""
        b = speech.shape[0]

        def emb(ids):
            return embedding(ids, self.embed.weight, dtype=speech.dtype)

        event_emo = emb(torch.arange(1, 3, device=speech.device))[None].expand(b, -1, -1)
        speech = torch.cat([emb(lid_ids)[:, None], event_emo, emb(textnorm_ids)[:, None],
                            speech], dim=1)
        return speech, speech_lengths + 4

    def infer(self, speech, speech_lengths, lid_ids, tn_ids, ban_emo_unk: bool = False):
        """Batched CTC argmax over the padded frames (``infer_jit``, JAX ``:193-208``) ->
        (ids (B, T + 4) int32, lengths (B,), fp32 log-probs (B, T + 4, vocab)). The
        argmax is taken of the log-probs, as in JAX, so ties fall alike."""
        speech, speech_lengths = self.with_prompt(speech, speech_lengths, lid_ids, tn_ids)
        encoder_out, encoder_out_lens = self.encoder(speech, speech_lengths)
        logp = self.ctc.log_softmax(encoder_out)
        if ban_emo_unk and self.EMO_UNK < logp.shape[-1]:  # JAX drops an index past V
            logp[:, :, self.EMO_UNK] = -torch.inf
        return logp.argmax(dim=-1).to(torch.int32), encoder_out_lens, logp

    def query_ids(self, kwargs):
        """The call's (language, textnorm) query-table ids (JAX ``:234-238``)."""
        lid = self.LID_DICT.get(kwargs.get("language", "auto") or "auto", 0)
        textnorm = kwargs.get("text_norm") or ("withitn" if kwargs.get("use_itn", False)
                                              else "woitn")
        return lid, self.TEXTNORM_DICT[textnorm]

    def inference(self, data_in, data_lengths=None, key: Optional[List] = None,
                  tokenizer=None, frontend=None, **kwargs):
        """waveforms -> rich text (JAX ``:210-255``): ``language`` ("auto", "zh", "en",
        "yue", "ja", "ko", "nospeech"), ``use_itn`` / ``text_norm`` and ``ban_emo_unk``
        set the prompt and the decode. Returns (results, meta), one ``{"key", "text"}``
        per input, the text with its ``<|tag|>``s."""
        meta = {}  # the features are cast to the weights' dtype, as Paraformer's are
        t0 = time.perf_counter()
        audio_list = load_audio_text_image_video(
            data_in, fs=frontend.fs, audio_fs=kwargs.get("fs", 16000),
            data_type=kwargs.get("data_type", "sound"))
        meta["load_data"] = f"{time.perf_counter() - t0:0.3f}"
        t1 = time.perf_counter()
        speech, speech_lengths = extract_fbank(audio_list, frontend=frontend,
                                               device=self.device)
        meta["extract_feat"] = f"{time.perf_counter() - t1:0.3f}"
        lid, tn = self.query_ids(kwargs)
        with torch.inference_mode():
            sp, ln, b = pad_feats_bucketed(speech, speech_lengths)
            full = torch.full((sp.shape[0],), lid, dtype=torch.long, device=sp.device)
            yseq, out_lens, _ = self.infer(sp.to(self.dtype), ln, full,
                                           torch.full_like(full, tn),
                                           kwargs.get("ban_emo_unk", False))
            # the one device-to-host copy: [speech length, encoder length, ids]
            block = torch.cat([ln[:b, None], out_lens[:b, None].to(torch.int32), yseq[:b]],
                              dim=1).cpu().numpy()
        meta["batch_data_time"] = (float(block[:, 0].sum()) * frontend.frame_shift_ms
                                   * frontend.lfr_n / 1000)

        if key is None:
            key = [f"rand_key_{i}" for i in range(b)]
        results = []
        for i in range(b):
            ids = block[i, 2:2 + block[i, 1]]
            # collapse repeats then drop blanks (CTC greedy)
            keep = np.concatenate([[True], ids[1:] != ids[:-1]])
            token_int = [int(t) for t in ids[keep] if t != self.blank_id]
            text = tokenizer.decode(token_int) if tokenizer is not None else ""
            results.append({"key": key[i], "text": text})
        return results, meta
