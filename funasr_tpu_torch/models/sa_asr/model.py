"""SA-ASR in PyTorch: speaker-attributed ASR, "who spoke what" (counterpart of
``funasr_tpu/models/sa_asr/model.py``; FunASR ``funasr/models/sa_asr/`` lineage), and
``LCBNetNAR``, the JAX package's non-autoregressive long-context biasing.

``SAASR`` is the port's Paraformer (SAN-M encoder, CIF, NAR decoder: on CUDA the flash
and FSMN kernels) plus a speaker branch: the profiles (B, S, 192) through ``spk_proj``,
then a cross attention of each decoded token's hidden state over them, whose
head-averaged attention is the speaker posterior (``_spk_logits``, JAX ``:48-57``).
``forward`` adds ``spk_weight`` x the speaker CE to the Paraformer loss, over a second
encode and the decoder's hidden states at the target length (the reference's batch
names ``profile`` / ``text_id`` are taken too). ``inference`` runs the decoder twice, for
the hidden states and for the logits, as the JAX package does, and gives
{"key", "text", "spk_ids"} (a speaker a token) when ``profiles=`` is given.

``LCBNetNAR``: the OCR text (``ocr_text=``) through the decoder's token table and a
``TransformerEncoder`` (no input layer), fused into the decoder's hidden states by a cross
attention (``bias_fuse``) before the output layer.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn

import funasr_tpu_torch.models.transformer.encoder  # noqa: F401
from funasr_tpu_torch.core.layers import apply_linear, embedding, make_pad_mask
from funasr_tpu_torch.core.module import init_weights
from funasr_tpu_torch.losses.label_smoothing_loss import label_smoothing_loss
from funasr_tpu_torch.models.paraformer.model import Paraformer, add_sos_eos_out
from funasr_tpu_torch.models.sanm.attention import (CrossAttentionConfig,
                                                    MultiHeadedAttentionCrossAtt,
                                                    cross_attention_apply)
from funasr_tpu_torch.models.transformer.encoder import TransformerEncoder
from funasr_tpu_torch.register import tables
from funasr_tpu_torch.utils import postprocess_utils
from funasr_tpu_torch.utils.load_utils import extract_fbank, load_audio_text_image_video


def _features(model, data_in, frontend, kwargs):
    audio_list = load_audio_text_image_video(data_in, fs=frontend.fs,
                                             audio_fs=kwargs.get("fs", 16000))
    speech, lens = extract_fbank(audio_list, frontend=frontend)
    return (torch.from_numpy(speech).to(model.device, model.dtype),
            torch.from_numpy(lens).to(model.device))


def _decode_hidden(model, speech, lens):
    """encode, CIF, the decoder's hidden states -> (encoder out, its lengths, embeds,
    token lengths, hidden)."""
    enc, enc_lens = model.encode(speech, lens)
    embeds, tok_num, _, _ = model.calc_predictor(enc, enc_lens)
    tok_lens = torch.clamp(torch.round(tok_num).to(torch.int32), 0, embeds.shape[1])
    hidden, _ = model.decoder(enc, enc_lens, embeds, tok_lens, return_hidden=True)
    return enc, enc_lens, embeds, tok_lens, hidden


@tables.register("model_classes", "SAASR")
@tables.register("model_classes", "SAAsr")
class SAASR(Paraformer):
    def __init__(self, *args, spk_embed_dim: int = 192, max_spk_num: int = 16,
                 spk_weight: float = 0.5, spk_attention_heads: int = 4, device=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__(*args, device=device, **kwargs)
        self.spk_embed_dim = spk_embed_dim
        self.max_spk_num = max_spk_num
        self.spk_weight = spk_weight
        enc_out = self.encoder.output_size()
        self.spk_cross_cfg = CrossAttentionConfig(spk_attention_heads, enc_out, enc_out)
        self.spk_proj = nn.Linear(spk_embed_dim, enc_out, device=device)
        self.spk_attn = MultiHeadedAttentionCrossAtt(self.spk_cross_cfg, device=device)
        self.spk_norm_w = nn.Parameter(torch.tensor(1.0, device=device))
        if generator is not None:
            init_weights(self, generator)

    def spk_logits(self, decoder_hidden, profiles):
        """decoder_hidden (B, L, D), profiles (B, S, E) -> (B, L, S) fp32 log of the
        head-averaged attention over the profiles."""
        prof = apply_linear(self.spk_proj, profiles.to(decoder_hidden.dtype))
        _, attn = cross_attention_apply(self.spk_attn, decoder_hidden, prof, None,
                                        ret_attn=True)
        return torch.log(attn.float().mean(dim=1) + 1e-9)

    def forward(self, speech, speech_lengths, text, text_lengths, generator=None,
                sampler_uniform=None, profiles=None, spk_labels=None, profile=None,
                profile_lengths=None, text_id=None, text_id_lengths=None, **kwargs):
        profiles = profiles if profiles is not None else profile
        spk_labels = spk_labels if spk_labels is not None else text_id
        loss, stats, weight = super().forward(speech, speech_lengths, text, text_lengths,
                                              generator, sampler_uniform)
        if profiles is None or spk_labels is None:
            return loss, stats, weight
        enc, enc_lens = self.encode(speech, speech_lengths)
        ys = (add_sos_eos_out(text, text_lengths, self.eos, self.ignore_id)
              if self.predictor_bias == 1 else text)
        ys_lens = text_lengths + self.predictor_bias
        mask = make_pad_mask(enc_lens, enc.shape[1])
        embeds, _, _, _ = self.predictor(enc, mask, ys.shape[1], target_length=ys_lens)
        hidden, _ = self.decoder(enc, enc_lens, embeds, ys_lens, return_hidden=True)
        spk = self.spk_logits(hidden, profiles)
        loss_spk = label_smoothing_loss(spk, spk_labels, self.ignore_id, 0.0, spk.shape[-1])
        loss = loss + self.spk_weight * loss_spk
        stats = dict(stats, loss_spk=loss_spk, loss=loss)
        return loss, stats, weight

    def inference(self, data_in, data_lengths=None, key: Optional[List] = None,
                  tokenizer=None, frontend=None, profiles=None, **kwargs):
        speech, lens = _features(self, data_in, frontend, kwargs)
        with torch.inference_mode():
            enc, enc_lens, embeds, tok_lens, hidden = _decode_hidden(self, speech, lens)
            logits, _ = self.decoder(enc, enc_lens, embeds, tok_lens)
            yseq = logits.argmax(-1)
            spk_ids = None
            if profiles is not None:
                spk_ids = self.spk_logits(hidden, torch.as_tensor(
                    np.asarray(profiles), device=self.device)).argmax(-1).cpu().numpy()
            yseq, tok_lens = yseq.cpu().numpy(), tok_lens.cpu().numpy()
        if key is None:
            key = [f"rand_key_{i}" for i in range(yseq.shape[0])]
        results = []
        for i in range(yseq.shape[0]):
            ids, spks = [], []
            for j in range(tok_lens[i]):
                tok = int(yseq[i, j])
                if tok in (self.blank_id, self.sos, self.eos):
                    continue
                ids.append(tok)
                if spk_ids is not None:
                    spks.append(int(spk_ids[i, j]))
            if tokenizer is not None:
                text, _ = postprocess_utils.sentence_postprocess(tokenizer.ids2tokens(ids))
            else:
                text = ids
            result = {"key": key[i], "text": text}
            if spk_ids is not None:
                result["spk_ids"] = spks
            results.append(result)
        return results, {}


@tables.register("model_classes", "LCBNetNAR")
class LCBNetNAR(Paraformer):
    """The bias text through a transformer, fused into the decoder's hidden states by
    cross attention before the output layer."""

    def __init__(self, *args, bias_encoder_blocks: int = 2, bias_attention_heads: int = 4,
                 device=None, generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__(*args, device=device, **kwargs)
        enc_out = self.encoder.output_size()
        self.bias_text_encoder = TransformerEncoder(
            input_size=enc_out, output_size=enc_out, attention_heads=bias_attention_heads,
            linear_units=enc_out * 4, num_blocks=bias_encoder_blocks, input_layer=None,
            device=device)
        self.bias_cross_cfg = CrossAttentionConfig(bias_attention_heads, enc_out, enc_out)
        self.bias_attn = MultiHeadedAttentionCrossAtt(self.bias_cross_cfg, device=device)
        if generator is not None:
            init_weights(self, generator)

    def bias_fuse(self, hidden, bias_ids):
        """hidden (B, L, D) + cross attention over the encoded bias ids (B, N)."""
        emb = embedding(bias_ids, self.decoder.embed[0].weight, dtype=hidden.dtype)
        lens = torch.full((emb.shape[0],), emb.shape[1], dtype=torch.int32,
                          device=emb.device)
        enc, _ = self.bias_text_encoder(emb, lens)
        return hidden + cross_attention_apply(self.bias_attn, hidden, enc, None)

    def inference(self, data_in, data_lengths=None, key=None, tokenizer=None, frontend=None,
                  ocr_text=None, **kwargs):
        speech, lens = _features(self, data_in, frontend, kwargs)
        with torch.inference_mode():
            _, _, _, tok_lens, hidden = _decode_hidden(self, speech, lens)
            if ocr_text and tokenizer is not None:
                bias_ids = torch.tensor([tokenizer.encode(ocr_text)], dtype=torch.long,
                                        device=self.device)
                hidden = self.bias_fuse(hidden, bias_ids.expand(hidden.shape[0], -1))
            yseq = apply_linear(self.decoder.output_layer, hidden).argmax(-1).cpu().numpy()
            tok_lens = tok_lens.cpu().numpy()
        if key is None:
            key = [f"rand_key_{i}" for i in range(yseq.shape[0])]
        results = []
        for i in range(yseq.shape[0]):
            ids = [int(t) for t in yseq[i, : tok_lens[i]]
                   if t not in (self.blank_id, self.sos, self.eos)]
            if tokenizer is not None:
                text, _ = postprocess_utils.sentence_postprocess(tokenizer.ids2tokens(ids))
                results.append({"key": key[i], "text": text})
            else:
                results.append({"key": key[i], "token_int": ids})
        return results, {}
