"""FSMN / SAN-M keyword spotting in PyTorch (counterpart of
``funasr_tpu/models/fsmn_kws/model.py``; FunASR ``funasr/models/fsmn_kws/model.py:27``,
``sanm_kws/``, ``fsmn_kws_mt/``, ``sanm_kws_streaming/``, decode helpers
``funasr/utils/kws_utils.py``).

An encoder and a CTC head: the FSMN (``models/fsmn_vad_streaming/encoder.py``, its memory
on the FSMN kernel; the recipes' lorder 10 / rorder 2 lookahead is one k 12 launch a
block) gives the logits itself when its ``output_dim`` is the vocabulary, with no CTC
head; any other encoder (``SANMEncoder`` for ``SanmKWS``) runs into ``CTC``.

* ``forward``: the CTC loss (``losses/ctc.py``, optax's recursion) averaged over the
  batch. The FSMN takes no lengths: padded frames are not masked, as in the JAX package.
* ``detect``: fp32 log-softmax on the device, one copy to the host, then per utterance
  and keyword the host viterbi (``ops/ctc_align.py::ctc_forced_align``, JAX's
  first-maximum rule); the score is ``(ll - blank_ll) / len(tokens)`` against
  ``kws_threshold``.
* ``inference``: ``decode_mode`` "forced_align" (default, every keyword over the
  threshold) or "prefix_beam" (``utils/kws_utils.py::KwsCtcPrefixDecoder``: the first
  keyword hit, its sqrt-compressed confidence and frame span). ``keywords=`` is a string
  (comma or space separated) or a list.
* ``FsmnKWSStreaming.detect_chunk``: one feature chunk, the FSMN's caches carried in the
  dict, detections over a rolling window of ``window_frames`` log-prob rows. Its
  ``inference`` is the offline one, as in the JAX package (a ``cache=`` is ignored).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

import funasr_tpu_torch.models.fsmn_vad_streaming.encoder  # noqa: F401 (registers FSMN)
import funasr_tpu_torch.models.sanm.encoder  # noqa: F401 (registers SANMEncoder)
from funasr_tpu_torch.core.module import init_weights
from funasr_tpu_torch.losses.ctc import ctc_loss
from funasr_tpu_torch.models.ctc.ctc import CTC
from funasr_tpu_torch.ops.ctc_align import ctc_forced_align
from funasr_tpu_torch.parallel.sharding import global_count
from funasr_tpu_torch.register import tables
from funasr_tpu_torch.utils.load_utils import extract_fbank, load_audio_text_image_video


def keyword_score(logp: np.ndarray, tokens, blank_id: int, blank_ll: float) -> float:
    """The forced-align log-likelihood of ``tokens`` over ``logp`` (T, V), less the
    all-blank path's ``blank_ll``, per token."""
    toks = np.asarray(tokens, np.int64)
    t = logp.shape[0]
    path = ctc_forced_align(logp, toks, t, len(toks), blank_id)
    ll = float(logp[np.arange(t), path].sum())
    return (ll - blank_ll) / max(len(toks), 1)


@tables.register("model_classes", "FsmnKWS")
@tables.register("model_classes", "SanmKWS")
class FsmnKWS(nn.Module):
    def __init__(self, specaug: Optional[str] = None, specaug_conf: Optional[Dict] = None,
                 normalize: Optional[str] = None, normalize_conf: Optional[Dict] = None,
                 encoder: str = "FSMN", encoder_conf: Optional[Dict] = None,
                 ctc: str = "CTC", ctc_conf: Optional[Dict] = None,
                 ctc_weight: float = 1.0, input_size: int = 360,
                 vocab_size: int = -1, ignore_id: int = -1, blank_id: int = 0,
                 device=None, generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__()
        enc_conf = dict(encoder_conf or {})
        if encoder == "FSMN":
            enc_conf.setdefault("input_dim", input_size)
            enc_conf.setdefault("use_softmax", False)
            enc_conf.setdefault("output_dim", vocab_size if vocab_size > 0
                                else enc_conf.get("output_dim", 128))
            self.encoder = tables.encoder_classes[encoder](device=device, **enc_conf)
            enc_out = self.encoder.output_size()
            self.encoder_is_logits = enc_out == vocab_size and vocab_size > 0
        else:
            self.encoder = tables.encoder_classes[encoder](input_size=input_size,
                                                           device=device, **enc_conf)
            enc_out = self.encoder.output_size()
            self.encoder_is_logits = False
        # the FSMN (any of its registered names) takes no lengths
        self.is_fsmn = hasattr(getattr(self.encoder, "cfg", None), "fsmn_layers")
        self.ctc = None
        if not self.encoder_is_logits:
            self.ctc = CTC(odim=vocab_size, encoder_output_size=enc_out, device=device,
                           **(ctc_conf or {}))
        self.specaug = (tables.specaug_classes[specaug](**(specaug_conf or {}))
                        if specaug else None)
        self.vocab_size = vocab_size
        self.blank_id = blank_id
        self.ignore_id = ignore_id
        if generator is not None:
            init_weights(self, generator)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return next(self.parameters()).dtype

    def logits(self, speech, speech_lengths, generator=None):
        """(B, T, D) features -> ((B, T', V) logits, (B,) lengths). ``generator`` draws
        SpecAug and the SAN-M encoder's dropout in ``train()`` mode."""
        if self.specaug is not None and self.training and generator is not None:
            speech, speech_lengths = self.specaug(speech, speech_lengths, generator)
        if self.is_fsmn:
            enc, enc_lens = self.encoder(speech), speech_lengths
        else:
            enc, enc_lens = self.encoder(speech, speech_lengths, generator=generator)
        if self.ctc is not None:
            return self.ctc.logits(enc), enc_lens
        return enc, enc_lens

    def forward(self, speech, speech_lengths, text, text_lengths, generator=None, **kwargs):
        """The CTC loss averaged over the batch (``forward_jit``) -> (loss, stats, B)."""
        logits, enc_lens = self.logits(speech, speech_lengths, generator)
        logits = logits.float()
        dev = logits.device
        logit_pad = (torch.arange(logits.shape[1], device=dev)[None]
                     >= enc_lens[:, None]).float()
        label_pad = (torch.arange(text.shape[1], device=dev)[None]
                     >= text_lengths[:, None]).float()
        labels = torch.where(label_pad > 0, 0, text)
        per_row = ctc_loss(logits, logit_pad, labels, label_pad, blank_id=self.blank_id)
        loss = per_row.sum() / global_count(per_row.shape[0])
        return loss, {"loss": loss}, speech.shape[0]

    def log_probs(self, speech, speech_lengths, softmax: bool = False):
        """fp32 log-softmax (or softmax) of the logits and the lengths, on the host (one
        copy)."""
        with torch.inference_mode():
            logits, lens = self.logits(
                torch.as_tensor(speech).to(self.device, self.dtype),
                torch.as_tensor(speech_lengths).to(self.device))
            fn = torch.softmax if softmax else torch.log_softmax
            return fn(logits.float(), dim=-1).cpu().numpy(), lens.cpu().numpy()

    def detect(self, speech, speech_lengths, keyword_token_lists, threshold: float = -5.0):
        """Each keyword's score per utterance: its forced-align log-likelihood's advantage
        over the all-blank path, per token -> [[{keyword_idx, score, detected}, ...]]."""
        logp, enc_lens = self.log_probs(speech, speech_lengths)
        out = []
        for i in range(logp.shape[0]):
            lp = logp[i, : int(enc_lens[i])]
            blank_ll = float(lp[:, self.blank_id].sum())
            utt = []
            for ki, toks in enumerate(keyword_token_lists):
                score = keyword_score(lp, toks, self.blank_id, blank_ll)
                utt.append({"keyword_idx": ki, "score": score, "detected": score > threshold})
            out.append(utt)
        return out

    def inference(self, data_in, data_lengths=None, key: Optional[List] = None,
                  tokenizer=None, frontend=None, **kwargs):
        meta: Dict = {}
        audio_list = load_audio_text_image_video(
            data_in, fs=frontend.fs, audio_fs=kwargs.get("fs", 16000))
        speech, speech_lengths = extract_fbank(audio_list, frontend=frontend)

        keywords = kwargs.get("keywords") or kwargs.get("keyword") or ""
        if isinstance(keywords, (list, tuple)):
            keywords = ",".join(keywords)
        if key is None:
            key = [f"rand_key_{i}" for i in range(speech.shape[0])]
        if not keywords or tokenizer is None:
            return [{"key": k, "value": []} for k in key], meta
        kw_list = [k for k in keywords.replace(" ", ",").split(",") if k]

        if kwargs.get("decode_mode", "forced_align") == "prefix_beam":
            from funasr_tpu_torch.utils.kws_utils import KwsCtcPrefixDecoder
            decoder = KwsCtcPrefixDecoder(
                keywords=",".join(kw_list),
                token_list=list(getattr(tokenizer, "token_list", [])),
                seg_dict=kwargs.get("seg_dict"), blank_id=self.blank_id)
            probs, enc_lens = self.log_probs(speech, speech_lengths, softmax=True)
            results = []
            for i in range(probs.shape[0]):
                ok, word, score, span = decoder.decode(probs[i, : int(enc_lens[i])])
                hits = [{"keyword": word, "score": round(score, 4), "frames": span}] if ok else []
                results.append({"key": key[i], "value": hits})
            return results, meta

        kw_tokens = [tokenizer.encode(k) for k in kw_list]
        detections = self.detect(speech, speech_lengths, kw_tokens,
                                 threshold=kwargs.get("kws_threshold", -5.0)) \
            if kw_tokens else [[] for _ in range(speech.shape[0])]
        results = []
        for i, dets in enumerate(detections):
            hits = [{"keyword": kw_list[d["keyword_idx"]], "score": round(d["score"], 4)}
                    for d in dets if d["detected"]]
            results.append({"key": key[i], "value": hits})
        return results, meta


@tables.register("model_classes", "FsmnKWSConvert")
@tables.register("model_classes", "FsmnKWSMT")
@tables.register("model_classes", "FsmnKWSMTConvert")
@tables.register("model_classes", "SanmKWSStreaming")
class FsmnKWSStreaming(FsmnKWS):
    """Streaming / multi-task KWS variants: chunked scoring with carried FSMN caches;
    detection over a sliding window of recent frames."""

    def __init__(self, *args, window_frames: int = 200, **kwargs):
        super().__init__(*args, **kwargs)
        self.window_frames = window_frames

    def init_cache(self):
        return {"encoder": {}, "logp_window": None}

    def detect_chunk(self, feats, cache, keyword_token_lists, threshold: float = -5.0):
        """Feed one (1, T, D) feature chunk; -> detections over the rolling window."""
        with torch.inference_mode():
            x = torch.as_tensor(feats).to(self.device, self.dtype)
            if self.is_fsmn:
                enc = self.encoder(x, cache=cache["encoder"])
            else:
                enc, _ = self.encoder(x, torch.tensor([x.shape[1]], device=x.device))
            logits = self.ctc.logits(enc) if self.ctc is not None else enc
            logp = torch.log_softmax(logits.float(), dim=-1).cpu().numpy()[0]
        win = logp if cache["logp_window"] is None else \
            np.concatenate([cache["logp_window"], logp])[-self.window_frames:]
        cache["logp_window"] = win
        out = []
        blank_ll = float(win[:, self.blank_id].sum())
        for ki, toks in enumerate(keyword_token_lists):
            if len(win) < len(toks) * 2 + 1:
                continue
            score = keyword_score(win, toks, self.blank_id, blank_ll)
            if score > threshold:
                out.append({"keyword_idx": ki, "score": score})
        return out
