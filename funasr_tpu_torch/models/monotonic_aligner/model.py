"""MonotonicAligner (fa-zh) in PyTorch: per-character timestamps for a given (audio,
text) pair (counterpart of ``funasr_tpu/models/monotonic_aligner/model.py``; FunASR
``funasr/models/monotonic_aligner/model.py:24-267``).

A SAN-M encoder and the CifPredictorV3 upsample head, whose alphas are rescaled to the
known token count (``get_upsample_timestamp(token_num=)``), then the host's
``ts_prediction_lfr6_standard`` per row. The upsampled alphas and peaks and the encoder
lengths come to the host in one copy. The training loss (MAE on the token count) comes
with the training slice.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

import funasr_tpu_torch.models.bicif_paraformer.cif_predictor  # noqa: F401 (registers V3)
from funasr_tpu_torch.core.layers import make_pad_mask
from funasr_tpu_torch.core.module import init_weights
from funasr_tpu_torch.register import tables
from funasr_tpu_torch.utils import postprocess_utils
from funasr_tpu_torch.utils.load_utils import extract_fbank, load_audio_text_image_video
from funasr_tpu_torch.utils.timestamp_tools import ts_prediction_lfr6_standard


@tables.register("model_classes", "MonotonicAligner")
class MonotonicAligner(nn.Module):
    def __init__(self, input_size: int = 80, normalize: Optional[str] = None,
                 encoder: str = "SANMEncoder", encoder_conf: Optional[Dict] = None,
                 predictor: str = "CifPredictorV3", predictor_conf: Optional[Dict] = None,
                 predictor_bias: int = 0, device=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__()
        if normalize is not None:
            raise NotImplementedError(f"normalize={normalize} is not ported")
        self.encoder = tables.encoder_classes[encoder](
            input_size=input_size, device=device, **(encoder_conf or {}))
        self.predictor = tables.predictor_classes[predictor](
            device=device, **(predictor_conf or {}))
        self.predictor_bias = predictor_bias
        if generator is not None:
            init_weights(self, generator)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return next(self.parameters()).dtype

    def upsampled(self, speech, speech_lengths, token_nums):
        """(B, T, D) features and (B,) token counts -> (us_alphas (B, T' * up), us_peaks,
        encoder lengths), fp32."""
        encoder_out, encoder_out_lens = self.encoder(speech, speech_lengths)
        mask = make_pad_mask(encoder_out_lens, encoder_out.shape[1])
        _, _, us_alphas, us_peaks = self.predictor.get_upsample_timestamp(
            encoder_out, mask, token_num=token_nums)
        return us_alphas, us_peaks, encoder_out_lens

    def inference(self, data_in, data_lengths=None, key: Optional[List] = None,
                  tokenizer=None, frontend=None, **kwargs):
        """``data_in``: a list of (audio, text) pairs, or the audio with ``text=`` (JAX
        ``:67-117``). Returns (results, meta): ``{"key", "text", "timestamp" (ms per
        token), "timestamp_str"}`` per pair."""
        meta = {}
        if isinstance(data_in, (list, tuple)) and len(data_in) and \
                isinstance(data_in[0], (list, tuple)):
            audio_in = [d[0] for d in data_in]
            text_in = [d[1] for d in data_in]
        else:
            audio_in, text_in = data_in, kwargs.get("text")
        t0 = time.perf_counter()
        audio_list = load_audio_text_image_video(
            audio_in, fs=frontend.fs, audio_fs=kwargs.get("fs", 16000))
        meta["load_data"] = f"{time.perf_counter() - t0:0.3f}"
        speech, speech_lengths = extract_fbank(audio_list, frontend=frontend)
        meta["batch_data_time"] = (float(np.sum(speech_lengths))
                                   * frontend.frame_shift_ms * frontend.lfr_n / 1000)

        token_lists = [tokenizer.encode(t) if isinstance(t, str) else list(t)
                       for t in (text_in if isinstance(text_in, list) else [text_in])]
        token_nums = torch.tensor([len(t) + self.predictor_bias for t in token_lists],
                                  dtype=torch.float32, device=self.device)
        with torch.inference_mode():
            us_alphas, us_peaks, enc_lens = self.upsampled(
                torch.from_numpy(speech).to(self.device, self.dtype),
                torch.from_numpy(speech_lengths).to(self.device), token_nums)
            n = us_alphas.shape[1]
            block = torch.cat([us_alphas, us_peaks, enc_lens[:, None].float()],
                              dim=1).cpu().numpy()
        us_alphas, us_peaks, enc_lens = block[:, :n], block[:, n:2 * n], block[:, 2 * n]
        up = self.predictor.upsample_times

        results = []
        if key is None:
            key = [f"rand_key_{i}" for i in range(len(token_lists))]
        for i, ids in enumerate(token_lists):
            token = tokenizer.ids2tokens(ids)
            n_us = int(enc_lens[i]) * up
            ts_str, timestamp = ts_prediction_lfr6_standard(
                us_alphas[i, :n_us], us_peaks[i, :n_us], list(token),
                vad_offset=kwargs.get("begin_time", 0), upsample_rate=up)
            text_post, timestamp, _ = postprocess_utils.sentence_postprocess(token, timestamp)
            results.append({"key": key[i], "text": text_post, "timestamp": timestamp,
                            "timestamp_str": ts_str})
        return results, meta
