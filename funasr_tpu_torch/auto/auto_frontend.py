"""AutoFrontend: standalone fbank extraction API (a copy of
``funasr_tpu/auto/auto_frontend.py``; counterpart of FunASR
``funasr/auto/auto_frontend.py:1-122``).

    frontend = AutoFrontend(model="<model dir>", device="cuda")
    rows = frontend(input=["a.wav", wave])  # [{"key", "input": (T, D) tensor, "input_len"}]

``device`` defaults to "cuda" and raises without a GPU, as ``AutoModel`` does; the
features are tensors on that device."""

from __future__ import annotations

import logging
import time

import torch

from funasr_tpu_torch.download.download_model_from_hub import download_model
from funasr_tpu_torch.register import tables
from funasr_tpu_torch.utils.misc import deep_update


class AutoFrontend:
    def __init__(self, **kwargs):
        self.device = torch.device(kwargs.get("device") or "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but torch.cuda.is_available() is false; "
                               "pass device='cpu' to run on the CPU")
        if "model" in kwargs and "frontend_conf" not in kwargs:
            kwargs = download_model(**kwargs)
        frontend = kwargs.get("frontend", "WavFrontend")
        frontend_class = tables.frontend_classes[frontend]
        self.frontend = frontend_class(**(kwargs.get("frontend_conf") or {}))
        self.kwargs = kwargs

    def __call__(self, input, input_len=None, batch_size: int = 1, key=None,
                 **cfg):
        from funasr_tpu_torch.auto.auto_model import prepare_data_iterator
        from funasr_tpu_torch.utils.load_utils import load_audio_text_image_video

        deep_update(self.kwargs, cfg)
        key_list, data_list = prepare_data_iterator(input, key=key)
        results = []
        for beg in range(0, len(data_list), batch_size):
            batch = data_list[beg: beg + batch_size]
            t0 = time.perf_counter()
            # the port's WavFrontend takes raw int16 PCM as it is (bit-exact to the
            # float path), so no int16 rescale is needed here
            audio = load_audio_text_image_video(
                batch, fs=self.frontend.fs, audio_fs=cfg.get("fs", 16000))
            feats, feat_lens = self.frontend.extract(audio, device=self.device)
            logging.debug("extract %d clips in %.3fs", len(batch),
                          time.perf_counter() - t0)
            for i in range(len(batch)):
                results.append({"key": key_list[beg + i],
                                "input": feats[i, : feat_lens[i]],
                                "input_len": int(feat_lens[i])})
        return results
