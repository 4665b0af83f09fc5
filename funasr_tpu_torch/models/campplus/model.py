"""CAM++ speaker embedding in PyTorch (counterpart of
``funasr_tpu/models/campplus/model.py``; FunASR ``funasr/models/campplus/
model.py:42-200``).

FCM resnet front -> TDNN (k 5, stride 2) -> three CAM dense TDNN blocks (12 / 24 / 16
layers, growth 32, dilations 1 / 2 / 2) with halving transits -> stats pooling ->
192-d dense. ``inference`` computes its own 80-bin kaldi fbank per clip on the model's
device, subtracts its mean over time, zero-pads the batch and runs ``forward``; the
frontend of the model directory's config is not used, as in the JAX package.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from funasr_tpu_torch.core.module import init_weights
from funasr_tpu_torch.models.campplus.components import (
    FCM, CAMDenseTDNNBlock, DenseLayer, TDNNLayer, TransitLayer, bn_relu, stats_pool)
from funasr_tpu_torch.register import tables

BLOCKS = ((12, 3, 1), (24, 3, 2), (16, 3, 2))  # (num_layers, kernel, dilation)


@tables.register("model_classes", "CAMPPlus")
class CAMPPlus(nn.Module):
    def __init__(self, feat_dim: int = 80, embedding_size: int = 192,
                 growth_rate: int = 32, bn_size: int = 4, init_channels: int = 128,
                 output_level: str = "segment", device=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        """``generator``: when given, every conv weight is drawn from it
        (``core/module.py::init_weights``). Keys of hub configs the inference path does
        not use (``config_str``, ``memory_efficient``) are accepted and ignored."""
        super().__init__()
        self.feat_dim = feat_dim
        self.embedding_size = embedding_size
        self.output_level = output_level
        self.head = FCM(32, feat_dim, device=device)
        channels = self.head.out_channels
        xvector = OrderedDict(tdnn=TDNNLayer(channels, init_channels, 5, stride=2,
                                             device=device))
        channels = init_channels
        for i, (num_layers, kernel, dilation) in enumerate(BLOCKS):
            xvector[f"block{i + 1}"] = CAMDenseTDNNBlock(
                num_layers, channels, growth_rate, bn_size * growth_rate, kernel, dilation,
                device)
            channels += num_layers * growth_rate
            xvector[f"transit{i + 1}"] = TransitLayer(channels, channels // 2, device)
            channels //= 2
        xvector["out_nonlinear"] = bn_relu(channels, device)
        self.xvector = nn.Sequential(xvector)
        if output_level == "segment":
            self.xvector.add_module("dense", DenseLayer(channels * 2, embedding_size, device))
        if generator is not None:
            init_weights(self, generator)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward(self, x):
        """x (B, T, feat_dim) mean-normalized fbank -> (B, embedding_size); with
        ``output_level="frame"`` the trunk's (B, C, T')."""
        h = self.head(x.transpose(1, 2))
        for name, layer in self.xvector.named_children():
            if name == "dense":
                continue
            h = layer(h)
        if self.output_level == "frame":
            return h
        return self.xvector.dense(stats_pool(h))

    def inference(self, data_in, data_lengths=None, key: Optional[List] = None,
                  tokenizer=None, frontend=None, **kwargs):
        """Returns ([{"spk_embedding": (B, embedding_size) numpy}], meta) over the
        batch of clips (reference contract ``model.py:160-200``)."""
        return speaker_inference(self, data_in, self.feat_dim, **kwargs)


def speaker_inference(model, data_in, feat_dim: int, **kwargs):
    """A speaker model's ``inference``: each clip's kaldi fbank of ``feat_dim`` bins on the
    model's device, its mean over time subtracted, the batch zero-padded, ``model``'s
    embeddings -> ([{"spk_embedding": (B, D) numpy}], meta)."""
    from funasr_tpu_torch.ops.fbank import fbank
    from funasr_tpu_torch.utils.load_utils import as_pcm16_f32, load_audio_text_image_video

    meta: Dict = {}
    t0 = time.perf_counter()
    audio_list = load_audio_text_image_video(
        data_in, fs=16000, audio_fs=kwargs.get("fs", 16000), data_type="sound")
    meta["load_data"] = f"{time.perf_counter() - t0:0.3f}"
    dev = next(model.parameters()).device
    with torch.inference_mode():
        feats = []
        for au in audio_list:
            f = fbank(torch.from_numpy(as_pcm16_f32(au)).to(dev), num_mel_bins=feat_dim)
            feats.append(f - f.mean(dim=0, keepdim=True))
        maxlen = max(f.shape[0] for f in feats)
        batch = torch.zeros(len(feats), maxlen, feat_dim, device=dev)
        for i, f in enumerate(feats):
            batch[i, : f.shape[0]] = f
        meta["batch_data_time"] = sum(len(a) for a in audio_list) / 16000.0
        embs = model(batch.to(next(model.parameters()).dtype)).float().cpu().numpy()
    return [{"spk_embedding": np.asarray(embs)}], meta
