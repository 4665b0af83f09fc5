"""ERes2NetV2 speaker embedding in PyTorch (counterpart of
``funasr_tpu/models/eres2net/model.py``; FunASR ``funasr/models/eres2net/eres2netv2.py:
185`` with ``fusion.py``'s AFF), under FunASR's state-dict names.

NCHW (B, C, F, T) as FunASR runs it (the JAX package runs NHWC): a 3x3 stem, four layers
of Res2Net blocks (the 1x1 ``conv1`` with the layer's stride over F and T, ``scale``
width-split 3x3 branches, each added to the previous branch's output, by an AFF
attention fusion in layers 3 and 4; ``conv3``; the shortcut), ReLU clipped at 20
(``relu20``); layer 3 downsampled (3x3, stride 2) and fused into layer 4 by AFF; TSTP
pooling (mean || unbiased std + 1e-8 over time, flattened channel-major) and the
``seg_1`` linear. Batch norm in eval mode (running statistics, eps 1e-5). Plain PyTorch:
the JAX package computes it with XLA convolutions, outside any Pallas kernel.

``inference`` is CAM++'s (``campplus/model.py::speaker_inference``): an 80-bin kaldi fbank
per clip on the model's device, its mean over time subtracted, the batch zero-padded; ->
[{"spk_embedding": (B, 192)}], so the model serves as ``AutoModel``'s ``spk_model`` in
CAM++'s place.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
from torch import nn

from funasr_tpu_torch.core.module import init_weights
from funasr_tpu_torch.models.campplus.model import speaker_inference
from funasr_tpu_torch.register import tables


def relu20(x):
    return x.clamp(0.0, 20.0)


def _conv(c_in, c_out, k, stride=1, bias=False, device=None):
    return nn.Conv2d(c_in, c_out, k, stride=stride, padding=(k - 1) // 2, bias=bias,
                     device=device)


class AFF(nn.Module):
    """Attentional feature fusion: ``local_att`` = 1x1 conv (2C -> C / r), BN, SiLU,
    1x1 conv (-> C), BN; out = x * (1 + tanh a) + y * (1 - tanh a)."""

    def __init__(self, channels: int, r: int = 4, device=None):
        super().__init__()
        inter = channels // r
        self.local_att = nn.Sequential(
            _conv(channels * 2, inter, 1, bias=True, device=device),
            nn.BatchNorm2d(inter, device=device), nn.SiLU(),
            _conv(inter, channels, 1, bias=True, device=device),
            nn.BatchNorm2d(channels, device=device))

    def forward(self, x, ds_y):
        att = 1.0 + torch.tanh(self.local_att(torch.cat([x, ds_y], dim=1)))
        return x * att + ds_y * (2.0 - att)


class BasicBlockERes2NetV2(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1, base_width: int = 26,
                 scale: int = 2, expansion: int = 2, use_aff: bool = False, device=None):
        super().__init__()
        self.width = width = int(math.floor(planes * (base_width / 64.0)))
        self.scale = scale
        self.conv1 = _conv(in_planes, width * scale, 1, stride, device=device)
        self.bn1 = nn.BatchNorm2d(width * scale, device=device)
        self.convs = nn.ModuleList(_conv(width, width, 3, device=device) for _ in range(scale))
        self.bns = nn.ModuleList(nn.BatchNorm2d(width, device=device) for _ in range(scale))
        self.fuse_models = (nn.ModuleList(AFF(width, device=device) for _ in range(scale - 1))
                            if use_aff else None)
        self.conv3 = _conv(width * scale, planes * expansion, 1, device=device)
        self.bn3 = nn.BatchNorm2d(planes * expansion, device=device)
        self.shortcut = nn.Sequential()
        if stride != 1 or in_planes != expansion * planes:
            self.shortcut = nn.Sequential(
                _conv(in_planes, planes * expansion, 1, stride, device=device),
                nn.BatchNorm2d(planes * expansion, device=device))

    def forward(self, x):
        spx = torch.split(relu20(self.bn1(self.conv1(x))), self.width, dim=1)
        pieces, sp = [], None
        for i in range(self.scale):
            if i == 0:
                sp = spx[i]
            elif self.fuse_models is not None:
                sp = self.fuse_models[i - 1](sp, spx[i])
            else:
                sp = sp + spx[i]
            sp = relu20(self.bns[i](self.convs[i](sp)))
            pieces.append(sp)
        out = self.bn3(self.conv3(torch.cat(pieces, dim=1)))
        return relu20(out + self.shortcut(x))


@tables.register("model_classes", "ERes2NetV2")
class ERes2NetV2(nn.Module):
    def __init__(self, num_blocks=(3, 4, 6, 3), m_channels: int = 64, feat_dim: int = 80,
                 embedding_size: int = 192, baseWidth: int = 26, scale: int = 2,
                 expansion: int = 2, output_level: str = "segment", device=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        """``generator``: when given, every conv and linear weight is drawn from it
        (``core/module.py::init_weights``). Hub config keys the inference path does not
        read (``pooling_func`` TSTP, ``two_emb_layer``) are accepted and ignored."""
        super().__init__()
        self.num_blocks = list(num_blocks)
        self.feat_dim = feat_dim
        self.embedding_size = embedding_size
        self.stats_dim = (feat_dim // 8) * m_channels * 8
        self.conv1 = _conv(1, m_channels, 3, device=device)
        self.bn1 = nn.BatchNorm2d(m_channels, device=device)
        in_planes = m_channels
        for li, (mult, stride) in enumerate(((1, 1), (2, 2), (4, 2), (8, 2))):
            planes = m_channels * mult
            blocks = []
            for bi in range(self.num_blocks[li]):
                blocks.append(BasicBlockERes2NetV2(
                    in_planes, planes, stride if bi == 0 else 1, baseWidth, scale, expansion,
                    use_aff=li >= 2, device=device))
                in_planes = planes * expansion
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
        self.layer3_ds = nn.Conv2d(m_channels * 4 * expansion, m_channels * 8 * expansion, 3,
                                   stride=2, padding=1, bias=False, device=device)
        self.fuse34 = AFF(m_channels * 8 * expansion, device=device)
        self.seg_1 = nn.Linear(self.stats_dim * expansion * 2, embedding_size, device=device)
        if generator is not None:
            init_weights(self, generator)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward(self, x):
        """x (B, T, feat_dim) mean-normalized fbank -> (B, embedding_size)."""
        h = relu20(self.bn1(self.conv1(x.transpose(1, 2)[:, None])))
        h = self.layer2(self.layer1(h))
        out3 = self.layer3(h)
        out4 = self.layer4(out3)
        fuse = self.fuse34(out4, self.layer3_ds(out3))  # (B, C, F', T')
        mean = fuse.mean(dim=-1)
        std = torch.sqrt(fuse.var(dim=-1, unbiased=True) + 1e-8)
        stats = torch.cat([mean.flatten(1), std.flatten(1)], dim=-1)
        return self.seg_1(stats)

    def inference(self, data_in, data_lengths=None, key: Optional[List] = None,
                  tokenizer=None, frontend=None, **kwargs):
        """Returns ([{"spk_embedding": (B, embedding_size) numpy}], meta) over the batch of
        clips (FunASR ``eres2netv2`` ``model.py:21``)."""
        return speaker_inference(self, data_in, self.feat_dim, **kwargs)
