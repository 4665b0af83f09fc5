"""CAM++ building blocks in PyTorch (counterpart of
``funasr_tpu/models/campplus/components.py``; FunASR ``funasr/models/campplus/
components.py``), as ``nn.Module``s under FunASR's state-dict names, so a
``speech_campplus_sv`` ``model.pt`` loads with ``load_state_dict``.

Layouts are FunASR's: the FCM front runs NCHW (B, C, F, T), the TDNN trunk (B, C, T).
Batch norm runs in eval mode (running statistics, eps 1e-5); a ``nonlinear*`` unit is a
``Sequential`` of ``batchnorm`` and ``relu``, as FunASR's ``get_nonlinear`` builds it.
Numerics copied from the JAX package, not "fixed":

* ``_seg_pooling`` averages ceil-mode windows of 100 frames over the valid frames of
  the last window, then repeats each mean over its window (``components.py:158-169``);
* ``stats_pool`` is mean || unbiased std with ``max(n - 1, 1)`` (``:202-207``);
* the FCM output (B, C, F, T) flattens to (B, C * F, T) (``:121-124``).
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn


def bn_relu(channels: int, device=None, affine: bool = True, relu: bool = True):
    """FunASR's ``get_nonlinear("batchnorm-relu")`` (``"batchnorm_"`` without affine
    parameters and relu)."""
    layers = [("batchnorm", nn.BatchNorm1d(channels, affine=affine, device=device))]
    if relu:
        layers.append(("relu", nn.ReLU()))
    return nn.Sequential(OrderedDict(layers))


# ---------------------------------------------------------------------------
# FCM: the 2D resnet front
# ---------------------------------------------------------------------------


class BasicResBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int = 1, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(c_in, c_out, 3, stride=(stride, 1), padding=1, bias=False,
                               device=device)
        self.bn1 = nn.BatchNorm2d(c_out, device=device)
        self.conv2 = nn.Conv2d(c_out, c_out, 3, stride=1, padding=1, bias=False,
                               device=device)
        self.bn2 = nn.BatchNorm2d(c_out, device=device)
        self.shortcut = nn.Sequential()
        if stride != 1 or c_in != c_out:
            self.shortcut = nn.Sequential(
                nn.Conv2d(c_in, c_out, 1, stride=(stride, 1), bias=False, device=device),
                nn.BatchNorm2d(c_out, device=device))

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + self.shortcut(x))


class FCM(nn.Module):
    def __init__(self, m_channels: int = 32, feat_dim: int = 80, num_blocks=(2, 2),
                 device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(1, m_channels, 3, stride=1, padding=1, bias=False,
                               device=device)
        self.bn1 = nn.BatchNorm2d(m_channels, device=device)
        self.layer1, self.layer2 = (
            nn.Sequential(*[BasicResBlock(m_channels, m_channels, 2 if i == 0 else 1, device)
                            for i in range(n)]) for n in num_blocks)
        self.conv2 = nn.Conv2d(m_channels, m_channels, 3, stride=(2, 1), padding=1,
                               bias=False, device=device)
        self.bn2 = nn.BatchNorm2d(m_channels, device=device)
        self.out_channels = m_channels * (feat_dim // 8)

    def forward(self, x):
        """x (B, F, T) -> (B, C * F // 8, T)."""
        out = torch.relu(self.bn1(self.conv1(x[:, None])))
        out = self.layer2(self.layer1(out))
        out = torch.relu(self.bn2(self.conv2(out)))
        b, c, f, t = out.shape
        return out.reshape(b, c * f, t)


# ---------------------------------------------------------------------------
# the TDNN trunk, (B, C, T)
# ---------------------------------------------------------------------------


class TDNNLayer(nn.Module):
    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int = 1,
                 dilation: int = 1, bias: bool = False, device=None):
        super().__init__()
        self.linear = nn.Conv1d(c_in, c_out, kernel, stride=stride,
                                padding=(kernel - 1) // 2 * dilation, dilation=dilation,
                                bias=bias, device=device)
        self.nonlinear = bn_relu(c_out, device)

    def forward(self, x):
        return self.nonlinear(self.linear(x))


def _seg_pooling(x, seg_len: int = 100):
    """(B, C, T) -> the mean of each ceil-mode window of ``seg_len`` frames (over its
    valid frames), repeated back over the window, (B, C, T)."""
    b, c, t = x.shape
    n_seg = -(-t // seg_len)
    xp = F.pad(x, (0, n_seg * seg_len - t))
    sums = xp.reshape(b, c, n_seg, seg_len).sum(dim=-1)
    # the counts are host numbers: writing one into a device tensor would make the host
    # wait for the device, once per layer
    last = t - (n_seg - 1) * seg_len
    seg = torch.cat([sums[..., :-1] / seg_len, sums[..., -1:] / last], dim=-1)
    return seg.repeat_interleave(seg_len, dim=-1)[..., :t]


class CAMLayer(nn.Module):
    def __init__(self, bn_channels: int, c_out: int, kernel: int, dilation: int,
                 reduction: int = 2, device=None):
        super().__init__()
        self.linear_local = nn.Conv1d(bn_channels, c_out, kernel,
                                      padding=(kernel - 1) // 2 * dilation,
                                      dilation=dilation, bias=False, device=device)
        self.linear1 = nn.Conv1d(bn_channels, bn_channels // reduction, 1, device=device)
        self.relu = nn.ReLU()
        self.linear2 = nn.Conv1d(bn_channels // reduction, c_out, 1, device=device)
        self.sigmoid = nn.Sigmoid()

    def forward(self, x):
        y = self.linear_local(x)
        context = x.mean(dim=-1, keepdim=True) + _seg_pooling(x)
        context = self.relu(self.linear1(context))
        return y * self.sigmoid(self.linear2(context))


class CAMDenseTDNNLayer(nn.Module):
    def __init__(self, c_in: int, c_out: int, bn_channels: int, kernel: int,
                 dilation: int, device=None):
        super().__init__()
        self.nonlinear1 = bn_relu(c_in, device)
        self.linear1 = nn.Conv1d(c_in, bn_channels, 1, bias=False, device=device)
        self.nonlinear2 = bn_relu(bn_channels, device)
        self.cam_layer = CAMLayer(bn_channels, c_out, kernel, dilation, device=device)

    def forward(self, x):
        return self.cam_layer(self.nonlinear2(self.linear1(self.nonlinear1(x))))


class CAMDenseTDNNBlock(nn.ModuleList):
    """``tdnnd1`` ... ``tdnnd{n}``: each layer's output is appended to its input."""

    def __init__(self, num_layers: int, c_in: int, c_out: int, bn_channels: int,
                 kernel: int, dilation: int, device=None):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"tdnnd{i + 1}", CAMDenseTDNNLayer(
                c_in + i * c_out, c_out, bn_channels, kernel, dilation, device))

    def forward(self, x):
        for layer in self:
            x = torch.cat([x, layer(x)], dim=1)
        return x


class TransitLayer(nn.Module):
    def __init__(self, c_in: int, c_out: int, device=None):
        super().__init__()
        self.nonlinear = bn_relu(c_in, device)
        self.linear = nn.Conv1d(c_in, c_out, 1, bias=False, device=device)

    def forward(self, x):
        return self.linear(self.nonlinear(x))


class DenseLayer(nn.Module):
    """Linear (a 1x1 conv, no bias) -> batch norm without affine parameters."""

    def __init__(self, c_in: int, c_out: int, device=None):
        super().__init__()
        self.linear = nn.Conv1d(c_in, c_out, 1, bias=False, device=device)
        self.nonlinear = bn_relu(c_out, device, affine=False, relu=False)

    def forward(self, x):
        """x (B, C_in) -> (B, C_out)."""
        return self.nonlinear(self.linear(x[..., None])[..., 0])


def stats_pool(x):
    """(B, C, T) -> (B, 2C): mean || unbiased std over time."""
    mean = x.mean(dim=-1)
    n = x.shape[-1]
    var = (x - mean[..., None]).square().sum(dim=-1) / max(n - 1, 1)
    return torch.cat([mean, torch.sqrt(torch.clamp_min(var, 0.0))], dim=-1)
