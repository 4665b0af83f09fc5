"""Feature normalization in PyTorch (counterpart of
``funasr_tpu/models/normalize/normalize.py``; FunASR ``global_mvn.py:12``,
``utterance_mvn.py:9``)."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from funasr_tpu_torch.core.layers import make_pad_mask
from funasr_tpu_torch.register import tables


@tables.register("normalize_classes", "GlobalMVN")
class GlobalMVN(nn.Module):
    """Normalize with precomputed global stats: an espnet stats ``.npy`` (row 0: sums,
    row 1: squared sums, the count last in row 0) or an ``.npz`` with ``mean`` and
    ``var``. ``mean`` and ``istd`` are buffers, so they follow the model's device and are
    not trained."""

    def __init__(self, stats_file: str, norm_means: bool = True, norm_vars: bool = True,
                 eps: float = 1.0e-20, **kwargs):
        super().__init__()
        self.norm_means = norm_means
        self.norm_vars = norm_vars
        self.eps = eps
        stats = np.load(stats_file)
        if isinstance(stats, np.ndarray):
            count = stats[0].flatten()[-1]
            mean = stats[0, :-1] / count
            var = stats[1, :-1] / count - mean * mean
        else:
            mean, var = stats["mean"], stats["var"]
        self.register_buffer("mean", torch.as_tensor(np.asarray(mean, np.float32)),
                             persistent=False)
        self.register_buffer("istd", torch.as_tensor(
            np.asarray(1.0 / np.sqrt(np.maximum(var, eps)), np.float32)), persistent=False)

    def forward(self, x, lengths):
        if self.norm_means:
            x = x - self.mean
        if self.norm_vars:
            x = x * self.istd
        return x, lengths


@tables.register("normalize_classes", "UtteranceMVN")
class UtteranceMVN(nn.Module):
    """Each utterance's mean (and, with ``norm_vars``, its variance) over its valid
    frames; padded frames come out zero when ``norm_means``."""

    def __init__(self, norm_means: bool = True, norm_vars: bool = False,
                 eps: float = 1.0e-20, **kwargs):
        super().__init__()
        self.norm_means = norm_means
        self.norm_vars = norm_vars
        self.eps = eps

    def forward(self, x, lengths):
        mask = make_pad_mask(lengths, x.shape[1])[..., None].to(x.dtype)
        n = mask.sum(dim=1, keepdim=True).clamp_min(1.0)
        mean = (x * mask).sum(dim=1, keepdim=True) / n
        if self.norm_means:
            x = (x - mean) * mask
        if self.norm_vars:
            centered = x if self.norm_means else (x - mean) * mask
            var = centered.square().sum(dim=1, keepdim=True) / n
            x = x / torch.sqrt(var + self.eps)
        return x, lengths


def build_normalize(normalize, normalize_conf=None):
    """The model's ``normalize`` layer from its config name, or None."""
    return tables.normalize_classes[normalize](**(normalize_conf or {})) if normalize else None
