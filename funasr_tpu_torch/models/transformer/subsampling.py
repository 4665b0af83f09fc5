"""Conv2d subsampling in PyTorch (counterpart of
``funasr_tpu/models/transformer/subsampling.py``; FunASR ``Conv2dSubsampling``): two
stride-2 3 x 3 convolutions with ReLU, then a linear over the channels-major flatten,
then the espnet PE, T -> about T / 4, under FunASR's ``conv.0``, ``conv.2`` and
``out.0`` names.

Numerics copied from the JAX package: each convolution's sum is rounded to x's dtype
before its bias is added (``subsampling.py:27-35``); the output lengths are
``min((len + 3) // 4, T')``, the count of kept frames 4k < len, not the convolution's
length formula (``:41-44``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from funasr_tpu_torch.core.layers import apply_linear
from funasr_tpu_torch.models.transformer.attention import add_espnet_pe


class Conv2dSubsampling(nn.Module):
    def __init__(self, idim: int, odim: int, device=None):
        super().__init__()
        f_out = ((idim - 1) // 2 - 1) // 2
        self.conv = nn.Sequential(nn.Conv2d(1, odim, 3, 2, device=device), nn.ReLU(),
                                  nn.Conv2d(odim, odim, 3, 2, device=device), nn.ReLU())
        self.out = nn.Sequential(nn.Linear(odim * f_out, odim, device=device))

    def forward(self, x, lengths, add_pe: bool = True):
        """x (B, T, F), lengths (B,) -> ((B, T', odim), (B,) int32)."""
        h = x[:, None]  # (B, 1, T, F)
        for conv in (self.conv[0], self.conv[2]):
            h = F.conv2d(h, conv.weight.to(h.dtype), stride=2).to(x.dtype)
            h = torch.relu(h + conv.bias.to(h.dtype)[:, None, None])
        b, c, t, f = h.shape
        h = apply_linear(self.out[0], h.transpose(1, 2).reshape(b, t, c * f))
        out_lens = torch.clamp((lengths + 3) // 4, max=t).to(torch.int32)
        if add_pe:
            h = add_espnet_pe(h)
        return h, out_lens
