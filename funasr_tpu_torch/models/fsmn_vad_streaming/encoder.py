"""The FSMN scoring encoder of the VAD in PyTorch (counterpart of
``funasr_tpu/models/fsmn_vad_streaming/encoder.py``).

FunASR's ``funasr/models/fsmn_vad_streaming/encoder.py``: ``in_linear1/2`` + ReLU, N
``BasicBlock``s (linear -> FSMN memory -> affine -> ReLU), ``out_linear1/2``, softmax.
Parameter names are FunASR's (``in_linear1.linear``, ``fsmn.{i}.linear.linear``,
``fsmn.{i}.fsmn_block.conv_left`` as a depthwise Conv2d weight (C, 1, lorder, 1),
``fsmn.{i}.affine.linear``, ``out_linear{1,2}.linear``), which is what the JAX package's
``convert_fsmn`` reads.

The memory is ``h + conv_left(concat(cache, h))``, where the cache holds the last
lorder - 1 projected frames of the previous chunk (zeros at the start). That is the
last T rows of the FSMN kernel's ``conv(pad(x)) + x`` over x = concat(cache, h) with
left pad lorder - 1 and no mask, so it runs ``ops/fsmn.py::fsmn_memory`` (the
hand-written kernel on CUDA) and drops the first lorder - 1 rows. The conv sum is rounded
to x's dtype before the residual, as in JAX. The lookahead branch (``rorder > 0``;
fsmn-vad has rorder 0) is a plain version on the CPU; on CUDA it raises.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from funasr_tpu_torch.core.layers import apply_linear
from funasr_tpu_torch.ops.fsmn import fsmn_memory
from funasr_tpu_torch.register import tables


class FSMNConfig(NamedTuple):
    input_dim: int = 400
    input_affine_dim: int = 140
    fsmn_layers: int = 4
    linear_dim: int = 250
    proj_dim: int = 128
    lorder: int = 20
    rorder: int = 0
    lstride: int = 1
    rstride: int = 1
    output_affine_dim: int = 140
    output_dim: int = 248
    use_softmax: bool = True


class AffineTransform(nn.Module):
    """FunASR's ``AffineTransform`` / ``LinearTransform``: a linear under ``.linear``."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True, device=None):
        super().__init__()
        self.linear = nn.Linear(d_in, d_out, bias=bias, device=device)

    def forward(self, x):
        return apply_linear(self.linear, x)


def lookahead_ref(h, weight, rorder: int):
    """Plain PyTorch version of ``conv_right``: sum_i w[:, i] * h[t + 1 + i], zero past
    T, rounded to h's dtype. h (B, T, C); weight (C, 1, rorder, 1)."""
    t, c = h.shape[1], h.shape[2]
    x = F.pad(h[:, 1:].float(), (0, 0, 0, rorder))
    w = weight.reshape(c, rorder).float()
    acc = torch.zeros(h.shape[0], t, c, dtype=torch.float32, device=h.device)
    for i in range(rorder):
        acc = acc + x[:, i : i + t] * w[:, i]
    return acc.to(h.dtype)


class FSMNBlock(nn.Module):
    def __init__(self, dim: int, lorder: int, rorder: int, device=None):
        super().__init__()
        self.lorder, self.rorder = lorder, rorder
        self.conv_left = nn.Conv2d(dim, dim, (lorder, 1), groups=dim, bias=False,
                                   device=device)
        if rorder > 0:
            self.conv_right = nn.Conv2d(dim, dim, (rorder, 1), groups=dim, bias=False,
                                        device=device)

    def forward(self, h, cache=None):
        """h (B, T, C) -> (h + memory, new cache or None)."""
        k, c = self.lorder, h.shape[-1]
        w = self.conv_left.weight.to(h.dtype).reshape(c, 1, k)
        if cache is not None:
            full = torch.cat([cache.to(h.dtype), h], dim=1)
            out = fsmn_memory(full, w, None, k - 1, 0)[:, k - 1:]
            new_cache = full[:, -(k - 1):] if k > 1 else cache
        else:
            out = fsmn_memory(h, w, None, k - 1, 0)
            new_cache = None
        if self.rorder > 0:
            if h.device.type != "cpu":
                raise NotImplementedError(
                    "the FSMN lookahead (rorder > 0) runs only as a plain version on the "
                    "CPU; its kernel route is not wired up (ROADMAP queue 2)")
            out = out + lookahead_ref(h, self.conv_right.weight, self.rorder)
        return out, new_cache


class BasicBlock(nn.Module):
    """linear (no bias) -> FSMN memory -> affine -> ReLU."""

    def __init__(self, cfg: FSMNConfig, device=None):
        super().__init__()
        self.linear = AffineTransform(cfg.linear_dim, cfg.proj_dim, bias=False, device=device)
        self.fsmn_block = FSMNBlock(cfg.proj_dim, cfg.lorder, cfg.rorder, device=device)
        self.affine = AffineTransform(cfg.proj_dim, cfg.linear_dim, device=device)

    def forward(self, x, cache=None):
        h, new_cache = self.fsmn_block(self.linear(x), cache)
        return torch.relu(self.affine(h)), new_cache


@tables.register("encoder_classes", "FSMN")
class FSMN(nn.Module):
    def __init__(self, input_dim: int, input_affine_dim: int, fsmn_layers: int,
                 linear_dim: int, proj_dim: int, lorder: int, rorder: int,
                 lstride: int, rstride: int, output_affine_dim: int, output_dim: int,
                 use_softmax: bool = True, device=None, **kwargs):
        super().__init__()
        if lstride != 1 or (rorder > 0 and rstride != 1):
            raise NotImplementedError("dilated FSMN strides are not supported")
        self.cfg = c = FSMNConfig(input_dim, input_affine_dim, fsmn_layers, linear_dim,
                                  proj_dim, lorder, rorder, lstride, rstride,
                                  output_affine_dim, output_dim, use_softmax)
        self.in_linear1 = AffineTransform(c.input_dim, c.input_affine_dim, device=device)
        self.in_linear2 = AffineTransform(c.input_affine_dim, c.linear_dim, device=device)
        self.fsmn = nn.ModuleList([BasicBlock(c, device) for _ in range(c.fsmn_layers)])
        self.out_linear1 = AffineTransform(c.linear_dim, c.output_affine_dim, device=device)
        self.out_linear2 = AffineTransform(c.output_affine_dim, c.output_dim, device=device)

    def output_size(self) -> int:
        return self.cfg.output_dim

    def forward(self, x, cache: Optional[Dict] = None):
        """x: (B, T, input_dim) -> (B, T, output_dim) softmax scores (fp32).

        ``cache``: dict carrying each layer's left context across chunks
        (``cache_layer_{i}``, (B, lorder - 1, proj), zeros at first; updated in place).
        """
        c = self.cfg
        h = torch.relu(self.in_linear2(self.in_linear1(x)))
        for i, block in enumerate(self.fsmn):
            if cache is None:
                h, _ = block(h)
                continue
            key = f"cache_layer_{i}"
            if key not in cache:
                cache[key] = torch.zeros(x.shape[0], (c.lorder - 1) * c.lstride, c.proj_dim,
                                         dtype=x.dtype, device=x.device)
            h, cache[key] = block(h, cache[key])
        h = self.out_linear2(self.out_linear1(h))
        if c.use_softmax:
            h = torch.softmax(h.float(), dim=-1)
        return h
