"""Standard multi-head attention in PyTorch (counterpart of
``funasr_tpu/models/transformer/attention.py::mha_apply``; FunASR
``funasr/models/transformer/attention.py::MultiHeadedAttention``): separate q, k and v
projections and ``linear_out`` under FunASR's names, scores scaled by 1/sqrt(d_k), the
fp32 masked softmax. Plain PyTorch: the JAX package computes it with einsums, outside any
Pallas kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from funasr_tpu_torch.core.layers import apply_linear, masked_softmax


class MHAConfig(NamedTuple):
    n_head: int
    n_feat: int

    @property
    def d_k(self) -> int:
        return self.n_feat // self.n_head


def _heads(x, h, dk):
    b, t, _ = x.shape
    return x.reshape(b, t, h, dk).transpose(1, 2)


class MultiHeadedAttention(nn.Module):
    def __init__(self, cfg: MHAConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.linear_q = nn.Linear(cfg.n_feat, cfg.n_feat, device=device)
        self.linear_k = nn.Linear(cfg.n_feat, cfg.n_feat, device=device)
        self.linear_v = nn.Linear(cfg.n_feat, cfg.n_feat, device=device)
        self.linear_out = nn.Linear(cfg.n_feat, cfg.n_feat, device=device)

    def forward(self, query, key, value, mask=None):
        return mha_apply(self, query, key, value, mask)


def mha_apply(attn: MultiHeadedAttention, query, key, value, mask=None):
    """query (B, Tq, D), key / value (B, Tk, D); mask: bool (B, 1 | Tq, Tk) or (B, Tk),
    True = attend -> (B, Tq, D)."""
    cfg = attn.cfg
    q = _heads(apply_linear(attn.linear_q, query), cfg.n_head, cfg.d_k)
    k = _heads(apply_linear(attn.linear_k, key), cfg.n_head, cfg.d_k)
    v = _heads(apply_linear(attn.linear_v, value), cfg.n_head, cfg.d_k)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(cfg.d_k)
    if mask is not None:
        mask = mask[:, None] if mask.dim() == 3 else mask[:, None, None, :]
    probs = masked_softmax(scores.to(query.dtype), mask)
    ctx = torch.matmul(probs, v)
    b, h, t, dk = ctx.shape
    return apply_linear(attn.linear_out, ctx.transpose(1, 2).reshape(b, t, h * dk))
