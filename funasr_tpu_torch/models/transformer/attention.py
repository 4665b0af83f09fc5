"""Standard and relative-position multi-head attention in PyTorch, and the espnet
positional encodings (counterpart of ``funasr_tpu/models/transformer/attention.py``;
FunASR ``funasr/models/transformer/attention.py::MultiHeadedAttention`` /
``RelPositionMultiHeadedAttention`` and ``embedding.py``): separate q, k and v projections
and ``linear_out`` under FunASR's names, scores scaled by 1/sqrt(d_k) and cast to the
input's dtype before the fp32 masked softmax. Plain PyTorch: the JAX package computes
both with einsums, outside any Pallas kernel.

The espnet PE interleaves sin and cos (even columns sin) and scales x by sqrt(d), unlike
SAN-M's sin || cos split (``core/layers.py::sinusoidal_pe``); the relative table runs over
positions T-1 .. -(T-1).
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


# ---------------------------------------------------------------------------
# relative-position self attention (espnet non-legacy) and the espnet PE tables
# ---------------------------------------------------------------------------


class RelPositionMultiHeadedAttention(MultiHeadedAttention):
    """FunASR ``RelPositionMultiHeadedAttention``: ``linear_pos`` (no bias) and the
    ``pos_bias_u`` / ``pos_bias_v`` (H, d_k) tables beside the q, k, v and out
    projections."""

    def __init__(self, cfg: MHAConfig, device=None):
        super().__init__(cfg, device=device)
        self.linear_pos = nn.Linear(cfg.n_feat, cfg.n_feat, bias=False, device=device)
        self.pos_bias_u = nn.Parameter(torch.zeros(cfg.n_head, cfg.d_k, device=device))
        self.pos_bias_v = nn.Parameter(torch.zeros(cfg.n_head, cfg.d_k, device=device))

    def init_from(self, generator):
        """Position biases ~ N(0, 0.02^2), as ``relpos_mha_init`` draws them."""
        dev = generator.device
        for p in (self.pos_bias_u, self.pos_bias_v):
            with torch.no_grad():
                p.copy_(torch.randn(p.shape, device=dev, generator=generator) * 0.02)

    def forward(self, x, pos_emb, mask=None):
        return relpos_mha_apply(self, x, pos_emb, mask)


def rel_shift(x):
    """(B, H, T, 2T-1) -> (B, H, T, T) Transformer-XL relative shift (``_rel_shift``,
    ``attention.py:68-75``)."""
    b, h, t, n = x.shape
    x_padded = torch.cat([x.new_zeros(b, h, t, 1), x], dim=-1).reshape(b, h, n + 1, t)
    return x_padded[:, :, 1:].reshape(b, h, t, n)[:, :, :, : (n + 1) // 2]


def relpos_mha_apply(attn: RelPositionMultiHeadedAttention, x, pos_emb, mask=None):
    """Rel-pos self attention (``relpos_mha_apply``, ``attention.py:78-97``): x (B, T, D),
    pos_emb (1, 2T-1, D), mask as ``mha_apply``'s -> (B, T, D). The positional scores are
    cast to x's dtype before the shift, and the sum to x's dtype before the softmax."""
    cfg = attn.cfg
    q = _heads(apply_linear(attn.linear_q, x), cfg.n_head, cfg.d_k)
    k = _heads(apply_linear(attn.linear_k, x), cfg.n_head, cfg.d_k)
    v = _heads(apply_linear(attn.linear_v, x), cfg.n_head, cfg.d_k)
    p = _heads(apply_linear(attn.linear_pos, pos_emb.to(x.dtype)), cfg.n_head, cfg.d_k)
    q_u = q + attn.pos_bias_u.to(q.dtype)[None, :, None, :]
    q_v = q + attn.pos_bias_v.to(q.dtype)[None, :, None, :]
    ac = torch.matmul(q_u.float(), k.float().transpose(-1, -2))
    bd = torch.matmul(q_v.float(), p.float().transpose(-1, -2))
    bd = rel_shift(bd.to(x.dtype)).float()
    scores = (ac + bd) / math.sqrt(cfg.d_k)
    if mask is not None:
        mask = mask[:, None] if mask.dim() == 3 else mask[:, None, None, :]
    probs = masked_softmax(scores.to(x.dtype), mask)
    ctx = torch.matmul(probs, v)
    b, h, t, dk = ctx.shape
    return apply_linear(attn.linear_out, ctx.transpose(1, 2).reshape(b, t, h * dk))


def _sin_cos_table(pos, d: int):
    """Interleaved sin / cos rows (espnet ``PositionalEncoding``) at fp32 positions."""
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=pos.device)
                    * -(math.log(10000.0) / d))
    pe = torch.zeros(pos.shape[0], d, dtype=torch.float32, device=pos.device)
    pe[:, 0::2] = torch.sin(pos[:, None] * div)
    pe[:, 1::2] = torch.cos(pos[:, None] * div)
    return pe


def espnet_pe(t: int, d: int, dtype=torch.float32, offset: int = 0, device=None):
    """Interleaved sin / cos PE table (T, D) (``espnet_pe``, ``attention.py:105-112``)."""
    pos = torch.arange(offset, offset + t, dtype=torch.float32, device=device)
    return _sin_cos_table(pos, d).to(dtype)


def add_espnet_pe(x, offset: int = 0):
    """x * sqrt(d) + PE (``add_espnet_pe``)."""
    d = x.shape[-1]
    return x * math.sqrt(d) + espnet_pe(x.shape[1], d, x.dtype, offset, x.device)[None]


def rel_pos_emb(t: int, d: int, dtype=torch.float32, device=None):
    """Relative PE table (1, 2T-1, D): positions T-1 .. -(T-1) (``rel_pos_emb``)."""
    pos = torch.arange(t - 1, -t, -1, dtype=torch.float32, device=device)
    return _sin_cos_table(pos, d)[None].to(dtype)
