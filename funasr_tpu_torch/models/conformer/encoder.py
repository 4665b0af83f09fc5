"""Conformer encoder in PyTorch (counterpart of ``funasr_tpu/models/conformer/encoder.py``
``ConformerEncoder``; FunASR ``funasr/models/conformer/encoder.py:286+``): macaron
half-step swish FFNs around relative-position self-attention and the convolution module
(pointwise -> GLU -> depthwise k 15 -> BatchNorm -> swish -> pointwise), a final norm per
block, over a conv2d x4 subsampling whose output is scaled by sqrt(d) without a PE.

The depthwise convolution runs ``core/layers.py::depthwise_conv1d``: on CUDA the plain
mode of the FSMN kernel (``csrc/fsmn.cu``), once a block. Numerics copied, not "fixed":
the convolution module masks nothing before its depthwise conv, so padded frames reach
the last valid frames and a padded batch differs from an utterance alone; BatchNorm is
the inference form with eps 1e-5, also under ``train()`` (its running statistics never
move, as JAX's ``batchnorm_apply``); GLU is a * sigmoid(b) and swish x * sigmoid(x).

``ChunkConformerEncoder`` (``conformer/encoder.py:157-355``, the streaming transducer's)
is the same layers under a block-causal chunk mask (``chunk_attention_mask``) with a
causal depthwise conv (pads k - 1 / 0, the input rows past each length masked first: the
kernel's input mask), so that its offline pass equals its chunked stream:
``forward_chunk`` carries per layer the keys / values of the last ``left_chunks x
chunk_size`` frames and the last k - 1 conv inputs (``init_cache``). The chunk's conv over
[cache | chunk] runs at pads (k - 1, 0) and keeps its last chunk_size rows, the values of
JAX's pads (0, 0) conv, so the kernel gets no new mode.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from funasr_tpu_torch.core.layers import (LayerNorm, PositionwiseFeedForward, apply_linear,
                                          batch_norm, depthwise_conv1d, linear, make_pad_mask,
                                          masked_softmax)
from funasr_tpu_torch.models.transformer.attention import (MHAConfig,
                                                           RelPositionMultiHeadedAttention,
                                                           _heads, rel_pos_emb, relpos_mha_apply)
from funasr_tpu_torch.models.transformer.subsampling import Conv2dSubsampling
from funasr_tpu_torch.register import tables


def swish(x):
    return x * torch.sigmoid(x)


class PositionwiseFeedForwardSwish(PositionwiseFeedForward):
    """Linear -> swish -> Linear (``_ffn_swish``, ``conformer/encoder.py:70-72``), under
    the same ``w_1`` / ``w_2`` names."""

    def forward(self, x):
        return apply_linear(self.w_2, swish(apply_linear(self.w_1, x)))


class ConformerConfig(NamedTuple):
    input_size: int
    output_size: int = 256
    attention_heads: int = 4
    linear_units: int = 2048
    num_blocks: int = 6
    cnn_module_kernel: int = 15
    macaron_style: bool = True
    input_layer: str = "conv2d"

    @property
    def mha(self) -> MHAConfig:
        return MHAConfig(self.attention_heads, self.output_size)


class ConvolutionModule(nn.Module):
    def __init__(self, channels: int, kernel: int, device=None):
        super().__init__()
        self.kernel = kernel
        self.pointwise_conv1 = nn.Conv1d(channels, 2 * channels, 1, device=device)
        self.depthwise_conv = nn.Conv1d(channels, channels, kernel, groups=channels,
                                        padding=(kernel - 1) // 2, device=device)
        self.norm = nn.BatchNorm1d(channels, device=device)
        self.pointwise_conv2 = nn.Conv1d(channels, channels, 1, device=device)

    def forward(self, x):
        """x (B, T, C) -> (B, T, C)."""
        h = linear(x, self.pointwise_conv1.weight[:, :, 0], self.pointwise_conv1.bias)
        a, b = h.chunk(2, dim=-1)
        h = a * torch.sigmoid(b)  # GLU
        pad = (self.kernel - 1) // 2
        h = depthwise_conv1d(h, self.depthwise_conv, pad, pad)
        h = swish(batch_norm(h, self.norm))
        return linear(h, self.pointwise_conv2.weight[:, :, 0], self.pointwise_conv2.bias)


class ConformerLayer(nn.Module):
    def __init__(self, cfg: ConformerConfig, device=None):
        super().__init__()
        d = cfg.output_size
        self.macaron = cfg.macaron_style
        self.self_attn = RelPositionMultiHeadedAttention(cfg.mha, device=device)
        self.feed_forward = PositionwiseFeedForwardSwish(d, cfg.linear_units, device=device)
        if cfg.macaron_style:
            self.feed_forward_macaron = PositionwiseFeedForwardSwish(d, cfg.linear_units,
                                                                     device=device)
            self.norm_ff_macaron = LayerNorm(d, device=device)
        self.conv_module = ConvolutionModule(d, cfg.cnn_module_kernel, device=device)
        self.norm_ff = LayerNorm(d, device=device)
        self.norm_mha = LayerNorm(d, device=device)
        self.norm_conv = LayerNorm(d, device=device)
        self.norm_final = LayerNorm(d, device=device)

    def forward(self, x, pos_emb, mask):
        if self.macaron:
            x = x + 0.5 * self.feed_forward_macaron(self.norm_ff_macaron(x))
        x = x + relpos_mha_apply(self.self_attn, self.norm_mha(x), pos_emb, mask)
        x = x + self.conv_module(self.norm_conv(x))
        x = x + 0.5 * self.feed_forward(self.norm_ff(x))
        return self.norm_final(x)


@tables.register("encoder_classes", "ConformerEncoder")
class ConformerEncoder(nn.Module):
    LAYER = ConformerLayer

    def __init__(self, input_size: int, output_size: int = 256, attention_heads: int = 4,
                 linear_units: int = 2048, num_blocks: int = 6, cnn_module_kernel: int = 15,
                 macaron_style: bool = True, input_layer: str = "conv2d", device=None,
                 **kwargs):
        super().__init__()
        self.cfg = ConformerConfig(input_size, output_size, attention_heads, linear_units,
                                   num_blocks, cnn_module_kernel, macaron_style, input_layer)
        if input_layer == "conv2d":
            self.embed = Conv2dSubsampling(input_size, output_size, device=device)
        self.encoders = nn.ModuleList(self.LAYER(self.cfg, device=device)
                                      for _ in range(num_blocks))
        self.after_norm = LayerNorm(output_size, device=device)

    def output_size(self) -> int:
        return self.cfg.output_size

    def forward(self, xs_pad, ilens, generator=None):
        """(B, T, F), (B,) -> ((B, T', D), (B,) int32)."""
        if self.cfg.input_layer == "conv2d":
            x, olens = self.embed(xs_pad, ilens, add_pe=False)
            x = x * (self.cfg.output_size ** 0.5)
        else:
            x, olens = xs_pad, ilens
        mask = make_pad_mask(olens, x.shape[1])[:, None, :]
        pos = rel_pos_emb(x.shape[1], self.cfg.output_size, x.dtype, x.device)
        for layer in self.encoders:
            x = layer(x, pos, mask)
        return self.after_norm(x), olens


# ---- the chunked (streaming) conformer ------------------------------------------------


def chunk_attention_mask(t: int, chunk_size: int, left_chunks: int, device=None):
    """(1, T, T) bool: frame q attends to k iff chunk(k) <= chunk(q) and chunk(q) -
    chunk(k) <= left_chunks (< 0: unlimited left context) (``conformer/encoder.py:
    157-166``)."""
    ci = torch.arange(t, device=device) // chunk_size
    dq = ci[:, None] - ci[None, :]
    allowed = dq >= 0
    if left_chunks >= 0:
        allowed = allowed & (dq <= left_chunks)
    return allowed[None]


def _conv_in(layer: ConformerLayer, h):
    """pointwise_conv1 and GLU over norm_conv's output h: the depthwise conv's input."""
    cm = layer.conv_module
    hc = linear(h, cm.pointwise_conv1.weight[:, :, 0], cm.pointwise_conv1.bias)
    a, b = hc.chunk(2, dim=-1)
    return a * torch.sigmoid(b)


def _conv_out(layer: ConformerLayer, x, hd):
    """BatchNorm, swish and pointwise_conv2 after the depthwise conv, the residual, the
    second half-step FFN and the block's final norm."""
    cm = layer.conv_module
    hd = swish(batch_norm(hd, cm.norm))
    x = x + linear(hd, cm.pointwise_conv2.weight[:, :, 0], cm.pointwise_conv2.bias)
    x = x + 0.5 * layer.feed_forward(layer.norm_ff(x))
    return layer.norm_final(x)


def _macaron(layer: ConformerLayer, x):
    return x + 0.5 * layer.feed_forward_macaron(layer.norm_ff_macaron(x)) if layer.macaron else x


class ChunkConformerLayer(ConformerLayer):
    """A Conformer layer under an explicit (B, T, T) attention mask with the causal conv
    (``_chunk_layer_apply``, ``conformer/encoder.py:169-196``): the conv's input is
    zeroed past each length (norm_conv's output, then the GLU's, the kernel's input mask).
    The chunk encoder calls it as a module, so FSDP2's hooks unshard it."""

    def forward(self, x, pos_emb, attn_mask, pad_mask):
        x = _macaron(self, x)
        x = x + relpos_mha_apply(self.self_attn, self.norm_mha(x), pos_emb, attn_mask)
        hc = _conv_in(self, self.norm_conv(x) * pad_mask[..., None].to(x.dtype))
        k = self.conv_module.kernel
        hc = depthwise_conv1d(hc, self.conv_module.depthwise_conv, k - 1, 0, mask=pad_mask)
        return _conv_out(self, x, hc)


def _attn_step(attn: RelPositionMultiHeadedAttention, x_chunk, k_cache, v_cache, valid_left,
               keep: int, d_model: int):
    """Rel-pos attention of a chunk over [cache | chunk] (``_attn_step``,
    ``conformer/encoder.py:248-293``): the positional term gathered by distance from the
    (2t - 1)-row table, keys before the cache's valid left frames masked -> (out, the
    last ``keep`` keys and values)."""
    cfg = attn.cfg
    b, cs, _ = x_chunk.shape
    l = k_cache.shape[2]
    q = _heads(apply_linear(attn.linear_q, x_chunk), cfg.n_head, cfg.d_k)
    k = torch.cat([k_cache, _heads(apply_linear(attn.linear_k, x_chunk), cfg.n_head, cfg.d_k)], 2)
    v = torch.cat([v_cache, _heads(apply_linear(attn.linear_v, x_chunk), cfg.n_head, cfg.d_k)], 2)
    t = l + cs
    q_u = q + attn.pos_bias_u.to(q.dtype)[None, :, None, :]
    q_v = q + attn.pos_bias_v.to(q.dtype)[None, :, None, :]
    ac = torch.matmul(q_u.float(), k.float().transpose(-1, -2))
    pe = rel_pos_emb(t, d_model, x_chunk.dtype, x_chunk.device)
    p = _heads(apply_linear(attn.linear_pos, pe), cfg.n_head, cfg.d_k)
    bd_all = torch.matmul(q_v.float(), p.float().transpose(-1, -2))  # (B, H, cs, 2t - 1)
    qpos = l + torch.arange(cs, device=x_chunk.device)
    kpos = torch.arange(t, device=x_chunk.device)
    idx = (t - 1) - (qpos[:, None] - kpos[None, :])  # distance -> table row
    bd = torch.gather(bd_all, 3, idx[None, None].expand(b, cfg.n_head, cs, t))
    scores = (ac + bd) / math.sqrt(cfg.d_k)
    key_valid = kpos[None] >= (l - valid_left)[:, None]  # (B, t)
    probs = masked_softmax(scores.to(x_chunk.dtype), key_valid[:, None, None, :])
    ctx = torch.matmul(probs.float(), v.float())
    out = apply_linear(attn.linear_out,
                       ctx.transpose(1, 2).reshape(b, cs, -1).to(x_chunk.dtype))
    return out, k[:, :, t - keep:], v[:, :, t - keep:]


@tables.register("encoder_classes", "ChunkConformerEncoder")
class ChunkConformerEncoder(ConformerEncoder):
    """Chunk-causal Conformer for streaming (``conformer/encoder.py:199-355``): the offline
    ``forward`` under the chunk mask and the causal conv, so that training matches
    streaming; ``forward_chunk`` over the caches of ``init_cache``."""

    LAYER = ChunkConformerLayer

    def __init__(self, *args, chunk_size: int = 16, left_chunks: int = 4, **kwargs):
        kwargs.setdefault("input_layer", "null")
        super().__init__(*args, **kwargs)
        self.chunk_size = chunk_size
        self.left_chunks = left_chunks

    def forward(self, xs_pad, ilens, generator=None, chunk_size=None, left_chunks=None):
        """(B, T, F), (B,) -> ((B, T', D) zeroed past each length, (B,) int32)."""
        cs = chunk_size or self.chunk_size
        lc = self.left_chunks if left_chunks is None else left_chunks
        if self.cfg.input_layer == "conv2d":
            x, olens = self.embed(xs_pad, ilens, add_pe=False)
            x = x * (self.cfg.output_size ** 0.5)
        else:
            x, olens = xs_pad, ilens
        t = x.shape[1]
        pad_mask = make_pad_mask(olens, t)
        attn_mask = chunk_attention_mask(t, cs, lc, x.device) & pad_mask[:, None, :]
        pos = rel_pos_emb(t, self.cfg.output_size, x.dtype, x.device)
        for layer in self.encoders:
            x = layer(x, pos, attn_mask, pad_mask)
        x = self.after_norm(x)
        return x * pad_mask[..., None].to(x.dtype), olens

    def init_cache(self, batch: int, dtype=torch.float32, device=None):
        """Stacked (num_blocks, ...) caches (``init_cache``, ``:248-263``): the keys and
        values of the last left_chunks x chunk_size frames, the last k - 1 conv inputs
        and the frames seen so far."""
        cfg = self.cfg
        device = device if device is not None else self.after_norm.weight.device
        l = self.left_chunks * self.chunk_size
        h, dk = cfg.attention_heads, cfg.output_size // cfg.attention_heads
        return {"k": torch.zeros(cfg.num_blocks, batch, h, l, dk, dtype=dtype, device=device),
                "v": torch.zeros(cfg.num_blocks, batch, h, l, dk, dtype=dtype, device=device),
                "conv": torch.zeros(cfg.num_blocks, batch, cfg.cnn_module_kernel - 1,
                                    cfg.output_size, dtype=dtype, device=device),
                "filled": torch.zeros(batch, dtype=torch.int32, device=device)}

    def forward_chunk(self, chunk, cache):
        """chunk (B, chunk_size, D) after the subsampling -> ((B, chunk_size, D), the new
        cache) (``forward_chunk``, ``:300-355``)."""
        k = self.cfg.cnn_module_kernel
        keep = self.left_chunks * self.chunk_size
        x = chunk
        cs = chunk.shape[1]
        valid_left = torch.clamp(cache["filled"], max=keep)
        new_k, new_v, new_conv = [], [], []
        for i, layer in enumerate(self.encoders):
            x = _macaron(layer, x)
            out, nk, nv = _attn_step(layer.self_attn, layer.norm_mha(x), cache["k"][i],
                                     cache["v"][i], valid_left, keep, self.cfg.output_size)
            x = x + out
            win = torch.cat([cache["conv"][i], _conv_in(layer, layer.norm_conv(x))], dim=1)
            new_conv.append(win[:, win.shape[1] - (k - 1):])
            hd = depthwise_conv1d(win, layer.conv_module.depthwise_conv, k - 1, 0)[:, -cs:]
            x = _conv_out(layer, x, hd)
            new_k.append(nk)
            new_v.append(nv)
        x = self.after_norm(x)
        return x, {"k": torch.stack(new_k), "v": torch.stack(new_v),
                   "conv": torch.stack(new_conv), "filled": cache["filled"] + cs}
