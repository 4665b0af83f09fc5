"""Conformer encoder in PyTorch (counterpart of ``funasr_tpu/models/conformer/encoder.py``
``ConformerEncoder``; FunASR ``funasr/models/conformer/encoder.py:286+``): macaron
half-step swish FFNs around relative-position self-attention and the convolution module
(pointwise -> GLU -> depthwise k 15 -> BatchNorm -> swish -> pointwise), a final norm per
block, over a conv2d x4 subsampling whose output is scaled by sqrt(d) without a PE.

The depthwise convolution runs ``core/layers.py::depthwise_conv1d``: on CUDA the plain
mode of the FSMN kernel (``csrc/fsmn.cu``), once a block. Numerics copied, not "fixed":
the convolution module masks nothing before its depthwise conv, so padded frames reach
the last valid frames and a padded batch differs from an utterance alone; BatchNorm is
the inference form with eps 1e-5; GLU is a * sigmoid(b) and swish x * sigmoid(x).
``ChunkConformerEncoder`` (the streaming transducer's) is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from funasr_tpu_torch.core.layers import (LayerNorm, PositionwiseFeedForward, apply_linear,
                                          batch_norm, depthwise_conv1d, linear, make_pad_mask)
from funasr_tpu_torch.models.transformer.attention import (MHAConfig,
                                                           RelPositionMultiHeadedAttention,
                                                           rel_pos_emb, relpos_mha_apply)
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
    def __init__(self, input_size: int, output_size: int = 256, attention_heads: int = 4,
                 linear_units: int = 2048, num_blocks: int = 6, cnn_module_kernel: int = 15,
                 macaron_style: bool = True, input_layer: str = "conv2d", device=None,
                 **kwargs):
        super().__init__()
        self.cfg = ConformerConfig(input_size, output_size, attention_heads, linear_units,
                                   num_blocks, cnn_module_kernel, macaron_style, input_layer)
        if input_layer == "conv2d":
            self.embed = Conv2dSubsampling(input_size, output_size, device=device)
        self.encoders = nn.ModuleList(ConformerLayer(self.cfg, device=device)
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
