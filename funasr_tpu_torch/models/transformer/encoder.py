"""Transformer encoder in PyTorch (counterpart of
``funasr_tpu/models/transformer/encoder.py``; FunASR ``transformer/encoder.py:140+``):
pre-norm self-attention + feed-forward blocks over a conv2d x4 subsampling (input layer
``conv2d``), a linear + espnet PE (``linear``) or the features as they are (anything
else), then the after-norm. The JAX package scans the stacked blocks; here they are an
``nn.ModuleList`` loop. ``dropout_rate`` and the other training keys are accepted and
ignored, as the JAX encoder ignores them.
"""

from __future__ import annotations

from typing import NamedTuple

from torch import nn

from funasr_tpu_torch.core.layers import (LayerNorm, PositionwiseFeedForward, apply_linear,
                                          make_pad_mask)
from funasr_tpu_torch.models.transformer.attention import (MHAConfig, MultiHeadedAttention,
                                                           add_espnet_pe, mha_apply)
from funasr_tpu_torch.models.transformer.subsampling import Conv2dSubsampling
from funasr_tpu_torch.register import tables


class TransformerEncoderConfig(NamedTuple):
    input_size: int
    output_size: int = 256
    attention_heads: int = 4
    linear_units: int = 2048
    num_blocks: int = 6
    input_layer: str = "conv2d"
    normalize_before: bool = True

    @property
    def mha(self) -> MHAConfig:
        return MHAConfig(self.attention_heads, self.output_size)


class EncoderLayer(nn.Module):
    """norm1 -> self-attention -> residual, norm2 -> FFN -> residual."""

    def __init__(self, cfg: TransformerEncoderConfig, device=None):
        super().__init__()
        self.norm1 = LayerNorm(cfg.output_size, device=device)
        self.norm2 = LayerNorm(cfg.output_size, device=device)
        self.self_attn = MultiHeadedAttention(cfg.mha, device=device)
        self.feed_forward = PositionwiseFeedForward(cfg.output_size, cfg.linear_units,
                                                    device=device)

    def forward(self, x, mask):
        """mask: (B, 1 | T, T) or (B, T) bool, True = attend."""
        h = self.norm1(x)
        x = x + mha_apply(self.self_attn, h, h, h, mask)
        return x + self.feed_forward(self.norm2(x))


@tables.register("encoder_classes", "TransformerEncoder")
class TransformerEncoder(nn.Module):
    def __init__(self, input_size: int, output_size: int = 256, attention_heads: int = 4,
                 linear_units: int = 2048, num_blocks: int = 6, input_layer: str = "conv2d",
                 normalize_before: bool = True, device=None, **kwargs):
        super().__init__()
        self.cfg = TransformerEncoderConfig(input_size, output_size, attention_heads,
                                            linear_units, num_blocks, input_layer,
                                            normalize_before)
        if input_layer == "conv2d":
            self.embed = Conv2dSubsampling(input_size, output_size, device=device)
        elif input_layer == "linear":
            self.embed = nn.Sequential(nn.Linear(input_size, output_size, device=device))
        self.encoders = nn.ModuleList(EncoderLayer(self.cfg, device=device)
                                      for _ in range(num_blocks))
        self.after_norm = LayerNorm(output_size, device=device)

    def output_size(self) -> int:
        return self.cfg.output_size

    def forward(self, xs_pad, ilens, generator=None):
        """(B, T, F), (B,) -> ((B, T', D), (B,) int32)."""
        if self.cfg.input_layer == "conv2d":
            x, olens = self.embed(xs_pad, ilens)
        elif self.cfg.input_layer == "linear":
            x, olens = add_espnet_pe(apply_linear(self.embed[0], xs_pad)), ilens
        else:
            x, olens = xs_pad, ilens
        mask = make_pad_mask(olens, x.shape[1])[:, None, :]
        for layer in self.encoders:
            x = layer(x, mask)
        if self.cfg.normalize_before:
            x = self.after_norm(x)
        return x, olens
