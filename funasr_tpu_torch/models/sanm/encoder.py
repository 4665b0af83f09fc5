"""SAN-M encoder in PyTorch (counterpart of ``funasr_tpu/models/sanm/encoder.py``).

FunASR's ``SANMEncoder`` (``funasr/models/sanm/encoder.py:187-535``): ``x * sqrt(d)`` +
sinusoidal PE, one dim-changing block (``encoders0``, no attention residual) then N-1
homogeneous blocks (``encoders``), after-norm, output masked. The JAX package scans the
stacked blocks; here they are an ``nn.ModuleList`` loop. Inference only: dropout (the
``dropout_rate`` of hub configs) is not applied.
"""

from __future__ import annotations

from typing import NamedTuple

from torch import nn

from funasr_tpu_torch.core.layers import (
    LayerNorm,
    PositionwiseFeedForward,
    add_sinusoidal_pe,
    make_pad_mask,
)
from funasr_tpu_torch.models.sanm.attention import (
    MultiHeadedAttentionSANM,
    SANMAttentionConfig,
    sanm_attention_apply_chunk,
)
from funasr_tpu_torch.register import tables


class SANMEncoderConfig(NamedTuple):
    input_size: int
    output_size: int = 256
    attention_heads: int = 4
    linear_units: int = 2048
    num_blocks: int = 6
    kernel_size: int = 11
    sanm_shift: int = 0
    input_layer: str = "pe"
    normalize_before: bool = True

    def attn_cfg(self, first: bool) -> SANMAttentionConfig:
        return SANMAttentionConfig(
            n_head=self.attention_heads,
            in_feat=self.input_size if first else self.output_size,
            n_feat=self.output_size,
            kernel_size=self.kernel_size,
            sanm_shift=self.sanm_shift,
        )


class EncoderLayerSANM(nn.Module):
    """Pre-norm layer; the attention residual only when dims match (reference
    ``EncoderLayerSANM.forward:118-135`` keys on in_size == size)."""

    def __init__(self, cfg: SANMEncoderConfig, first: bool, device=None):
        super().__init__()
        attn_cfg = cfg.attn_cfg(first)
        self.residual_attn = attn_cfg.in_feat == attn_cfg.n_feat
        self.norm1 = LayerNorm(attn_cfg.in_feat, device=device)
        self.norm2 = LayerNorm(cfg.output_size, device=device)
        self.self_attn = MultiHeadedAttentionSANM(attn_cfg, device=device)
        self.feed_forward = PositionwiseFeedForward(cfg.output_size, cfg.linear_units,
                                                    device=device)

    def forward(self, x, mask, lengths, mode: str = "none", vad_pos=None):
        h = self.self_attn(self.norm1(x), mask, lengths, mode, vad_pos)
        x = x + h if self.residual_attn else h
        return x + self.feed_forward(self.norm2(x))

    def forward_chunk(self, x, cache, lengths, chunk_size, look_back: int):
        """One streaming chunk (``scama/encoder.py:87-97``) -> (out, new K/V cache)."""
        h, cache = sanm_attention_apply_chunk(self.self_attn, self.norm1(x), cache, lengths,
                                              chunk_size, look_back)
        x = x + h if self.residual_attn else h
        return x + self.feed_forward(self.norm2(x)), cache


@tables.register("encoder_classes", "SANMEncoder")
class SANMEncoder(nn.Module):
    def __init__(self, input_size: int, output_size: int = 256, attention_heads: int = 4,
                 linear_units: int = 2048, num_blocks: int = 6, kernel_size: int = 11,
                 sanm_shfit: int = 0, input_layer: str = "pe",
                 normalize_before: bool = True, device=None, **kwargs):
        super().__init__()
        if input_layer not in ("pe", "null", None):
            raise NotImplementedError(f"input_layer={input_layer}")
        self.cfg = cfg = SANMEncoderConfig(
            input_size=input_size, output_size=output_size,
            attention_heads=attention_heads, linear_units=linear_units,
            num_blocks=num_blocks, kernel_size=kernel_size, sanm_shift=sanm_shfit,
            input_layer=input_layer, normalize_before=normalize_before,
        )
        self.encoders0 = nn.ModuleList([EncoderLayerSANM(cfg, True, device)])
        self.encoders = nn.ModuleList(
            [EncoderLayerSANM(cfg, False, device) for _ in range(num_blocks - 1)])
        self.after_norm = LayerNorm(output_size, device=device)

    def output_size(self) -> int:
        return self.cfg.output_size

    def forward(self, xs_pad, ilens):
        """xs_pad: (B, T, input_size); ilens: (B,) -> ((B, T, out), (B,) lens)."""
        cfg = self.cfg
        mask = make_pad_mask(ilens, xs_pad.shape[1])
        x = xs_pad * (cfg.output_size ** 0.5)
        if cfg.input_layer == "pe":
            x = add_sinusoidal_pe(x)
        for layer in (*self.encoders0, *self.encoders):
            x = layer(x, mask, ilens)
        if cfg.normalize_before:
            x = self.after_norm(x)
        return x * mask[..., None].to(x.dtype), ilens
