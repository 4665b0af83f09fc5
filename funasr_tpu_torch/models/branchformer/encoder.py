"""Branchformer / E-Branchformer encoders and their AED models in PyTorch (counterpart of
``funasr_tpu/models/branchformer/encoder.py``; FunASR ``funasr/models/branchformer/`` and
``e_branchformer/``): each block runs a self-attention branch (relative-position by
default) beside a cgMLP branch (channel projection -> exact GELU -> a GLU whose gate is
LayerNorm -> input mask -> depthwise conv k 31 over time -> channel projection); the
branches merge by concat + linear (Branchformer) or concat + a depthwise conv k 3
residual + linear between macaron half-step FFNs (E-Branchformer).

Both depthwise convolutions run ``core/layers.py::depthwise_conv1d``: on CUDA the plain
mode of the FSMN kernel (``csrc/fsmn.cu``), the gate's with its input mask, the merge's
without. ``Branchformer`` and ``EBranchformer`` are Transformer AEDs over these encoders.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from funasr_tpu_torch.core.layers import (LayerNorm, PositionwiseFeedForward, apply_linear,
                                          depthwise_conv1d, make_pad_mask)
from funasr_tpu_torch.models.transformer.attention import (MHAConfig, MultiHeadedAttention,
                                                           RelPositionMultiHeadedAttention,
                                                           mha_apply, rel_pos_emb,
                                                           relpos_mha_apply)
from funasr_tpu_torch.models.transformer.model import Transformer
from funasr_tpu_torch.models.transformer.subsampling import Conv2dSubsampling
from funasr_tpu_torch.register import tables


class BranchformerConfig(NamedTuple):
    input_size: int
    output_size: int = 256
    attention_heads: int = 4
    cgmlp_linear_units: int = 2048
    cgmlp_conv_kernel: int = 31
    num_blocks: int = 12
    merge_method: str = "concat"  # branchformer; "conv": e-branchformer
    use_macaron: bool = False     # e-branchformer
    ffn_units: int = 1024
    attention_layer_type: str = "rel_selfattn"

    @property
    def mha(self) -> MHAConfig:
        return MHAConfig(self.attention_heads, self.output_size)


class ConvolutionalSpatialGatingUnit(nn.Module):
    """The cgMLP's gate: ``norm`` (LayerNorm) and ``conv`` (depthwise, bias)."""

    def __init__(self, channels: int, kernel: int, device=None):
        super().__init__()
        self.kernel = kernel
        self.norm = LayerNorm(channels, device=device)
        self.conv = nn.Conv1d(channels, channels, kernel, groups=channels,
                              padding=(kernel - 1) // 2, device=device)


class ConvolutionalGatingMLP(nn.Module):
    def __init__(self, cfg: BranchformerConfig, device=None):
        super().__init__()
        d, h = cfg.output_size, cfg.cgmlp_linear_units
        self.channel_proj1 = nn.Sequential(nn.Linear(d, h, device=device), nn.GELU())
        self.csgu = ConvolutionalSpatialGatingUnit(h // 2, cfg.cgmlp_conv_kernel, device)
        self.channel_proj2 = nn.Linear(h // 2, d, device=device)

    def forward(self, x, mask):
        """x (B, T, D), mask (B, T) bool or None -> (B, T, D)."""
        h = F.gelu(apply_linear(self.channel_proj1[0], x))
        a, b = h.chunk(2, dim=-1)
        pad = (self.csgu.kernel - 1) // 2
        g = depthwise_conv1d(self.csgu.norm(b), self.csgu.conv, pad, pad, mask)
        return apply_linear(self.channel_proj2, a * g)


class BranchformerLayer(nn.Module):
    def __init__(self, cfg: BranchformerConfig, device=None):
        super().__init__()
        d = cfg.output_size
        self.cfg = cfg
        self.attn = (RelPositionMultiHeadedAttention(cfg.mha, device=device)
                     if cfg.attention_layer_type == "rel_selfattn"
                     else MultiHeadedAttention(cfg.mha, device=device))
        self.cgmlp = ConvolutionalGatingMLP(cfg, device=device)
        self.merge_proj = nn.Linear(2 * d, d, device=device)
        self.norm_mha = LayerNorm(d, device=device)
        self.norm_mlp = LayerNorm(d, device=device)
        self.norm_final = LayerNorm(d, device=device)
        if cfg.merge_method == "conv":
            self.depthwise_conv_fusion = nn.Conv1d(2 * d, 2 * d, 3, groups=2 * d, padding=1,
                                                   device=device)
        if cfg.use_macaron:
            self.feed_forward_macaron = PositionwiseFeedForward(d, cfg.ffn_units, device)
            self.norm_ff_macaron = LayerNorm(d, device=device)
            self.feed_forward = PositionwiseFeedForward(d, cfg.ffn_units, device)
            self.norm_ff = LayerNorm(d, device=device)

    def forward(self, x, mask, pos=None):
        """x (B, T, D), mask (B, T) bool, pos (1, 2T-1, D) (rel-pos attention)."""
        if self.cfg.use_macaron:
            x = x + 0.5 * self.feed_forward_macaron(self.norm_ff_macaron(x))
        h_att = self.norm_mha(x)
        if self.cfg.attention_layer_type == "rel_selfattn":
            h_att = relpos_mha_apply(self.attn, h_att, pos, mask[:, None, :])
        else:
            h_att = mha_apply(self.attn, h_att, h_att, h_att, mask[:, None, :])
        h_mlp = self.cgmlp(self.norm_mlp(x), mask)
        merged = torch.cat([h_att, h_mlp], dim=-1)
        if self.cfg.merge_method == "conv":
            merged = merged + depthwise_conv1d(merged, self.depthwise_conv_fusion, 1, 1)
        x = x + apply_linear(self.merge_proj, merged)
        if self.cfg.use_macaron:
            x = x + 0.5 * self.feed_forward(self.norm_ff(x))
        return self.norm_final(x)


@tables.register("encoder_classes", "BranchformerEncoder")
class BranchformerEncoder(nn.Module):
    MERGE = "concat"
    MACARON = False

    def __init__(self, input_size: int, output_size: int = 256, attention_heads: int = 4,
                 cgmlp_linear_units: int = 2048, cgmlp_conv_kernel: int = 31,
                 num_blocks: int = 12, ffn_units: int = 1024,
                 attention_layer_type: str = "rel_selfattn", use_ffn: Optional[bool] = None,
                 device=None, **kwargs):
        super().__init__()
        macaron = self.MACARON if use_ffn is None else use_ffn
        self.cfg = BranchformerConfig(input_size, output_size, attention_heads,
                                      cgmlp_linear_units, cgmlp_conv_kernel, num_blocks,
                                      self.MERGE, macaron, ffn_units, attention_layer_type)
        self.embed = Conv2dSubsampling(input_size, output_size, device=device)
        self.encoders = nn.ModuleList(BranchformerLayer(self.cfg, device=device)
                                      for _ in range(num_blocks))
        self.after_norm = LayerNorm(output_size, device=device)

    def output_size(self) -> int:
        return self.cfg.output_size

    def forward(self, xs_pad, ilens, generator=None):
        """(B, T, F), (B,) -> ((B, T', D), (B,) int32)."""
        relpos = self.cfg.attention_layer_type == "rel_selfattn"
        x, olens = self.embed(xs_pad, ilens, add_pe=not relpos)
        if relpos:
            x = x * (self.cfg.output_size ** 0.5)
        mask = make_pad_mask(olens, x.shape[1])
        pos = rel_pos_emb(x.shape[1], self.cfg.output_size, x.dtype, x.device) if relpos else None
        for layer in self.encoders:
            x = layer(x, mask, pos)
        return self.after_norm(x), olens


@tables.register("encoder_classes", "EBranchformerEncoder")
class EBranchformerEncoder(BranchformerEncoder):
    MERGE = "conv"
    MACARON = True


@tables.register("model_classes", "Branchformer")
class Branchformer(Transformer):
    """AED over a Branchformer encoder (FunASR ``branchformer/model.py``)."""

    def __init__(self, encoder: str = "BranchformerEncoder", **kwargs):
        super().__init__(encoder=encoder, **kwargs)


@tables.register("model_classes", "EBranchformer")
class EBranchformer(Transformer):
    def __init__(self, encoder: str = "EBranchformerEncoder", **kwargs):
        super().__init__(encoder=encoder, **kwargs)
