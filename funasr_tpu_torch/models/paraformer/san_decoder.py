"""Paraformer SAN decoder in PyTorch (counterpart of
``funasr_tpu/models/paraformer/san_decoder.py``; FunASR ``ParaformerSANDecoder``, also
registered as ``ParaformerDecoderSAN`` and ``ParaformerDecoderSANExport``): per layer,
pre-norm multi-head self-attention over the CIF embeddings (no causal mask),
cross-attention to the encoder and a ReLU feed-forward, each with its residual; then the
after-norm, the padded token rows zeroed and the vocab projection. No FSMN and no flash
attention: the JAX package runs it with einsums.
"""

from __future__ import annotations

from typing import NamedTuple

from torch import nn

from funasr_tpu_torch.core.layers import (LayerNorm, PositionwiseFeedForward, apply_linear,
                                          make_pad_mask)
from funasr_tpu_torch.models.transformer.attention import MHAConfig, MultiHeadedAttention
from funasr_tpu_torch.register import tables


class SANDecoderConfig(NamedTuple):
    vocab_size: int
    encoder_output_size: int
    attention_heads: int = 4
    linear_units: int = 2048
    num_blocks: int = 6
    use_output_layer: bool = True

    @property
    def dim(self) -> int:
        return self.encoder_output_size

    @property
    def mha(self) -> MHAConfig:
        return MHAConfig(self.attention_heads, self.dim)


class DecoderLayerSAN(nn.Module):
    def __init__(self, cfg: SANDecoderConfig, device=None):
        super().__init__()
        self.norm1 = LayerNorm(cfg.dim, device=device)
        self.norm2 = LayerNorm(cfg.dim, device=device)
        self.norm3 = LayerNorm(cfg.dim, device=device)
        self.self_attn = MultiHeadedAttention(cfg.mha, device=device)
        self.src_attn = MultiHeadedAttention(cfg.mha, device=device)
        self.feed_forward = PositionwiseFeedForward(cfg.dim, cfg.linear_units, device=device)

    def forward(self, x, tgt_mask, memory, memory_mask):
        h = self.norm1(x)
        x = x + self.self_attn(h, h, h, tgt_mask[:, None, :])
        h = self.norm2(x)
        x = x + self.src_attn(h, memory, memory, memory_mask[:, None, :])
        return x + self.feed_forward(self.norm3(x))


@tables.register("decoder_classes", "ParaformerSANDecoder")
@tables.register("decoder_classes", "ParaformerDecoderSAN")
@tables.register("decoder_classes", "ParaformerDecoderSANExport")
class ParaformerSANDecoder(nn.Module):
    def __init__(self, vocab_size: int, encoder_output_size: int, attention_heads: int = 4,
                 linear_units: int = 2048, num_blocks: int = 6, use_output_layer: bool = True,
                 device=None, **kwargs):
        super().__init__()
        self.cfg = cfg = SANDecoderConfig(vocab_size, encoder_output_size, attention_heads,
                                          linear_units, num_blocks, use_output_layer)
        self.embed = nn.Sequential(nn.Embedding(vocab_size, cfg.dim, device=device))
        self.decoders = nn.ModuleList([DecoderLayerSAN(cfg, device) for _ in range(num_blocks)])
        self.after_norm = LayerNorm(cfg.dim, device=device)
        self.output_layer = (nn.Linear(cfg.dim, vocab_size, device=device)
                             if use_output_layer else None)

    def forward(self, hs_pad, hlens, sematic_embeds, ys_lens):
        """hs_pad (B, Tm, d) memory, sematic_embeds (B, K, d) -> (logits (B, K, vocab),
        ys_lens)."""
        tgt_mask = make_pad_mask(ys_lens, sematic_embeds.shape[1])
        memory_mask = make_pad_mask(hlens, hs_pad.shape[1])
        x = sematic_embeds
        for layer in self.decoders:
            x = layer(x, tgt_mask, hs_pad, memory_mask)
        x = self.after_norm(x) * tgt_mask[..., None].to(x.dtype)
        if self.output_layer is not None:
            x = apply_linear(self.output_layer, x)
        return x, ys_lens
