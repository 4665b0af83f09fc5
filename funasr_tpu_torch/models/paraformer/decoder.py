"""Paraformer SAN-M NAR decoder in PyTorch (counterpart of
``funasr_tpu/models/paraformer/decoder.py::ParaformerSANMDecoder.__call__``).

FunASR's ``ParaformerSANMDecoder`` (``funasr/models/paraformer/decoder.py:233-645``):
``decoders`` (FFN -> FSMN with the layer input as residual -> cross-attention),
``decoders2`` (no cross-attention), ``decoders3`` (FFN only, NO residual), after-norm and
the vocab projection. ``embed`` is kept for the state dict (the glancing sampler of
training uses it; SeACo embeds its hotwords with it). ``forward_asf`` is the SeACo
decoder's attention-score probe. The streaming ``forward_chunk`` is slice 3.
"""

from __future__ import annotations

from typing import NamedTuple

from torch import nn

from funasr_tpu_torch.core.layers import (
    LayerNorm,
    PositionwiseFeedForwardDecoderSANM,
    apply_linear,
    make_pad_mask,
)
from funasr_tpu_torch.models.sanm.attention import (
    CrossAttentionConfig,
    FSMNDecoderConfig,
    MultiHeadedAttentionCrossAtt,
    MultiHeadedAttentionSANMDecoder,
    cross_attention_apply,
)
from funasr_tpu_torch.register import tables


class ParaformerDecoderConfig(NamedTuple):
    vocab_size: int
    encoder_output_size: int
    attention_heads: int = 4
    linear_units: int = 2048
    num_blocks: int = 6
    att_layer_num: int = 6
    kernel_size: int = 11
    sanm_shift: int = 0
    use_output_layer: bool = True

    @property
    def dim(self) -> int:
        return self.encoder_output_size

    @property
    def fsmn_cfg(self) -> FSMNDecoderConfig:
        return FSMNDecoderConfig(self.dim, self.kernel_size, self.sanm_shift)

    @property
    def cross_cfg(self) -> CrossAttentionConfig:
        return CrossAttentionConfig(self.attention_heads, self.dim,
                                    self.encoder_output_size)


class DecoderLayerSANM(nn.Module):
    def __init__(self, cfg: ParaformerDecoderConfig, has_self: bool, has_src: bool,
                 device=None):
        super().__init__()
        self.norm1 = LayerNorm(cfg.dim, device=device)
        self.feed_forward = PositionwiseFeedForwardDecoderSANM(cfg.dim, cfg.linear_units,
                                                               device=device)
        self.self_attn = self.src_attn = None
        if has_self:
            self.norm2 = LayerNorm(cfg.dim, device=device)
            self.self_attn = MultiHeadedAttentionSANMDecoder(cfg.fsmn_cfg, device=device)
        if has_src:
            self.norm3 = LayerNorm(cfg.dim, device=device)
            self.src_attn = MultiHeadedAttentionCrossAtt(cfg.cross_cfg, device=device)

    def forward(self, tgt, tgt_mask, memory, memory_mask):
        h = self.feed_forward(self.norm1(tgt))
        x = h
        if self.self_attn is not None:
            x = tgt + self.self_attn(self.norm2(h), tgt_mask)
        if self.src_attn is not None:
            x = x + self.src_attn(self.norm3(x), memory, memory_mask)
        return x


@tables.register("decoder_classes", "ParaformerSANMDecoder")
class ParaformerSANMDecoder(nn.Module):
    def __init__(self, vocab_size: int, encoder_output_size: int,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, att_layer_num: int = 6, kernel_size: int = 11,
                 sanm_shfit: int = 0, use_output_layer: bool = True, device=None,
                 **kwargs):
        super().__init__()
        if sanm_shfit is None:
            sanm_shfit = (kernel_size - 1) // 2
        self.cfg = cfg = ParaformerDecoderConfig(
            vocab_size=vocab_size, encoder_output_size=encoder_output_size,
            attention_heads=attention_heads, linear_units=linear_units,
            num_blocks=num_blocks, att_layer_num=att_layer_num,
            kernel_size=kernel_size, sanm_shift=sanm_shfit,
            use_output_layer=use_output_layer,
        )
        self.embed = nn.Sequential(nn.Embedding(vocab_size, cfg.dim, device=device))
        self.decoders = nn.ModuleList(
            [DecoderLayerSANM(cfg, True, True, device) for _ in range(att_layer_num)])
        self.decoders2 = nn.ModuleList(
            [DecoderLayerSANM(cfg, True, False, device)
             for _ in range(num_blocks - att_layer_num)])
        self.decoders3 = nn.ModuleList([DecoderLayerSANM(cfg, False, False, device)])
        self.after_norm = LayerNorm(cfg.dim, device=device)
        self.output_layer = (nn.Linear(cfg.dim, vocab_size, device=device)
                             if use_output_layer else None)

    def forward(self, hs_pad, hlens, ys_in_pad, ys_in_lens, return_hidden: bool = False):
        """hs_pad: (B, Tm, enc) memory; ys_in_pad: (B, Tq, dim) CIF acoustic embeds.

        Returns (logits (B, Tq, vocab), ys_in_lens).
        """
        tgt_mask = make_pad_mask(ys_in_lens, ys_in_pad.shape[1])
        memory_mask = make_pad_mask(hlens, hs_pad.shape[1])
        x = ys_in_pad
        for layer in self.decoders:
            x = layer(x, tgt_mask, hs_pad, memory_mask)
        return self.forward_tail(x, tgt_mask, ys_in_lens, return_hidden)

    def forward_tail(self, x, tgt_mask, ys_in_lens, return_hidden: bool = False):
        """The layers after the cross-attention ones, the after-norm and the vocab
        projection (none under ``return_hidden``)."""
        for layer in (*self.decoders2, *self.decoders3):
            x = layer(x, tgt_mask, None, None)
        hidden = self.after_norm(x)
        if self.output_layer is not None and not return_hidden:
            return apply_linear(self.output_layer, hidden), ys_in_lens
        return hidden, ys_in_lens

    def forward_asf(self, hs_pad, hlens, ys_in_pad, ys_in_lens, probe_layer=None):
        """Run the first ``probe_layer`` - 1 layers (6 when None, at most
        ``att_layer_num``), then the next layer up to its cross-attention, and return
        that attention's probabilities (B, H, Tq, Tk): the attention-score filtering
        probe (``decoder.py:151-178``; FunASR ``forward_asf6``)."""
        probe = min(probe_layer if probe_layer is not None else 6, self.cfg.att_layer_num) - 1
        tgt_mask = make_pad_mask(ys_in_lens, ys_in_pad.shape[1])
        memory_mask = make_pad_mask(hlens, hs_pad.shape[1])
        x = ys_in_pad
        for layer in self.decoders[:probe]:
            x = layer(x, tgt_mask, hs_pad, memory_mask)
        layer = self.decoders[probe]
        h = layer.feed_forward(layer.norm1(x))
        x = x + layer.self_attn(layer.norm2(h), tgt_mask)
        _, attn = cross_attention_apply(layer.src_attn, layer.norm3(x), hs_pad, memory_mask,
                                        ret_attn=True)
        return attn
