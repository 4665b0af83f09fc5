"""Paraformer SAN-M NAR decoder in PyTorch (counterpart of
``funasr_tpu/models/paraformer/decoder.py::ParaformerSANMDecoder.__call__``).

FunASR's ``ParaformerSANMDecoder`` (``funasr/models/paraformer/decoder.py:233-645``):
``decoders`` (FFN -> FSMN with the layer input as residual -> cross-attention),
``decoders2`` (no cross-attention), ``decoders3`` (FFN only, NO residual), after-norm and
the vocab projection. ``embed`` is kept for the state dict (the glancing sampler of
training uses it; SeACo embeds its hotwords with it). ``forward_asf`` is the SeACo
decoder's attention-score probe. ``forward_chunk`` is the streaming decode
(``decoder.py:180-270``): FFN -> the FSMN step over [cache | tokens] on the FSMN kernel
(k = 11, pads (10, 0)) -> cross-attention over [cached | this chunk's] memory, for
``decoders``; the same without cross-attention for ``decoders2``; ``decoders3`` with no
residual. The token rows are padded to the chunk's bucket with ``n`` valid (a device
tensor), so no host wait sits between the predictor and the decoder.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
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
    cross_attention_apply_chunk,
    fsmn_decoder_apply_masked,
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

    def forward_chunk(self, memory, tgt, n, cache):
        """One streaming chunk: memory (B, Tm, enc) the chunk's encoder output, tgt
        (B, tmax, dim) the predictor's embeddings with ``n`` (a 0-d device tensor) valid
        rows -> logits (B, tmax, vocab); rows from n on are padding, which the caller
        drops. ``cache``: {"decode_fsmn": per-layer (B, k - 1, dim) or None, "opt":
        per cross-attention layer {"k", "v"} or None, "chunk_size",
        "decoder_chunk_look_back"}, updated in place."""
        cfg = self.cfg
        b, _, d = tgt.shape
        if cache.get("decode_fsmn") is None:
            cache["decode_fsmn"] = [tgt.new_zeros(b, cfg.kernel_size - 1, d)
                                    for _ in range(len(self.decoders) + len(self.decoders2))]
        look_back = cache.get("decoder_chunk_look_back", 0)
        chunk_size = cache.get("chunk_size")
        logits, fsmn, opt = self.chunk_step(memory, tgt, n, cache["decode_fsmn"],
                                            cache.get("opt"), chunk_size, look_back)
        cache["decode_fsmn"] = fsmn
        if look_back > 0 or look_back == -1:
            cache["opt"] = opt
        return logits

    def chunk_step(self, memory, tgt, n, fsmn_cache, opt_cache, chunk_size, look_back: int):
        """``_forward_chunk_impl``: -> (logits, new FSMN caches, new cross caches)."""
        index = n.reshape(1).long() + torch.arange(self.cfg.kernel_size - 1,
                                                   device=tgt.device)
        opt_cache = opt_cache or [None] * len(self.decoders)
        x, new_fsmn, new_opt = tgt, [], []
        for i, layer in enumerate((*self.decoders, *self.decoders2)):
            h = layer.feed_forward(layer.norm1(x))
            h, fc = fsmn_decoder_apply_masked(layer.self_attn, layer.norm2(h), fsmn_cache[i],
                                              index)
            x = x + h
            new_fsmn.append(fc)
            if layer.src_attn is not None:
                h, oc = cross_attention_apply_chunk(layer.src_attn, layer.norm3(x), memory,
                                                    opt_cache[i], chunk_size, look_back)
                x = x + h
                new_opt.append(oc)
        layer = self.decoders3[0]
        x = self.after_norm(layer.feed_forward(layer.norm1(x)))
        if self.output_layer is not None:
            x = apply_linear(self.output_layer, x)
        return x, new_fsmn, new_opt
