"""FsmnDecoderSCAMAOpt in PyTorch: the autoregressive SAN-M decoder under SCAMA chunk
windows (counterpart of ``funasr_tpu/models/scama/decoder.py``; FunASR
``funasr/models/scama/decoder.py:203``).

Token embeddings in; ``att_layer_num`` layers of FFN -> FSMN memory (the "self
attention", causal through its left context) -> cross-attention to the chunked encoder
output under a per-token key mask (B, U, Tm), the SCAMA window of
``utils.build_scama_mask_for_cross_attention_decoder`` ANDed with the memory's pad mask
(``_cross_attention_3dmask``: matmul + masked softmax, plain PyTorch as JAX's einsum);
then ``decoders2`` (FFN -> FSMN), ``decoders3`` (FFN, no residual), after-norm and the
vocab projection. The decoder width (``attention_dim``) may differ from the encoder's.
``concat_embeds`` puts [embeddings || the CIF's acoustic embeddings] through
``embed_concat_ffn`` first (FFN to the decoder width, no residual).

The FSMN blocks run ``sanm/attention.py::fsmn_decoder_apply``, so on CUDA the FSMN
kernel: pads ((k - 1) // 2 + sanm_shfit, the rest), where ``sanm_shfit`` defaults to
(k - 1) // 2: k 11 runs the (11, 10) instantiation, k 21 the generic one. The layers are
``paraformer/decoder.py::DecoderLayerSANM``'s, FunASR's state-dict names, with the 3-D
mask in their cross-attention (``DecoderLayerSCAMA``).

Target ids below 0 (``ignore_id`` padding, which UniASR feeds under ``predictor_bias``
0) take the embedding row of ``id + vocab``, as ``jnp.take`` wraps a negative index;
those rows are masked out of every valid row's output.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from funasr_tpu_torch.core.layers import (
    LayerNorm,
    PositionwiseFeedForwardDecoderSANM,
    apply_linear,
    embedding,
    make_pad_mask,
)
from funasr_tpu_torch.models.paraformer.decoder import DecoderLayerSANM
from funasr_tpu_torch.models.sanm.attention import (
    CrossAttentionConfig,
    FSMNDecoderConfig,
    _cross_context,
    _cross_heads,
)
from funasr_tpu_torch.register import tables


class SCAMADecoderConfig(NamedTuple):
    """``ParaformerDecoderConfig`` with the decoder width (``attention_dim``) decoupled
    from the encoder output size (FunASR ``scama/decoder.py:272-273``)."""
    vocab_size: int
    encoder_output_size: int
    attention_dim: int
    attention_heads: int = 4
    linear_units: int = 2048
    num_blocks: int = 6
    att_layer_num: int = 6
    kernel_size: int = 21
    sanm_shift: int = 0
    use_output_layer: bool = True

    @property
    def dim(self) -> int:
        return self.attention_dim

    @property
    def fsmn_cfg(self) -> FSMNDecoderConfig:
        return FSMNDecoderConfig(self.dim, self.kernel_size, self.sanm_shift)

    @property
    def cross_cfg(self) -> CrossAttentionConfig:
        return CrossAttentionConfig(self.attention_heads, self.dim, self.encoder_output_size)


class EmbedConcatFFN(nn.Module):
    """FunASR's ``embed_concat_ffn`` layer: norm1 -> FFN (dim + enc -> dim), no residual."""

    def __init__(self, cfg: SCAMADecoderConfig, device=None):
        super().__init__()
        width = cfg.dim + cfg.encoder_output_size
        self.norm1 = LayerNorm(width, device=device)
        self.feed_forward = PositionwiseFeedForwardDecoderSANM(width, cfg.linear_units,
                                                               device=device, adim=cfg.dim)

    def forward(self, x):
        return self.feed_forward(self.norm1(x))


def cross_attention_3dmask(attn, x, memory, mask3):
    """Cross attention with a per-query key mask ``mask3`` (B, Tq, Tk) bool
    (``_cross_attention_3dmask``; FunASR ``scama/decoder.py:410-413``); a query row with
    no key gives 0 through the softmax."""
    q_h, k_h, v_h = _cross_heads(attn, x, memory)
    return _cross_context(attn, q_h, k_h, v_h, mask3[:, None])[0]


class DecoderLayerSCAMA(DecoderLayerSANM):
    """``DecoderLayerSANM`` whose cross-attention takes the per-query key mask (B, Tq, Tk).
    The layers run as modules, so FSDP2 gathers each one's shards around its call."""

    def forward(self, tgt, tgt_mask, memory, mask3):
        h = self.feed_forward(self.norm1(tgt))
        x = h
        if self.self_attn is not None:
            x = tgt + self.self_attn(self.norm2(h), tgt_mask)
        if self.src_attn is not None:
            x = x + cross_attention_3dmask(self.src_attn, self.norm3(x), memory, mask3)
        return x


@tables.register("decoder_classes", "FsmnDecoderSCAMAOpt")
class FsmnDecoderSCAMAOpt(nn.Module):
    def __init__(self, vocab_size: int, encoder_output_size: int, attention_heads: int = 4,
                 linear_units: int = 2048, num_blocks: int = 6, att_layer_num: int = 6,
                 kernel_size: int = 21, sanm_shfit=None, use_output_layer: bool = True,
                 input_layer: str = "embed", concat_embeds: bool = False,
                 attention_dim=None, device=None, **kwargs):
        super().__init__()
        if sanm_shfit is None:
            sanm_shfit = (kernel_size - 1) // 2
        if input_layer != "embed":
            raise ValueError("the SCAMA decoder takes token embeddings (input_layer 'embed')")
        self.cfg = cfg = SCAMADecoderConfig(
            vocab_size=vocab_size, encoder_output_size=encoder_output_size,
            attention_dim=attention_dim or encoder_output_size,
            attention_heads=attention_heads, linear_units=linear_units,
            num_blocks=num_blocks, att_layer_num=att_layer_num, kernel_size=kernel_size,
            sanm_shift=sanm_shfit, use_output_layer=use_output_layer)
        self.concat_embeds = concat_embeds
        self.embed = nn.Sequential(nn.Embedding(vocab_size, cfg.dim, device=device))
        self.decoders = nn.ModuleList(
            [DecoderLayerSCAMA(cfg, True, True, device) for _ in range(att_layer_num)])
        self.decoders2 = nn.ModuleList(
            [DecoderLayerSCAMA(cfg, True, False, device)
             for _ in range(num_blocks - att_layer_num)])
        self.decoders3 = nn.ModuleList([DecoderLayerSCAMA(cfg, False, False, device)])
        self.after_norm = LayerNorm(cfg.dim, device=device)
        self.output_layer = (nn.Linear(cfg.dim, vocab_size, device=device)
                             if use_output_layer else None)
        self.embed_concat_ffn = (nn.ModuleList([EmbedConcatFFN(cfg, device)])
                                 if concat_embeds else None)

    def forward(self, hs_pad, hlens, ys_in_pad, ys_in_lens, chunk_mask=None,
                pre_acoustic_embeds=None):
        """hs_pad (B, Tm, enc) the memory, hlens (B,) (or (1,), for every row); ys_in_pad
        (B, U) token ids; ``chunk_mask`` (B, >= U, Tm) float SCAMA windows (None: the pad
        mask alone) -> (logits (B, U, vocab), valid target counts (B,))."""
        cfg = self.cfg
        b, u = ys_in_pad.shape
        tgt_mask = make_pad_mask(ys_in_lens, u)
        mask3 = make_pad_mask(hlens, hs_pad.shape[1])[:, None, :].float().expand(
            b, u, hs_pad.shape[1])
        if chunk_mask is not None:
            mask3 = mask3 * chunk_mask[:, :u, :]
        mask3 = mask3 > 0.5

        ids = torch.where(ys_in_pad < 0, ys_in_pad + cfg.vocab_size, ys_in_pad)
        x = embedding(ids, self.embed[0].weight, dtype=hs_pad.dtype)
        if pre_acoustic_embeds is not None and self.concat_embeds:
            x = self.embed_concat_ffn[0](torch.cat([x, pre_acoustic_embeds[:, :u]], dim=-1))
        for layer in self.decoders:
            x = layer(x, tgt_mask, hs_pad, mask3)
        for layer in (*self.decoders2, *self.decoders3):
            x = layer(x, tgt_mask, None, None)
        x = self.after_norm(x)
        if self.output_layer is not None:
            x = apply_linear(self.output_layer, x)
        return x, tgt_mask.sum(dim=1)
