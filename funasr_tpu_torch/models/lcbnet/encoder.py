"""LCB-Net's auxiliary encoders in PyTorch (counterpart of
``funasr_tpu/models/lcbnet/encoder.py``; FunASR ``funasr/models/lcbnet/encoder.py``):

* ``TransformerTextEncoder`` (FunASR ``:131``): OCR token ids -> embedding -> the espnet
  PE (x sqrt(d) + PE) -> the Transformer encoder layers (no input layer);
* ``FusionSANEncoder`` (``SelfSrcAttention``, ``:244``): one block fusing the text
  memory into the audio stream, self-attention -> cross-attention -> FFN, each pre-norm
  with a residual;
* ``ConvBiasPredictor`` (``ConvPredictor``, ``:373``): per OCR token, cross-attention
  to the audio -> FFN -> a depthwise conv (k = l_order + r_order + 1, pads l_order /
  r_order, a bias) plus its input -> ReLU -> one logit.

The attentions are ``transformer/attention.py::mha_apply`` (plain PyTorch, as JAX's
einsums). The predictor's depthwise conv runs ``core/layers.py::depthwise_conv1d``: the
FSMN kernel's plain mode on CUDA (its generic instantiation at k 7 / left 3), the plain
version on the CPU.
"""

from __future__ import annotations

import torch
from torch import nn

from funasr_tpu_torch.core.layers import (LayerNorm, PositionwiseFeedForward, apply_linear,
                                          depthwise_conv1d, embedding, make_pad_mask)
from funasr_tpu_torch.models.transformer.attention import (MHAConfig, MultiHeadedAttention,
                                                           add_espnet_pe, mha_apply)
from funasr_tpu_torch.models.transformer.encoder import TransformerEncoder
from funasr_tpu_torch.register import tables


@tables.register("encoder_classes", "TransformerTextEncoder")
class TransformerTextEncoder(TransformerEncoder):
    """Token ids -> (B, L, D) text memory; FunASR's names: ``embed.0`` (the token
    table), ``encoders.{i}``, ``after_norm``."""

    def __init__(self, vocab_size: int = -1, input_size: int = -1, output_size: int = 256,
                 attention_heads: int = 4, linear_units: int = 2048, num_blocks: int = 3,
                 device=None, **kwargs):
        kwargs["input_layer"] = None  # the ids are embedded here
        super().__init__(input_size=output_size, output_size=output_size,
                         attention_heads=attention_heads, linear_units=linear_units,
                         num_blocks=num_blocks, device=device, **kwargs)
        vocab = vocab_size if vocab_size > 0 else input_size
        self.embed = nn.Sequential(nn.Embedding(vocab, output_size, device=device))

    def forward(self, text, text_lengths, generator=None):
        """(B, L) ids, (B,) lengths -> ((B, L, D), lengths)."""
        x = add_espnet_pe(embedding(text, self.embed[0].weight))
        return super().forward(x, text_lengths, generator=generator)


@tables.register("encoder_classes", "FusionSANEncoder")
class SelfSrcAttention(nn.Module):
    def __init__(self, size: int = 256, attention_heads: int = 4, attention_dim: int = 256,
                 linear_units: int = 2048, device=None, **kwargs):
        super().__init__()
        cfg = MHAConfig(attention_heads, size)
        self.size = size
        self.norm1 = LayerNorm(size, device=device)
        self.self_attn = MultiHeadedAttention(cfg, device=device)
        self.norm2 = LayerNorm(size, device=device)
        self.src_attn = MultiHeadedAttention(cfg, device=device)
        self.norm3 = LayerNorm(size, device=device)
        self.feed_forward = PositionwiseFeedForward(size, linear_units, device=device)

    def output_size(self) -> int:
        return self.size

    def forward(self, x, memory, memory_lengths=None):
        """x (B, T, D) attends itself (no mask) and ``memory`` (B, L, D) (keys past
        ``memory_lengths`` masked when given) -> (B, T, D)."""
        mem_mask = None
        if memory_lengths is not None:
            mem_mask = make_pad_mask(memory_lengths, memory.shape[1])[:, None, :]
        h = self.norm1(x)
        x = x + mha_apply(self.self_attn, h, h, h, None)
        h = self.norm2(x)
        x = x + mha_apply(self.src_attn, h, memory, memory, mem_mask)
        return x + self.feed_forward(self.norm3(x))


@tables.register("encoder_classes", "ConvBiasPredictor")
class ConvPredictor(nn.Module):
    def __init__(self, size: int = 256, l_order: int = 3, r_order: int = 3,
                 attention_heads: int = 4, linear_units: int = 2048, device=None, **kwargs):
        super().__init__()
        self.size = size
        self.l_order, self.r_order = l_order, r_order
        self.atten = MultiHeadedAttention(MHAConfig(attention_heads, size), device=device)
        self.norm1 = LayerNorm(size, device=device)
        self.feed_forward = PositionwiseFeedForward(size, linear_units, device=device)
        self.norm2 = LayerNorm(size, device=device)
        self.conv1d = nn.Conv1d(size, size, l_order + r_order + 1, groups=size,
                                device=device)
        self.output_linear = nn.Linear(size, 1, device=device)

    def forward(self, text_enc, asr_enc):
        """text memory (B, L, D), audio memory (B, T, D) -> per-token logits (B, L)."""
        x = text_enc + mha_apply(self.atten, text_enc, asr_enc, asr_enc, None)
        x = x + self.feed_forward(self.norm1(x))
        h = self.norm2(x)
        mem = depthwise_conv1d(h, self.conv1d, self.l_order, self.r_order)
        return apply_linear(self.output_linear, torch.relu(mem + h))[..., 0]
