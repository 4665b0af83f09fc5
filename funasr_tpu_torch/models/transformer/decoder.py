"""Autoregressive Transformer decoder in PyTorch (counterpart of
``funasr_tpu/models/transformer/decoder.py``; FunASR ``TransformerDecoder``): token
embedding + espnet PE, pre-norm causal self-attention, cross-attention and feed-forward
blocks, the after-norm and the output layer. ``forward`` is the teacher-forced pass;
``score_step`` the beam search's scorer: next-token log-probs for a batch of prefixes,
the whole prefix recomputed at the bucketed length the search pads it to, as the JAX
package does (no per-layer key / value cache).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from funasr_tpu_torch.core.layers import (LayerNorm, PositionwiseFeedForward, apply_linear,
                                          embedding, make_pad_mask)
from funasr_tpu_torch.models.transformer.attention import (MHAConfig, MultiHeadedAttention,
                                                           add_espnet_pe, mha_apply)
from funasr_tpu_torch.register import tables


class TransformerDecoderConfig(NamedTuple):
    vocab_size: int
    encoder_output_size: int
    attention_heads: int = 4
    linear_units: int = 2048
    num_blocks: int = 6
    normalize_before: bool = True

    @property
    def dim(self) -> int:
        return self.encoder_output_size

    @property
    def mha(self) -> MHAConfig:
        return MHAConfig(self.attention_heads, self.dim)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: TransformerDecoderConfig, device=None):
        super().__init__()
        self.norm1 = LayerNorm(cfg.dim, device=device)
        self.norm2 = LayerNorm(cfg.dim, device=device)
        self.norm3 = LayerNorm(cfg.dim, device=device)
        self.self_attn = MultiHeadedAttention(cfg.mha, device=device)
        self.src_attn = MultiHeadedAttention(cfg.mha, device=device)
        self.feed_forward = PositionwiseFeedForward(cfg.dim, cfg.linear_units, device=device)

    def forward(self, x, tgt_mask, memory, memory_mask):
        h = self.norm1(x)
        x = x + mha_apply(self.self_attn, h, h, h, tgt_mask)
        h = self.norm2(x)
        x = x + mha_apply(self.src_attn, h, memory, memory, memory_mask[:, None, :])
        return x + self.feed_forward(self.norm3(x))


def causal_pad_mask(lengths, length: int):
    """(B, L, L) bool: causal and inside each row's length."""
    causal = torch.tril(torch.ones(length, length, dtype=torch.bool, device=lengths.device))
    return causal[None] & make_pad_mask(lengths, length)[:, None, :]


def last_log_probs(logits, lengths):
    """(N, L, V) logits -> (N, V) fp32 log-probs at each row's last valid position."""
    rows = torch.arange(logits.shape[0], device=logits.device)
    return torch.log_softmax(logits[rows, lengths.long() - 1].float(), dim=-1)


@tables.register("decoder_classes", "TransformerDecoder")
class TransformerDecoder(nn.Module):
    def __init__(self, vocab_size: int, encoder_output_size: int, attention_heads: int = 4,
                 linear_units: int = 2048, num_blocks: int = 6, normalize_before: bool = True,
                 device=None, **kwargs):
        super().__init__()
        self.cfg = TransformerDecoderConfig(vocab_size, encoder_output_size, attention_heads,
                                            linear_units, num_blocks, normalize_before)
        d = self.cfg.dim
        self.embed = nn.Sequential(nn.Embedding(vocab_size, d, device=device))
        self.decoders = nn.ModuleList(self.make_layer(i, device) for i in range(num_blocks))
        self.after_norm = LayerNorm(d, device=device)
        self.output_layer = nn.Linear(d, vocab_size, device=device)

    def make_layer(self, i: int, device=None) -> nn.Module:
        return DecoderLayer(self.cfg, device=device)

    def run(self, ys, tgt_mask, memory, memory_mask):
        """ids (N, L), tgt_mask (N, L, L), memory (N, T, D), memory_mask (N, T) -> logits
        (N, L, V) in memory's dtype."""
        x = add_espnet_pe(embedding(ys, self.embed[0].weight, dtype=memory.dtype))
        for layer in self.decoders:
            x = layer(x, tgt_mask, memory, memory_mask)
        return apply_linear(self.output_layer, self.after_norm(x))

    def forward(self, hs_pad, hlens, ys_in_pad, ys_in_lens):
        """Teacher-forced: causal + padding mask -> (logits, ys_in_lens)."""
        tgt_mask = causal_pad_mask(ys_in_lens, ys_in_pad.shape[1])
        memory_mask = make_pad_mask(hlens, hs_pad.shape[1])
        return self.run(ys_in_pad, tgt_mask, hs_pad, memory_mask), ys_in_lens

    def score_step(self, ys, ys_len, memory, memory_mask):
        """Next-token log-probs (N, V) fp32 for prefixes ``ys`` (N, Lmax) of lengths
        ``ys_len``, the whole prefix recomputed."""
        logits = self.run(ys, causal_pad_mask(ys_len, ys.shape[1]), memory, memory_mask)
        return last_log_probs(logits, ys_len)
