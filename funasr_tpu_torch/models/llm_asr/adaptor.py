"""Audio -> LLM adaptors in PyTorch (counterpart of ``funasr_tpu/models/llm_asr/adaptor.py``;
FunASR ``funasr/models/llm_asr/adaptor.py``: ``Linear:10`` stacks k frames and projects
them to the LLM's width through a ReLU MLP; ``Transformer:126`` adds self-attention
blocks after it; ``QFormer:49`` is a bank of learned queries cross-attending the
encoder's output). Parameter names are FunASR's (``linear1``, ``linear2``,
``blocks.N.{norm1, self_attn.linear_q, feed_forward.w_1, ...}``); the attention is
``models/transformer/attention.py``'s, plain PyTorch as in JAX (einsums outside any Pallas
kernel).
"""

from __future__ import annotations

import torch
from torch import nn

from funasr_tpu_torch.core.layers import (LayerNorm, PositionwiseFeedForward, apply_linear,
                                          make_pad_mask)
from funasr_tpu_torch.core.module import init_weights
from funasr_tpu_torch.models.transformer.attention import MHAConfig, MultiHeadedAttention
from funasr_tpu_torch.register import tables


@tables.register("adaptor_classes", "Linear")
class LinearAdaptor(nn.Module):
    def __init__(self, downsample_rate: int = 2, encoder_dim: int = 512, llm_dim: int = 1024,
                 ffn_dim: int = 2048, device=None, **kwargs):
        super().__init__()
        self.k = downsample_rate
        self.encoder_dim, self.llm_dim, self.ffn_dim = encoder_dim, llm_dim, ffn_dim
        self.linear1 = nn.Linear(encoder_dim * self.k, ffn_dim, device=device)
        self.linear2 = nn.Linear(ffn_dim, llm_dim, device=device)

    def audio_token_len(self, fbank_len: int) -> int:
        """LLM token slots one audio span takes (reference ``llm_asr/model.py:778-786``)."""
        return max(int(fbank_len) // self.k, 1)

    def forward(self, x, lengths=None):
        """x (B, T, enc) -> ((B, T // k, llm_dim), lengths // k); trailing frames
        dropped."""
        b, t, d = x.shape
        t_keep = (t // self.k) * self.k
        x = x[:, :t_keep].reshape(b, t_keep // self.k, d * self.k)
        h = torch.relu(apply_linear(self.linear1, x))
        out = apply_linear(self.linear2, h)
        return out, (None if lengths is None else lengths // self.k)


class TransformerBlock(nn.Module):
    """Pre-norm self-attention + FFN block (FunASR's ``EncoderLayer`` names: ``norm1``,
    ``self_attn``, ``norm2``, ``feed_forward``; JAX ``transformer/encoder.py::
    _layer_apply``)."""

    def __init__(self, dim: int, heads: int, ffn_dim: int, device=None):
        super().__init__()
        self.norm1 = LayerNorm(dim, device=device)
        self.self_attn = MultiHeadedAttention(MHAConfig(heads, dim), device=device)
        self.norm2 = LayerNorm(dim, device=device)
        self.feed_forward = PositionwiseFeedForward(dim, ffn_dim, device=device)

    def forward(self, x, mask):
        h = self.norm1(x)
        x = x + self.self_attn(h, h, h, mask[:, None, :])
        return x + self.feed_forward(self.norm2(x))


@tables.register("adaptor_classes", "Transformer")
class TransformerAdaptor(LinearAdaptor):
    """The Linear adaptor + ``n_layer`` self-attention blocks (reference ``adaptor.py:126``)."""

    def __init__(self, *args, n_layer: int = 2, attention_heads: int = 8, device=None,
                 **kwargs):
        super().__init__(*args, device=device, **kwargs)
        self.n_layer, self.attention_heads = n_layer, attention_heads
        self.blocks = nn.ModuleList([
            TransformerBlock(self.llm_dim, attention_heads, self.ffn_dim, device)
            for _ in range(n_layer)])

    def forward(self, x, lengths=None):
        out, out_lens = super().forward(x, lengths)
        lens = (out_lens if out_lens is not None
                else torch.full((out.shape[0],), out.shape[1], device=out.device))
        mask = make_pad_mask(lens, out.shape[1])
        for block in self.blocks:
            out = block(out, mask)
        return out, out_lens


class QFormerLayer(nn.Module):
    def __init__(self, dim: int, heads: int, ffn_dim: int, device=None):
        super().__init__()
        self.norm1 = LayerNorm(dim, device=device)
        self.self_attn = MultiHeadedAttention(MHAConfig(heads, dim), device=device)
        self.norm2 = LayerNorm(dim, device=device)
        self.cross_attn = MultiHeadedAttention(MHAConfig(heads, dim), device=device)
        self.norm3 = LayerNorm(dim, device=device)
        self.ffn = PositionwiseFeedForward(dim, ffn_dim, device=device)


@tables.register("adaptor_classes", "QFormer")
class QFormerAdaptor(nn.Module):
    """BLIP-2-style query former (reference ``adaptor.py:49``): ``query_tokens`` learned
    queries go through ``n_layer`` (self-attention, cross-attention to the encoder's
    output, FFN) blocks, then ``proj`` to the LLM's width; every utterance gives the same
    number of audio tokens."""

    def __init__(self, encoder_dim: int = 512, llm_dim: int = 1024, query_tokens: int = 64,
                 n_layer: int = 2, attention_heads: int = 8, ffn_dim: int = 2048, device=None,
                 **kwargs):
        super().__init__()
        self.encoder_dim, self.llm_dim, self.n_query = encoder_dim, llm_dim, query_tokens
        self.queries = nn.Parameter(torch.zeros(query_tokens, encoder_dim, device=device))
        self.layers = nn.ModuleList([QFormerLayer(encoder_dim, attention_heads, ffn_dim, device)
                                     for _ in range(n_layer)])
        self.proj = nn.Linear(encoder_dim, llm_dim, device=device)

    def audio_token_len(self, fbank_len: int) -> int:
        return self.n_query

    def forward(self, x, lengths=None):
        b = x.shape[0]
        q = self.queries[None].expand(b, -1, -1).to(x.dtype)
        mem_mask = None if lengths is None else make_pad_mask(lengths, x.shape[1])[:, None, :]
        for lp in self.layers:
            h = lp.norm1(q)
            q = q + lp.self_attn(h, h, h, None)
            h = lp.norm2(q)
            q = q + lp.cross_attn(h, x, x, mem_mask)
            q = q + lp.ffn(lp.norm3(q))
        out = apply_linear(self.proj, q)
        return out, torch.full((b,), self.n_query, dtype=torch.int32, device=x.device)


def init_adaptor(adaptor: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded weights (``init_weights``' rules; QFormer's queries normal * 0.02, as the
    JAX ``init``)."""
    init_weights(adaptor, generator)
    if isinstance(adaptor, QFormerAdaptor):
        with torch.no_grad():
            q = adaptor.queries
            q.copy_(torch.randn(q.shape, device=generator.device, generator=generator) * 0.02)
    return adaptor
