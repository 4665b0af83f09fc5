"""SAN-M attention in PyTorch (counterpart of ``funasr_tpu/models/sanm/attention.py``).

Three modules with FunASR's parameter names (``funasr/models/sanm/attention.py``):

* ``MultiHeadedAttentionSANM``: fused q|k|v projection, scaled-dot attention over heads
  and an FSMN depthwise-conv memory over the pre-split V, summed;
* ``MultiHeadedAttentionSANMDecoder``: the NAR decoder's FSMN-only "self attention";
* ``MultiHeadedAttentionCrossAtt``: cross attention with a fused k|v projection.

The ``*_apply`` functions hold the math (as in the JAX package, with the module in the
params role); each module's ``forward`` calls its function.

Kernels: every FSMN memory runs through ``ops/fsmn.py`` (a hand-written CUDA kernel on
the card) and encoder self-attention through ``ops/flash_attention.py``, at every T:
the JAX package's 1024-frame threshold for its flash route (``attention.py:79``) was
measured on a TPU. Flash keeps fp32 scores, where the JAX einsum route rounds them to
x's dtype before its fp32 softmax (``attention.py:127``); the two agree in fp32.
Decoder cross-attention (16 heads of 32 at Paraformer-large width) stays matmul +
softmax, as in the JAX package. The ``attn_mask`` argument (used by the streaming
punctuation model) and the chunked streaming variants come with later slices.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from funasr_tpu_torch.core.layers import apply_linear, masked_softmax
from funasr_tpu_torch.ops.flash_attention import flash_attention
from funasr_tpu_torch.ops.fsmn import fsmn_memory


def _fsmn_pads(kernel_size: int, sanm_shift: int):
    left = (kernel_size - 1) // 2
    if sanm_shift > 0:
        left += sanm_shift
    return left, kernel_size - 1 - left


class SANMAttentionConfig(NamedTuple):
    n_head: int
    in_feat: int
    n_feat: int
    kernel_size: int = 11
    sanm_shift: int = 0

    @property
    def d_k(self) -> int:
        return self.n_feat // self.n_head

    @property
    def fsmn_pads(self):
        return _fsmn_pads(self.kernel_size, self.sanm_shift)


class FSMNDecoderConfig(NamedTuple):
    n_feat: int
    kernel_size: int = 11
    sanm_shift: int = 0

    @property
    def fsmn_pads(self):
        return _fsmn_pads(self.kernel_size, self.sanm_shift)


class CrossAttentionConfig(NamedTuple):
    n_head: int
    n_feat: int
    encoder_output_size: Optional[int] = None

    @property
    def d_k(self) -> int:
        return self.n_feat // self.n_head

    @property
    def kv_in(self) -> int:
        return self.encoder_output_size or self.n_feat


def _depthwise_conv(channels: int, kernel_size: int, device=None):
    """torch's depthwise Conv1d: weight (C, 1, k), the layout of FunASR's ``fsmn_block``."""
    return nn.Conv1d(channels, channels, kernel_size, groups=channels, bias=False,
                     device=device)


def _split_heads(x, n_head, d_k):
    b, t, _ = x.shape
    return x.reshape(b, t, n_head, d_k).transpose(1, 2)  # (B, H, T, dk), a view


def _merge_heads(x):
    b, h, t, dk = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dk)


class MultiHeadedAttentionSANM(nn.Module):
    def __init__(self, cfg: SANMAttentionConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.linear_out = nn.Linear(cfg.n_feat, cfg.n_feat, device=device)
        self.linear_q_k_v = nn.Linear(cfg.in_feat, cfg.n_feat * 3, device=device)
        self.fsmn_block = _depthwise_conv(cfg.n_feat, cfg.kernel_size, device)

    def forward(self, x, mask, lengths):
        return sanm_attention_apply(self, x, mask, lengths)


class MultiHeadedAttentionSANMDecoder(nn.Module):
    def __init__(self, cfg: FSMNDecoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.fsmn_block = _depthwise_conv(cfg.n_feat, cfg.kernel_size, device)

    def forward(self, x, mask):
        return fsmn_decoder_apply(self, x, mask)


class MultiHeadedAttentionCrossAtt(nn.Module):
    def __init__(self, cfg: CrossAttentionConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.linear_q = nn.Linear(cfg.n_feat, cfg.n_feat, device=device)
        self.linear_k_v = nn.Linear(cfg.kv_in, cfg.n_feat * 2, device=device)
        self.linear_out = nn.Linear(cfg.n_feat, cfg.n_feat, device=device)

    def forward(self, x, memory, memory_mask):
        return cross_attention_apply(self, x, memory, memory_mask)


def sanm_attention_apply(attn: MultiHeadedAttentionSANM, x, mask, lengths):
    """x: (B, T, in_feat); mask: (B, T) bool valid-mask or None; lengths: (B,) valid
    key counts -> (B, T, n_feat)."""
    cfg = attn.cfg
    qkv = apply_linear(attn.linear_q_k_v, x)
    q, k, v = torch.split(qkv, cfg.n_feat, dim=-1)
    left, right = cfg.fsmn_pads
    fsmn = fsmn_memory(v, attn.fsmn_block.weight, mask, left, right)

    q_h = _split_heads(q, cfg.n_head, cfg.d_k)
    k_h = _split_heads(k, cfg.n_head, cfg.d_k)
    v_h = _split_heads(v, cfg.n_head, cfg.d_k)
    ctx = flash_attention(q_h, k_h, v_h, lengths)
    att_out = apply_linear(attn.linear_out, _merge_heads(ctx))
    return att_out + fsmn


def fsmn_decoder_apply(attn: MultiHeadedAttentionSANMDecoder, x, mask):
    """FSMN-only 'self attention' of the NAR decoder. x: (B, T, C)."""
    left, right = attn.cfg.fsmn_pads
    return fsmn_memory(x, attn.fsmn_block.weight, mask, left, right)


def cross_attention_apply(attn: MultiHeadedAttentionCrossAtt, x, memory, memory_mask,
                          ret_attn: bool = False):
    """x: (B, Tq, n_feat); memory: (B, Tk, enc); memory_mask: (B, Tk) bool or None.
    ``ret_attn`` also returns the masked-softmax probabilities (B, H, Tq, Tk), in x's
    dtype (the SeACo decoder's attention-score filter reads them)."""
    cfg = attn.cfg
    q = apply_linear(attn.linear_q, x)
    kv = apply_linear(attn.linear_k_v, memory.to(x.dtype))
    k, v = torch.split(kv, cfg.n_feat, dim=-1)
    q_h = _split_heads(q, cfg.n_head, cfg.d_k) * (cfg.d_k ** -0.5)
    k_h = _split_heads(k, cfg.n_head, cfg.d_k)
    v_h = _split_heads(v, cfg.n_head, cfg.d_k)
    scores = torch.matmul(q_h, k_h.transpose(-1, -2))
    mask = None if memory_mask is None else memory_mask[:, None, None, :]
    probs = masked_softmax(scores, mask)
    out = apply_linear(attn.linear_out, _merge_heads(torch.matmul(probs, v_h)))
    return (out, probs) if ret_attn else out
