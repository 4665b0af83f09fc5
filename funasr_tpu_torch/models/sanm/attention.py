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
softmax, as in the JAX package. The JAX ``attn_mask`` of the streaming punctuation
encoder (a causal or "VAD corner" query-key mask beside the pad mask) is the flash
kernel's per-row key limit here (``mode`` / ``vad_pos``).

Streaming (``attention.py:134-262``): ``sanm_attention_apply_chunk`` attends a chunk's
queries over [cached K/V | chunk] on the flash kernel (Tq < Tk) and keeps the keys up to
the stride boundary, trimmed to the look-back; ``cross_attention_apply_chunk`` is the
decoder's cross-attention over [cached | this chunk's] memory (matmul + softmax);
``fsmn_decoder_apply_masked`` runs the decoder's FSMN as a causal k-tap conv over
concat(cache, x) on the FSMN kernel (pads (k - 1, 0)) and rolls in the last k - 1 valid
rows by a gather at the device tensor ``n``, so no host wait is needed for the fired
count.
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

    def forward(self, x, mask, lengths, mode: str = "none", vad_pos=None):
        return sanm_attention_apply(self, x, mask, lengths, mode, vad_pos)


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


def sanm_attention_apply(attn: MultiHeadedAttentionSANM, x, mask, lengths,
                         mode: str = "none", vad_pos=None):
    """x: (B, T, in_feat); mask: (B, T) bool valid-mask or None; lengths: (B,) valid
    key counts -> (B, T, n_feat). ``mode`` / ``vad_pos``: the query rows' key limits
    (``ops/flash_attention.py::key_limits``); the FSMN branch keeps the pad mask."""
    cfg = attn.cfg
    qkv = apply_linear(attn.linear_q_k_v, x)
    q, k, v = torch.split(qkv, cfg.n_feat, dim=-1)
    left, right = cfg.fsmn_pads
    fsmn = fsmn_memory(v, attn.fsmn_block.weight, mask, left, right)

    q_h = _split_heads(q, cfg.n_head, cfg.d_k)
    k_h = _split_heads(k, cfg.n_head, cfg.d_k)
    v_h = _split_heads(v, cfg.n_head, cfg.d_k)
    ctx = flash_attention(q_h, k_h, v_h, lengths, mode, vad_pos)
    att_out = apply_linear(attn.linear_out, _merge_heads(ctx))
    return att_out + fsmn


def sanm_attention_apply_chunk(attn: MultiHeadedAttentionSANM, x, kv_cache, lengths,
                               chunk_size=None, look_back: int = 0):
    """One streaming chunk (``attention.py:134-170``): x (B, T, in_feat) attends over
    [cached K/V | chunk] with no mask; ``lengths`` (B,) holds that key count, Tk.
    ``kv_cache``: None or {"k", "v"} (B, H, Tc, dk). With a look-back (> 0, or -1 for
    unbounded) the new cache is [cache | chunk keys up to the stride boundary] (the
    ``chunk_size[2]`` look-ahead rows dropped, they come again next chunk), trimmed to
    the last ``look_back * chunk_size[1]`` keys; at look-back 0 it is ``kv_cache``.
    Returns ((B, T, n_feat), new cache)."""
    cfg = attn.cfg
    qkv = apply_linear(attn.linear_q_k_v, x)
    q, k, v = torch.split(qkv, cfg.n_feat, dim=-1)
    left, right = cfg.fsmn_pads
    fsmn = fsmn_memory(v, attn.fsmn_block.weight, None, left, right)

    q_h = _split_heads(q, cfg.n_head, cfg.d_k)
    k_h = _split_heads(k, cfg.n_head, cfg.d_k)
    v_h = _split_heads(v, cfg.n_head, cfg.d_k)
    new_cache = kv_cache
    if chunk_size is not None and (look_back > 0 or look_back == -1):
        if kv_cache is not None:
            k_h = torch.cat([kv_cache["k"], k_h], dim=2)
            v_h = torch.cat([kv_cache["v"], v_h], dim=2)
        keep = k_h.shape[2] - chunk_size[2]
        start = 0 if look_back == -1 else max(keep - look_back * chunk_size[1], 0)
        new_cache = {"k": k_h[:, :, start:keep], "v": v_h[:, :, start:keep]}
    ctx = flash_attention(q_h, k_h, v_h, lengths)
    att_out = apply_linear(attn.linear_out, _merge_heads(ctx))
    return att_out + fsmn, new_cache


def fsmn_decoder_apply(attn: MultiHeadedAttentionSANMDecoder, x, mask):
    """FSMN-only 'self attention' of the NAR decoder. x: (B, T, C)."""
    left, right = attn.cfg.fsmn_pads
    return fsmn_memory(x, attn.fsmn_block.weight, mask, left, right)


def fsmn_decoder_apply_masked(attn: MultiHeadedAttentionSANMDecoder, x, cache, cache_index):
    """The streaming decoder's FSMN step over a padded token chunk (``attention.py:
    242-262``): x (B, tmax, C) of which the first n rows are valid, ``cache`` (B, k - 1,
    C) the last k - 1 valid rows before them. The k-tap conv over buf = concat(cache, x)
    is causal, so the rows below n never see the padding: the FSMN kernel runs it with
    pads (k - 1, 0) and the last tmax rows are kept. The new cache is buf[n : n + k - 1],
    gathered at ``cache_index`` = n + arange(k - 1) (a device tensor: the fired count
    never comes to the host). Returns ((B, tmax, C), new cache)."""
    k = attn.cfg.kernel_size
    buf = torch.cat([cache, x], dim=1)
    out = fsmn_memory(buf, attn.fsmn_block.weight, None, k - 1, 0)[:, k - 1:]
    new_cache = buf.index_select(1, cache_index) if k > 1 else cache
    return out, new_cache


def cross_attention_apply(attn: MultiHeadedAttentionCrossAtt, x, memory, memory_mask,
                          ret_attn: bool = False):
    """x: (B, Tq, n_feat); memory: (B, Tk, enc); memory_mask: (B, Tk) bool or None.
    ``ret_attn`` also returns the masked-softmax probabilities (B, H, Tq, Tk), in x's
    dtype (the SeACo decoder's attention-score filter reads them)."""
    q_h, k_h, v_h = _cross_heads(attn, x, memory)
    mask = None if memory_mask is None else memory_mask[:, None, None, :]
    out, probs = _cross_context(attn, q_h, k_h, v_h, mask)
    return (out, probs) if ret_attn else out


def _cross_heads(attn: MultiHeadedAttentionCrossAtt, x, memory):
    """Scaled query heads and key / value heads, each (B, H, T, dk)."""
    cfg = attn.cfg
    q = apply_linear(attn.linear_q, x)
    kv = apply_linear(attn.linear_k_v, memory.to(x.dtype))
    k, v = torch.split(kv, cfg.n_feat, dim=-1)
    return (_split_heads(q, cfg.n_head, cfg.d_k) * (cfg.d_k ** -0.5),
            _split_heads(k, cfg.n_head, cfg.d_k), _split_heads(v, cfg.n_head, cfg.d_k))


def _cross_context(attn: MultiHeadedAttentionCrossAtt, q_h, k_h, v_h, mask):
    scores = torch.matmul(q_h, k_h.transpose(-1, -2))
    probs = masked_softmax(scores, mask)
    return apply_linear(attn.linear_out, _merge_heads(torch.matmul(probs, v_h))), probs


def cross_attention_apply_chunk(attn: MultiHeadedAttentionCrossAtt, x, memory, kv_cache,
                                chunk_size=None, look_back: int = 0):
    """The streaming decoder's cross-attention (``attention.py:173-195``): keys and values
    from this chunk's memory, after the cached ones when ``look_back`` > 0; the new cache
    is their last ``look_back * chunk_size[1]`` rows (at look-back <= 0 it is
    ``kv_cache``). Returns ((B, Tq, n_feat), new cache)."""
    q_h, k_h, v_h = _cross_heads(attn, x, memory)
    new_cache = kv_cache
    if chunk_size is not None and look_back > 0:
        if kv_cache is not None:
            k_h = torch.cat([kv_cache["k"], k_h], dim=2)
            v_h = torch.cat([kv_cache["v"], v_h], dim=2)
        start = max(k_h.shape[2] - look_back * chunk_size[1], 0)
        new_cache = {"k": k_h[:, :, start:], "v": v_h[:, :, start:]}
    return _cross_context(attn, q_h, k_h, v_h, None)[0], new_cache
