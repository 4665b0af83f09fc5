"""Lightweight / dynamic convolution Transformer decoders in PyTorch (counterpart of
``funasr_tpu/models/transformer/conv_decoders.py``; FunASR
``funasr/models/transformer/decoder.py:461-775`` and ``transformer/utils/{lightconv,
lightconv2d,dynamic_conv,dynamic_conv2d}.py``): the decoder's self-attention is replaced by

- a lightweight conv: GLU(linear1(x)) -> a causal depthwise conv whose k taps are shared
  by C / wshare channel groups and softmax-normalised -> linear2;
- a dynamic conv: the same, with per-position taps made from the GLU output by
  ``linear_weight``, softmaxed over the taps (out-of-range and future taps at -inf);
- the "2D" variants first convolve along the feature axis with a second shared kernel
  (``weight_f`` / ``linear_weight_f``).

Cross-attention and the FFN stay standard. Plain PyTorch, k shifted multiply-adds as in
the JAX package, which computes these shared-kernel convolutions outside any Pallas
kernel. Each layer's kernel length may differ (``conv_kernel_length``), so the JAX
package keeps the layers as a plain list, not a scan stack.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from funasr_tpu_torch.core.layers import LayerNorm, PositionwiseFeedForward, apply_linear
from funasr_tpu_torch.models.transformer.attention import MultiHeadedAttention, mha_apply
from funasr_tpu_torch.models.transformer.decoder import TransformerDecoder
from funasr_tpu_torch.register import tables


def _glu(x):
    a, b = x.chunk(2, dim=-1)
    return a * torch.sigmoid(b)


def _shared_kernel_conv(x, w):
    """x (B, T, C); w (H, k) softmaxed taps; channel c uses head c % H; tap i reads
    position t + i - k // 2."""
    b, t, c = x.shape
    h, k = w.shape
    pad = k // 2
    xpad = F.pad(x, (0, 0, pad, pad))
    w_full = w.T.repeat(1, c // h)  # (k, C)
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xpad[:, i:i + t, :] * w_full[i][None, None, :]
    return out


def _softmax_taps(weight, k: int, causal: bool):
    """(H, k) raw taps -> softmax over the taps, future taps (i > k // 2) masked."""
    if causal:
        taps = torch.arange(k, device=weight.device)
        weight = torch.where((taps <= k // 2)[None, :], weight, float("-inf"))
    return torch.softmax(weight.float(), dim=-1)


class LightweightConvolution(nn.Module):
    def __init__(self, dim: int, wshare: int, kernel: int, freq_conv: bool, device=None):
        super().__init__()
        self.kernel = kernel
        self.linear1 = nn.Linear(dim, dim * 2, device=device)
        self.linear2 = nn.Linear(dim, dim, device=device)
        self.weight = nn.Parameter(torch.rand(wshare, kernel, device=device))
        if freq_conv:
            self.weight_f = nn.Parameter(torch.rand(wshare, kernel, device=device))

    def init_from(self, generator):
        """Shared taps ~ U[0, 1), as ``lightweight_conv_init`` draws them."""
        for p in (self.weight, getattr(self, "weight_f", None)):
            if p is not None:
                with torch.no_grad():
                    p.copy_(torch.rand(p.shape, device=generator.device, generator=generator))

    def forward(self, x, causal: bool = True):
        h = _glu(apply_linear(self.linear1, x))
        if hasattr(self, "weight_f"):
            b, t, c = h.shape
            hh, k = self.weight_f.shape
            wf = torch.softmax(self.weight_f.float(), dim=-1)
            pad_f = k // 2
            hpad_f = F.pad(h, (pad_f, pad_f))
            head = torch.arange(c, device=h.device) // (c // hh)
            acc = torch.zeros_like(h)
            for i in range(k):
                acc = acc + hpad_f[:, :, i:i + c] * wf[head, i].to(h.dtype)
            h = acc
        out = _shared_kernel_conv(h, _softmax_taps(self.weight, self.kernel, causal))
        return apply_linear(self.linear2, out)


class DynamicConvolution(nn.Module):
    def __init__(self, dim: int, wshare: int, kernel: int, freq_conv: bool, device=None):
        super().__init__()
        self.wshare, self.kernel = wshare, kernel
        self.linear1 = nn.Linear(dim, dim * 2, device=device)
        self.linear2 = nn.Linear(dim, dim, device=device)
        self.linear_weight = nn.Linear(dim, wshare * kernel, device=device)
        if freq_conv:
            self.linear_weight_f = nn.Linear(dim, wshare * kernel, device=device)

    def forward(self, x, causal: bool = True):
        b, t, c = x.shape
        wshare, kernel = self.wshare, self.kernel
        group = c // wshare
        pad = kernel // 2
        h = _glu(apply_linear(self.linear1, x))
        if hasattr(self, "linear_weight_f"):
            wf = torch.softmax(apply_linear(self.linear_weight_f, h)
                               .reshape(b, t, wshare, kernel).float(), dim=-1)
            hpad_f = F.pad(h, (pad, pad))
            acc = torch.zeros_like(h)
            head = torch.arange(c, device=h.device) // group
            for i in range(kernel):
                acc = acc + hpad_f[:, :, i:i + c] * wf[:, :, head, i].to(h.dtype)
            h = acc
        # per-position taps from the GLU output; a tap outside the sequence, or in the
        # future under the causal mask, gets -inf before the softmax
        w = apply_linear(self.linear_weight, h).reshape(b, t, wshare, kernel)
        taps = torch.arange(kernel, device=x.device)[None, None, None, :]
        t_idx = torch.arange(t, device=x.device)[None, :, None, None]
        valid = (t_idx + taps - pad) >= 0
        if causal:
            valid = valid & (taps <= pad)
        w = torch.softmax(torch.where(valid, w, float("-inf")).float(), dim=-1)
        hg = F.pad(h, (0, 0, pad, pad)).reshape(b, t + 2 * pad, wshare, group)
        out = torch.zeros((b, t, wshare, group), dtype=h.dtype, device=h.device)
        for i in range(kernel):
            out = out + hg[:, i:i + t] * w[..., i][..., None].to(h.dtype)
        return apply_linear(self.linear2, out.reshape(b, t, c))


class ConvDecoderLayer(nn.Module):
    def __init__(self, cfg, conv_cls, wshare: int, kernel: int, freq: bool, device=None):
        super().__init__()
        self.norm1 = LayerNorm(cfg.dim, device=device)
        self.norm2 = LayerNorm(cfg.dim, device=device)
        self.norm3 = LayerNorm(cfg.dim, device=device)
        self.self_attn = conv_cls(cfg.dim, wshare, kernel, freq, device=device)
        self.src_attn = MultiHeadedAttention(cfg.mha, device=device)
        self.feed_forward = PositionwiseFeedForward(cfg.dim, cfg.linear_units, device=device)

    def forward(self, x, tgt_mask, memory, memory_mask):
        h = self.self_attn(self.norm1(x))
        if tgt_mask is not None:
            h = h * tgt_mask[:, -1, :, None].to(h.dtype)
        x = x + h
        h = self.norm2(x)
        x = x + mha_apply(self.src_attn, h, memory, memory, memory_mask[:, None, :])
        return x + self.feed_forward(self.norm3(x))


class _ConvTransformerDecoder(TransformerDecoder):
    """The TransformerDecoder with each layer's self-attention a convolution (FunASR
    names ``decoders.{i}.self_attn``, the JAX package's ``self_conv``)."""

    CONV = LightweightConvolution
    FREQ = False
    #: the JAX package keeps these layers as a list (each its own kernel length), not a
    #: scan stack, so int8 quantization treats them as single layers
    SCAN_STACKED = False

    def __init__(self, vocab_size: int, encoder_output_size: int, attention_heads: int = 4,
                 linear_units: int = 2048, num_blocks: int = 6, conv_wshare: int = 4,
                 conv_kernel_length=(11, 11, 11, 11, 11, 11), device=None, **kwargs):
        ks = conv_kernel_length
        kernels = [ks] * num_blocks if isinstance(ks, int) else list(ks)[:num_blocks]
        while len(kernels) < num_blocks:
            kernels.append(kernels[-1])
        self.wshare, self.kernels = conv_wshare, kernels
        super().__init__(vocab_size, encoder_output_size, attention_heads, linear_units,
                         num_blocks, device=device, **kwargs)

    def make_layer(self, i: int, device=None) -> nn.Module:
        return ConvDecoderLayer(self.cfg, self.CONV, self.wshare, self.kernels[i], self.FREQ,
                                device=device)


@tables.register("decoder_classes", "LightweightConvolutionTransformerDecoder")
class LightweightConvolutionTransformerDecoder(_ConvTransformerDecoder):
    CONV, FREQ = LightweightConvolution, False


@tables.register("decoder_classes", "LightweightConvolution2DTransformerDecoder")
class LightweightConvolution2DTransformerDecoder(_ConvTransformerDecoder):
    CONV, FREQ = LightweightConvolution, True


@tables.register("decoder_classes", "DynamicConvolutionTransformerDecoder")
class DynamicConvolutionTransformerDecoder(_ConvTransformerDecoder):
    CONV, FREQ = DynamicConvolution, False


@tables.register("decoder_classes", "DynamicConvolution2DTransformerDecoder")
class DynamicConvolution2DTransformerDecoder(_ConvTransformerDecoder):
    CONV, FREQ = DynamicConvolution, True
