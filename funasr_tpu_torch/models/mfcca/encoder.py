"""MFCCA encoder in PyTorch: the multi-frame cross-channel attention conformer
(counterpart of ``funasr_tpu/models/mfcca/encoder.py``; FunASR
``funasr/models/mfcca/mfcca_encoder.py:104`` + ``encoder_layer_mfcca.py:166``), under
FunASR's state-dict names (``encoders.{i}.norm_mha`` / ``encoder_cros_channel_atten``,
``encoders.{i}.encoder_csa.*``, ``conv1`` .. ``conv4``, ``after_norm``), which the JAX
package's ``convert_mfcca`` reads.

Sequences are (B C, T, D), a channel a row. Every block first lets each frame's channel
vectors attend over a 5-frame window of every channel (``_cca``: queries (B T, C, D), keys
and values (B T, 5 C, D), no mask), then runs a pre-norm conformer layer: legacy
relative-position self attention (the reversed position table's first T rows,
``legacy_rel_pe``; the Transformer-XL shift of ``legacy_rel_shift``), the convolution
module (GLU, the depthwise conv at k 31 through ``core/layers.py::depthwise_conv1d``: the
FSMN kernel's plain mode on CUDA, fp32 k 31 / left 15 its own instantiation; batch norm
in eval mode; swish), the swish FFN (no macaron, no 0.5 factor) and the final norm. After
the blocks the channels are tiled to 8 and fused by four 2-D convs (kernel (5, 7), pads
(2, 3), over (T, D)), as ``F.conv2d``: the JAX package runs them as
``conv_general_dilated``, not as a Pallas kernel. The attention is plain PyTorch, as the
JAX package computes it with einsums.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from funasr_tpu_torch.core.layers import (LayerNorm, apply_linear, batch_norm,
                                          depthwise_conv1d, linear, make_pad_mask,
                                          masked_softmax)
from funasr_tpu_torch.models.conformer.encoder import (ConvolutionModule,
                                                       PositionwiseFeedForwardSwish, swish)
from funasr_tpu_torch.models.transformer.attention import (
    MHAConfig, MultiHeadedAttention, RelPositionMultiHeadedAttention, _heads, mha_apply)
from funasr_tpu_torch.models.transformer.subsampling import Conv2dSubsampling
from funasr_tpu_torch.register import tables


def legacy_rel_pe(t: int, d: int, dtype=torch.float32, device=None, max_len: int = 5000):
    """LegacyRelPositionalEncoding's table slice (ref ``transformer/embedding.py:216``):
    positions max_len - 1 down to max_len - t -> (t, d)."""
    pos = torch.arange(max_len - 1, max_len - 1 - t, -1, dtype=torch.float32,
                       device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / d))
    pe = torch.zeros(t, d, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(dtype)


def legacy_rel_shift(x):
    """ref ``transformer/attention.py:307-327`` (Transformer-XL appendix B)."""
    b, h, t1, t2 = x.shape
    x = F.pad(x, (1, 0)).reshape(b, h, t2 + 1, t1)[:, :, 1:]
    return x.reshape(b, h, t1, t2)


class LegacyRelPositionMultiHeadedAttention(RelPositionMultiHeadedAttention):
    """ref ``attention.py:279-360``: ``linear_pos`` over the (1, T, D) legacy table."""

    def forward(self, x, pos_emb, mask=None):
        return legacy_relpos_mha_apply(self, x, pos_emb, mask)


def legacy_relpos_mha_apply(attn, x, pos_emb, mask=None):
    """x (B, T, D), pos_emb (1, T, D), mask (B, T) bool valid -> (B, T, D)."""
    cfg = attn.cfg
    q = _heads(apply_linear(attn.linear_q, x), cfg.n_head, cfg.d_k)
    k = _heads(apply_linear(attn.linear_k, x), cfg.n_head, cfg.d_k)
    v = _heads(apply_linear(attn.linear_v, x), cfg.n_head, cfg.d_k)
    pk = _heads(apply_linear(attn.linear_pos, pos_emb.to(x.dtype)), cfg.n_head, cfg.d_k)
    q_u = q + attn.pos_bias_u.to(q.dtype)[None, :, None, :]
    q_v = q + attn.pos_bias_v.to(q.dtype)[None, :, None, :]
    ac = torch.matmul(q_u.float(), k.float().transpose(-1, -2))
    bd = torch.matmul(q_v.float(), pk.float().transpose(-1, -2).expand(q.shape[0], -1, -1, -1))
    scores = (ac + legacy_rel_shift(bd)) / math.sqrt(cfg.d_k)
    att = masked_softmax(scores, None if mask is None else mask[:, None, None, :])
    ctx = torch.matmul(att.to(x.dtype), v)
    b, h, t, dk = ctx.shape
    return apply_linear(attn.linear_out, ctx.transpose(1, 2).reshape(b, t, h * dk))


class MFCCAConvModule(ConvolutionModule):
    """The Conformer's convolution module with the encoder's activation."""

    def __init__(self, channels: int, kernel: int, act, device=None):
        super().__init__(channels, kernel, device=device)
        self.act = act

    def forward(self, x):
        h = linear(x, self.pointwise_conv1.weight[:, :, 0], self.pointwise_conv1.bias)
        a, b = h.chunk(2, dim=-1)
        h = a * torch.sigmoid(b)  # GLU
        pad = (self.kernel - 1) // 2
        h = self.act(batch_norm(depthwise_conv1d(h, self.depthwise_conv, pad, pad), self.norm))
        return linear(h, self.pointwise_conv2.weight[:, :, 0], self.pointwise_conv2.bias)


class FFN(PositionwiseFeedForwardSwish):
    """Linear -> the encoder's activation -> Linear (``w_1`` / ``w_2``)."""

    def __init__(self, d: int, units: int, act, device=None):
        super().__init__(d, units, device=device)
        self.act = act

    def forward(self, x):
        return apply_linear(self.w_2, self.act(apply_linear(self.w_1, x)))


class EncoderLayerCSA(nn.Module):
    """The conformer half of a block (FunASR's ``encoder_csa``)."""

    def __init__(self, d: int, heads: int, units: int, rel_attn: bool, use_cnn: bool,
                 kernel: int, act, device=None):
        super().__init__()
        cls = LegacyRelPositionMultiHeadedAttention if rel_attn else MultiHeadedAttention
        self.rel_attn = rel_attn
        self.self_attn = cls(MHAConfig(heads, d), device=device)
        self.norm_mha = LayerNorm(d, device=device)
        self.feed_forward = FFN(d, units, act, device=device)
        self.norm_ff = LayerNorm(d, device=device)
        self.use_cnn = use_cnn
        if use_cnn:
            self.conv_module = MFCCAConvModule(d, kernel, act, device=device)
            self.norm_conv = LayerNorm(d, device=device)
            self.norm_final = LayerNorm(d, device=device)

    def forward(self, x, pos_emb, mask):
        h = self.norm_mha(x)
        if self.rel_attn:
            x = x + legacy_relpos_mha_apply(self.self_attn, h, pos_emb, mask)
        else:
            x = x + mha_apply(self.self_attn, h, h, h, mask)
        if self.use_cnn:
            x = x + self.conv_module(self.norm_conv(x))
        x = x + self.feed_forward(self.norm_ff(x))
        return self.norm_final(x) if self.use_cnn else x


class EncoderLayerMFCCA(nn.Module):
    def __init__(self, d: int, heads: int, units: int, rel_attn: bool, use_cnn: bool,
                 kernel: int, act, device=None):
        super().__init__()
        self.heads = heads
        self.norm_mha = LayerNorm(d, device=device)
        self.encoder_cros_channel_atten = MultiHeadedAttention(MHAConfig(heads, d),
                                                               device=device)
        self.encoder_csa = EncoderLayerCSA(d, heads, units, rel_attn, use_cnn, kernel, act,
                                           device=device)

    def cca(self, x, b: int, channels: int):
        """Multi-frame cross-channel attention (ref ``encoder_layer_mfcca.py:240-266``):
        each frame's channel vectors attend over a 5-frame window of every channel."""
        bc, t, d = x.shape
        xn = self.norm_mha(x).reshape(b, channels, t, d).transpose(1, 2)  # (B, T, C, D)
        xp = F.pad(xn, (0, 0, 0, 0, 2, 2))
        win = torch.stack([xp[:, i:i + t] for i in range(5)], dim=2)  # (B, T, 5, C, D)
        q = xn.reshape(b * t, channels, d)
        kv = win.reshape(b * t, 5 * channels, d)
        att = mha_apply(self.encoder_cros_channel_atten, q, kv, kv)
        att = att.reshape(b, t, channels, d).transpose(1, 2).reshape(bc, t, d)
        return x + att

    def forward(self, x, pos_emb, mask, b: int, channels: int):
        return self.encoder_csa(self.cca(x, b, channels), pos_emb, mask)


@tables.register("encoder_classes", "MFCCAEncoder")
class MFCCAEncoder(nn.Module):
    """ref ``mfcca_encoder.py:104``; the production config: legacy rel-pos self
    attention, no macaron, conv module kernel 31, swish."""

    def __init__(self, input_size: int, output_size: int = 256, attention_heads: int = 4,
                 linear_units: int = 2048, num_blocks: int = 6,
                 input_layer: Optional[str] = "conv2d", normalize_before: bool = True,
                 macaron_style: bool = False, rel_pos_type: str = "legacy",
                 pos_enc_layer_type: str = "rel_pos",
                 selfattention_layer_type: str = "rel_selfattn",
                 activation_type: str = "swish", use_cnn_module: bool = True,
                 cnn_module_kernel: int = 31, dropout_rate: float = 0.0, device=None, **_):
        super().__init__()
        if rel_pos_type == "legacy" and selfattention_layer_type == "rel_selfattn":
            selfattention_layer_type = "legacy_rel_selfattn"
        if selfattention_layer_type not in ("legacy_rel_selfattn", "selfattn"):
            raise NotImplementedError(f"MFCCA self attention {selfattention_layer_type!r}")
        if not normalize_before or macaron_style:
            raise NotImplementedError("MFCCA's production config: pre-norm, no macaron")
        d = output_size
        self._output_size = d
        self.num_blocks = num_blocks
        self.input_layer = input_layer
        self.rel_attn = selfattention_layer_type == "legacy_rel_selfattn"
        act = swish if activation_type == "swish" else torch.relu
        self.encoders = nn.ModuleList([
            EncoderLayerMFCCA(d, attention_heads, linear_units, self.rel_attn, use_cnn_module,
                              cnn_module_kernel, act, device=device)
            for _ in range(num_blocks)])
        self.after_norm = LayerNorm(d, device=device)
        if input_layer == "conv2d":
            self.embed = Conv2dSubsampling(input_size, d, device=device)
        elif input_layer == "linear":
            self.embed = nn.Sequential(nn.Linear(input_size, d, device=device),
                                       LayerNorm(d, device=device))
        # the channel-fusion stack (ref mfcca_encoder.py:339-345): 8 -> 16 -> 32 -> 16 -> 1
        for name, (ci, co) in {"conv1": (8, 16), "conv2": (16, 32), "conv3": (32, 16),
                               "conv4": (16, 1)}.items():
            setattr(self, name, nn.Conv2d(ci, co, (5, 7), padding=(2, 3), device=device))

    def output_size(self) -> int:
        return self._output_size

    def forward(self, xs_pad, ilens, generator=None, channel_size: int = 1):
        """xs_pad (B C, T, F) per-channel features -> fused ((B, T', D), (B,) lengths)."""
        d = self._output_size
        if self.input_layer == "conv2d":
            x, olens = self.embed(xs_pad, ilens, add_pe=False)
        elif self.input_layer == "linear":
            x, olens = self.embed[1](apply_linear(self.embed[0], xs_pad)), ilens
        else:
            x, olens = xs_pad, ilens
        x = x * math.sqrt(d)
        t = x.shape[1]
        pos_emb = legacy_rel_pe(t, d, x.dtype, x.device)[None] if self.rel_attn else None
        mask = make_pad_mask(olens, t)
        b = x.shape[0] // channel_size
        for layer in self.encoders:
            x = layer(x, pos_emb, mask, b, channel_size)
        # channel fusion (ref mfcca_encoder.py:389-404): tiled to 8 channels, 2-D convs
        # over (T, D)
        h = x.reshape(b, channel_size, t, d)
        if channel_size < 8:
            h = h.repeat(1, -(-8 // channel_size), 1, 1)[:, :8]
        for name in ("conv1", "conv2", "conv3", "conv4"):
            conv = getattr(self, name)
            h = F.conv2d(h, conv.weight.to(h.dtype), padding=(2, 3)) + conv.bias.to(
                h.dtype)[:, None, None]
        x = self.after_norm(h[:, 0])
        return x, olens.reshape(b, channel_size)[:, 0]
