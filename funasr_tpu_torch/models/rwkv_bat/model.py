"""RWKV encoder and the BAT family in PyTorch (counterpart of
``funasr_tpu/models/rwkv_bat/model.py``; FunASR ``funasr/models/rwkv_bat/`` and
``funasr/models/bat/``).

``RWKVEncoder`` (``model.py:23-118``): an input linear, blocks of time mixing (the WKV
recurrence, a linear attention) and channel mixing, a final norm, the output zeroed past
each length. The WKV recurrence (``_wkv_scan``, ``:47-73``) is a T-step loop in fp32 in
the same max-shifted form: the state (num, den, max exponent) starts at (0, 0, -1e30) and
the output divides by max(den, 1e-9). The JAX package runs it as a ``lax.scan``; no
Pallas kernel exists for it, so the port has none.

``BAT`` / ``RWKVBAT`` (``:121-131``) is the Transducer over ``RWKVEncoder`` (the band
restriction of the lattice around predicted boundaries is the full RNN-T loss, the JAX
package's exact superset), ``ConformerRWKV`` (``:134-137``) the Transformer AED over it.
The parameters keep the JAX layout's names under FunASR's model prefixes:
``encoder.embed``, ``encoder.blocks.{i}.{ln1, time_decay, time_first, r_proj, k_proj,
v_proj, o_proj, ln2, ffn_k, ffn_r, ffn_v}``, ``encoder.after_norm``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from funasr_tpu_torch.core.layers import LayerNorm, apply_linear, make_pad_mask
from funasr_tpu_torch.models.transducer.model import Transducer
from funasr_tpu_torch.models.transformer.model import Transformer
from funasr_tpu_torch.register import tables


class RWKVConfig(NamedTuple):
    input_size: int
    output_size: int = 256
    num_blocks: int = 6
    ffn_mult: int = 4


def wkv_scan(w, u, k, v):
    """The WKV recurrence over time (``_wkv_scan``): k, v (B, T, D) fp32, w (decay) and u
    (bonus) (D,) -> (B, T, D) fp32."""
    decay = -torch.exp(w.float())
    u = u.float()
    b, t, d = k.shape
    num = torch.zeros(b, d, device=k.device)
    den = torch.zeros(b, d, device=k.device)
    m = torch.full((b, d), -1e30, device=k.device)
    ys = []
    for i in range(t):
        k_t, v_t = k[:, i], v[:, i]
        mo = torch.maximum(m, u + k_t)
        out_num = num * torch.exp(m - mo) + torch.exp(u + k_t - mo) * v_t
        out_den = den * torch.exp(m - mo) + torch.exp(u + k_t - mo)
        ys.append(out_num / torch.clamp(out_den, min=1e-9))
        m2 = torch.maximum(m + decay, k_t)
        num = num * torch.exp(m + decay - m2) + torch.exp(k_t - m2) * v_t
        den = den * torch.exp(m + decay - m2) + torch.exp(k_t - m2)
        m = m2
    return torch.stack(ys, dim=1)


class RWKVBlock(nn.Module):
    def __init__(self, d: int, ffn: int, device=None):
        super().__init__()
        self.ln1 = LayerNorm(d, device=device)
        self.time_decay = nn.Parameter(torch.zeros(d, device=device))
        self.time_first = nn.Parameter(torch.zeros(d, device=device))
        self.r_proj, self.k_proj, self.v_proj, self.o_proj = (
            nn.Linear(d, d, bias=False, device=device) for _ in range(4))
        self.ln2 = LayerNorm(d, device=device)
        self.ffn_k = nn.Linear(d, ffn, bias=False, device=device)
        self.ffn_r = nn.Linear(d, d, bias=False, device=device)
        self.ffn_v = nn.Linear(ffn, d, bias=False, device=device)

    def forward(self, x):
        """``_rwkv_block_apply`` (``model.py:76-87``)."""
        h = self.ln1(x)
        r = torch.sigmoid(apply_linear(self.r_proj, h))
        k = apply_linear(self.k_proj, h).float()
        v = apply_linear(self.v_proj, h).float()
        wkv = wkv_scan(self.time_decay, self.time_first, k, v).to(x.dtype)
        x = x + apply_linear(self.o_proj, r * wkv)
        h = self.ln2(x)
        kf = torch.square(torch.relu(apply_linear(self.ffn_k, h)))
        rf = torch.sigmoid(apply_linear(self.ffn_r, h))
        return x + rf * apply_linear(self.ffn_v, kf)


@tables.register("encoder_classes", "RWKVEncoder")
class RWKVEncoder(nn.Module):
    SCAN_STACKED_LISTS = ("blocks",)  # JAX scans them: quant's rule for stacked leaves

    def __init__(self, input_size: int, output_size: int = 256, num_blocks: int = 6,
                 ffn_mult: int = 4, device=None, **kwargs):
        super().__init__()
        self.cfg = RWKVConfig(input_size, output_size, num_blocks, ffn_mult)
        self.embed = nn.Linear(input_size, output_size, device=device)
        self.blocks = nn.ModuleList(RWKVBlock(output_size, output_size * ffn_mult,
                                              device=device) for _ in range(num_blocks))
        self.after_norm = LayerNorm(output_size, device=device)

    def output_size(self) -> int:
        return self.cfg.output_size

    def forward(self, xs_pad, ilens, generator=None):
        """(B, T, F), (B,) -> ((B, T, D) zeroed past each length, (B,))."""
        x = apply_linear(self.embed, xs_pad)
        for block in self.blocks:
            x = block(x)
        x = self.after_norm(x)
        return x * make_pad_mask(ilens, x.shape[1])[..., None].to(x.dtype), ilens


@tables.register("model_classes", "BAT")
@tables.register("model_classes", "RWKVBAT")
class BAT(Transducer):
    """Boundary-aware transducer: the Transducer over ``RWKVEncoder`` by default
    (``BAT``, ``model.py:121-131``)."""

    def __init__(self, encoder: str = "RWKVEncoder", **kwargs):
        super().__init__(encoder=encoder, **kwargs)


@tables.register("model_classes", "ConformerRWKV")
class ConformerRWKV(Transformer):
    """The Transformer AED over ``RWKVEncoder`` by default (``model.py:134-137``)."""

    def __init__(self, encoder: str = "RWKVEncoder", **kwargs):
        super().__init__(encoder=encoder, **kwargs)
