"""Neural-net primitives of the PyTorch port (counterpart of ``funasr_tpu/core/layers.py``).

Primitives are plain functions on tensors; the few layers that own weights are
``nn.Module``s whose parameter names follow FunASR's state dict (``w_1``, ``w_2``,
``norm``, LayerNorm ``weight``/``bias``), so a FunASR ``model.pt`` loads with
``load_state_dict``. Weights keep torch layouts: Linear ``(out, in)``, Conv1d
``(C_out, C_in / groups, K)``.

Numerics copied from the JAX package, not "fixed":

* LayerNorm eps is 1e-12 (``funasr_tpu/core/layers.py:28``), computed in fp32 and
  cast back; ``nn.LayerNorm``'s 1e-5 default is never used.
* ``linear`` multiplies in x's dtype with fp32 accumulation and adds the bias before the
  single rounding to x's dtype (``:60-63``).
* Sinusoidal PE positions start at 1, sin || cos split (``:269-289``).
* Pad masks are True at VALID positions (``:292-294``); ``masked_softmax`` fills masked
  scores with finfo(f32).min and zeroes them after the softmax (``:297-311``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-12


def linear(x, weight, bias=None):
    """x (..., in) @ weight (out, in).T + bias -> (..., out) in x's dtype.

    ``F.linear`` accumulates in fp32 and adds the bias before its one rounding (the
    cuBLAS(Lt) epilogue on CUDA), which is ``linear_apply``'s order.
    """
    w = weight.to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    return F.linear(x, w, b)


def apply_linear(mod, x):
    """A linear layer's module applied to x (``linear_apply``'s dispatch, ``:50-53``):
    ``nn.Linear`` through ``linear``; an int8 layer (``ops/quant.py::Int8Linear``, swapped
    in by ``quantize_params_int8``) through its own forward, ``qlinear``."""
    if isinstance(mod, nn.Linear):
        return linear(x, mod.weight, mod.bias)
    return mod(x)


def layer_norm(x, weight, bias, eps: float = LN_EPS):
    """fp32 LayerNorm over the last axis, cast back to x's dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps)
    return y.to(x.dtype)


def conv1d(x, weight, bias=None, *, left_pad: int = 0, right_pad: int = 0):
    """Full conv1d, x (B, T, C_in) -> (B, T', C_out), zero padding, stride 1.

    Runs as one GEMM over the unfolded (T', C_in * K) windows, so it follows ``linear``'s
    numerics and never reaches cuDNN (whose fp32 convolutions default to TF32).
    """
    c_out, c_in, k = weight.shape
    xp = F.pad(x, (0, 0, left_pad, right_pad))
    win = xp.unfold(1, k, 1)  # (B, T', C_in, K)
    return linear(win.reshape(*win.shape[:2], c_in * k), weight.reshape(c_out, c_in * k),
                  bias)


def conv_transpose1d_stride_eq_kernel(x, weight, bias=None):
    """``nn.ConvTranspose1d`` with stride == kernel (``core/layers.py:188-194``): each
    input frame emits K output frames. x (B, T, C_in), weight (C_in, C_out, K) ->
    (B, T * K, C_out), as one GEMM with ``linear``'s numerics (fp32 accumulation, the
    bias added before the one rounding)."""
    c_in, c_out, k = weight.shape
    w = weight.permute(2, 1, 0).reshape(k * c_out, c_in)  # row k * C_out + d
    b = None if bias is None else bias.repeat(k)
    y = linear(x, w, b)  # (B, T, K * C_out)
    return y.reshape(x.shape[0], x.shape[1] * k, c_out)


def embedding(ids, weight, *, dtype=torch.float32):
    return F.embedding(ids, weight).to(dtype)


def sinusoidal_pe(positions, depth: int, dtype=torch.float32):
    """FunASR SinusoidalPositionEncoder.encode: (T,) 1-based positions -> (T, depth)."""
    positions = positions.float()
    log_timescale_increment = math.log(10000.0) / (depth / 2 - 1)
    inv_timescales = torch.exp(
        torch.arange(depth // 2, dtype=torch.float32, device=positions.device)
        * -log_timescale_increment)
    scaled = positions[:, None] * inv_timescales[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=-1).to(dtype)


def add_sinusoidal_pe(x, start_pos: int = 1):
    """x: (B, T, D) -> x + pe, positions start at ``start_pos`` (reference starts at 1)."""
    t, d = x.shape[1], x.shape[2]
    pos = torch.arange(start_pos, start_pos + t, dtype=torch.float32, device=x.device)
    return x + sinusoidal_pe(pos, d, x.dtype)[None]


def make_pad_mask(lengths, maxlen: int):
    """(B,) lengths -> (B, T) bool, True at VALID positions (inverse of the torch ref)."""
    return torch.arange(maxlen, device=lengths.device)[None, :] < lengths[:, None]


def masked_softmax(scores, mask, *, dim: int = -1):
    """fp32 softmax with a boolean valid-mask (True = attend), in scores' dtype."""
    sf = scores.float()
    if mask is not None:
        sf = sf.masked_fill(~mask, torch.finfo(torch.float32).min)
    out = torch.softmax(sf, dim=dim)
    if mask is not None:
        out = out.masked_fill(~mask, 0.0)
    return out.to(scores.dtype)


def lstm_apply(lstm: nn.LSTM, x):
    """A unidirectional ``nn.LSTM`` (any number of layers, FunASR's parameter names) over
    x (B, T, D) -> (B, T, H), in fp32 whatever the weights' dtype, as ``lstm_apply``
    (``core/layers.py:209-239``) computes: per layer the input product plus both biases
    for every step at once, then one (B, H) x (H, 4H) product a step, gates (i, f, g, o).
    The hotword bias encoders run it over a few tokens per word."""
    h_all = x.float()
    for layer in range(lstm.num_layers):
        w_ih, w_hh, b_ih, b_hh = (getattr(lstm, f"{name}_l{layer}").float() for name in
                                  ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))
        pre = F.linear(h_all, w_ih) + b_ih + b_hh
        h = torch.zeros(x.shape[0], lstm.hidden_size, device=x.device)
        c = torch.zeros_like(h)
        steps = []
        for t in range(x.shape[1]):
            i, f, g, o = (pre[:, t] + h @ w_hh.T).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            steps.append(h)
        h_all = torch.stack(steps, dim=1)
    return h_all


def encode_hotwords(lstm: nn.LSTM, table, hw_lists):
    """Hotwords as token-id lists (N of them) -> (N, H) fp32: the rows of the embedding
    ``table`` through ``lstm_apply``, each word's last valid step (its first for an empty
    word), as the hotword models take it (``seaco_paraformer/model.py:55-62``)."""
    lengths = [len(h) for h in hw_lists]
    ids = torch.zeros(len(hw_lists), max(lengths), dtype=torch.long)
    for i, h in enumerate(hw_lists):
        ids[i, :len(h)] = torch.as_tensor(h, dtype=torch.long)
    h = lstm_apply(lstm, embedding(ids.to(table.device), table))
    last = torch.as_tensor([max(n - 1, 0) for n in lengths], device=table.device)
    return h[torch.arange(len(hw_lists), device=table.device), last]


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` parameters (``weight``, ``bias``) with eps 1e-12 in fp32."""

    def __init__(self, dim: int, device=None):
        super().__init__(dim, eps=LN_EPS, device=device)

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class PositionwiseFeedForward(nn.Module):
    """Linear -> ReLU -> Linear (FunASR ``transformer/positionwise_feed_forward.py``)."""

    def __init__(self, idim: int, hidden_units: int, device=None):
        super().__init__()
        self.w_1 = nn.Linear(idim, hidden_units, device=device)
        self.w_2 = nn.Linear(hidden_units, idim, device=device)

    def forward(self, x):
        h = torch.relu(apply_linear(self.w_1, x))
        return apply_linear(self.w_2, h)


class PositionwiseFeedForwardDecoderSANM(nn.Module):
    """Linear -> ReLU -> LayerNorm(hidden) -> Linear(no bias)
    (FunASR ``sanm/positionwise_feed_forward.py``)."""

    def __init__(self, idim: int, hidden_units: int, device=None):
        super().__init__()
        self.w_1 = nn.Linear(idim, hidden_units, device=device)
        self.w_2 = nn.Linear(hidden_units, idim, bias=False, device=device)
        self.norm = LayerNorm(hidden_units, device=device)

    def forward(self, x):
        h = torch.relu(apply_linear(self.w_1, x))
        return apply_linear(self.w_2, self.norm(h))
