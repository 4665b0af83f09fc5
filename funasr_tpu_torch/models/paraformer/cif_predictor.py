"""CIF predictors (CifPredictorV2 and V1) in PyTorch (counterpart of
``funasr_tpu/models/paraformer/cif_predictor.py``).

FunASR's ``CifPredictorV2`` (``funasr/models/paraformer/cif_predictor.py:209-412``):
pad(l, r) conv1d + relu + linear + sigmoid alphas, then (inference) the tail-threshold
fire appended. The fired-token axis is the caller's ``max_tokens`` budget; slots past a
row's token count are zero. With ``target_length`` (training, ``cif_predictor.py:68-90``)
the alphas are rescaled so each row sums to its target token count, no tail fire is
appended and the token count returned is the unscaled alpha sum (``mae_token_loss``
reads it). ``forward_chunk`` is the streaming predictor (``cif_predictor.py:106-167``):
the chunk's alphas kept inside its stride, the tail-threshold frame appended when final,
the sequential integrate with a carried state (``ops/cif.py::cif_scan``) and the fired
frames compacted to the front by a stable sort, all on the device.

``CifPredictorV1`` (registered as ``CifPredictor``; FunASR ``cif_predictor.py:17``) is V2
with a depthwise alpha conv (``Conv1d(idim, idim, l + r + 1, groups=idim)``, with a bias)
and a residual before the ReLU. The JAX package also binds ``CifPredictorV2Export`` and
``CifPredictorV3Export`` to it; in FunASR those wrap V2 and V3, whose ``cif_conv1d`` is a
full (idim, idim, k) conv that V1's (idim, 1, k) weight cannot hold, so the port leaves
both names unbound (ROADMAP section 3).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from funasr_tpu_torch.core.layers import apply_linear, conv1d
from funasr_tpu_torch.ops.cif import cif, cif_scan
from funasr_tpu_torch.parallel.sharding import global_count
from funasr_tpu_torch.register import tables


@tables.register("predictor_classes", "CifPredictorV2")
class CifPredictorV2(nn.Module):
    def __init__(self, idim: int, l_order: int = 1, r_order: int = 1,
                 threshold: float = 1.0, smooth_factor: float = 1.0,
                 noise_threshold: float = 0.0, tail_threshold: float = 0.45,
                 tail_mask: bool = True, device=None, **kwargs):
        super().__init__()
        self.l_order, self.r_order = l_order, r_order
        self.threshold = threshold
        self.smooth_factor = smooth_factor
        self.noise_threshold = noise_threshold
        self.tail_threshold = tail_threshold
        self.cif_conv1d = nn.Conv1d(idim, idim, l_order + r_order + 1, device=device)
        self.cif_output = nn.Linear(idim, 1, device=device)

    def alphas(self, hidden, mask):
        """hidden: (B, T, D); mask: (B, T) bool -> per-frame alphas (B, T) fp32."""
        h = conv1d(hidden, self.cif_conv1d.weight, self.cif_conv1d.bias,
                   left_pad=self.l_order, right_pad=self.r_order)
        out = apply_linear(self.cif_output, torch.relu(h))
        a = torch.sigmoid(out[..., 0].float())
        a = torch.relu(a * self.smooth_factor - self.noise_threshold)
        if mask is not None:
            a = a * mask.float()
        return a

    def forward(self, hidden, mask, max_tokens: int, target_length=None):
        """Returns (acoustic_embeds (B,K,D), token_num (B,), alphas (B,T+1), fires);
        with ``target_length`` (B,) the training branch: alphas (B, T) rescaled to it."""
        b, t, _ = hidden.shape
        a = self.alphas(hidden, mask)
        if target_length is not None:
            token_num = a.sum(dim=1)
            a = a * (target_length.float() / token_num.clamp_min(1e-9))[:, None]
            acoustic_embeds, fires = cif(hidden, a, max_tokens, self.threshold)
            return acoustic_embeds, token_num, a, fires
        if self.tail_threshold > 0.0:
            # one extra frame of zeros; alpha[len] += tail_threshold
            lens = (mask.sum(dim=1) if mask is not None
                    else torch.full((b,), t, dtype=torch.long, device=hidden.device))
            tail = F.one_hot(lens.long(), t + 1).float() * self.tail_threshold
            alphas_c = F.pad(a, (0, 1)) + tail
            hidden_c = F.pad(hidden, (0, 0, 0, 1))
            out_token_num = torch.floor(alphas_c.sum(dim=1))
        else:
            hidden_c, alphas_c, out_token_num = hidden, a, a.sum(dim=1)
        acoustic_embeds, fires = cif(hidden_c, alphas_c, max_tokens, self.threshold)
        return acoustic_embeds, out_token_num, alphas_c, fires

    def forward_chunk(self, hidden, state, max_tokens: int, is_final: bool = False,
                      chunk_size=None):
        """One streaming chunk. hidden (B, T, D); ``state`` {"integrate" (B,), "frame"
        (B, D)} fp32; ``chunk_size`` [pad_left, stride, look-ahead] zeroes the alphas
        outside the stride (the look-ahead rows come again next chunk) -> (embeds
        (B, min(max_tokens, T'), D) with the fired frames first and zeros past
        ``n_fired``, n_fired (B,) int32 on the device, new state). T' = T + 1 when
        final (the tail-threshold frame)."""
        b, t, d = hidden.shape
        a = self.alphas(hidden, None)
        if chunk_size is not None:
            pos = torch.arange(t, device=hidden.device)[None, :]
            keep = pos >= chunk_size[0]
            if not is_final:
                keep &= pos < chunk_size[0] + chunk_size[1]
            a = a * keep.to(a.dtype)
        if is_final:
            a = torch.cat([a, torch.full((b, 1), self.tail_threshold, dtype=torch.float32,
                                         device=a.device)], dim=1)
            hidden = torch.cat([hidden, hidden.new_zeros(b, 1, d)], dim=1)
            t += 1
        integrate, frame, fire_mask, fired_frames = cif_scan(
            hidden, a, state["integrate"], state["frame"], self.threshold)
        n_fired = fire_mask.sum(dim=1).to(torch.int32)
        order = torch.argsort((~fire_mask).to(torch.int32), dim=1, stable=True)
        k = min(max_tokens, t)
        embeds = torch.take_along_dim(fired_frames, order[..., None], dim=1)[:, :k]
        valid = torch.arange(k, device=hidden.device)[None, :] < n_fired[:, None]
        embeds = torch.where(valid[..., None], embeds, 0.0).to(hidden.dtype)
        return embeds, n_fired, {"integrate": integrate, "frame": frame}

    @staticmethod
    def init_state(batch: int, dim: int, device=None):
        return {"integrate": torch.zeros(batch, device=device),
                "frame": torch.zeros(batch, dim, device=device)}


def mae_token_loss(token_num, pre_token_length, normalize_length: bool = False):
    """L1 token-count loss (``cif_predictor.py:175``; FunASR ``mae_loss``): the summed
    |target count - predicted count| over the batch size (or the target total), over the
    data group (``global_count``)."""
    norm = global_count(token_num.shape[0] if not normalize_length else token_num.sum())
    return (token_num.float() - pre_token_length).abs().sum() / norm


@tables.register("predictor_classes", "CifPredictor")
class CifPredictorV1(CifPredictorV2):
    def __init__(self, idim: int, l_order: int = 1, r_order: int = 1, *args, device=None,
                 **kwargs):
        super().__init__(idim, l_order, r_order, *args, device=device, **kwargs)
        self.cif_conv1d = nn.Conv1d(idim, idim, l_order + r_order + 1, groups=idim,
                                    device=device)

    def alphas(self, hidden, mask):
        """``depthwise_conv1d_apply`` (fp32 taps, the bias added, one rounding to hidden's
        dtype) + hidden -> relu -> linear -> sigmoid; (B, T) fp32."""
        w = self.cif_conv1d.weight[:, 0].float()  # (C, k)
        pad = F.pad(hidden.float(), (0, 0, self.l_order, self.r_order))
        t = hidden.shape[1]
        mem = torch.zeros(hidden.shape, dtype=torch.float32, device=hidden.device)
        for i in range(w.shape[1]):
            mem = mem + pad[:, i:i + t] * w[:, i]
        mem = (mem + self.cif_conv1d.bias.float()).to(hidden.dtype)
        out = apply_linear(self.cif_output, torch.relu(mem + hidden))
        a = torch.sigmoid(out[..., 0].float())
        a = torch.relu(a * self.smooth_factor - self.noise_threshold)
        if mask is not None:
            a = a * mask.float()
        return a
