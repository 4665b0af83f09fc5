"""The PIF (parallel integrate-and-fire) predictor of E-Paraformer in PyTorch
(counterpart of ``funasr_tpu/models/e_paraformer/pif_predictor.py``; FunASR
``funasr/models/e_paraformer/pif_predictor.py:17-131``).

Its alphas are CifPredictorV1's: a depthwise conv with a bias plus the residual, ReLU,
linear, sigmoid (JAX ``:73-87``; the k = 3 conv stays plain PyTorch, as the JAX package
computes it outside any Pallas kernel). Instead of the sequential fire, each output token
k attends to the frames with a per-head Gaussian kernel centred where the alpha cumsum
crosses k + 0.5 (JAX ``:89-117``):

    score[b, h, k, t] = -((k + 0.5 - cumsum(alpha)[b, t]) * sigma[h])^2 + bias[h]
    emb[b, k] = concat_h(softmax_t(score) @ hidden_h)

It returns no fires (None): E-Paraformer has no CIF timestamps.
"""

from __future__ import annotations

import torch
from torch import nn

from funasr_tpu_torch.models.paraformer.cif_predictor import CifPredictorV1
from funasr_tpu_torch.register import tables


@tables.register("predictor_classes", "PifPredictor")
class PifPredictor(CifPredictorV1):
    def __init__(self, idim: int, l_order: int = 1, r_order: int = 1, threshold: float = 1.0,
                 smooth_factor: float = 1.0, noise_threshold: float = 0.0, sigma: float = 0.5,
                 bias: float = 0.0, sigma_heads: int = 4, device=None, **kwargs):
        super().__init__(idim, l_order, r_order, threshold=threshold,
                         smooth_factor=smooth_factor, noise_threshold=noise_threshold,
                         device=device)
        self.sigma_heads = sigma_heads
        self.sigma = nn.Parameter(torch.full((sigma_heads,), float(sigma), device=device))
        self.bias = nn.Parameter(torch.full((sigma_heads,), float(bias), device=device))

    def forward(self, hidden, mask, max_tokens: int, target_length=None):
        """hidden (B, T, D), mask (B, T) bool -> (embeds (B, max_tokens, D) in hidden's
        dtype, token_num (B,), alphas (B, T) rescaled to the token count, None)."""
        b, t, d = hidden.shape
        hh = self.sigma_heads
        a = self.alphas(hidden, mask)
        token_num = a.sum(dim=1)
        tgt = target_length.float() if target_length is not None else torch.round(token_num)
        a = a * (tgt / torch.clamp_min(token_num, 1e-9))[:, None]
        alignment = torch.cumsum(a, dim=-1)
        fire_pos = torch.arange(max_tokens, dtype=torch.float32, device=hidden.device) + 0.5
        delta = fire_pos[None, None, :, None] - alignment[:, None, None, :]  # (B, 1, K, T)
        scores = (-(delta * self.sigma.float()[None, :, None, None]) ** 2
                  + self.bias.float()[None, :, None, None])  # (B, H, K, T)
        if mask is not None:
            scores = scores.masked_fill(~mask[:, None, None, :], -torch.inf)
        weights = torch.softmax(scores, dim=-1)
        heads = hidden.reshape(b, t, hh, d // hh).transpose(1, 2).float()
        emb = torch.matmul(weights, heads).transpose(1, 2).reshape(b, max_tokens, d)
        valid = torch.arange(max_tokens, device=hidden.device)[None] < tgt[:, None]
        emb = emb * valid[..., None]
        return (emb.to(hidden.dtype), token_num if target_length is not None else tgt, a,
                None)
