"""CTC head in PyTorch (counterpart of ``funasr_tpu/models/ctc/ctc.py``; FunASR
``funasr/models/ctc/ctc.py:7-148``): the ``ctc_lo`` projection and its log-softmax /
argmax. The loss (``CTC.loss``, optax's alpha recursion in the JAX package) serves
training only and comes with the training slice (ROADMAP item 20).
"""

from __future__ import annotations

import torch
from torch import nn

from funasr_tpu_torch.core.layers import apply_linear
from funasr_tpu_torch.register import tables


@tables.register("ctc_classes", "CTC")
class CTC(nn.Module):
    def __init__(self, odim: int, encoder_output_size: int, dropout_rate: float = 0.0,
                 blank_id: int = 0, device=None, **kwargs):
        super().__init__()
        self.odim = odim
        self.blank_id = blank_id
        self.ctc_lo = nn.Linear(encoder_output_size, odim, device=device)

    def logits(self, hs_pad):
        """(B, T, D) -> (B, T, odim) in hs_pad's dtype."""
        return apply_linear(self.ctc_lo, hs_pad)

    def log_softmax(self, hs_pad):
        """fp32 log-probs: the logits cast to fp32 first (``ctc.py:34-35``)."""
        return torch.log_softmax(self.logits(hs_pad).float(), dim=-1)

    def argmax(self, hs_pad):
        return self.logits(hs_pad).argmax(dim=-1)
