"""CTC head in PyTorch (counterpart of ``funasr_tpu/models/ctc/ctc.py``; FunASR
``funasr/models/ctc/ctc.py:7-148``): the ``ctc_lo`` projection and its log-softmax /
argmax, and ``loss``: the mean over utterances of the per-sequence CTC NLL with
optax's numerics (``losses/ctc.py``), which the training loss of a model with
``ctc_weight > 0`` reads.
"""

from __future__ import annotations

import torch
from torch import nn

from funasr_tpu_torch.core.layers import apply_linear
from funasr_tpu_torch.losses.ctc import ctc_loss
from funasr_tpu_torch.parallel.sharding import global_count
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

    def loss(self, hs_pad, hlens, ys_pad, ys_lens):
        """Mean per-utterance CTC loss (``ctc.py:38-47``), the rows counted over the data
        group (``global_count``). ys_pad: (B, L), any padding."""
        logits = self.logits(hs_pad).float()
        t, l = logits.shape[1], ys_pad.shape[1]
        dev = logits.device
        logit_paddings = (torch.arange(t, device=dev)[None, :] >= hlens[:, None]).float()
        label_paddings = (torch.arange(l, device=dev)[None, :] >= ys_lens[:, None]).float()
        labels = torch.where(label_paddings > 0, 0, ys_pad)
        per_row = ctc_loss(logits, logit_paddings, labels, label_paddings,
                           blank_id=self.blank_id)
        return per_row.sum() / global_count(per_row.shape[0])
