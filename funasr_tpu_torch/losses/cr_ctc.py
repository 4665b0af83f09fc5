"""Consistency-regularized CTC in PyTorch (counterpart of ``funasr_tpu/losses/cr_ctc.py``;
FunASR ``funasr/losses/cr_ctc.py``): CTC on two augmented views of the same utterances
plus a symmetric KL between their frame posteriors."""

from __future__ import annotations

import torch

from funasr_tpu_torch.losses.ctc import ctc_loss
from funasr_tpu_torch.parallel.sharding import global_count


def cr_ctc_loss(logits_a, logits_b, logit_lengths, labels, label_lengths,
                blank_id: int = 0, cr_weight: float = 0.2):
    """logits_{a,b}: (B, T, V) from two augmentations -> scalar loss; the rows and the
    frames counted over the data group (``global_count``)."""
    t = logits_a.shape[1]
    dev = logits_a.device
    logit_pad = (torch.arange(t, device=dev)[None] >= logit_lengths[:, None]).float()
    l = labels.shape[1]
    label_pad = (torch.arange(l, device=dev)[None] >= label_lengths[:, None]).float()
    labels_clean = torch.where(label_pad > 0, 0, labels)
    rows = global_count(logits_a.shape[0])
    ctc_a = ctc_loss(logits_a.float(), logit_pad, labels_clean, label_pad, blank_id).sum() / rows
    ctc_b = ctc_loss(logits_b.float(), logit_pad, labels_clean, label_pad, blank_id).sum() / rows
    logp_a = torch.log_softmax(logits_a.float(), -1)
    logp_b = torch.log_softmax(logits_b.float(), -1)
    p_a, p_b = logp_a.exp(), logp_b.exp()
    valid = (1.0 - logit_pad)[..., None]
    kl_ab = (p_a * (logp_a - logp_b) * valid).sum()
    kl_ba = (p_b * (logp_b - logp_a) * valid).sum()
    n = global_count((1.0 - logit_pad).sum()).clamp_min(1.0)
    consistency = (kl_ab + kl_ba) / (2.0 * n)
    return 0.5 * (ctc_a + ctc_b) + cr_weight * consistency
