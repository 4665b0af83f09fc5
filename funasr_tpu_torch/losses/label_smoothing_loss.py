"""Label-smoothing KL loss and token accuracy in PyTorch (counterpart of
``funasr_tpu/losses/label_smoothing_loss.py``; FunASR ``label_smoothing_loss.py:14``,
``compute_acc.py:4``)."""

from __future__ import annotations

import math

import torch

from funasr_tpu_torch.parallel.sharding import global_count


def label_smoothing_loss(logits, targets, ignore_id: int = -1, smoothing: float = 0.1,
                         vocab_size: int | None = None, normalize_length: bool = False):
    """KL(true_dist || softmax(logits)) with uniform smoothing, padding ignored.

    logits: (B, T, V); targets: (B, T) int with ``ignore_id`` padding. Normalized by the
    batch size, or by the token count under ``normalize_length``, each over the data
    group (``global_count``). The true distribution's entropy is kept, as FunASR's
    ``KLDivLoss`` on a built true_dist does.
    """
    v = vocab_size or logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = targets != ignore_id
    tgt = torch.where(valid, targets, 0).long()
    confidence = 1.0 - smoothing
    low = smoothing / (v - 1)
    true_entropy = -(confidence * math.log(confidence + 1e-30)
                     + (v - 1) * low * math.log(low + 1e-30))
    picked = torch.gather(logp, -1, tgt[..., None])[..., 0]
    cross = confidence * picked + low * (logp.sum(dim=-1) - picked)
    kl = (-true_entropy - cross) * valid
    denom = global_count(valid.sum() if normalize_length else targets.shape[0])
    return kl.sum() / denom


def th_accuracy(logits, targets, ignore_id: int = -1):
    """Token accuracy over the non-ignored positions (a 0-d fp32 tensor), their count
    over the data group (``global_count``)."""
    pred = logits.argmax(dim=-1)
    valid = targets != ignore_id
    correct = ((pred == targets) & valid).sum()
    return correct.float() / global_count(valid.sum()).clamp_min(1).float()
