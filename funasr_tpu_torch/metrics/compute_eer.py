"""Speaker-verification metrics: EER and minDCF (a copy of
``funasr_tpu/metrics/compute_eer.py``; counterpart of FunASR
``funasr/metrics/compute_eer.py`` / ``compute_min_dcf.py``)."""

from __future__ import annotations

import numpy as np


def compute_eer(scores: np.ndarray, labels: np.ndarray):
    """scores: similarity scores; labels: 1=target, 0=nontarget.
    Returns (eer, threshold)."""
    order = np.argsort(scores)
    scores = np.asarray(scores)[order]
    labels = np.asarray(labels)[order]
    n_target = labels.sum()
    n_nontarget = len(labels) - n_target
    # sweeping threshold upward: targets below threshold are misses
    fnr = np.cumsum(labels) / max(n_target, 1)
    fpr = 1.0 - np.cumsum(1 - labels) / max(n_nontarget, 1)
    idx = int(np.nanargmin(np.abs(fnr - fpr)))
    eer = float((fnr[idx] + fpr[idx]) / 2)
    return eer, float(scores[idx])


def compute_min_dcf(scores: np.ndarray, labels: np.ndarray, p_target: float = 0.01,
                    c_miss: float = 1.0, c_fa: float = 1.0):
    order = np.argsort(scores)
    scores = np.asarray(scores)[order]
    labels = np.asarray(labels)[order]
    n_target = labels.sum()
    n_nontarget = len(labels) - n_target
    fnr = np.cumsum(labels) / max(n_target, 1)
    fpr = 1.0 - np.cumsum(1 - labels) / max(n_nontarget, 1)
    dcf = c_miss * fnr * p_target + c_fa * fpr * (1 - p_target)
    denom = min(c_miss * p_target, c_fa * (1 - p_target))
    idx = int(np.argmin(dcf))
    return float(dcf[idx] / denom), float(scores[idx])
