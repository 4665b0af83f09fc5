"""Low Frame Rate (LFR) stacking and CMVN in PyTorch (counterpart of
``funasr_tpu/ops/lfr.py``).

LFR stacks ``lfr_m`` frames with stride ``lfr_n``; the left context replicates the first
frame ((m-1)//2 copies) and the tail replicates each row's last valid frame. As in the
JAX package it is a clamped gather: window index ``i*n + j - (m-1)//2`` clipped to
``[0, len-1]``. CMVN is ``(x + means) * istd`` from a Kaldi ``am.mvn`` file.
"""

from __future__ import annotations

import numpy as np
import torch


def lfr_out_len(t, lfr_n: int):
    return -(-t // lfr_n)  # ceil


def apply_lfr_batch(feats, lengths, lfr_m: int, lfr_n: int):
    """(B, T, D) + (B,) -> ((B, ceil(T/n), m*D), (B,) lfr lengths)."""
    b, t, d = feats.shape
    t_lfr = lfr_out_len(t, lfr_n)
    dev = feats.device
    last = torch.clamp_min(lengths.long() - 1, 0)[:, None, None]
    idx = (torch.arange(t_lfr, device=dev)[None, :, None] * lfr_n
           + torch.arange(lfr_m, device=dev)[None, None, :] - (lfr_m - 1) // 2)
    idx = torch.minimum(torch.clamp_min(idx, 0), last)  # (B, T_lfr, m)
    out = feats[torch.arange(b, device=dev)[:, None, None], idx]  # (B, T_lfr, m, D)
    out_lens = -(-lengths // lfr_n)
    return out.reshape(b, t_lfr, lfr_m * d), out_lens.to(torch.int32)


def apply_cmvn(feats, means, istd):
    """(..., D) -> (x + means) * istd (kaldi AddShift then Rescale)."""
    return (feats + means) * istd


def load_cmvn(cmvn_file: str) -> np.ndarray:
    """Parse a Kaldi-format ``am.mvn`` (AddShift means + Rescale vars) -> (2, D) fp32."""
    with open(cmvn_file, "r", encoding="utf-8") as f:
        lines = f.readlines()
    means, istd = None, None
    for i, line in enumerate(lines):
        item = line.split()
        if not item:
            continue
        if item[0] == "<AddShift>":
            nxt = lines[i + 1].split()
            if nxt[0] == "<LearnRateCoef>":
                means = np.array(nxt[3 : len(nxt) - 1], dtype=np.float32)
        elif item[0] == "<Rescale>":
            nxt = lines[i + 1].split()
            if nxt[0] == "<LearnRateCoef>":
                istd = np.array(nxt[3 : len(nxt) - 1], dtype=np.float32)
    if means is None or istd is None:
        raise ValueError(f"could not parse CMVN stats from {cmvn_file}")
    return np.stack([means, istd])
