"""Continuous Integrate-and-Fire (CIF) in plain PyTorch (counterpart of
``funasr_tpu/ops/cif.py::cif_fires`` and ``::cif``; CIF has no TPU kernel).

* fires: ``csum = cumsum(alphas)`` in fp32; frame t fires when ``floor(csum[t])``
  increases (alphas <= 1 and threshold 1.0: at most one fire per frame).
* weights: a firing frame splits its alpha between the completing token
  (``floor(csum[t]) - csum[t-1]``) and the next one (``csum[t] - floor(csum[t])``).
* token embeddings: one fp32 (B,K,T) x (B,T,D) product against the weight matrix.
* ``fires_thr``: the fire trace at another threshold (the timestamp head's
  ``threshold - 1e-4``), through ``cif_fires`` on ``alphas / threshold``.
* ``cif_scan_step`` / ``cif_scan``: the streaming predictor's sequential integrate
  (``ops/cif.py:80-98``) with a carried (integrate, frame): one step per frame, in the
  JAX scan's fp32 order, so the fire decisions are the same sums (a chunk has at most
  16 frames).

The cumsum sums in another order than XLA's, on the CPU and more so on the GPU, so a
fire count can differ from the JAX package's only where a running sum sits within
rounding of an integer.
"""

from __future__ import annotations

import torch


def cif_fires(alphas):
    """alphas: (B, T) -> (fires (B,T), fire_mask (B,T) bool, csum), all fp32."""
    csum = torch.cumsum(alphas.float(), dim=1)
    floor = torch.floor(csum)
    prev_floor = torch.cat([torch.zeros_like(floor[:, :1]), floor[:, :-1]], dim=1)
    fire_mask = floor > prev_floor
    fires = fire_mask.float() + csum - floor
    return fires, fire_mask, csum


def fires_thr(alphas, threshold: float):
    """The sequential fire trace at ``threshold`` (reference ``cif_wo_hidden``), fp32:
    ``cif_fires(alphas / threshold) * threshold``
    (``funasr_tpu/models/bicif_paraformer/cif_predictor.py:81-87``)."""
    fires, _, _ = cif_fires(alphas.float() / threshold)
    return fires * threshold


def _one_hot(idx, k: int):
    """float one-hot; indices outside [0, k) give a zero row (``jax.nn.one_hot``)."""
    return (idx[..., None] == torch.arange(k, device=idx.device)).float()


def cif(hidden, alphas, max_tokens: int, threshold: float = 1.0):
    """hidden (B,T,D), alphas (B,T) -> (frames (B,max_tokens,D) in hidden's dtype,
    fires (B,T)). ``threshold`` must be 1.0 (the floor-difference form needs it)."""
    if threshold != 1.0:
        raise ValueError("CIF floor-difference form requires threshold == 1.0")
    fires, fire_mask, csum = cif_fires(alphas)
    floor = torch.floor(csum)
    prev_csum = torch.cat([torch.zeros_like(csum[:, :1]), csum[:, :-1]], dim=1)
    prev_floor = torch.cat([torch.zeros_like(floor[:, :1]), floor[:, :-1]], dim=1)

    w_cur = torch.where(fire_mask, floor - prev_csum, alphas.float())
    w_next = torch.where(fire_mask, csum - floor, torch.zeros_like(csum))
    tok = prev_floor.long()  # token being built at frame t (0-based)
    k = max_tokens
    w = w_cur[..., None] * _one_hot(tok, k) + w_next[..., None] * _one_hot(tok + 1, k)
    frames = torch.bmm(w.transpose(1, 2), hidden.float())  # (B, K, D)

    # only completed tokens (index < per-row fire count) are real
    n_fires = fire_mask.sum(dim=1)
    valid = torch.arange(k, device=hidden.device)[None, :] < n_fires[:, None]
    frames = torch.where(valid[..., None], frames, 0.0)
    return frames.to(hidden.dtype), fires


def cif_scan_step(integrate, frame, alpha, hidden, threshold: float = 1.0):
    """One streaming integrate step: integrate (B,), frame (B, D), alpha (B,), hidden
    (B, D), all fp32 -> (new integrate, new frame, fire (B,) bool, fired frame (B, D))."""
    dist_completion = threshold - integrate
    integrate = integrate + alpha
    fire = integrate >= threshold
    cur = torch.where(fire, dist_completion, alpha)
    remains = alpha - cur
    fired_frame = frame + cur[:, None] * hidden
    new_frame = torch.where(fire[:, None], remains[:, None] * hidden, fired_frame)
    new_integrate = torch.where(fire, integrate - threshold, integrate)
    return new_integrate, new_frame, fire, fired_frame


def cif_scan(hidden, alphas, integrate, frame, threshold: float = 1.0):
    """``cif_scan_step`` over the T frames of hidden (B, T, D) and alphas (B, T) from the
    carry (integrate (B,), frame (B, D)) -> (integrate, frame, fire_mask (B, T),
    fired_frames (B, T, D)), fp32."""
    hid = hidden.float()
    fires, frames = [], []
    for i in range(alphas.shape[1]):
        integrate, frame, fire, fired = cif_scan_step(integrate, frame, alphas[:, i],
                                                      hid[:, i], threshold)
        fires.append(fire)
        frames.append(fired)
    return integrate, frame, torch.stack(fires, dim=1), torch.stack(frames, dim=1)
