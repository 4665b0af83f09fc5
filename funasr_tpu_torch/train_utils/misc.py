"""Misc training utilities (counterpart of ``funasr_tpu/train_utils/misc.py``; FunASR
``set_all_random_seed.py``, ``model_summary.py``, ``load_pretrained_model.py`` with
scope_map / excludes remapping, ``add_gradient_noise.py``)."""

from __future__ import annotations

import logging
import random
from typing import Optional, Sequence

import numpy as np
import torch


def set_all_random_seed(seed: int) -> torch.Generator:
    """Seed Python's, numpy's and torch's default generators; returns a generator seeded
    the same (the JAX function returns ``PRNGKey(seed)``)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def model_summary(model: torch.nn.Module) -> str:
    """Parameter counts per top-level child module + total."""
    lines = []
    total = 0
    for name, child in model.named_children():
        n = sum(p.numel() for p in child.parameters())
        total += n
        lines.append(f"  {name:24s} {n / 1e6:10.2f} M")
    lines.append(f"  {'TOTAL':24s} {total / 1e6:10.2f} M")
    out = "\n".join(lines)
    logging.info("model summary:\n%s", out)
    return out


def load_pretrained_model(model: torch.nn.Module, path: str,
                          scope_map: Optional[Sequence[str]] = None,
                          excludes: Optional[Sequence[str]] = None,
                          ignore_init_mismatch: bool = True) -> torch.nn.Module:
    """Load a FunASR-layout state dict (``model.pt`` or a trainer checkpoint) into
    ``model`` in place. ``scope_map``: ["src_prefix", "dst_prefix", ...] renames applied
    first; ``excludes``: key prefixes dropped. Shape mismatches keep the model's tensor
    (with a warning) under ``ignore_init_mismatch``, else raise."""
    from funasr_tpu_torch.utils.load_utils import load_torch_checkpoint
    sd = load_torch_checkpoint(path)
    if scope_map:
        pairs = list(scope_map)
        remapped = {}
        for k, v in sd.items():
            for i in range(0, len(pairs) - 1, 2):
                if k.startswith(pairs[i]):
                    k = pairs[i + 1] + k[len(pairs[i]):]
                    break
            remapped[k] = v
        sd = remapped
    if excludes:
        sd = {k: v for k, v in sd.items() if not any(k.startswith(e) for e in excludes)}
    own = model.state_dict()
    keep = {}
    for k, v in sd.items():
        if k in own and own[k].shape != v.shape:
            if not ignore_init_mismatch:
                raise ValueError(f"{k}: checkpoint {tuple(v.shape)} vs model "
                                 f"{tuple(own[k].shape)}")
            logging.warning("%s: shape mismatch, keeping the model's init", k)
            continue
        keep[k] = v
    missing, unexpected = model.load_state_dict(keep, strict=False)
    if missing or unexpected:
        logging.info("pretrained load: %d missing, %d unexpected keys", len(missing),
                     len(unexpected))
    return model


def add_gradient_noise(model: torch.nn.Module, step: int, eta: float = 1.0,
                       gamma: float = 0.55, generator=None):
    """Annealed gaussian gradient noise in place: sigma = eta / (1 + step) ** gamma."""
    sigma = eta / (1 + step) ** gamma
    for p in model.parameters():
        if p.grad is not None:
            p.grad.add_(torch.randn(p.grad.shape, generator=generator, device=p.device,
                                    dtype=p.grad.dtype) * sigma)
