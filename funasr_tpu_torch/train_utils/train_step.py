"""A bare training step (counterpart of ``funasr_tpu/train_utils/train_step.py``).

``make_train_step(model, optimizer, clip_grad_norm)`` returns ``step(batch) -> stats``:
loss, backward, the gradients' global norm (``stats["grad_norm"]``), clipping by
min(1, clip / (norm + 1e-6)), and the optimizer step. Unlike the ``Trainer`` (which zeroes
the gradients and still steps), a non-finite norm here skips the update: parameters and
optimizer state stay as they were (``train_step.py:44-51``). The batch holds features,
not waveforms: speech / speech_lengths / text / text_lengths tensors on the model's
device.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from funasr_tpu_torch.train_utils.trainer import global_norm


def make_train_step(model, optimizer, clip_grad_norm: Optional[float] = None,
                    generator=None) -> Callable:
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch):
        model.train()
        for p in params:
            p.grad = None
        loss, stats, _ = model(batch["speech"], batch["speech_lengths"], batch["text"],
                               batch["text_lengths"], generator=generator)
        loss.backward()
        grads = []
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        gnorm = global_norm(grads)
        stats = dict(stats)
        stats["grad_norm"] = gnorm
        if not torch.isfinite(gnorm):
            return stats
        if clip_grad_norm is not None:
            torch._foreach_mul_(grads, torch.clamp(clip_grad_norm / (gnorm + 1e-6), max=1.0))
        optimizer.step()
        return stats

    return step
