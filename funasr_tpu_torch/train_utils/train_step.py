"""A bare training step (counterpart of ``funasr_tpu/train_utils/train_step.py``) and the
gradient half of every step, the ``Trainer``'s too.

``make_train_step(model, optimizer, clip_grad_norm, data=)`` returns ``step(batch) ->
stats``: loss, backward, the gradients' global norm (``stats["grad_norm"]``), clipping by
min(1, clip / (norm + 1e-6)), and the optimizer step. Unlike the ``Trainer`` (which zeroes
the gradients and still steps), a non-finite norm here skips the update: parameters and
optimizer state stay as they were (``train_step.py:44-51``). The batch holds features,
not waveforms: speech / speech_lengths / text / text_lengths tensors on the model's
device. With a ``parallel.sharding.DataGroup`` (``data``), the batch is the global one:
each rank steps on its rows and the stats are the global batch's
(``parallel/dryrun.py`` is the caller that gives one).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from funasr_tpu_torch.parallel.sharding import local


def global_norm(grads, data=None) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (``optax.global_norm``), fp32: each
    tensor's L2 norm in one multi-tensor launch, then their norm; under fsdp over this
    rank's shards, then summed over the group (``DataGroup.sum_norms``)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
        [local(g) for g in grads])).float())
    return norm if data is None else data.sum_norms(norm)


def backward(loss, params, data=None):
    """``loss.backward()``; zeros for every parameter the loss did not reach (optax's
    gradient tree holds every leaf, so decay and moments cover it too); under dp the
    gradients summed over the group -> the gradients, in ``params``' order."""
    loss.backward()
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    if data is not None:
        data.reduce_gradients(grads)
    return grads


def scale_(grads, scale) -> None:
    """Every gradient times ``scale`` in place (on this rank's shards under fsdp)."""
    torch._foreach_mul_([local(g) for g in grads], scale)


def clip_scale(gnorm, clip_grad_norm):
    return torch.clamp(clip_grad_norm / (gnorm + 1e-6), max=1.0)


def make_train_step(model, optimizer, clip_grad_norm: Optional[float] = None,
                    generator=None, data=None) -> Callable:
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch):
        model.train()
        for p in params:
            p.grad = None
        if data is not None:
            batch = data.local_rows(batch)
        with data.active() if data is not None else contextlib.nullcontext():
            loss, stats, _ = model(batch["speech"], batch["speech_lengths"], batch["text"],
                                   batch["text_lengths"], generator=generator)
        grads = backward(loss, params, data)
        gnorm = global_norm(grads, data)
        stats = dict(stats) if data is None else data.sum_stats(stats)
        stats["grad_norm"] = gnorm
        if not torch.isfinite(gnorm):
            return stats
        if clip_grad_norm is not None:
            scale_(grads, clip_scale(gnorm, clip_grad_norm))
        optimizer.step()
        return stats

    return step
