"""LR schedules as ``torch.optim.lr_scheduler.LambdaLR`` (counterpart of
``funasr_tpu/schedulers.py``): the lr of update n (0-based, the optax count) is the
optax schedule's value at n. ``build_scheduler`` returns the LambdaLR; call its
``step()`` after each applied update."""

from __future__ import annotations

import math

from torch.optim.lr_scheduler import LambdaLR

from funasr_tpu_torch.register import tables


def warmuplr(lr: float = 1e-3, warmup_steps: int = 25000, **kwargs):
    """lr * warmup^0.5 * min(s^-0.5, s * warmup^-1.5), s = n + 1 (espnet WarmupLR)."""
    def schedule(n):
        s = n + 1.0
        return lr * warmup_steps ** 0.5 * min(s ** -0.5, s * warmup_steps ** -1.5)
    return schedule


def noamlr(lr: float = 1.0, model_size: int = 512, warmup_steps: int = 25000, **kwargs):
    def schedule(n):
        s = n + 1.0
        return lr * model_size ** -0.5 * min(s ** -0.5, s * warmup_steps ** -1.5)
    return schedule


def tri_stage(lr: float = 1e-3, phase_ratio=(0.1, 0.4, 0.5), total_steps: int = 100000,
              init_lr_scale: float = 0.01, final_lr_scale: float = 0.01, **kwargs):
    """optax ``join_schedules`` of a linear warm-up from lr * init_lr_scale over w steps,
    a constant lr over h, and ``exponential_decay(lr, d, final_lr_scale)``."""
    w, h, d = [int(r * total_steps) for r in phase_ratio]

    def schedule(n):
        if n < w:
            return lr * init_lr_scale + (lr - lr * init_lr_scale) * min(n, w) / w
        if n < w + h:
            return lr
        return lr * final_lr_scale ** ((n - w - h) / d) if d > 0 else lr
    return schedule


tables.scheduler_classes["warmuplr"] = warmuplr
tables.scheduler_classes["noamlr"] = noamlr
tables.scheduler_classes["tri_stage"] = tri_stage


def build_scheduler(optimizer, scheduler: str = "warmuplr", scheduler_conf=None) -> LambdaLR:
    """A LambdaLR over ``optimizer`` whose lr at update n is the schedule's (the JAX
    package's ``build_scheduler``), the schedule's lr defaulting to the optimizer's."""
    base = optimizer.param_groups[0]["lr"]
    if base == 0 or not math.isfinite(base):
        raise ValueError(f"a schedule needs a finite non-zero optimizer lr, got {base}")
    conf = dict(scheduler_conf or {})
    conf.setdefault("lr", base)
    factory = tables.scheduler_classes.get(scheduler)
    if factory is None:
        raise KeyError(f"unknown scheduler {scheduler}")
    schedule = factory(**conf)
    return LambdaLR(optimizer, lambda n: schedule(n) / base)
