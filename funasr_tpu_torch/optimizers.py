"""Optimizer registry -> ``torch.optim`` optimizers with the JAX package's numerics
(counterpart of ``funasr_tpu/optimizers.py``, whose factories return optax transforms).

* ``adam``: ``optax.adam``; with ``weight_decay > 0`` it is ``optax.adamw`` (decoupled
  decay, ``optimizers.py:11-16``), so ``torch.optim.AdamW``, not torch's L2 ``Adam``.
* ``adamw``: ``optax.adamw`` (weight decay 0.01 by default) = ``torch.optim.AdamW``.
* ``sgd``: ``optax.sgd`` with ``add_decayed_weights`` before the momentum trace
  (``:25-29``) = ``torch.optim.SGD(weight_decay=, momentum=)``: both add wd * p to the
  gradient and then keep buf = momentum * buf + g.
* ``fairseq_adam``: ``adam`` with ``adam_b1`` / ``adam_b2`` / ``adam_eps``.

Every parameter is decayed, biases and norms included, as optax's transforms do with no
mask. A schedule (``schedulers.py``) scales the lr per update through ``LambdaLR``.
"""

from __future__ import annotations

import torch

from funasr_tpu_torch.register import tables


def _adam(params, lr, weight_decay: float = 0.0, betas=(0.9, 0.999), eps: float = 1e-8,
          **kwargs):
    if weight_decay:
        return torch.optim.AdamW(params, lr=lr, betas=tuple(betas), eps=eps,
                                 weight_decay=weight_decay)
    return torch.optim.Adam(params, lr=lr, betas=tuple(betas), eps=eps)


def _adamw(params, lr, weight_decay: float = 0.01, betas=(0.9, 0.999), eps: float = 1e-8,
           **kwargs):
    return torch.optim.AdamW(params, lr=lr, betas=tuple(betas), eps=eps,
                             weight_decay=weight_decay)


def _sgd(params, lr, momentum: float = 0.0, weight_decay: float = 0.0, **kwargs):
    return torch.optim.SGD(params, lr=lr, momentum=momentum, weight_decay=weight_decay)


def _fairseq_adam(params, lr, adam_b1: float = 0.9, adam_b2: float = 0.98,
                  adam_eps: float = 1e-8, weight_decay: float = 0.0, **kwargs):
    return _adam(params, lr, weight_decay=weight_decay, betas=(adam_b1, adam_b2), eps=adam_eps)


tables.optim_classes["adam"] = _adam
tables.optim_classes["adamw"] = _adamw
tables.optim_classes["sgd"] = _sgd
tables.optim_classes["fairseq_adam"] = _fairseq_adam


def build_optimizer(params, optim: str = "adam", optim_conf=None) -> torch.optim.Optimizer:
    """A ``torch.optim`` optimizer over ``params`` at ``optim_conf["lr"]`` (1e-3 by
    default); a scheduler built over it scales that lr per update."""
    conf = dict(optim_conf or {})
    lr = conf.pop("lr", 1e-3)
    factory = tables.optim_classes.get(optim)
    if factory is None:
        raise KeyError(f"unknown optimizer {optim}; have {sorted(tables.optim_classes)}")
    return factory(params, lr, **conf)
