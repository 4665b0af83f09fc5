"""LoRA adapters on the port's ``nn.Linear`` modules (counterpart of
``funasr_tpu/models/lora/layers.py``; FunASR ``funasr/models/lora/``: LoRA Linear +
``mark_only_lora_as_trainable``).

A LoRA'd linear is an ``nn.Linear`` that carries two more parameters, ``lora_A`` (r, in)
and ``lora_B`` (out, r), peft's layout and the JAX ``lora_a`` (in, r) / ``lora_b`` (r,
out) transposed (``convert.py::params_from_jax`` maps them). ``lora_linear_apply`` adds
the low-rank update scaled by alpha / r; ``lora_param_filter`` leaves ``requires_grad`` on
the LoRA factors (and the listed extras) only, which the trainer reads;
``merge_lora`` folds the factors into the weights for serving.

A library, as in the JAX package: no model or trainer calls it (the JAX ``bin/train`` and
``Trainer`` never do), and a module's own ``forward`` ignores the factors.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from funasr_tpu_torch.core.layers import apply_linear


def lora_init(linear: nn.Linear, r: int = 8,
              generator: Optional[torch.Generator] = None) -> nn.Linear:
    """Attach ``lora_A`` (normal / r, drawn as the JAX (in, r) array from ``generator``
    on its device, then transposed) and ``lora_B`` (zeros) to ``linear``; returns it."""
    d_out, d_in = linear.weight.shape
    dev = generator.device if generator is not None else linear.weight.device
    a = torch.randn(d_in, r, generator=generator, device=dev) * (1.0 / r)
    w = linear.weight
    linear.lora_A = nn.Parameter(a.T.contiguous().to(w.device, w.dtype))
    linear.lora_B = nn.Parameter(torch.zeros(d_out, r, device=w.device, dtype=w.dtype))
    return linear


def lora_linear_apply(linear: nn.Linear, x, r: int = 8, alpha: int = 16):
    """The base linear plus alpha / r x (x A^T) B^T, each product in x's dtype."""
    y = apply_linear(linear, x)
    h = F.linear(x, linear.lora_A.to(x.dtype))
    h = F.linear(h, linear.lora_B.to(x.dtype))
    return y + (alpha / r) * h


def inject_lora(module: nn.Module, generator: Optional[torch.Generator] = None,
                targets: Sequence[str] = ("linear_q_k_v", "linear_out"),
                r: int = 8) -> List[str]:
    """``lora_init`` on every ``nn.Linear`` whose dotted name holds one of ``targets``,
    in ``named_modules`` order; returns their names."""
    names = []
    for name, mod in module.named_modules():
        if isinstance(mod, nn.Linear) and any(t in name for t in targets):
            lora_init(mod, r, generator)
            names.append(name)
    return names


def lora_param_filter(module: nn.Module, extra_trainable: Sequence[str] = ()) -> List[str]:
    """``requires_grad`` on for the LoRA factors and every parameter whose name holds one
    of ``extra_trainable``, off elsewhere (the JAX filter's mask, which ``optax.masked``
    reads there); returns the trainable names."""
    trainable = []
    for name, p in module.named_parameters():
        keep = (name.rsplit(".", 1)[-1].startswith("lora_")
                or any(e in name for e in extra_trainable))
        p.requires_grad_(keep)
        if keep:
            trainable.append(name)
    return trainable


@torch.no_grad()
def merge_lora(module: nn.Module, r: int = 8, alpha: int = 16) -> nn.Module:
    """Fold each linear's factors into its weight (W += alpha / r x B A) and drop them."""
    for mod in module.modules():
        if isinstance(mod, nn.Linear) and hasattr(mod, "lora_A"):
            delta = (alpha / r) * (mod.lora_B.float() @ mod.lora_A.float())
            mod.weight.add_(delta.to(mod.weight.dtype))
            del mod.lora_A, mod.lora_B
    return module
