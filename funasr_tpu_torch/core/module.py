"""Parameter utilities of the port (counterpart of ``funasr_tpu/core/module.py``)."""

from __future__ import annotations

import math

import torch
from torch import nn


def cast_floats(module: nn.Module, dtype) -> nn.Module:
    """Cast floating-point parameters and buffers to ``dtype`` (bf16 weights for
    serving, as ``bench.py:127`` casts the JAX params); integer tensors are kept."""
    return module.to(dtype)


def _fill(param, sample):
    with torch.no_grad():
        param.copy_(sample.to(param.device, param.dtype))


def maybe_dropout(x, rate: float, training: bool, generator=None):
    """Inverted dropout (``funasr_tpu/core/module.py::maybe_dropout``): each element kept
    with probability 1 - rate and scaled by 1 / (1 - rate), the keep-mask drawn from
    ``generator`` (a ``torch.Generator`` on x's device). The identity outside training,
    at rate 0 or without a generator, as the JAX function is without a key: a module
    left in ``train()`` mode still decodes deterministically."""
    if not training or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise every weight from ``generator``, with the JAX package's init rules:
    Linear, Conv1d / Conv2d and ConvTranspose1d weights and biases uniform in
    +-1/sqrt(fan_in) (torch defaults, ``core/layers.py::linear_init`` / ``conv1d_init`` /
    ``depthwise_conv1d_init`` / ``conv_transpose1d_init``; the fan-in of a transposed
    conv's (C_in, C_out, K) weight is C_out * K, JAX's C_in * K where they are equal), LSTM
    weights and biases uniform in +-1/sqrt(hidden) (``lstm_init``), Embedding standard
    normal, LayerNorm ones and zeros; BatchNorm keeps its defaults; a module with an
    ``init_from(generator)`` method draws its own bare tensors there. Samples are drawn on the generator's device and copied, so
    a CPU generator initialises a model on any device identically.
    """
    dev = generator.device
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            for p in (m.weight, m.bias):
                if p is not None:
                    _fill(p, torch.empty(p.shape, device=dev).uniform_(
                        -bound, bound, generator=generator))
        elif isinstance(m, nn.LSTM):
            bound = 1.0 / math.sqrt(m.hidden_size)
            for p in m.parameters():
                _fill(p, torch.empty(p.shape, device=dev).uniform_(
                    -bound, bound, generator=generator))
        elif isinstance(m, nn.Embedding):
            _fill(m.weight, torch.randn(m.weight.shape, device=dev, generator=generator))
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif hasattr(m, "init_from"):  # a module's own tensors (attention position biases)
            m.init_from(generator)
    return module
