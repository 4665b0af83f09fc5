"""Int8 quantization for serving (counterpart of ``funasr_tpu/ops/quant.py``).

Two layouts of a quantized ``nn.Linear``, both held by ``Int8Linear`` (per-output-channel
symmetric int8 weights in torch layout ``(out, in)`` with an fp32 ``scale (out,)``):

* ``w_q``: weight-only int8 (activations stay float; the bandwidth play);
* ``w_q8``: W8A8, activations quantized per row at run time and the product run in
  int8 -> int32 (the compute play for batched offline serving). On CUDA it runs the
  hand-written kernel of ``ops/w8a8.py``.

``quantize_params_int8(model, mode=...)`` swaps, in place, the large ``nn.Linear``s that
the JAX function quantizes in a parameter tree: inside a layer the JAX package stacks for
``lax.scan``, only those under a known linear name (``LINEAR3_KEYS``).

Numerics copied from the JAX package:

* Weights are quantized in their own dtype: on the bf16 path ``scale = max|w| / 127``
  and ``w / scale`` are bf16, then ``scale`` is cast to fp32 (``quant.py:36-39``, after
  ``auto_model.py:249-251``'s cast). The divisions are true divisions on every device
  (JAX quantizes eagerly; PyTorch on CUDA would turn ``t / 127.0`` into a product with
  the reciprocal).
* ``Int8Linear.scale`` stays fp32 when the module is cast (``cast_floats`` /
  ``Module.to(bfloat16)``); only the bias follows the cast.
* Weight-only int8 multiplies the fp32 product by ``scale`` before any rounding
  (``quant.py:93-95``): the product runs in fp32, not in x's dtype.
"""

from __future__ import annotations

import torch
from torch import nn

from funasr_tpu_torch.core.layers import linear
from funasr_tpu_torch.ops.w8a8 import quantize_rows_int8 as _quantize_rows_int8  # noqa: F401
from funasr_tpu_torch.ops.w8a8 import w8a8_linear

_KEYS = {"weight_only": "w_q", "w8a8": "w_q8"}

# The leaf names the JAX package quantizes inside a scan-stacked layer (``quant.py``'s
# ``_LINEAR3_KEYS``: a stacked (L, in, out) kernel looks like a conv kernel, so it is
# quantized only under a known linear name).
LINEAR3_KEYS = frozenset({
    "linear_q_k_v", "linear_out", "linear_q", "linear_k_v", "w_1", "w_2",
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj",
})
# the layer lists the JAX package stacks for ``lax.scan`` (``convert.py``'s ``_STACKED``)
STACKED_LISTS = frozenset({"encoders", "decoders", "decoders2", "tp_encoders"})


def scan_stacked(model: nn.Module, name: str) -> bool:
    """Whether the JAX package holds the module ``name`` inside a scan-stacked layer: under
    an ``nn.ModuleList`` named in ``STACKED_LISTS`` whose owner does not set
    ``SCAN_STACKED = False`` (the convolution decoders keep a plain list), or in the
    owner's own ``SCAN_STACKED_LISTS`` (``RWKVEncoder``'s ``blocks``)."""
    parts = name.split(".")
    for i in range(1, len(parts)):
        if not parts[i].isdigit():
            continue
        owner = model.get_submodule(".".join(parts[: i - 1]))
        if (parts[i - 1] in STACKED_LISTS and getattr(owner, "SCAN_STACKED", True)
                or parts[i - 1] in getattr(owner, "SCAN_STACKED_LISTS", ())):
            return True
    return False


class Int8Linear(nn.Module):
    """A linear layer quantized to int8: buffer ``w_q8`` (W8A8) or ``w_q`` (weight-only),
    int8 ``(out, in)``; buffer ``scale`` fp32 ``(out,)``; parameter ``bias`` or None."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 key: str = "w_q8", device=None):
        super().__init__()
        if key not in _KEYS.values():
            raise ValueError(f"key must be one of {sorted(_KEYS.values())}, got {key!r}")
        self.in_features, self.out_features, self.key = in_features, out_features, key
        self.register_buffer(key, torch.zeros((out_features, in_features), dtype=torch.int8,
                                              device=device))
        self.register_buffer("scale", torch.ones(out_features, dtype=torch.float32,
                                                 device=device))
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_features, device=device))
        else:
            self.register_parameter("bias", None)

    @property
    def weight_q(self) -> torch.Tensor:
        return getattr(self, self.key)

    def forward(self, x):
        return qlinear(self, x)

    def _apply(self, fn, recurse=True):
        # ``scale`` follows the module's device but never its dtype: casting it to bf16
        # would round the scales that the int8 weights were quantized against
        scale = self._buffers.pop("scale")
        try:
            super()._apply(fn, recurse)
        finally:
            self._buffers["scale"] = scale
        target = fn(torch.empty(0, dtype=torch.float32, device=scale.device)).device
        self._buffers["scale"] = scale.to(target)
        return self

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"key={self.key}, bias={self.bias is not None}")


def quantize_linear_int8(lin: nn.Linear, key: str = "w_q") -> Int8Linear:
    """``nn.Linear`` -> ``Int8Linear`` (``quant.py::quantize_linear_int8``): per-output
    channel ``scale = max(max|w| / 127, 1e-12)`` and ``w_q = clip(round(w / scale))``,
    in the weight's dtype; ``scale`` then fp32. The bias is kept as it is."""
    w = lin.weight.detach()
    scale = torch.clamp_min(w.abs().amax(dim=1) / torch.full_like(w[:, 0], 127.0), 1e-12)
    w_q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    out = Int8Linear(lin.in_features, lin.out_features, lin.bias is not None, key,
                     device=w.device)
    with torch.no_grad():
        out.weight_q.copy_(w_q)
        out.scale.copy_(scale.float())
        if lin.bias is not None:
            out.bias = nn.Parameter(lin.bias.detach().clone())
    return out


def dequantize_linear_int8(mod: Int8Linear) -> nn.Linear:
    """Inverse of :func:`quantize_linear_int8` (for inspection and tests): an fp32
    ``nn.Linear`` with ``weight = w_q * scale``."""
    lin = nn.Linear(mod.in_features, mod.out_features, mod.bias is not None,
                    device=mod.scale.device)
    with torch.no_grad():
        lin.weight.copy_(mod.weight_q.float() * mod.scale[:, None])
        if mod.bias is not None:
            lin.bias.copy_(mod.bias)
    return lin


def qlinear(mod, x):
    """Linear apply for the three layouts (``quant.py::qlinear``); output in x's dtype.

    * ``nn.Linear`` (``{"w"}``): ``core/layers.py::linear``;
    * ``Int8Linear`` ``w_q`` (weight-only): fp32 product of x and the int8 weights,
      times ``scale``, plus the bias, rounded once;
    * ``Int8Linear`` ``w_q8`` (W8A8): ``ops/w8a8.py::w8a8_linear`` (the kernel on CUDA,
      its plain version on the CPU).
    """
    if isinstance(mod, nn.Linear):
        return linear(x, mod.weight, mod.bias)
    if mod.key == "w_q8":
        return w8a8_linear(x, mod.w_q8, mod.scale, mod.bias)
    y = torch.matmul(x.float(), mod.w_q.float().T) * mod.scale
    if mod.bias is not None:
        y = y + mod.bias.float()
    return y.to(x.dtype)


def quantize_params_int8(model: nn.Module, min_dim: int = 256,
                         mode: str = "weight_only") -> nn.Module:
    """Swap, in place and under the same attribute name, every ``nn.Linear`` that the JAX
    package quantizes (``quant.py::quantize_params_int8``) for an ``Int8Linear``: its
    smaller dimension >= ``min_dim``, no ``embed`` in its qualified name, and, inside a
    layer the JAX package stacks for ``lax.scan`` (``scan_stacked``), a leaf name in
    ``LINEAR3_KEYS``. Returns ``model``.

    ``mode``: "weight_only" (``w_q``) or "w8a8" (``w_q8``). Under "w8a8" the logits
    projection (``output_layer`` / ``lm_head``) stays weight-only (``w_q``): per-row
    int8 activations there reorder the argmax. Convolutions are never swapped."""
    key = _KEYS[mode]
    targets = [(name, mod) for name, mod in model.named_modules()
               if isinstance(mod, nn.Linear) and "embed" not in name
               and min(mod.in_features, mod.out_features) >= min_dim
               and (name.rpartition(".")[2] in LINEAR3_KEYS or not scan_stacked(model, name))]
    for name, mod in targets:
        parent_name, _, leaf = name.rpartition(".")
        parent = model.get_submodule(parent_name)
        k = "w_q" if leaf in ("output_layer", "lm_head") else key
        setattr(parent, leaf, quantize_linear_int8(mod, key=k))
    return model


def quantized_bytes(model: nn.Module) -> int:
    """Total bytes of the model's parameters and buffers (for reporting compression)."""
    return sum(t.numel() * t.element_size() for t in model.state_dict().values())
