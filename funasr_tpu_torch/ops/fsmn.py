"""FSMN memory block: a hand-written Hopper kernel and its plain PyTorch version.

    out = mask * (dwconv(mask * x) + mask * x)

Replaces the TPU kernel ``benchmarks/bench_pallas_dwconv.py::dw_pallas`` (the FSMN
depthwise conv1d, bit-exact to ``funasr_tpu/core/layers.py::depthwise_conv1d_apply``),
fused with the mask / residual / mask passes of ``funasr_tpu/models/sanm/attention.py``
``_fsmn`` (encoder) and ``fsmn_decoder_apply`` (decoder), which compute this same
function. The CUDA source, ``funasr_tpu_torch/csrc/fsmn.cu``, notes what bounds it on the
H100 (device-memory bandwidth: 23 flops per element for k = 11; 7.5 us of bytes at
(32, 384, 512) bf16, where the first port took 0.0488 ms) and what its design does about
it: 16-byte loads and stores of 8 bf16 or 4 fp32 channels per thread, k and the pads as
template parameters (11 and 5 on the SAN-M path, 20 and 19 for the VAD's fp32 causal
memory, 21 and 10 for the SeACo decoder's memory at 4 channels a thread, so that bf16's
window and taps fit in registers too; a generic instantiation for the rest) so the
k-vector input window stays in registers and loads run several rows ahead, the weights
read once per thread, the mask once per warp and row (as ballot bits), and the three
elementwise passes fused away.

Taps accumulate in fp32; the conv sum is rounded to x's dtype before the residual is
added, and the sum rounded again, in the JAX functions' order.

On CUDA the kernel moves 16-byte vectors, so x's base must be 16-byte aligned and C and
x's batch / time strides multiples of 16 bytes / element size (8 bf16, 4 fp32): the
path's inputs are (the v slice at offset 2C of q|k|v, the decoder's contiguous input);
anything else raises ``ValueError``.

Dispatch: a CPU tensor takes ``fsmn_memory_ref``; a CUDA tensor launches the kernel or
raises. ``fsmn_memory.launches`` counts kernel launches. ``generic=True`` launches the
generic instantiation whatever k is, to time a specialised one against it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from funasr_tpu_torch.ops import cuda_lib

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_KERNEL = 64
TIME_STEPS = 24 * 4  # time steps per block (csrc/fsmn.cu: TT x WARPS)


def _masked(x, mask):
    return x if mask is None else x * mask[..., None].to(x.dtype)


def fsmn_memory_ref(x, weight, mask, left_pad: int, right_pad: int):
    """Plain PyTorch version. x (B, T, C); weight (C, 1, k) (torch depthwise Conv1d);
    mask (B, T) bool, True = valid, or None -> (B, T, C) in x's dtype."""
    c, k = weight.shape[0], weight.shape[-1]
    x = _masked(x, mask)
    pad = F.pad(x.float(), (0, 0, left_pad, right_pad))
    w = weight.reshape(c, k).float()
    t = x.shape[1]
    acc = torch.zeros(pad.shape[0], t, c, dtype=torch.float32, device=x.device)
    for i in range(k):
        acc = acc + pad[:, i : i + t] * w[:, i]
    return _masked(acc.to(x.dtype) + x, mask)


def _check(x, weight, mask, left_pad, right_pad):
    if x.dtype not in _DTYPES or weight.dtype != x.dtype:
        raise TypeError(f"fsmn_memory takes float32 or bfloat16 x and weight of one dtype, "
                        f"got {x.dtype}, {weight.dtype}")
    if x.dim() != 3 or x.stride(2) != 1:
        raise ValueError(f"x must be (B, T, C) with unit channel stride, got "
                         f"{tuple(x.shape)} strides {x.stride()}")
    b, t, c = x.shape
    k = weight.shape[-1]
    if weight.shape not in ((c, 1, k), (c, k)) or weight.device != x.device:
        raise ValueError(f"weight must be ({c}, 1, k) on {x.device}, got "
                         f"{tuple(weight.shape)} on {weight.device}")
    if not 1 <= k <= MAX_KERNEL or left_pad < 0 or right_pad < 0 or left_pad + right_pad != k - 1:
        raise ValueError(f"need 1 <= k <= {MAX_KERNEL} and pads summing to k - 1, got "
                         f"k={k}, pads=({left_pad}, {right_pad})")
    if b > 65535 or -(-t // TIME_STEPS) > 65535:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's grid")
    if mask is not None and (mask.dtype != torch.bool or mask.shape != (b, t)
                             or mask.device != x.device):
        raise ValueError(f"mask must be a ({b}, {t}) bool tensor on {x.device}")
    vec = 16 // x.element_size()  # the kernel moves 16-byte vectors
    if c % vec or x.stride(0) % vec or x.stride(1) % vec or x.data_ptr() % 16:
        raise ValueError(f"the FSMN kernel needs C and x's batch / time strides multiples of "
                         f"{vec} and a 16-byte aligned base; got C={c}, strides {x.stride()}, "
                         f"base offset {x.data_ptr() % 16}")


def fsmn_memory(x, weight, mask, left_pad: int, right_pad: int, *, generic: bool = False):
    """x (B, T, C) (any batch/time strides, unit channel stride); weight (C, 1, k) in
    x's dtype; mask (B, T) bool or None -> contiguous (B, T, C) in x's dtype."""
    if x.device.type == "cpu":
        return fsmn_memory_ref(x, weight, mask, left_pad, right_pad)
    if x.device.type != "cuda":
        raise ValueError(f"fsmn_memory runs on CPU or CUDA tensors, not {x.device}")
    _check(x, weight, mask, left_pad, right_pad)
    b, t, c = x.shape
    k = weight.shape[-1]
    w = weight.reshape(c, k).contiguous()
    if w.data_ptr() % 16:  # a view at an odd offset: the kernel reads 16-byte vectors
        w = w.clone()
    m = None if mask is None else mask.contiguous()
    out = torch.empty((b, t, c), dtype=x.dtype, device=x.device)
    lib = cuda_lib.load_library()
    fsmn_memory.launches += 1
    err = (lib.fsmn_memory_generic_fwd if generic else lib.fsmn_memory_fwd)(
        _DTYPES[x.dtype], x.data_ptr(), w.data_ptr(),
        None if m is None else m.data_ptr(), out.data_ptr(), b, t, c, k, left_pad,
        x.stride(0), x.stride(1), cuda_lib.stream_handle(x.device))
    cuda_lib.check(err, "fsmn_memory_fwd")
    return out


fsmn_memory.launches = 0
