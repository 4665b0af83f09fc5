"""W8A8 linear: a hand-written Hopper kernel and its plain PyTorch version.

    x_q, sx = quantize_rows_int8(x)
    y = fma(float(x_q @ w_q8.T), sx * scale, bias)    rounded once to x's dtype

Replaces the TPU kernel ``benchmarks/bench_pallas_w8a8.py::w8a8_matmul`` (per-row int8
quantization of x fused with an int8 x int8 -> int32 GEMM and a scale epilogue). The
numerics are those of the path the kernel serves, ``funasr_tpu/ops/quant.py::qlinear``'s
``w_q8`` branch, as the JAX package runs it (jitted, ``_infer_program``):

* ``sx = max(max|x|, 1e-6) * fl(1/127)``: under jit XLA rewrites the division by the
  constant 127 (``quant.py:60``) into this product; eager JAX divides and differs in
  the last bit for ~3 % of rows. (The Pallas body's ``* (1.0 / 127.0)`` is the same.)
* ``x / sx`` stays an IEEE division; ``round`` is half to even; clamp to +-127.
* The bias add contracts with the scale product into one fma (XLA's CPU fusion); with
  no bias, ``float(acc) * (sx * scale)``.

The CUDA source, ``funasr_tpu_torch/csrc/w8a8.cu``, notes what bounds it on the H100
(bytes at the path's shapes, most of them the output) and its design: a row-quantize
kernel that reads each row once into an int8 scratch, then a persistent ``wgmma`` s8
GEMM fed by TMA from one producer warp, whose two consumer warpgroups take alternate
tiles so that one's scale / bias epilogue (staged in shared memory, written by TMA
stores) overlaps the other's products. It is bit-exact to ``w8a8_linear_ref``.
``plan_w8a8`` holds the wrapper's shape arithmetic (paddings).

Dispatch: a CPU tensor takes ``w8a8_linear_ref``; a CUDA tensor launches the kernel or
raises. ``w8a8_linear.launches`` counts kernel launches.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from funasr_tpu_torch.ops import cuda_lib

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BIAS_DTYPES = {torch.float32: 1, torch.bfloat16: 2}
INV127 = 1.0 / 127.0  # fl32(1/127) when a float32 tensor is multiplied by it


@dataclass(frozen=True)
class W8A8Plan:
    """The paddings of one (M, K, N) call."""

    kp: int            # K rounded up to 16: the TMA row pitch of x_q and of the weights
    pad_weights: bool  # K % 16 != 0: the weights are copied into an (N, kp) zero buffer
    out_pitch: int     # output row pitch in elements: N rounded up to 16 bytes


def plan_w8a8(m: int, k: int, n: int, dtype: torch.dtype) -> W8A8Plan:
    kp = -(-k // 16) * 16
    per16 = 16 // dtype.itemsize
    return W8A8Plan(kp=kp, pad_weights=kp != k, out_pitch=-(-n // per16) * per16)


def quantize_rows_int8(x):
    """Dynamic symmetric per-row int8 quantization (``quant.py::_quantize_rows_int8`` as
    jitted): x (..., K) float -> (x_q int8 (..., K), sx fp32 (..., 1)), x ~= x_q * sx."""
    xf = x.float()
    sx = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-6) * INV127
    x_q = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return x_q, sx


def w8a8_linear_ref(x, w_q8, scale, bias=None):
    """Plain PyTorch version. x (..., K) fp32 or bf16; w_q8 (N, K) int8; scale (N,)
    fp32; bias (N,) float or None -> (..., N) in x's dtype.

    The integer product runs in float64, exact while |sum| < 2^53 (K < 5.5e11); the fma
    is float64 product + add rounded once to float32 (the product of two floats is exact
    in float64)."""
    x_q, sx = quantize_rows_int8(x)
    acc = torch.matmul(x_q.double(), w_q8.double().T).float()
    s = sx * scale.float()
    if bias is None:
        y = acc * s
    else:
        y = (acc.double() * s.double() + bias.double()).float()
    return y.to(x.dtype)


def _check(x, w_q8, scale, bias):
    if x.dtype not in _DTYPES:
        raise TypeError(f"w8a8_linear takes float32 or bfloat16 x, got {x.dtype}")
    if w_q8.dtype != torch.int8 or w_q8.dim() != 2 or w_q8.shape[1] != x.shape[-1]:
        raise ValueError(f"w_q8 must be int8 (N, {x.shape[-1]}), got {w_q8.dtype} "
                         f"{tuple(w_q8.shape)}")
    n = w_q8.shape[0]
    if scale.dtype != torch.float32 or scale.shape != (n,):
        raise ValueError(f"scale must be float32 ({n},), got {scale.dtype} {tuple(scale.shape)}")
    if bias is not None and (bias.dtype not in _BIAS_DTYPES or bias.shape != (n,)):
        raise ValueError(f"bias must be float32 or bfloat16 ({n},), got {bias.dtype} "
                         f"{tuple(bias.shape)}")
    for name, t in (("w_q8", w_q8), ("scale", scale), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def w8a8_linear(x, w_q8, scale, bias=None):
    """x (..., K) fp32 or bf16 (any row stride); w_q8 (N, K) int8; scale (N,) fp32;
    bias (N,) fp32 / bf16 or None -> contiguous (..., N) in x's dtype.

    On CUDA, x is viewed as (M, K) rows (copied only if that view needs a non-unit column
    stride); the wrapper allocates the (M, Kp) int8 rows x_q and the (M,) fp32 row scales
    that the kernel fills (``plan_w8a8``)."""
    if x.device.type == "cpu":
        return w8a8_linear_ref(x, w_q8, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"w8a8_linear runs on CPU or CUDA tensors, not {x.device}")
    _check(x, w_q8, scale, bias)
    k, n = x.shape[-1], w_q8.shape[0]
    x2 = x.reshape(-1, k)
    if x2.stride(1) != 1:
        x2 = x2.contiguous()
    m = x2.shape[0]
    if m == 0:
        return torch.empty((*x.shape[:-1], n), dtype=x.dtype, device=x.device)
    p = plan_w8a8(m, k, n, x.dtype)
    x_q = torch.empty((m, p.kp), dtype=torch.int8, device=x.device)
    sx = torch.empty(m, dtype=torch.float32, device=x.device)
    out = torch.empty((m, p.out_pitch), dtype=x.dtype, device=x.device)
    w = F.pad(w_q8, (0, p.kp - k)) if p.pad_weights else w_q8.contiguous()
    if w.data_ptr() % 16:  # TMA reads from a 16-byte aligned base
        w = w.clone()
    sc = scale.contiguous()
    b = None if bias is None else bias.contiguous()
    lib = cuda_lib.load_library()
    w8a8_linear.launches += 1
    err = lib.w8a8_linear_fwd(
        _DTYPES[x.dtype], x2.data_ptr(), x2.stride(0), w.data_ptr(), sc.data_ptr(),
        None if b is None else b.data_ptr(), 0 if b is None else _BIAS_DTYPES[b.dtype],
        x_q.data_ptr(), sx.data_ptr(), out.data_ptr(), p.out_pitch, m, n, k, p.kp,
        cuda_lib.sm_count(x.device.index), cuda_lib.stream_handle(x.device))
    cuda_lib.check(err, "w8a8_linear_fwd")
    if p.out_pitch != n:
        out = out[:, :n].contiguous()
    return out.view(*x.shape[:-1], n)


w8a8_linear.launches = 0
