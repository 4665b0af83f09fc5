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
(int8 tensor-core throughput at the path's shapes) and its design (a row-quantize
kernel into a padded int8 scratch, then a ``mma.sync`` s8 GEMM with a 4-stage
``cp.async`` ring and the fused epilogue). It is bit-exact to ``w8a8_linear_ref``.

Dispatch: a CPU tensor takes ``w8a8_linear_ref``; a CUDA tensor launches the kernel or
raises. ``w8a8_linear.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from funasr_tpu_torch.ops import cuda_lib

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BIAS_DTYPES = {torch.float32: 1, torch.bfloat16: 2}
# x_q scratch padding: BM rows and BK columns of csrc/w8a8.cu
_BM, _BK = 128, 64
INV127 = 1.0 / 127.0  # fl32(1/127) when a float32 tensor is multiplied by it


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
    stride); the wrapper allocates the padded (Mp, Kp) int8 scratch of x_q and the (Mp,)
    row scales the kernel fills."""
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
    out = torch.empty((*x.shape[:-1], n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    mp, kp = -(-m // _BM) * _BM, -(-k // _BK) * _BK
    if mp // _BM > 65535:
        raise ValueError(f"{m} rows exceed the kernel's grid")
    x_q = torch.empty((mp, kp), dtype=torch.int8, device=x.device)
    sx = torch.empty((mp,), dtype=torch.float32, device=x.device)
    w = w_q8.contiguous()
    b = None if bias is None else bias.contiguous()
    lib = cuda_lib.load_library()
    w8a8_linear.launches += 1
    err = lib.w8a8_linear_fwd(
        _DTYPES[x.dtype], x2.data_ptr(), x2.stride(0), w.data_ptr(), scale.contiguous().data_ptr(),
        None if b is None else b.data_ptr(), 0 if b is None else _BIAS_DTYPES[b.dtype],
        x_q.data_ptr(), sx.data_ptr(), out.data_ptr(), m, n, k, mp, kp,
        cuda_lib.stream_handle(x.device))
    cuda_lib.check(err, "w8a8_linear_fwd")
    return out


w8a8_linear.launches = 0
