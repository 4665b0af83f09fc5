"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA kernels, holds each
against its plain PyTorch version, checks the port on CUDA against the port on the CPU,
and drives the offline Paraformer decode, ``AutoModel(quant="w8a8")`` and the default
(fp32) ``AutoModel`` at Paraformer-large width.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. device: CUDA must be available; prints ``nvidia-smi`` name and power limit;
2. build: compiles ``funasr_tpu_torch/csrc/*.cu`` with nvcc, one process per source in
   parallel (seconds printed);
3. kernels: flash attention at (32, 4, 384, 128) and (1, 4, 1408, 128), bf16 and fp32,
   ragged lengths, valid query rows; FSMN memory at (32, 384, 512) and (32, 208, 512),
   k = 11; each against its plain version;
4. w8a8 kernel: the W8A8 linear at every (M, K, N) of the W8A8 path (ragged K = 560 and
   M = 720 included), bf16 and fp32 x, bit-exact to its plain version (a mismatch
   raises);
5. CUDA vs CPU: a small config (2 + 2 blocks, d = 64), same weights, fp32: token ids
   equal, encoder output within ``CPU_GPU_ENC_TOL``; then d = 256 under W8A8 (the
   kernel on CUDA, its plain version on the CPU): every W8A8 call of the CUDA decode
   bit-exact to the plain version on its own input, encoder within
   ``W8A8_ENC_REL_TOL`` relative L2, token agreement printed (see the constants);
6. main path: Paraformer-large width (``bench.py``'s PROD_CONF: 50 encoder blocks,
   16 decoder blocks, vocab 8404) in bf16 with seeded random weights: 32 x 15 s int16
   PCM and one 70 s utterance through WavFrontend -> model.inference -> text; the
   kernel launch counts of that run must show every encoder attention and every FSMN
   block went through the kernels; RTFx at B = 32 x 15 s, and one decode under
   torch.profiler: device time by kernel and the device's idle share;
7. AutoModel (``phase_automodel``): a model directory at PROD_CONF width (config.yaml,
   8404 tokens, identity am.mvn, model.pt of a seeded port Paraformer) through
   ``AutoModel(model=dir, device="cuda", bf16=True, quant="w8a8", batch_size=32)
   .generate(32 x 15 s int16 PCM)``: 32 non-empty texts, finite scores, and launch
   counts of >= 282 W8A8 linears, 50 flash and 66 FSMN per decode; RTFx; then the same
   directory at ``quant=None`` in the same call: its RTFx and the token agreement
   (printed, not gated: with random weights the argmax margins are degenerate,
   ``tests/test_w8a8_production.py``); one profiled ``generate`` of each; then the
   public default from the same directory, ``AutoModel(model=dir, device="cuda",
   batch_size=32)`` (no bf16, no quant: fp32): 32 non-empty texts, finite scores, >= 50
   flash and >= 66 FSMN launches per decode, and its profile showing them in the fp32
   kernels (``FP32_KERNELS``); RTFx and one profiled ``generate``.

Kernel times (phases 3-4): ``ms`` is device time per launch over 20 back-to-back
launches between one pair of CUDA events, queued behind a spin kernel so that host
overhead leaves no gaps (``device_ms``, median of 5); ``call_ms`` one lone call
between events, so the wrapper's host overhead is in it; ``plain_ms`` the plain PyTorch
version and ``library_ms`` one PyTorch call computing the same function
(``LIBRARY_CALLS``; for W8A8 the integer product alone, with cuBLAS bf16 ``F.linear``
beside it as ``cublas_bf16_ms``), both timed like ``ms``; ``bound_ms`` the least time
the card could take (``bound_ms()``, from the bytes and operations of ``*_work()`` at
the H100's published peaks; fp32 flash on the 3xTF32 route, ``flash_bound()``, with the
CUDA-core figure beside it as ``cuda_core_bound_ms``). The W8A8 lines add its quantize / GEMM split from
torch.profiler. No L2 flush between launches: on the path each kernel reads what the
op before it just wrote.

The second-to-last line is the kernels' JSON record (``kernels_line``: each kernel at
its main path shape, with ``launches`` of the main path's run and
``launches_per_decode``; flash and FSMN add their fp32 figures under ``fp32``, launches
from the fp32 ``AutoModel`` decode), the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# tolerances of the kernel phase (kernel vs plain on the same inputs, max abs error)
FLASH_TOL = {torch.float32: 1e-4,    # fp32 products, sums in another order
             torch.bfloat16: 2e-2}   # bf16 output rounding + P rounded to bf16
FSMN_TOL = {torch.float32: 1e-5,     # fp32 taps, FMA vs separate multiply-add
            torch.bfloat16: 2e-2}    # one bf16 ulp of outputs up to 4 in magnitude
CPU_GPU_ENC_TOL = 1e-3               # fp32 encoder output, cuBLAS vs CPU sum order
# W8A8, CUDA vs CPU (d = 256): the fp32 ops upstream of each W8A8 linear (LayerNorm,
# attention, cuBLAS) differ in the last bits between the devices, and an activation that
# sits within that of a rounding boundary of x / sx moves its int8 value by one. At
# this config 3 of 126,000 first-layer activations do so for most inputs, and the
# difference grows through the quantized layers: encoder drift 2.0e-3-3.5e-3 relative L2
# over 12 input seeds on the H100 (1.8e-7 where none crosses), with random-weight argmax
# margins that flip tokens. So the kernel is held bit-exact per call on the path's own
# activations, the drift to a bound above the measured range, and the agreement only
# against a broken path (random tokens agree 1 in 304).
W8A8_ENC_REL_TOL = 1e-2
W8A8_MIN_AGREEMENT = 0.5
W8A8_TOL = 0                         # the W8A8 kernel is bit-exact to its plain version

PROD_CONF = dict(
    input_size=560, vocab_size=8404,
    encoder_conf=dict(output_size=512, attention_heads=4, linear_units=2048,
                      num_blocks=50, kernel_size=11, sanm_shfit=0, dropout_rate=0.0),
    decoder_conf=dict(attention_heads=16, linear_units=2048, num_blocks=16,
                      att_layer_num=16, kernel_size=11, sanm_shfit=0),
    predictor_conf=dict(idim=512, l_order=1, r_order=1, tail_threshold=0.45),
    sos=1, eos=2, predictor_bias=1)

SMALL_CONF = dict(
    input_size=560, vocab_size=41,
    encoder_conf=dict(output_size=64, attention_heads=4, linear_units=96, num_blocks=2),
    decoder_conf=dict(attention_heads=4, linear_units=96, num_blocks=2, att_layer_num=2,
                      sanm_shfit=0),
    predictor_conf=dict(idim=64), sos=1, eos=2, predictor_bias=1)

# the W8A8 CUDA-vs-CPU config: every linear large enough to quantize (min dim 256)
D256_CONF = dict(
    input_size=560, vocab_size=304,
    encoder_conf=dict(output_size=256, attention_heads=4, linear_units=256, num_blocks=2),
    decoder_conf=dict(attention_heads=4, linear_units=256, num_blocks=2, att_layer_num=2,
                      sanm_shfit=0),
    predictor_conf=dict(idim=256), sos=1, eos=2, predictor_bias=1)

FRONTEND_CONF = dict(fs=16000, n_mels=80, lfr_m=7, lfr_n=6, cmvn_file=None, dither=0.0)

# (M, K, N) of every W8A8 linear on the path at B = 32 x 15 s (encoder M = 32 x 384,
# decoder M = 32 x 208) and of the long-form decoder (M = 1408 / 2 + 16)
W8A8_SHAPES = [(12288, 560, 1536), (12288, 512, 1536), (12288, 512, 512), (12288, 512, 2048),
               (12288, 2048, 512), (6656, 512, 512), (6656, 512, 2048), (6656, 2048, 512),
               (12288, 512, 1024), (720, 512, 2048)]


def log(*args):
    print(*args, flush=True)


def device_ms(fn, launches=20, repeats=5, warmup=3):
    """Device time of one call: `launches` back-to-back calls between one pair of CUDA
    events, divided by their number; median over `repeats` after warm-up. A spin kernel
    ahead of the first event holds the stream until the host has queued every launch,
    so the wrapper's host overhead never leaves the device idle between them. If the
    spin had already ended when the host finished queueing, the repeat is dropped and
    the spin doubled."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times, spin = [], 1 << 21
    while len(times) < repeats:
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        e0.record()
        for _ in range(launches):
            fn()
        e1.record()
        starved = e0.query() and spin < 1 << 31
        e1.synchronize()
        if starved:
            spin *= 2
        else:
            times.append(e0.elapsed_time(e1) / launches)
    return statistics.median(times)


def call_ms(fn, iters=20, warmup=3):
    """Wall time of one lone call, host overhead included (the wrapper's checks, ctypes
    marshalling, allocations): CUDA events around each single call; median."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def wall_ms(fn, runs=5):
    """Host-clock wall time of `fn` ending in a synchronize: (median ms, all runs)."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def profile_kernels(fn, calls=1):
    """Device time in ms and launches of each kernel over `calls` calls of `fn`, from
    torch.profiler: {kernel name: (ms, launches)}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def profile_once(fn, label, wall):
    """One call of `fn` under torch.profiler: device kernel time in all and by kernel,
    and the device's idle share against `wall`, the unprofiled median wall ms. Returns
    {kernel name: (ms, launches)}."""
    by_name = profile_kernels(fn)
    kernels = sorted(((t, n, name) for name, (t, n) in by_name.items()), reverse=True)
    device = sum(t for t, _, _ in kernels)
    log(f"profile {label}: device kernel time {device:.2f} ms, unprofiled wall {wall:.2f} ms, "
        f"idle share {1 - device / wall:.1%}; by kernel (ms, launches):")
    for t, n, name in kernels[:14]:
        log(f"  {t:8.3f} {n:5d}  {name[:110]}")
    for group, keys in PORT_KERNELS.items():  # the port's kernels, all instantiations
        rows = [(t, n) for t, n, name in kernels if any(k in name for k in keys)]
        log(f"  port {group}: {sum(t for t, _ in rows):.3f} ms over {sum(n for _, n in rows)} "
            f"launches")
    return by_name


def kernel_totals(by_name, key):
    """(device ms, launches) summed over the profiled kernels whose name holds `key`."""
    rows = [v for name, v in by_name.items() if key in name]
    return sum(t for t, _ in rows), sum(n for _, n in rows)


# the device kernels of each wrapper, by name
PORT_KERNELS = {"flash_attention": ("flash_bf16_kernel", "flash_f32_kernel"),
                "fsmn_memory": ("fsmn_kernel",),
                "w8a8_linear": ("quantize_rows_kernel", "gemm_kernel")}
# the fp32 instantiations, which the default (fp32) AutoModel must launch
FP32_KERNELS = {"flash_attention": "flash_f32_kernel", "fsmn_memory": "fsmn_kernel<float"}


# NVIDIA H100 SXM, published dense peaks (data sheet) at the full 700 W power limit;
# "fp32" is the CUDA cores' rate, "tf32" the tensor cores'
H100_PEAK = {"bytes": 3.35e12, "bf16": 989e12, "int8": 1979e12, "tf32": 495e12,
             "fp32": 67e12}


def bound_ms(n_bytes, n_ops, op_type, peak=H100_PEAK):
    """The least time the card could take: the larger of the bytes over the memory rate
    and the operations over the peak rate of their type; (ms, "bytes" | "operations")."""
    t_bytes, t_ops = n_bytes / peak["bytes"] * 1e3, n_ops / peak[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_work(b, h, t, d, lengths, elem_bytes):
    """Bytes and flops of flash attention over (B, H, T, D): q read and o written in
    full, k and v read up to the keys each row needs (its length; all T keys for a
    length-0 row, which averages V), the int32 lengths; 4 T L D flops per head."""
    keys = [n if n > 0 else t for n in lengths]
    n_bytes = elem_bytes * h * d * sum(2 * t + 2 * n for n in keys) + 4 * b
    return n_bytes, 4 * h * t * d * sum(keys)


def flash_bound(b, h, t, d, lengths, dtype):
    """The flash bound (ms, by) for `dtype`. fp32 takes the card's fastest route to
    fp32-accurate products: the 3xTF32 split, three TF32 products per product, on the
    tensor cores."""
    n_bytes, n_ops = flash_work(b, h, t, d, lengths, 2 if dtype == torch.bfloat16 else 4)
    if dtype == torch.bfloat16:
        return bound_ms(n_bytes, n_ops, "bf16")
    return bound_ms(n_bytes, 3 * n_ops, "tf32")


def fsmn_work(b, t, c, k, elem_bytes):
    """Bytes and flops of the FSMN memory block: x read and out written once, the
    (C, k) taps, the bool mask; k multiply-adds and the residual add per element."""
    return elem_bytes * (2 * b * t * c + c * k) + b * t, (2 * k + 1) * b * t * c


def w8a8_work(m, k, n, x_bytes, bias_bytes):
    """Bytes and int8 operations of the W8A8 linear: x read, int8 weights, fp32 scales
    and the bias read, out (x's dtype) written; 2 M N K integer operations."""
    return m * k * x_bytes + n * k + 4 * n + bias_bytes * n + m * n * x_bytes, 2 * m * n * k


LIBRARY_CALLS = {
    "flash_attention": "torch.nn.functional.scaled_dot_product_attention(q, k, v, "
                       "attn_mask=key_valid[:, None, None, :])",
    "fsmn_memory": "torch.nn.functional.conv1d(xm, w, padding=5, groups=C)",
    "w8a8_linear": "torch._int_mm(x_q, w_q8.t())",
}


def pcm(rng, seconds, fs=16000):
    return np.asarray(rng.standard_normal(int(seconds * fs)) * 0.1 * 32767, np.int16)


def phase_kernels(dev):
    import torch.nn.functional as F
    from funasr_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref
    from funasr_tpu_torch.ops.fsmn import fsmn_memory, fsmn_memory_ref

    g = torch.Generator(device="cpu").manual_seed(0)
    record = {}
    for shape in ((32, 4, 384, 128), (1, 4, 1408, 128)):
        b, h, t, d = shape
        for dtype in (torch.bfloat16, torch.float32):
            # q | k | v as strided head views of one fused projection, as on the path
            qkv = torch.randn(b, t, 3, h, d, generator=g).to(dev, dtype)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            lens_list = [t - 37 * (i % 2) for i in range(b)]
            lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
            out = flash_attention(q, k, v, lens)
            torch.cuda.synchronize()
            ref = flash_attention_ref(q, k, v, lens)
            err = max((out[i, :, :n] - ref[i, :, :n]).abs().max().item()
                      for i, n in enumerate(lens_list))
            row = dict(shape=shape, max_abs_err=err,
                       ms=device_ms(lambda: flash_attention(q, k, v, lens)),
                       call_ms=call_ms(lambda: flash_attention(q, k, v, lens)),
                       plain_ms=device_ms(lambda: flash_attention_ref(q, k, v, lens)))
            row["bound_ms"], row["bound_by"] = flash_bound(b, h, t, d, lens_list, dtype)
            if dtype == torch.float32:  # the CUDA-core bound, beside the 3xTF32 one
                row["cuda_core_bound_ms"] = bound_ms(
                    *flash_work(b, h, t, d, lens_list, 4), "fp32")[0]
            key_valid = torch.arange(t, device=dev)[None, :] < lens[:, None].long()
            mask = key_valid[:, None, None, :]
            row["library_ms"] = device_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
            log(f"flash {shape} {str(dtype)[6:]}: max_abs_err {err:.3e} "
                f"(tol {FLASH_TOL[dtype]:g}) " + timing_line(row))
            if not (math.isfinite(err) and err <= FLASH_TOL[dtype]):
                raise AssertionError(f"flash kernel disagrees at {shape} {dtype}: {err}")
            if shape == (32, 4, 384, 128):
                record[("flash_attention", dtype)] = row

    for shape in ((32, 384, 512), (32, 208, 512)):
        b, t, c = shape
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(b, t, 3 * c, generator=g).to(dev, dtype)[..., 2 * c:]
            w = (torch.rand(c, 1, 11, generator=g) - 0.5).to(dev, dtype)
            lens = torch.tensor([t - 17 * (i % 3) for i in range(b)], device=dev)
            mask = torch.arange(t, device=dev)[None] < lens[:, None]
            out = fsmn_memory(x, w, mask, 5, 5)
            torch.cuda.synchronize()
            err = (out - fsmn_memory_ref(x, w, mask, 5, 5)).abs().max().item()
            xm = (x * mask[..., None].to(dtype)).transpose(1, 2).contiguous()  # (B, C, T)
            row = dict(shape=shape, max_abs_err=err,
                       ms=device_ms(lambda: fsmn_memory(x, w, mask, 5, 5)),
                       call_ms=call_ms(lambda: fsmn_memory(x, w, mask, 5, 5)),
                       plain_ms=device_ms(lambda: fsmn_memory_ref(x, w, mask, 5, 5)),
                       library_ms=device_ms(lambda: F.conv1d(xm, w, padding=5, groups=c)))
            row["bound_ms"], row["bound_by"] = bound_ms(
                *fsmn_work(b, t, c, 11, x.element_size()), "fp32")
            log(f"fsmn {shape} k=11 {str(dtype)[6:]}: max_abs_err {err:.3e} "
                f"(tol {FSMN_TOL[dtype]:g}) " + timing_line(row))
            if not (math.isfinite(err) and err <= FSMN_TOL[dtype]):
                raise AssertionError(f"fsmn kernel disagrees at {shape} {dtype}: {err}")
            if shape == (32, 384, 512):
                record[("fsmn_memory", dtype)] = row
    return record


def timing_line(row):
    return (f"kernel {row['ms']:.4f} ms (back-to-back launches; lone call, host overhead "
            f"included, {row['call_ms']:.4f}) plain {row['plain_ms']:.4f} library "
            f"{row['library_ms']:.4f} "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
            f"{row['bound_ms'] / row['ms']:.1%} of it)"
            + (f"; CUDA-core fp32 bound {row['cuda_core_bound_ms']:.4f} ms"
               if "cuda_core_bound_ms" in row else ""))


def phase_w8a8_kernel(dev):
    import torch.nn.functional as F
    from funasr_tpu_torch.ops.w8a8 import (plan_w8a8, quantize_rows_int8, w8a8_linear,
                                           w8a8_linear_ref)

    g = torch.Generator(device=dev).manual_seed(0)
    record = None
    for m, k, n in W8A8_SHAPES:
        w_q8 = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
        scale = torch.rand(n, generator=g, device=dev) * 1e-3
        w_bf16 = (w_q8.float() * scale[:, None]).to(torch.bfloat16)
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(m, k, generator=g, device=dev).to(dtype)
            x[-1] = 0  # a zero-padded bucket row
            bias = torch.randn(n, generator=g, device=dev).to(dtype)
            out = w8a8_linear(x, w_q8, scale, bias)
            torch.cuda.synchronize()
            ref = w8a8_linear_ref(x, w_q8, scale, bias)
            err = (out.float() - ref.float()).abs().max().item()
            row = dict(shape=(m, k, n), max_abs_err=err,
                       ms=device_ms(lambda: w8a8_linear(x, w_q8, scale, bias)),
                       call_ms=call_ms(lambda: w8a8_linear(x, w_q8, scale, bias)),
                       plain_ms=device_ms(lambda: w8a8_linear_ref(x, w_q8, scale, bias),
                                          launches=5))
            # the library's integer product alone, on the padded int8 operands
            kp = plan_w8a8(m, k, n, dtype).kp
            x_q = F.pad(quantize_rows_int8(x)[0], (0, kp - k))
            w_p = F.pad(w_q8, (0, kp - k))
            row["library_ms"] = device_ms(lambda: torch._int_mm(x_q, w_p.t()))
            xb, bb = x.to(torch.bfloat16), bias.to(torch.bfloat16)
            row["cublas_bf16_ms"] = device_ms(lambda: F.linear(xb, w_bf16, bb))
            row["bound_ms"], row["bound_by"] = bound_ms(
                *w8a8_work(m, k, n, x.element_size(), bias.element_size()), "int8")
            log(f"w8a8 ({m}, {k}, {n}) {str(dtype)[6:]}: max_abs_err {err:.3e} "
                f"(tol {W8A8_TOL}) " + timing_line(row)
                + f"; cuBLAS bf16 F.linear {row['cublas_bf16_ms']:.4f}")
            if dtype == torch.bfloat16:
                split = profile_kernels(lambda: w8a8_linear(x, w_q8, scale, bias), calls=10)
                log("  profile, ms per call: " + ", ".join(
                    f"{name.split('<')[0].split('::')[-1]} {t / 10:.4f}"
                    for name, (t, _) in split.items()))
            if not torch.equal(out, ref):
                raise AssertionError(f"w8a8 kernel disagrees at {(m, k, n)} {dtype}: {err}")
            if (m, k, n) == (12288, 512, 2048) and dtype == torch.bfloat16:
                record = row
    return record


def compare_cuda_cpu(dev, cpu_model, gpu_model, seed):
    """The same weights on the CPU and on CUDA, 3 utterances: encoder max abs and
    relative L2 errors, whether the token ids are equal, the share of equal tokens, and
    the CUDA token counts."""
    from funasr_tpu_torch import tables

    rng = np.random.default_rng(seed)
    waves = [pcm(rng, s) for s in (3.0, 4.5, 2.2)]
    frontend = tables.frontend_classes["WavFrontend"](**FRONTEND_CONF)
    feats, flens = frontend.extract(waves)
    with torch.inference_mode():
        enc_cpu, _ = cpu_model.encode(torch.from_numpy(feats), torch.from_numpy(flens))
        enc_gpu, _ = gpu_model.encode(torch.from_numpy(feats).to(dev),
                                      torch.from_numpy(flens).to(dev))
    diff = enc_gpu.cpu() - enc_cpu
    out_cpu = cpu_model.infer_bucketed(feats, flens)
    out_gpu = gpu_model.infer_bucketed(feats, flens)
    same_lens = np.array_equal(out_cpu[1], out_gpu[1])
    seqs = [(out_cpu[0][i, :n], out_gpu[0][i, :m])
            for i, (n, m) in enumerate(zip(out_cpu[1], out_gpu[1]))]
    n_same = sum(int((a[:len(b)] == b[:len(a)]).sum()) for a, b in seqs)
    return dict(enc_err=diff.abs().max().item(), enc_rel=(diff.norm() / enc_cpu.norm()).item(),
                same_ids=same_lens and all(np.array_equal(a, b) for a, b in seqs),
                agree=n_same / max(sum(max(len(a), len(b)) for a, b in seqs), 1),
                counts=out_gpu[1].tolist())


def phase_cuda_vs_cpu(dev):
    from funasr_tpu_torch import tables

    g = torch.Generator().manual_seed(0)
    cpu_model = tables.model_classes["Paraformer"](**SMALL_CONF, generator=g).eval()
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    r = compare_cuda_cpu(dev, cpu_model, gpu_model, seed=1)
    log(f"cuda vs cpu (2+2 blocks, d=64, fp32): encoder max_abs_err {r['enc_err']:.3e} "
        f"(tol {CPU_GPU_ENC_TOL:g}); token counts {r['counts']} ids equal {r['same_ids']}")
    if not (r["enc_err"] <= CPU_GPU_ENC_TOL and r["same_ids"]):
        raise AssertionError("the port on CUDA disagrees with the port on the CPU")


def phase_cuda_vs_cpu_w8a8(dev, seed=2):
    """W8A8 at d = 256 (every linear quantized), the kernel on CUDA against the plain
    version on the CPU. Gates: every W8A8 call of the CUDA run (encoder and decoder)
    launched the kernel and equals, bit for bit, the CPU plain version applied to that
    call's own CUDA input; the encoder drift within W8A8_ENC_REL_TOL; the token
    agreement at least W8A8_MIN_AGREEMENT. Token ids equal is printed, not gated."""
    from funasr_tpu_torch import tables
    from funasr_tpu_torch.ops.quant import Int8Linear, quantize_params_int8
    from funasr_tpu_torch.ops.w8a8 import w8a8_linear, w8a8_linear_ref

    g = torch.Generator().manual_seed(0)
    cpu_model = quantize_params_int8(
        tables.model_classes["Paraformer"](**D256_CONF, generator=g).eval(), mode="w8a8")
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    calls = []  # (layer name, CUDA input, CUDA output) of every W8A8 call
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, name=name: calls.append((name, inp[0].cpu(), out.cpu())))
        for name, m in gpu_model.named_modules() if isinstance(m, Int8Linear) and m.key == "w_q8"]
    before = w8a8_linear.launches
    r = compare_cuda_cpu(dev, cpu_model, gpu_model, seed)
    launched = w8a8_linear.launches - before
    for h in hooks:
        h.remove()
    cpu_layers = dict(cpu_model.named_modules())
    differ = [name for name, x, y in calls
              if not torch.equal(w8a8_linear_ref(x, cpu_layers[name].w_q8, cpu_layers[name].scale,
                                                 cpu_layers[name].bias), y)]
    log(f"cuda vs cpu W8A8 (2+2 blocks, d=256, fp32, seed {seed}): {len(calls)} W8A8 calls on "
        f"CUDA, {launched} kernel launches, {len(differ)} differ from the CPU plain version "
        f"on their own input; encoder rel L2 {r['enc_rel']:.3e} (tol {W8A8_ENC_REL_TOL:g}), "
        f"max_abs_err {r['enc_err']:.3e}; token counts {r['counts']}, ids equal "
        f"{r['same_ids']}, agreement {r['agree']:.4f} (min {W8A8_MIN_AGREEMENT:g})")
    if differ or not calls or launched != len(calls):
        raise AssertionError(f"W8A8 kernel calls on the path disagree or bypass it: {differ}")
    if not (r["enc_rel"] <= W8A8_ENC_REL_TOL and r["agree"] >= W8A8_MIN_AGREEMENT):
        raise AssertionError("the W8A8 port on CUDA disagrees with the port on the CPU")


def phase_main_path(dev, tables, counters, card):
    from funasr_tpu_torch.core.module import cast_floats

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    model = tables.model_classes["Paraformer"](**PROD_CONF, device=dev, generator=g)
    model = cast_floats(model, torch.bfloat16).eval()
    frontend = tables.frontend_classes["WavFrontend"](**FRONTEND_CONF)
    token_list = ["<blank>", "<s>", "</s>"] + [chr(0x4E00 + i) for i in range(8400)] + ["<unk>"]
    tokenizer = tables.tokenizer_classes["CharTokenizer"](token_list=token_list)
    log(f"main path: Paraformer-large width, bf16, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params, "
        f"built in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    batch = [pcm(rng, 15.0) for _ in range(32)]
    long_form = [pcm(rng, 70.0)]

    # warm-up (cuBLAS handles, allocator), outside the counted run
    model.inference(batch, tokenizer=tokenizer, frontend=frontend)
    torch.cuda.synchronize()

    for c in counters:
        c.launches = 0
    results, _ = model.inference(batch, tokenizer=tokenizer, frontend=frontend)
    long_results, _ = model.inference(long_form, tokenizer=tokenizer, frontend=frontend)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    n_decodes = 2
    log(f"main path launches over {n_decodes} decodes: {launches}")
    if len(results) != 32 or len(long_results) != 1:
        raise AssertionError(f"expected 32 + 1 results, got {len(results)} + {len(long_results)}")
    if not all(isinstance(r["text"], str) and r["text"] for r in results + long_results):
        raise AssertionError("empty transcript on the main path")
    if launches["flash_attention"] < 50 * n_decodes or launches["fsmn_memory"] < 66 * n_decodes:
        raise AssertionError(f"the main path bypassed a kernel: {launches}")

    # finite outputs of the expected shapes, at both buckets
    for waves, t_bucket in ((batch, 384), (long_form, 1408)):
        feats, flens = frontend.extract(waves, device=dev)
        yseq, token_lens, score, alphas, _ = model.infer_bucketed(feats, flens)
        if alphas.shape != (len(waves), t_bucket + 1):
            raise AssertionError(f"alphas shape {alphas.shape}, expected T bucket {t_bucket}")
        if not (np.isfinite(score).all() and np.isfinite(alphas).all()):
            raise AssertionError("NaN or inf on the main path")
        log(f"bucket T={t_bucket}: token counts {token_lens.tolist()[:8]}..., "
            f"decoded width {yseq.shape[1]}, mean score {float(score.mean()):.3f}")

    def decode():
        model.inference(batch, tokenizer=tokenizer, frontend=frontend)

    t_med, times = wall_ms(decode)
    log(f"main path B=32 x 15 s: waves -> text median {t_med:.2f} ms "
        f"(runs {[round(x, 2) for x in times]}), RTFx {32 * 15e3 / t_med:.1f}, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")
    profile_once(decode, "main path bf16, model.inference", t_med)
    return launches


def write_model_dir(d, dev):
    """A FunASR-layout model directory at PROD_CONF width with seeded random weights."""
    import yaml
    from funasr_tpu_torch import tables

    g = torch.Generator(device=dev).manual_seed(0)
    model = tables.model_classes["Paraformer"](**PROD_CONF, device=dev, generator=g)
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, os.path.join(d, "model.pt"))
    tokens = ["<blank>", "<s>", "</s>"] + [chr(0x4E00 + i) for i in range(8400)] + ["<unk>"]
    with open(os.path.join(d, "tokens.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(tokens) + "\n")
    dim = PROD_CONF["input_size"]
    with open(os.path.join(d, "am.mvn"), "w") as f:
        f.write(f"<Nnet>\n<Splice> {dim} {dim}\n[ 0 ]\n<AddShift> {dim} {dim}\n"
                f"<LearnRateCoef> 0 [ {' '.join(['0.0'] * dim)} ]\n<Rescale> {dim} {dim}\n"
                f"<LearnRateCoef> 0 [ {' '.join(['1.0'] * dim)} ]\n</Nnet>\n")
    cfg = dict(model="Paraformer", model_conf=dict(sos=1, eos=2, predictor_bias=1, ctc_weight=0.0),
               encoder="SANMEncoder", encoder_conf=PROD_CONF["encoder_conf"],
               decoder="ParaformerSANMDecoder", decoder_conf=PROD_CONF["decoder_conf"],
               predictor="CifPredictorV2", predictor_conf=PROD_CONF["predictor_conf"],
               frontend="WavFrontend", frontend_conf=dict(FRONTEND_CONF, cmvn_file="am.mvn"),
               tokenizer="CharTokenizer",
               tokenizer_conf=dict(token_list="tokens.txt", unk_symbol="<unk>"))
    with open(os.path.join(d, "config.yaml"), "w", encoding="utf-8") as f:
        yaml.safe_dump(cfg, f, allow_unicode=True)


def token_agreement(texts_a, texts_b):
    """Share of aligned positions with the same character (one token per character)."""
    same = sum(sum(x == y for x, y in zip(a, b)) for a, b in zip(texts_a, texts_b))
    return same / max(sum(max(len(a), len(b)) for a, b in zip(texts_a, texts_b)), 1)


def phase_automodel(dev, counters, card):
    """AutoModel at PROD_CONF width from one model directory: W8A8 (bf16), quant=None
    (bf16), then the public default, fp32. Returns the launches of one W8A8 decode and
    of one fp32 decode."""
    import tempfile

    rng = np.random.default_rng(0)
    batch = [pcm(rng, 15.0) for _ in range(32)]
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        write_model_dir(d, dev)
        log(f"AutoModel: model dir written in {time.perf_counter() - t0:.1f} s")
        w8a8_launches = automodel_w8a8(d, batch, dev, counters, card)
        fp32_launches = automodel_fp32(d, batch, dev, counters, card)
    return w8a8_launches, fp32_launches


def automodel_w8a8(d, batch, dev, counters, card):
    from funasr_tpu_torch import AutoModel

    t1 = time.perf_counter()
    am = AutoModel(model=d, device="cuda", bf16=True, quant="w8a8", batch_size=32,
                   log_level="WARNING")
    log(f"AutoModel W8A8: built in {time.perf_counter() - t1:.1f} s")
    am.generate(input=batch)  # warm-up, outside the counted run
    torch.cuda.synchronize()

    for c in counters:
        c.launches = 0
    results = am.generate(input=batch)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    log(f"AutoModel W8A8 launches over 1 decode: {launches}")
    if len(results) != 32 or not all(isinstance(r["text"], str) and r["text"]
                                     for r in results):
        raise AssertionError("AutoModel W8A8: expected 32 non-empty texts")
    if (launches["w8a8_linear"] < 282 or launches["flash_attention"] < 50
            or launches["fsmn_memory"] < 66):
        raise AssertionError(f"AutoModel W8A8 bypassed a kernel: {launches}")

    feats, flens = am.kwargs["frontend"].extract(batch, device=dev)
    _, token_lens, score, alphas, _ = am.model.infer_bucketed(feats, flens)
    if not (np.isfinite(score).all() and np.isfinite(alphas).all()):
        raise AssertionError("NaN or inf on the AutoModel W8A8 path")

    t_med, times = wall_ms(lambda: am.generate(input=batch))
    log(f"AutoModel W8A8 B=32 x 15 s: generate median {t_med:.2f} ms "
        f"(runs {[round(x, 2) for x in times]}), RTFx {32 * 15e3 / t_med:.1f}, "
        f"token counts {token_lens.tolist()[:8]}..., mean score {float(score.mean()):.3f} "
        f"on {card}")
    profile_once(lambda: am.generate(input=batch), "AutoModel W8A8 generate", t_med)
    del am
    ref = AutoModel(model=d, device="cuda", bf16=True, batch_size=32, log_level="WARNING")
    ref_results = ref.generate(input=batch)
    r_med, times = wall_ms(lambda: ref.generate(input=batch))
    log(f"AutoModel quant=None (bf16) B=32 x 15 s, same call: generate median {r_med:.2f} "
        f"ms (runs {[round(x, 2) for x in times]}), RTFx {32 * 15e3 / r_med:.1f}; W8A8 "
        f"takes {t_med / r_med:.3f}x its time")
    profile_once(lambda: ref.generate(input=batch), "AutoModel quant=None generate", r_med)
    del ref
    agree = token_agreement([r["text"] for r in results], [r["text"] for r in ref_results])
    log(f"AutoModel W8A8 vs quant=None (bf16): token agreement {agree:.4f} (not gated: "
        f"random weights)")
    return launches


def automodel_fp32(d, batch, dev, counters, card):
    """The public default, ``AutoModel(model=d, device="cuda")`` with no bf16 and no
    quant: the whole model in fp32, so every encoder attention and every FSMN block
    takes the fp32 kernels. Gates: 32 non-empty texts, finite scores, >= 50 flash and
    >= 66 FSMN launches per decode, and the profile showing those launches in the fp32
    kernels (``FP32_KERNELS``)."""
    from funasr_tpu_torch import AutoModel

    t1 = time.perf_counter()
    am = AutoModel(model=d, device="cuda", batch_size=32, log_level="WARNING")
    dtype = next(am.model.parameters()).dtype
    log(f"AutoModel fp32 (default dtype {dtype}): built in {time.perf_counter() - t1:.1f} s")
    if dtype != torch.float32:
        raise AssertionError(f"the default AutoModel runs in {dtype}, not float32")
    am.generate(input=batch)  # warm-up, outside the counted run
    torch.cuda.synchronize()

    for c in counters:
        c.launches = 0
    results = am.generate(input=batch)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    log(f"AutoModel fp32 launches over 1 decode: {launches}")
    if len(results) != 32 or not all(isinstance(r["text"], str) and r["text"]
                                     for r in results):
        raise AssertionError("AutoModel fp32: expected 32 non-empty texts")
    if launches["flash_attention"] < 50 or launches["fsmn_memory"] < 66:
        raise AssertionError(f"AutoModel fp32 bypassed a kernel: {launches}")

    feats, flens = am.kwargs["frontend"].extract(batch, device=dev)
    _, token_lens, score, alphas, _ = am.model.infer_bucketed(feats, flens)
    if not (np.isfinite(score).all() and np.isfinite(alphas).all()):
        raise AssertionError("NaN or inf on the AutoModel fp32 path")

    t_med, times = wall_ms(lambda: am.generate(input=batch))
    log(f"AutoModel fp32 B=32 x 15 s: generate median {t_med:.2f} ms "
        f"(runs {[round(x, 2) for x in times]}), RTFx {32 * 15e3 / t_med:.1f}, "
        f"token counts {token_lens.tolist()[:8]}..., mean score {float(score.mean()):.3f} "
        f"on {card}")
    by_name = profile_once(lambda: am.generate(input=batch), "AutoModel fp32 generate", t_med)
    fp32 = {name: kernel_totals(by_name, key) for name, key in FP32_KERNELS.items()}
    log("AutoModel fp32 profile, fp32 kernels (ms, launches) per decode: " + ", ".join(
        f"{FP32_KERNELS[name]} {ms:.3f} ms / {n}" for name, (ms, n) in fp32.items()))
    if fp32["flash_attention"][1] < 50 or fp32["fsmn_memory"][1] < 66:
        raise AssertionError(f"AutoModel fp32 did not run the fp32 kernels: {fp32}")
    del am
    return launches


def kernels_line(record, launches, am_launches, fp32_launches):
    """The kernels' JSON record: one entry per kernel at its main-path shape, ``launches``
    of the main path's run (2 decodes; W8A8: one AutoModel W8A8 decode) and
    ``launches_per_decode``; flash and FSMN carry their fp32 figures under ``fp32``, with
    the launches of one decode of the default (fp32) AutoModel."""
    per_decode = {"flash_attention": launches["flash_attention"] / 2,
                  "fsmn_memory": launches["fsmn_memory"] / 2,
                  "w8a8_linear": am_launches["w8a8_linear"]}
    sources = {
        "flash_attention": ("funasr_tpu_torch/csrc/flash_attention.cu",
                            "funasr_tpu/ops/flash_attention.py:63", launches),
        "fsmn_memory": ("funasr_tpu_torch/csrc/fsmn.cu", "benchmarks/bench_pallas_dwconv.py:21",
                        launches),
        "w8a8_linear": ("funasr_tpu_torch/csrc/w8a8.cu", "benchmarks/bench_pallas_w8a8.py:18",
                        am_launches),
    }
    kernels = []
    for name, (src, tpu, counts) in sources.items():
        entry = dict(name=name, route="cuda", source=src, replaces=tpu, launches=counts[name],
                     launches_per_decode=per_decode[name], library_call=LIBRARY_CALLS[name],
                     **record[(name, torch.bfloat16)])
        if (name, torch.float32) in record:
            entry["fp32"] = dict(launches=fp32_launches[name],
                                 launches_per_decode=fp32_launches[name],
                                 **record[(name, torch.float32)])
        kernels.append(entry)
    return {"kernels": kernels}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is false; needs an NVIDIA GPU")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    import funasr_tpu_torch
    from funasr_tpu_torch.ops import cuda_lib
    from funasr_tpu_torch.ops.flash_attention import flash_attention
    from funasr_tpu_torch.ops.fsmn import fsmn_memory
    from funasr_tpu_torch.ops.w8a8 import w8a8_linear

    lib = cuda_lib.load_library()
    log(f"build: {lib.build_seconds:.1f} s (nvcc, sm_90a, one process per source) -> "
        f"{lib._name}")
    for line in lib.build_log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log("  " + line.strip())

    counters = (flash_attention, fsmn_memory, w8a8_linear)
    record = phase_kernels(dev)
    record[("w8a8_linear", torch.bfloat16)] = phase_w8a8_kernel(dev)
    phase_cuda_vs_cpu(dev)
    phase_cuda_vs_cpu_w8a8(dev)
    launches = phase_main_path(dev, funasr_tpu_torch.tables, counters, card)
    am_launches, fp32_launches = phase_automodel(dev, counters, card)
    print(json.dumps(kernels_line(record, launches, am_launches, fp32_launches)))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
