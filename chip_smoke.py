"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA kernels, holds each
against its plain PyTorch version, checks the port on CUDA against the port on the CPU,
and drives the offline Paraformer decode, ``AutoModel(quant="w8a8")``, the default
(fp32) ``AutoModel`` at Paraformer-large width, and the VAD -> ASR -> punctuation
pipeline ``AutoModel(model=, vad_model=, punc_model=)``.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. device: CUDA must be available; prints ``nvidia-smi`` name and power limit;
2. build: compiles ``funasr_tpu_torch/csrc/*.cu`` with nvcc, one process per source in
   parallel (seconds printed);
3. kernels: flash attention at (32, 4, 384, 128) and (1, 4, 1408, 128), bf16 and fp32,
   ragged lengths, valid query rows; FSMN memory at (32, 384, 512) and (32, 208, 512),
   k = 11; and at the pipeline's shapes (``pipeline_kernel_rows``): the VAD's FSMN at
   (1, 6019, 128) fp32, k = 20, pads (19, 0), no mask; the punctuation encoder's FSMN
   at (1, 64, 256) fp32, k = 11, a prefix mask; its flash at (1, 8, 64, 32) fp32 and
   bf16 with a ragged length; each against its plain version;
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
   kernels (``FP32_KERNELS``); RTFx and one profiled ``generate``;
8. pipeline (``phase_pipeline``): three model directories written from the port's
   seeded modules (the PROD_CONF Paraformer; fsmn-vad at its published widths crafted
   into an energy detector with small seeded memory taps; ct-punc-c at its published
   widths, vocab 272727) through ``AutoModel(model=asr, vad_model=vad, punc_model=punc,
   device="cuda")`` (fp32, the public default), 4 requests of 300 s of synthetic speech
   bursts (3-14 s) and near silence (1-3 s), one ``generate`` each. Gates per request:
   one row with its key and a text ending in sentence-final punctuation, >= 10 VAD
   segments equal to the port's VAD on the CPU to the ms, the first 3 punctuation
   windows' logits within ``PUNC_LOGIT_TOL`` of the CPU port's, and each stage's kernel
   launches (``kernel_sites`` x its calls). Prints RTFx per request, the wall ms of each
   stage (VAD, ASR, punctuation) and one profiled request (device ms by kernel, idle
   share).

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
from the fp32 ``AutoModel`` decode, and their rows at the pipeline's shapes under
``pipeline``, launches from phase 8's four requests), the last line
``{"ok": true, "device": {...}}``.
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
    record.update(pipeline_kernel_rows(dev, g))
    return record


def fsmn_row(x, w, mask, left, right):
    """One FSMN kernel row against its plain version, with the library call
    ``F.conv1d(groups=C)`` (zero padding max(left, right), the causal output sliced) plus
    the residual."""
    import torch.nn.functional as F
    from funasr_tpu_torch.ops.fsmn import fsmn_memory, fsmn_memory_ref

    b, t, c = x.shape
    k = w.shape[-1]
    out = fsmn_memory(x, w, mask, left, right)
    torch.cuda.synchronize()
    err = (out - fsmn_memory_ref(x, w, mask, left, right)).abs().max().item()
    xm = x if mask is None else x * mask[..., None].to(x.dtype)
    xm = xm.transpose(1, 2).contiguous()  # (B, C, T)
    pad, off = max(left, right), max(left, right) - left
    row = dict(shape=(b, t, c), k=k, pads=(left, right), max_abs_err=err,
               library_call=f"F.conv1d(xm, w, padding={pad}, groups=C)[..., {off}:{off} + T]"
                            " + xm",
               ms=device_ms(lambda: fsmn_memory(x, w, mask, left, right)),
               call_ms=call_ms(lambda: fsmn_memory(x, w, mask, left, right)),
               plain_ms=device_ms(lambda: fsmn_memory_ref(x, w, mask, left, right)),
               library_ms=device_ms(
                   lambda: F.conv1d(xm, w, padding=pad, groups=c)[..., off:off + t] + xm))
    row["bound_ms"], row["bound_by"] = bound_ms(*fsmn_work(b, t, c, k, x.element_size()),
                                                "fp32")
    return row


def flash_row(q, k, v, lens_list):
    """One flash kernel row against its plain version and scaled_dot_product_attention;
    the error over each row's valid queries."""
    import torch.nn.functional as F
    from funasr_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref

    b, h, t, d = q.shape
    lens = torch.tensor(lens_list, dtype=torch.int32, device=q.device)
    out = flash_attention(q, k, v, lens)
    torch.cuda.synchronize()
    ref = flash_attention_ref(q, k, v, lens)
    err = max((out[i, :, :n] - ref[i, :, :n]).abs().max().item()
              for i, n in enumerate(lens_list))
    mask = (torch.arange(t, device=q.device)[None, :] < lens[:, None].long())[:, None, None, :]
    row = dict(shape=(b, h, t, d), max_abs_err=err,
               library_call=LIBRARY_CALLS["flash_attention"],
               ms=device_ms(lambda: flash_attention(q, k, v, lens)),
               call_ms=call_ms(lambda: flash_attention(q, k, v, lens)),
               plain_ms=device_ms(lambda: flash_attention_ref(q, k, v, lens)),
               library_ms=device_ms(
                   lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)))
    row["bound_ms"], row["bound_by"] = flash_bound(b, h, t, d, lens_list, q.dtype)
    return row


def pipeline_kernel_rows(dev, g):
    """The kernels at the shapes of the VAD -> ASR -> punctuation pipeline (phase 8):
    the VAD's causal FSMN memory over cache + one 60 s chunk (k = 20, pads 19 / 0, no
    mask, C = 128, fp32), the punctuation encoder's FSMN (v slice, k = 11, prefix mask,
    C = 256) and its flash attention (8 heads x 32, strided head views of q|k|v, a ragged
    length), each against its plain version. Raises on a disagreement."""
    rows = {}
    x = torch.randn(1, 6019, 128, generator=g).to(dev)  # concat(cache, h), contiguous
    w = ((torch.rand(128, 1, 20, generator=g) - 0.5) * 2e-3).to(dev)
    rows[("fsmn_memory", "vad")] = fsmn_row(x, w, None, 19, 0)
    x = torch.randn(1, 64, 3 * 256, generator=g).to(dev)[..., 2 * 256:]
    w = (torch.rand(256, 1, 11, generator=g) - 0.5).to(dev)
    mask = torch.arange(64, device=dev)[None] < 57
    rows[("fsmn_memory", "punc")] = fsmn_row(x, w, mask, 5, 5)
    for dtype in (torch.float32, torch.bfloat16):
        qkv = torch.randn(1, 64, 3, 8, 32, generator=g).to(dev, dtype)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        rows[("flash_attention", "punc", dtype)] = flash_row(q, k, v, [57])
    for key, row in rows.items():
        dtype = key[2] if len(key) > 2 else torch.float32
        tol = (FLASH_TOL if key[0] == "flash_attention" else FSMN_TOL)[dtype]
        log(f"{key[0]} {key[1]} {row['shape']} {str(dtype)[6:]}: max_abs_err "
            f"{row['max_abs_err']:.3e} (tol {tol:g}) " + timing_line(row))
        if not (math.isfinite(row["max_abs_err"]) and row["max_abs_err"] <= tol):
            raise AssertionError(f"{key} kernel disagrees: {row['max_abs_err']}")
    return rows


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


def identity_cmvn(dim):
    return (f"<Nnet>\n<Splice> {dim} {dim}\n[ 0 ]\n<AddShift> {dim} {dim}\n"
            f"<LearnRateCoef> 0 [ {' '.join(['0.0'] * dim)} ]\n<Rescale> {dim} {dim}\n"
            f"<LearnRateCoef> 0 [ {' '.join(['1.0'] * dim)} ]\n</Nnet>\n")


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
    with open(os.path.join(d, "am.mvn"), "w") as f:
        f.write(identity_cmvn(PROD_CONF["input_size"]))
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


# ---- phase 8: the VAD -> ASR -> punctuation pipeline -----------------------------------

# fsmn-vad and ct-punc-c at their published widths (benchmarks/bench_realtime_ws.py:63-83)
VAD_CONF = dict(input_dim=400, input_affine_dim=140, fsmn_layers=4, linear_dim=250,
                proj_dim=128, lorder=20, rorder=0, lstride=1, rstride=1,
                output_affine_dim=140, output_dim=248)
PUNC_ENC = dict(input_size=256, output_size=256, attention_heads=8, linear_units=1024,
                num_blocks=4, input_layer="pe", kernel_size=11, sanm_shfit=0)
PUNC_MODEL_CONF = dict(punc_list=["<unk>", "_", "，", "。", "？", "、"], embed_unit=256,
                       att_unit=256, sentence_end_id=3)
PUNC_VOCAB = 272727
PIPELINE_REQUESTS = 4
REQUEST_SECONDS = 300.0
MIN_SEGMENTS = 10
PUNC_LOGIT_TOL = 1e-3  # fp32 logits, CUDA against the CPU: cuBLAS and kernel sum order


def write_config(d, cfg):
    import yaml
    with open(os.path.join(d, "config.yaml"), "w", encoding="utf-8") as f:
        yaml.safe_dump(cfg, f, allow_unicode=True)


def craft_energy_vad(vad, g, tap=1e-3):
    """A deterministic energy detector at fsmn-vad width: every layer averages its input,
    the output affine maps the mean log-mel energy m to logits sil = 3 - 2m, speech = 2m
    (every other pdf -10). The memory taps are seeded values in +-tap, so the FSMN kernel's
    output enters the scores."""
    enc, c = vad.encoder, vad.encoder.cfg
    with torch.no_grad():
        for lin, fan_in in ((enc.in_linear1.linear, c.input_dim),
                            (enc.in_linear2.linear, c.input_affine_dim),
                            (enc.out_linear1.linear, c.linear_dim)):
            lin.weight.fill_(1.0 / fan_in)
            lin.bias.zero_()
        for blk in enc.fsmn:
            blk.linear.linear.weight.fill_(1.0 / c.linear_dim)
            w = blk.fsmn_block.conv_left.weight
            w.copy_((torch.rand(w.shape, generator=g) * 2 - 1) * tap)
            blk.affine.linear.weight.fill_(1.0 / c.proj_dim)
            blk.affine.linear.bias.zero_()
        out = enc.out_linear2.linear
        out.weight.zero_()
        out.weight[0].fill_(-2.0 / c.output_affine_dim)
        out.weight[1].fill_(2.0 / c.output_affine_dim)
        out.bias.fill_(-10.0)
        out.bias[0] = 3.0
        out.bias[1] = 0.0


def write_pipeline_dirs(root, dev):
    """Three FunASR-layout model directories under `root`: the PROD_CONF Paraformer,
    fsmn-vad (crafted energy detector) and ct-punc-c (the ASR's 8404 tokens first, then
    filler tokens up to 272727), all from the port's seeded modules."""
    from funasr_tpu_torch import tables

    dirs = {name: os.path.join(root, name) for name in ("asr", "vad", "punc")}
    for d in dirs.values():
        os.makedirs(d)
    write_model_dir(dirs["asr"], dev)

    g = torch.Generator().manual_seed(1)
    vad = tables.model_classes["FsmnVADStreaming"](encoder_conf=VAD_CONF, generator=g)
    craft_energy_vad(vad, g)
    torch.save(vad.state_dict(), os.path.join(dirs["vad"], "model.pt"))
    with open(os.path.join(dirs["vad"], "am.mvn"), "w") as f:
        f.write(identity_cmvn(VAD_CONF["input_dim"]))
    write_config(dirs["vad"], dict(
        model="FsmnVADStreaming",
        model_conf=dict(max_end_silence_time=800, speech_noise_thres=0.6, sil_pdf_ids=[0]),
        encoder="FSMN", encoder_conf=VAD_CONF, frontend="WavFrontendOnline",
        frontend_conf=dict(fs=16000, window="hamming", n_mels=80, frame_length=25,
                           frame_shift=10, lfr_m=5, lfr_n=1, cmvn_file="am.mvn",
                           dither=0.0)))

    asr_tokens = (["<blank>", "<s>", "</s>"] + [chr(0x4E00 + i) for i in range(8400)]
                  + ["<unk>"])
    tokens = asr_tokens + [f"<filler_{i}>" for i in range(PUNC_VOCAB - len(asr_tokens))]
    punc = tables.model_classes["CTTransformer"](
        encoder_conf=PUNC_ENC, vocab_size=len(tokens), **PUNC_MODEL_CONF,
        generator=torch.Generator().manual_seed(2))
    torch.save(punc.state_dict(), os.path.join(dirs["punc"], "model.pt"))
    with open(os.path.join(dirs["punc"], "tokens.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(tokens) + "\n")
    write_config(dirs["punc"], dict(
        model="CTTransformer", model_conf=PUNC_MODEL_CONF, encoder="SANMEncoder",
        encoder_conf=PUNC_ENC, tokenizer="CharTokenizer",
        tokenizer_conf=dict(token_list="tokens.txt", unk_symbol="<unk>")))
    return dirs


def long_recording(rng, seconds=REQUEST_SECONDS, fs=16000):
    """Synthetic long-form speech (the idea of tests/pipeline_parity_util.py's
    multi_segment_wav at request length): 3-14 s bursts of noise or amplitude-modulated
    tones, 1-3 s of near silence (a 1e-6 noise floor) between them; float32 in [-1, 1)."""
    wav = (rng.standard_normal(int(seconds * fs)) * 1e-6).astype(np.float32)
    t0 = rng.uniform(0.3, 1.5)
    while t0 + 3.0 < seconds:
        i, j = int(t0 * fs), int(min(t0 + rng.uniform(3.0, 14.0), seconds - 0.5) * fs)
        tt = np.arange(j - i) / fs
        if rng.random() < 0.5:
            burst = 0.1 * rng.standard_normal(j - i)
        else:
            f0 = rng.uniform(120.0, 450.0)
            burst = 0.3 * np.sin(2 * np.pi * f0 * tt) * (1 + 0.4 * np.sin(2 * np.pi * 3 * tt))
        wav[i:j] += burst.astype(np.float32)
        t0 = j / fs + rng.uniform(1.0, 3.0)
    return wav


class Stage:
    """Wraps ``obj.attr`` (an instance attribute shadows the method, so its callers call
    the wrapper): per call, wall ms up to a synchronize and the kernel launches made
    inside it; with ``keep``, the results (the first item of what it returns)."""

    def __init__(self, obj, attr, counters, keep=False):
        self.counters, self.keep, self.inner = counters, keep, getattr(obj, attr)
        self.reset()
        setattr(obj, attr, self)

    def reset(self):
        self.calls, self.ms, self.results = 0, 0.0, []
        self.launches = {c.__name__: 0 for c in self.counters}

    def __call__(self, *args, **kwargs):
        before = {c.__name__: c.launches for c in self.counters}
        t0 = time.perf_counter()
        out = self.inner(*args, **kwargs)
        torch.cuda.synchronize()
        self.ms += (time.perf_counter() - t0) * 1e3
        self.calls += 1
        for c in self.counters:
            self.launches[c.__name__] += c.launches - before[c.__name__]
        if self.keep:
            self.results.extend(out[0])
        return out


def kernel_sites(model):
    """Launches of each kernel per forward of `model`: one flash per SAN-M self-attention,
    one FSMN per SAN-M attention, decoder FSMN block and VAD memory block."""
    from funasr_tpu_torch.models.fsmn_vad_streaming.encoder import FSMNBlock
    from funasr_tpu_torch.models.sanm.attention import (MultiHeadedAttentionSANM,
                                                        MultiHeadedAttentionSANMDecoder)

    def count(*kinds):
        return sum(isinstance(m, kinds) for m in model.modules())
    sites = {"fsmn_memory": count(MultiHeadedAttentionSANM, MultiHeadedAttentionSANMDecoder,
                                  FSMNBlock)}
    if count(MultiHeadedAttentionSANM):
        sites["flash_attention"] = count(MultiHeadedAttentionSANM)
    return sites


def forward_counter(module):
    """A list that grows by one per forward call of `module`."""
    calls = []
    module.register_forward_hook(lambda *_: calls.append(1))
    return calls


def phase_pipeline(dev, counters, card):
    """AutoModel(model=asr, vad_model=vad, punc_model=punc, device="cuda"), the public
    default (fp32 everywhere), answering PIPELINE_REQUESTS requests of ~300 s, one
    ``generate`` each. Gates per request: one row with its key and text ending in
    sentence-final punctuation; >= MIN_SEGMENTS VAD segments, equal to the port's VAD
    on the CPU to the ms; the first 3 punctuation windows' logits within PUNC_LOGIT_TOL
    of the CPU port's; launches per stage at least the model's kernel sites times its
    calls (``kernel_sites``; FSMN 4 per VAD encoder call, 66 per ASR batch, 4 per
    punctuation window; flash 50 per ASR batch, 4 per window).
    Returns the launches per request of each stage."""
    import tempfile
    from funasr_tpu_torch import AutoModel
    from funasr_tpu_torch.frontends import wav_frontend
    from funasr_tpu_torch.models.ct_transformer.utils import split_to_mini_sentence, split_words

    rng = np.random.default_rng(5)
    requests = [long_recording(rng) for _ in range(PIPELINE_REQUESTS)]
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        dirs = write_pipeline_dirs(root, dev)
        log(f"pipeline: model dirs written in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        am = AutoModel(model=dirs["asr"], vad_model=dirs["vad"], punc_model=dirs["punc"],
                       device="cuda", log_level="WARNING")
        log(f"pipeline: AutoModel(model, vad_model, punc_model, device='cuda') built in "
            f"{time.perf_counter() - t0:.1f} s")
    dtypes = {name: next(m.parameters()).dtype for name, m in
              (("asr", am.model), ("vad", am.vad_model), ("punc", am.punc_model))}
    if set(dtypes.values()) != {torch.float32}:
        raise AssertionError(f"the default pipeline is not fp32: {dtypes}")
    # kernel launches per VAD encoder call, ASR batch and punctuation window: 4 FSMN;
    # 50 flash + 66 FSMN (PROD_CONF); 4 flash + 4 FSMN
    sites = {"vad": kernel_sites(am.vad_model), "asr": kernel_sites(am.model),
             "punc": kernel_sites(am.punc_model)}
    log(f"pipeline: kernel launches per VAD encoder call / ASR batch / punctuation window: "
        f"{sites}")
    cpu_vad = copy.deepcopy(am.vad_model).cpu()
    cpu_punc = copy.deepcopy(am.punc_model).cpu()
    stages = {"vad": Stage(am.vad_model, "inference", counters, keep=True),
              "asr": Stage(am.model, "inference", counters),
              "punc": Stage(am.punc_model, "inference", counters),
              # inside the VAD: the fbank (on the card) + LFR / CMVN (host), and the
              # encoder on the card with the scores' copy to the host; inside the
              # punctuation stage: each window's forward and its logits' copy
              "vad_fbank": Stage(am.vad_kwargs["frontend"], "forward_streaming", counters),
              "vad_fbank_only": Stage(wav_frontend, "fbank", counters),
              "vad_scores": Stage(am.vad_model, "silence_scores", counters),
              "punc_windows": Stage(am.punc_model, "window_logits", counters)}
    vad_calls = forward_counter(am.vad_model.encoder)
    windows = forward_counter(am.punc_model.encoder)
    am.generate(input=[requests[0][:16000 * 60]], key=["warm-up"])  # outside the counts
    torch.cuda.synchronize()

    per_request = []
    for r, wav in enumerate(requests):
        for st in stages.values():
            st.reset()
        vad_calls.clear()
        windows.clear()
        key = f"request_{r}"
        t0 = time.perf_counter()
        rows = am.generate(input=[wav], key=[key], return_raw_text=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        audio_s = len(wav) / 16000
        segments = stages["vad"].results[0]["value"]
        stats = dict(wall_ms=wall * 1e3, rtfx=audio_s / wall, segments=len(segments),
                     vad_calls=len(vad_calls), asr_batches=stages["asr"].calls,
                     windows=len(windows),
                     **{f"{name}_ms": st.ms for name, st in stages.items()},
                     **{f"{name}_launches": st.launches for name, st in stages.items()})
        per_request.append(stats)
        log(f"pipeline {key}: {audio_s:.1f} s of audio, wall {stats['wall_ms']:.2f} ms, "
            f"RTFx {stats['rtfx']:.1f}; stages: VAD {stats['vad_ms']:.2f} ms "
            f"({stats['vad_calls']} encoder calls, {len(segments)} segments), ASR "
            f"{stats['asr_ms']:.2f} ms ({stats['asr_batches']} batches), punctuation "
            f"{stats['punc_ms']:.2f} ms ({stats['windows']} windows); launches "
            f"VAD {stats['vad_launches']} ASR {stats['asr_launches']} "
            f"punc {stats['punc_launches']}; text {len(rows[0]['text'])} chars on {card}")
        log(f"  inside the stages: VAD fbank + LFR {stats['vad_fbank_ms']:.2f} ms (the fbank "
            f"on the card and back {stats['vad_fbank_only_ms']:.2f}), VAD "
            f"encoder + scores to the host {stats['vad_scores_ms']:.2f} ms, VAD host rest "
            f"(decibel loop, state machine) "
            f"{stats['vad_ms'] - stats['vad_fbank_ms'] - stats['vad_scores_ms']:.2f} ms; "
            f"punctuation window forwards + logits to the host {stats['punc_windows_ms']:.2f}"
            f" ms, host rest {stats['punc_ms'] - stats['punc_windows_ms']:.2f} ms")

        if len(rows) != 1 or rows[0]["key"] != key:
            raise AssertionError(f"{key}: expected one row with its key, got {rows}")
        text = rows[0]["text"]
        if not (isinstance(text, str) and text and text[-1] in "。？.?"):
            raise AssertionError(f"{key}: text {text[-20:]!r} does not end a sentence")
        if len(segments) < MIN_SEGMENTS:
            raise AssertionError(f"{key}: {len(segments)} VAD segments < {MIN_SEGMENTS}")
        cpu_segments = am.inference([wav], model=cpu_vad, kwargs=am.vad_kwargs)[0]["value"]
        if cpu_segments != segments:
            raise AssertionError(f"{key}: VAD segments on CUDA differ from the CPU port's: "
                                 f"{segments} vs {cpu_segments}")
        tok = am.punc_kwargs["tokenizer"]
        ids = [tok.token2id.get(w, tok.unk_id) for w in split_words(rows[0]["raw_text"])]
        err = max(np.abs(am.punc_model.window_logits(np.asarray(w, np.int32))
                         - cpu_punc.window_logits(np.asarray(w, np.int32))).max()
                  for w in split_to_mini_sentence(ids, 20)[:3])
        log(f"  VAD segments equal to the CPU port's ({len(segments)}); punctuation logits "
            f"of the first 3 windows: max_abs_err {err:.3e} (tol {PUNC_LOGIT_TOL:g})")
        if not err <= PUNC_LOGIT_TOL:
            raise AssertionError(f"{key}: punctuation logits on CUDA differ by {err}")
        need = {(stage, kernel): n * calls for stage, calls in
                (("vad", stats["vad_calls"]), ("asr", stats["asr_batches"]),
                 ("punc", stats["windows"])) for kernel, n in sites[stage].items()}
        short = {k: (stats[f"{k[0]}_launches"][k[1]], n) for k, n in need.items()
                 if stats[f"{k[0]}_launches"][k[1]] < n or n == 0}
        if short:
            raise AssertionError(f"{key}: a stage bypassed a kernel (launches, needed): "
                                 f"{short}")

    walls = [s["wall_ms"] for s in per_request]
    total_audio = sum(len(w) for w in requests) / 16000
    log(f"pipeline: {PIPELINE_REQUESTS} requests, {total_audio:.1f} s of audio, RTFx "
        f"{[round(s['rtfx'], 1) for s in per_request]} (all {total_audio * 1e3 / sum(walls):.1f}); "
        f"stage wall ms, mean per request: " + ", ".join(
            f"{name} {statistics.mean(s[f'{name}_ms'] for s in per_request):.2f}"
            for name in stages) + f" on {card}")
    profile_once(lambda: am.generate(input=[requests[0]], key=["profiled"]),
                 "pipeline request 0 (VAD + ASR + punctuation)", walls[0])
    return per_request


# the kernel rows at the pipeline's shapes: kernel -> [(label, record key, the phase 8
# stage whose launches they are, None where the default fp32 pipeline does not run it)]
PIPELINE_ENTRIES = {
    "flash_attention": [("punc_fp32", ("flash_attention", "punc", torch.float32), "punc"),
                        ("punc_bf16", ("flash_attention", "punc", torch.bfloat16), None)],
    "fsmn_memory": [("vad", ("fsmn_memory", "vad"), "vad"),
                    ("punc", ("fsmn_memory", "punc"), "punc")],
}


def kernels_line(record, launches, am_launches, fp32_launches, pipeline=None):
    """The kernels' JSON record: one entry per kernel at its main-path shape, ``launches``
    of the main path's run (2 decodes; W8A8: one AutoModel W8A8 decode) and
    ``launches_per_decode``; flash and FSMN carry their fp32 figures under ``fp32``, with
    the launches of one decode of the default (fp32) AutoModel, and their rows at the
    pipeline's shapes under ``pipeline``, with the launches of phase 8's requests
    (``pipeline``: its per-request stats)."""
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
        for label, key, stage in PIPELINE_ENTRIES.get(name, ()) if pipeline else ():
            n = sum(r[f"{stage}_launches"][name] for r in pipeline) if stage else 0
            entry.setdefault("pipeline", {})[label] = dict(
                launches=n, launches_per_request=n / len(pipeline), **record[key])
        kernels.append(entry)
    return {"kernels": kernels}


def main():
    t_start = time.perf_counter()
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
    pipeline = phase_pipeline(dev, counters, card)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels_line(record, launches, am_launches, fp32_launches, pipeline)))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
