"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA kernels, holds each
against its plain PyTorch version, checks the port on CUDA against the port on the CPU,
and drives the offline Paraformer decode at Paraformer-large width.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. device: CUDA must be available; prints ``nvidia-smi`` name and power limit;
2. build: compiles ``funasr_tpu_torch/csrc/*.cu`` with nvcc (seconds printed);
3. kernels: flash attention at (32, 4, 384, 128) and (1, 4, 1408, 128), bf16 and fp32,
   ragged lengths, valid query rows; FSMN memory at (32, 384, 512) and (32, 208, 512),
   k = 11; each against its plain version, with median kernel and plain times;
4. CUDA vs CPU: a small config (2 + 2 blocks, d = 64), same weights, fp32: token ids
   equal, encoder output within ``CPU_GPU_ENC_TOL``;
5. main path: Paraformer-large width (``bench.py``'s PROD_CONF: 50 encoder blocks,
   16 decoder blocks, vocab 8404) in bf16 with seeded random weights: 32 x 15 s int16
   PCM and one 70 s utterance through WavFrontend -> model.inference -> text; the
   kernel launch counts of that run must show every encoder attention and every FSMN
   block went through the kernels; RTFx at B = 32 x 15 s.

The second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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

FRONTEND_CONF = dict(fs=16000, n_mels=80, lfr_m=7, lfr_n=6, cmvn_file=None, dither=0.0)


def log(*args):
    print(*args, flush=True)


def median_ms(fn, iters=30, warmup=5):
    """Median device time of one call, CUDA events around each call after warm-up."""
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


def pcm(rng, seconds, fs=16000):
    return np.asarray(rng.standard_normal(int(seconds * fs)) * 0.1 * 32767, np.int16)


def phase_kernels(dev):
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
            lens = torch.tensor([t - 37 * (i % 2) for i in range(b)], dtype=torch.int32,
                                device=dev)
            out = flash_attention(q, k, v, lens)
            torch.cuda.synchronize()
            ref = flash_attention_ref(q, k, v, lens)
            err = max((out[i, :, :n] - ref[i, :, :n]).abs().max().item()
                      for i, n in enumerate(lens.tolist()))
            ms = median_ms(lambda: flash_attention(q, k, v, lens))
            plain_ms = median_ms(lambda: flash_attention_ref(q, k, v, lens))
            ok = math.isfinite(err) and err <= FLASH_TOL[dtype]
            log(f"flash {shape} {str(dtype)[6:]}: max_abs_err {err:.3e} "
                f"(tol {FLASH_TOL[dtype]:g}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
            if not ok:
                raise AssertionError(f"flash kernel disagrees at {shape} {dtype}: {err}")
            if shape == (32, 4, 384, 128) and dtype == torch.bfloat16:
                record["flash_attention"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

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
            ms = median_ms(lambda: fsmn_memory(x, w, mask, 5, 5))
            plain_ms = median_ms(lambda: fsmn_memory_ref(x, w, mask, 5, 5))
            log(f"fsmn {shape} k=11 {str(dtype)[6:]}: max_abs_err {err:.3e} "
                f"(tol {FSMN_TOL[dtype]:g}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
            if not (math.isfinite(err) and err <= FSMN_TOL[dtype]):
                raise AssertionError(f"fsmn kernel disagrees at {shape} {dtype}: {err}")
            if shape == (32, 384, 512) and dtype == torch.bfloat16:
                record["fsmn_memory"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return record


def phase_cuda_vs_cpu(dev, tables):
    rng = np.random.default_rng(1)
    waves = [pcm(rng, s) for s in (3.0, 4.5, 2.2)]
    g = torch.Generator().manual_seed(0)
    cpu_model = tables.model_classes["Paraformer"](**SMALL_CONF, generator=g).eval()
    gpu_model = tables.model_classes["Paraformer"](**SMALL_CONF, device=dev).eval()
    gpu_model.load_state_dict(cpu_model.state_dict())
    frontend = tables.frontend_classes["WavFrontend"](**FRONTEND_CONF)
    feats, flens = frontend.extract(waves)
    with torch.inference_mode():
        enc_cpu, _ = cpu_model.encode(torch.from_numpy(feats), torch.from_numpy(flens))
        enc_gpu, _ = gpu_model.encode(torch.from_numpy(feats).to(dev),
                                      torch.from_numpy(flens).to(dev))
    enc_err = (enc_gpu.cpu() - enc_cpu).abs().max().item()
    out_cpu = cpu_model.infer_bucketed(feats, flens)
    out_gpu = gpu_model.infer_bucketed(feats, flens)
    same_lens = np.array_equal(out_cpu[1], out_gpu[1])
    same_ids = same_lens and all(
        np.array_equal(out_cpu[0][i, :n], out_gpu[0][i, :n]) for i, n in enumerate(out_cpu[1]))
    log(f"cuda vs cpu (2+2 blocks, d=64, fp32): encoder max_abs_err {enc_err:.3e} "
        f"(tol {CPU_GPU_ENC_TOL:g}); token counts {out_gpu[1].tolist()} "
        f"ids equal {same_ids}")
    if not (enc_err <= CPU_GPU_ENC_TOL and same_ids):
        raise AssertionError("the port on CUDA disagrees with the port on the CPU")


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

    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.inference(batch, tokenizer=tokenizer, frontend=frontend)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t_med = statistics.median(times)
    log(f"main path B=32 x 15 s: waves -> text median {t_med * 1e3:.2f} ms "
        f"(runs {[round(x * 1e3, 2) for x in times]}), RTFx {32 * 15.0 / t_med:.1f}, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")
    return launches


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

    lib = cuda_lib.load_library()
    log(f"build: {lib.build_seconds:.1f} s (nvcc, sm_90a) -> {lib._name}")
    for line in lib.build_log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log("  " + line.strip())

    record = phase_kernels(dev)
    phase_cuda_vs_cpu(dev, funasr_tpu_torch.tables)
    launches = phase_main_path(dev, funasr_tpu_torch.tables, (flash_attention, fsmn_memory),
                               card)

    kernels = [
        dict(name="flash_attention", route="cuda",
             source="funasr_tpu_torch/csrc/flash_attention.cu",
             replaces="funasr_tpu/ops/flash_attention.py:63",
             launches=launches["flash_attention"], **record["flash_attention"]),
        dict(name="fsmn_memory", route="cuda", source="funasr_tpu_torch/csrc/fsmn.cu",
             replaces="benchmarks/bench_pallas_dwconv.py:21",
             launches=launches["fsmn_memory"], **record["fsmn_memory"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
