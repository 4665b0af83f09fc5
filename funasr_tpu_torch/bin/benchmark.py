"""Benchmark harness: speed (RTFx) + accuracy (CER/WER) over an audio set (a copy of
``funasr_tpu/bin/benchmark.py`` over the port's ``AutoModel``; ``++device=cpu`` runs it
on the CPU, the default is ``cuda``).

Counterpart of the reference harness (FunASR ``benchmark_vllm.py`` CLI with
``--audio-dir/--label-json``; RTFx definition per
``docs/benchmark/rtf_reproducibility.md:8-28``: audio_seconds / processing_seconds).

Usage:
    python -m funasr_tpu_torch.bin.benchmark ++model=<dir-or-alias> \
        ++audio_dir=wavs/ ++label_json=labels.json [++vad_model=...] \
        [++batch_size_s=300] [++warmup=1] [++language=zh]

    # CER mode over a Kaldi-style pair (AISHELL-1 layout;
    # reference benchmarks/benchmark_pipeline_cer.md methodology):
    python -m funasr_tpu_torch.bin.benchmark ++model=<dir-or-alias> ++mode=cer \
        ++wav_scp=test/wav.scp ++text=test/text [++batch_size=16]

label_json: {"utt_id_or_filename": "reference text", ...}
wav_scp:    "<utt_id> <path>" lines; text: "<utt_id> <transcript>" lines.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import sys
import time


def run_benchmark(model, audio_files, labels=None, warmup: int = 1, **cfg):
    from funasr_tpu_torch.metrics.wer import compute_cer
    from funasr_tpu_torch.utils.load_utils import load_audio

    total_audio_s = 0.0
    for f in audio_files:
        total_audio_s += len(load_audio(f)) / 16000.0

    # warmup compiles
    for _ in range(warmup):
        model.generate(input=audio_files[0], **cfg)

    t0 = time.perf_counter()
    results = []
    for f in audio_files:
        res = model.generate(input=f, **cfg)
        results.append((f, res[0].get("text", "") if res else ""))
    wall = time.perf_counter() - t0
    rtfx = total_audio_s / wall

    report = {"n_files": len(audio_files), "audio_seconds": round(total_audio_s, 1),
              "wall_seconds": round(wall, 2), "rtfx": round(rtfx, 1)}
    if labels:
        refs, hyps = [], []
        for f, hyp in results:
            key = os.path.splitext(os.path.basename(f))[0]
            ref = labels.get(key) or labels.get(os.path.basename(f))
            if ref is not None:
                refs.append(ref)
                hyps.append(hyp)
        if refs:
            cer = compute_cer(refs, hyps)
            report.update(cer=round(cer["cer"] * 100, 2),
                          sub=round(cer["sub"] * 100, 2),
                          dele=round(cer["del"] * 100, 2),
                          ins=round(cer["ins"] * 100, 2),
                          n_scored=len(refs))
    return report, results


def run_streaming_latency(model, audio=None, chunk_ms: int = 600,
                          seconds: float = 20.0, warmup_chunks: int = 6,
                          **cfg):
    """Streaming chunk-latency harness (the reference's realtime service
    metric definitions, ``docs/benchmark/realtime_ws_benchmark.md:60-70``):
    feeds ``chunk_ms`` strides through the streaming model and reports
    first_update_ms (wall to the first non-empty partial), per-chunk p50/p95,
    and RTF. ``model``: an AutoModel over a streaming-capable class."""
    import numpy as np

    from funasr_tpu_torch.utils.load_utils import load_audio

    fs = 16000
    if audio is None:
        rng = np.random.default_rng(0)
        wav = (rng.standard_normal(int(seconds * fs)) * 0.1).astype(np.float32)
    else:
        wav = np.asarray(load_audio(audio), np.float32)
    stride = int(fs * chunk_ms / 1000)
    cache = {}
    lat, first_update_ms = [], None
    t_start = time.perf_counter()
    total = max(len(wav) // stride, 1)
    for i in range(total):
        chunk = wav[i * stride: (i + 1) * stride]
        t0 = time.perf_counter()
        res = model.generate(input=chunk, cache=cache,
                             is_final=i == total - 1, **cfg)
        lat.append(time.perf_counter() - t0)
        if first_update_ms is None and res and res[0].get("text"):
            first_update_ms = (time.perf_counter() - t_start) * 1000
    steady = sorted(lat[warmup_chunks:]) or sorted(lat)
    p50 = steady[len(steady) // 2] * 1000
    p95 = steady[min(int(len(steady) * 0.95), len(steady) - 1)] * 1000
    return {"mode": "latency", "chunk_ms": chunk_ms, "n_chunks": total,
            "first_update_ms": round(first_update_ms, 1)
            if first_update_ms else None,
            "chunk_p50_ms": round(p50, 1), "chunk_p95_ms": round(p95, 1),
            "rtf": round(round(p50, 1) / chunk_ms, 4),
            "compile_chunks": warmup_chunks}


def _read_kaldi_pairs(path):
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split(maxsplit=1)
            if len(parts) == 2:
                out[parts[0]] = parts[1]
    return out


def run_cer_eval(model, wav_scp: str, text_path: str, batch_size: int = 16,
                 hyp_out: str = None, **cfg):
    """Kaldi pair (wav.scp + text) -> CER report + per-utt hyps.

    Mirrors the reference's pipeline CER methodology
    (``benchmarks/benchmark_pipeline_cer.md`` / ``benchmark_vllm.py``): decode
    every utterance, strip whitespace for zh scoring, report corpus CER and
    sub/del/ins plus RTFx over the decode wall time.
    """
    from funasr_tpu_torch.metrics.wer import compute_cer
    from funasr_tpu_torch.utils.load_utils import load_audio

    wavs = _read_kaldi_pairs(wav_scp)
    refs_map = _read_kaldi_pairs(text_path)
    keys = [k for k in wavs if k in refs_map]
    if not keys:
        raise SystemExit(f"no overlapping utt ids between {wav_scp} and {text_path}")
    paths = [wavs[k] for k in keys]

    total_audio_s = sum(len(load_audio(p)) / 16000.0 for p in paths)
    # warmup compile on the first utterance
    model.generate(input=paths[0], batch_size=batch_size, **cfg)
    t0 = time.perf_counter()
    results = model.generate(input=paths, key=keys, batch_size=batch_size, **cfg)
    wall = time.perf_counter() - t0

    hyps_map = {r["key"]: r.get("text", "") for r in results}
    refs = [refs_map[k].replace(" ", "") for k in keys]
    hyps = [hyps_map.get(k, "").replace(" ", "") for k in keys]
    cer = compute_cer(refs, hyps)
    report = {"mode": "cer", "n_utts": len(keys),
              "audio_seconds": round(total_audio_s, 1),
              "wall_seconds": round(wall, 2),
              # 4 decimals: slow hosts (or contended CI) can land below 0.05,
              # and a 1-decimal round would flush a real value to 0.0
              "rtfx": round(total_audio_s / wall, 4),
              "cer": round(cer["cer"] * 100, 2),
              "sub": round(cer["sub"] * 100, 2),
              "del": round(cer["del"] * 100, 2),
              "ins": round(cer["ins"] * 100, 2)}
    if hyp_out:
        with open(hyp_out, "w", encoding="utf-8") as f:
            for k in keys:
                f.write(f"{k} {hyps_map.get(k, '')}\n")
    return report


def main_cli(argv=None):
    from funasr_tpu_torch.auto.auto_model import AutoModel
    from funasr_tpu_torch.bin._overrides import parse_overrides

    logging.basicConfig(level=logging.INFO)
    cfg = parse_overrides(sys.argv[1:] if argv is None else argv)
    mode = cfg.pop("mode", "rtfx")
    audio_dir = cfg.pop("audio_dir", None)
    label_json = cfg.pop("label_json", None)
    wav_scp = cfg.pop("wav_scp", None)
    text_path = cfg.pop("text", None)
    hyp_out = cfg.pop("hyp_out", None)
    warmup = int(cfg.pop("warmup", 1))
    if "model" not in cfg:
        raise SystemExit(__doc__)

    model_keys = {"model", "vad_model", "punc_model", "spk_model", "hub",
                  "disable_pbar", "batch_size", "device", "quant",
                  # config-override keys so a freshly trained checkpoint can be
                  # evaluated: ++model=<conf dir> ++init_param=<model.pt.avg>
                  # ++tokenizer_conf.token_list=... (the recipe stage-5 path)
                  "init_param", "tokenizer_conf", "frontend_conf", "model_conf",
                  "encoder_conf", "decoder_conf", "predictor_conf", "seed",
                  "bf16", "fp16", "vad_kwargs", "punc_kwargs", "spk_kwargs"}
    model = AutoModel(**{k: v for k, v in cfg.items() if k in model_keys},
                      disable_pbar=True)
    run_cfg = {k: v for k, v in cfg.items() if k not in model_keys}

    if mode == "cer":
        if not (wav_scp and text_path):
            raise SystemExit("++mode=cer needs ++wav_scp= and ++text=")
        report = run_cer_eval(model, wav_scp, text_path, hyp_out=hyp_out,
                              batch_size=int(cfg.get("batch_size", 16)),
                              **{k: v for k, v in run_cfg.items()
                                 if k != "batch_size"})
        print(json.dumps(report, ensure_ascii=False))
        return

    if mode == "latency":
        report = run_streaming_latency(
            model, audio=cfg.get("audio"),
            chunk_ms=int(cfg.get("chunk_ms", 600)),
            seconds=float(cfg.get("seconds", 20.0)),
            **{k: v for k, v in run_cfg.items()
               if k not in ("audio", "chunk_ms", "seconds", "batch_size")})
        print(json.dumps(report, ensure_ascii=False))
        return

    if not audio_dir:
        raise SystemExit(__doc__)
    files = sorted(glob.glob(os.path.join(audio_dir, "*.wav"))
                   + glob.glob(os.path.join(audio_dir, "*.pcm")))
    if not files:
        raise SystemExit(f"no audio in {audio_dir}")
    labels = None
    if label_json:
        with open(label_json, encoding="utf-8") as f:
            labels = json.load(f)

    report, _ = run_benchmark(model, files, labels, warmup=warmup, **run_cfg)
    print(json.dumps(report, ensure_ascii=False))


if __name__ == "__main__":
    main_cli()
