"""Model export CLI of the port -> ``torch.export`` programs (a counterpart of
``funasr_tpu/bin/export.py``, which writes ``jax.export`` StableHLO).

One program per (batch, frames) bucket: ``infer_core(speech, lengths, max_tokens)[:3]``
(yseq (B, K) int32, token_lens (B,) int32, score (B,)) with ``max_tokens =
_max_tokens_for(frames)``, as the JAX package exports ``infer_jit(...)[:3]``. A program
takes ``(params, speech (B, T, input_dim) fp32, lengths (B,) int32)``: the weights are an
input, written once for the directory to ``params.pt`` (the JAX package's
``params.npz``), not once in each program. Its kernels are the custom ops
``funasr_tpu_torch::{flash_attention, fsmn_memory, w8a8_linear}`` (``ops/``), so a
program exported on the card runs the Hopper kernels, under ``bf16=True`` the bf16 ones
and under ``quant="w8a8"`` the W8A8 one. A program is traced on the device it will run
on (constants bake the device in): the manifest names it.

The directory: ``model_b{B}_t{T}.pt2`` per bucket, ``params.pt``,
``export_manifest.json`` (``{"format": "torch.export", "device", "functions": [{"file",
"batch", "frames", "input_dim", "max_tokens"}, ...]}``) and the sidecars ``config.yaml``,
``tokens.txt``, ``am.mvn``, ``tokens.json`` copied from the model dir.
``export_runtime.py::ExportedModel`` runs it without the model code.

Usage:
    python -m funasr_tpu_torch.bin.export ++model=<dir-or-alias> ++output_dir=exported \\
        ++buckets='[(4,168),(32,384)]' [++device=cpu] [++quant=w8a8] [++bf16=True]
"""

from __future__ import annotations

import ast
import json
import logging
import os
import shutil
import sys
import time

import torch

SIDECARS = ("config.yaml", "tokens.txt", "am.mvn", "tokens.json")


class _Core(torch.nn.Module):
    """``model.infer_core(speech, lengths, max_tokens)[:3]``, speech cast to the model's
    dtype."""

    def __init__(self, model, max_tokens: int):
        super().__init__()
        self.model = model
        self.max_tokens = max_tokens

    def forward(self, speech, lengths):
        return self.model.infer_core(speech.to(self.model.dtype), lengths,
                                     self.max_tokens)[:3]


class _Program(torch.nn.Module):
    """``_Core`` over the weights it is given: the model sits outside the module tree,
    so the exported program holds none of its weights."""

    def __init__(self, core: _Core):
        super().__init__()
        self._core = (core,)

    def forward(self, params, speech, lengths):
        core = self._core[0]
        return torch.func.functional_call(
            core, {f"model.{k}": v for k, v in params.items()}, (speech, lengths))


def export_model(model, output_dir: str, buckets=None):
    """Write one program per (batch, frames) bucket (default ``[(4, 168)]``) and the
    weights, on the model's device. Returns the manifest's ``functions``."""
    os.makedirs(output_dir, exist_ok=True)
    buckets = [tuple(b) for b in (buckets or [(4, 168)])]
    device = model.device
    input_dim = model.encoder.cfg.input_size
    params = dict(model.state_dict())
    functions = []
    for b, t in buckets:
        max_tokens = model._max_tokens_for(t)
        speech = torch.zeros((b, t, input_dim), dtype=torch.float32, device=device)
        lengths = torch.full((b,), t, dtype=torch.int32, device=device)
        t0 = time.perf_counter()
        with torch.no_grad():
            program = torch.export.export(_Program(_Core(model, max_tokens)),
                                          (params, speech, lengths), strict=False)
        program.example_inputs = None  # they hold the weights: keep them out of the file
        name = f"model_b{b}_t{t}.pt2"
        torch.export.save(program, os.path.join(output_dir, name))
        functions.append({"file": name, "batch": b, "frames": t, "input_dim": input_dim,
                          "max_tokens": max_tokens,
                          "trace_s": round(time.perf_counter() - t0, 3)})
        logging.info("exported %s in %.1f s", name, functions[-1]["trace_s"])
    torch.save({k: v.detach().cpu() for k, v in params.items()},
               os.path.join(output_dir, "params.pt"))
    with open(os.path.join(output_dir, "export_manifest.json"), "w") as f:
        json.dump({"format": "torch.export", "device": device.type,
                   "functions": functions}, f, indent=2)
    return functions


def copy_sidecars(model_path, output_dir: str):
    """The files the runtime loads beside the programs, from the model dir."""
    for name in SIDECARS if model_path else ():
        src = os.path.join(model_path, name)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(output_dir, name))


def main_cli(argv=None):
    from funasr_tpu_torch.auto.auto_model import AutoModel
    from funasr_tpu_torch.bin._overrides import parse_overrides

    logging.basicConfig(level=logging.INFO)
    cfg = parse_overrides(sys.argv[1:] if argv is None else argv)
    if "model" not in cfg:
        raise SystemExit("pass ++model=<dir-or-alias>")
    output_dir = cfg.pop("output_dir", "exported")
    buckets = cfg.pop("buckets", [(4, 168)])
    if isinstance(buckets, str):
        buckets = ast.literal_eval(buckets)
    am = AutoModel(**cfg)
    am.export(output_dir=output_dir, buckets=buckets)
    logging.info("export complete -> %s", output_dir)


if __name__ == "__main__":
    main_cli()
