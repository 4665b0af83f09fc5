"""Inference CLI of the port (a copy of ``funasr_tpu/bin/inference.py``; counterpart of
FunASR ``funasr/bin/inference.py:9-36``):
``python -m funasr_tpu_torch.bin.inference ++model=<dir-or-alias> ++input=audio.wav``.
Every other ``++key=value`` goes to ``AutoModel``: ``++device=cpu`` runs on the CPU (the
default is ``cuda``), ``++quant=w8a8`` / ``++bf16=True`` as in the Python API."""

from __future__ import annotations

import json
import logging
import sys


def main_cli(argv=None):
    from funasr_tpu_torch.auto.auto_model import AutoModel
    from funasr_tpu_torch.bin._overrides import parse_overrides

    logging.basicConfig(level=logging.INFO)
    cfg = parse_overrides(sys.argv[1:] if argv is None else argv)
    if "model" not in cfg:
        raise SystemExit("pass ++model=<dir-or-alias>")
    input_data = cfg.pop("input", None)
    if input_data is None:
        raise SystemExit("pass ++input=<wav/scp/jsonl>")
    model = AutoModel(**cfg)
    res = model.generate(input=input_data)
    for r in res:
        r.pop("punc_array", None)
        r.pop("spk_embedding", None)
        print(json.dumps(r, ensure_ascii=False, default=str))
    return res


if __name__ == "__main__":
    main_cli()
