"""OpenAI-compatible API server CLI of the port (a copy of ``funasr_tpu/bin/server.py``;
counterpart of FunASR ``funasr/bin/server.py:25-108``).

Usage: funasr-tpu-torch-server --model <dir-or-alias> [--vad-model ...] [--punc-model ...]
       [--host 0.0.0.0] [--port 8000] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import logging


def main_cli(argv=None):
    parser = argparse.ArgumentParser(description="funasr-tpu-torch OpenAI-compatible server")
    parser.add_argument("--model", required=True)
    parser.add_argument("--vad-model", default=None)
    parser.add_argument("--punc-model", default=None)
    parser.add_argument("--spk-model", default=None)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a GPU) or cpu")
    parser.add_argument("--log-level", default="INFO")
    args = parser.parse_args(argv)
    logging.basicConfig(level=getattr(logging, args.log_level.upper()))

    from funasr_tpu_torch.auto.auto_model import AutoModel
    from funasr_tpu_torch.bin._server_app import TranscriptionApp, run_app

    model = AutoModel(model=args.model, vad_model=args.vad_model,
                      punc_model=args.punc_model, spk_model=args.spk_model,
                      device=args.device, disable_pbar=True)
    app = TranscriptionApp(model, model_name=args.model)
    asyncio.run(run_app(app, args.host, args.port))


if __name__ == "__main__":
    main_cli()
