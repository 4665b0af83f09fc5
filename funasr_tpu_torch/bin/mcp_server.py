"""MCP (Model Context Protocol) stdio server exposing speech tools, over the port's
``AutoModel`` (a copy of ``funasr_tpu/bin/mcp_server.py``: the same messages and tools).

Counterpart of the reference's agent integration (FunASR
``examples/mcp_server/`` — an MCP server wrapping AutoModel so LLM agents can
transcribe audio). Stdlib-only JSON-RPC 2.0 over stdin/stdout implementing the
MCP handshake (initialize / notifications/initialized), ``tools/list`` and
``tools/call`` with:

- ``transcribe``: {"audio_path", "hotword"?, "language"?, "itn"?} -> text
- ``inverse_normalize``: {"text", "language"} -> written-form text

The model runs on the card unless ``--device cpu`` is given.

Usage:
    python -m funasr_tpu_torch.bin.mcp_server --model paraformer-zh [--vad-model ..]
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

PROTOCOL_VERSION = "2024-11-05"

TOOLS = [
    {
        "name": "transcribe",
        "description": "Transcribe an audio file (wav/pcm) to text.",
        "inputSchema": {
            "type": "object",
            "properties": {
                "audio_path": {"type": "string",
                               "description": "path to a 16 kHz wav/pcm file"},
                "hotword": {"type": "string",
                            "description": "space-separated biasing hotwords"},
                "language": {"type": "string"},
                "itn": {"type": "boolean",
                        "description": "apply inverse text normalization"},
            },
            "required": ["audio_path"],
        },
    },
    {
        "name": "inverse_normalize",
        "description": "Convert spoken-form numbers in text to written form.",
        "inputSchema": {
            "type": "object",
            "properties": {
                "text": {"type": "string"},
                "language": {"type": "string", "description": "zh/en/ja/..."},
            },
            "required": ["text"],
        },
    },
]


class McpServer:
    def __init__(self, model_kwargs):
        self._model_kwargs = model_kwargs
        self._model = None  # built lazily on first transcribe

    def _get_model(self):
        if self._model is None:
            from funasr_tpu_torch.auto.auto_model import AutoModel
            self._model = AutoModel(disable_pbar=True, **self._model_kwargs)
        return self._model

    # -- tool implementations ------------------------------------------------

    def tool_transcribe(self, args):
        gen_kwargs = {}
        for k in ("hotword", "language", "itn"):
            if args.get(k) is not None:
                gen_kwargs[k] = args[k]
        res = self._get_model().generate(input=args["audio_path"], **gen_kwargs)
        return res[0].get("text", "") if res else ""

    def tool_inverse_normalize(self, args):
        from funasr_tpu_torch.text.inverse_normalize import InverseNormalizer
        lang = str(args.get("language", "zh"))[:2]
        return InverseNormalizer(lang=lang).inverse_normalize(args["text"])

    # -- JSON-RPC ---------------------------------------------------------------

    def handle(self, req):
        method = req.get("method", "")
        params = req.get("params") or {}
        if method == "initialize":
            return {"protocolVersion": PROTOCOL_VERSION,
                    "capabilities": {"tools": {}},
                    "serverInfo": {"name": "funasr-tpu", "version": "1.0"}}
        if method == "tools/list":
            return {"tools": TOOLS}
        if method == "tools/call":
            name = params.get("name")
            args = params.get("arguments") or {}
            try:
                if name == "transcribe":
                    text = self.tool_transcribe(args)
                elif name == "inverse_normalize":
                    text = self.tool_inverse_normalize(args)
                else:
                    raise ValueError(f"unknown tool {name!r}")
                return {"content": [{"type": "text", "text": text}]}
            except Exception as e:  # noqa: BLE001 - surfaced to the client
                return {"content": [{"type": "text",
                                     "text": f"error: {type(e).__name__}: {e}"}],
                        "isError": True}
        if method == "ping":
            return {}
        return None  # notifications and unknown methods

    def serve(self, stdin=None, stdout=None):
        stdin = stdin or sys.stdin
        stdout = stdout or sys.stdout
        for line in stdin:
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
            except json.JSONDecodeError:
                continue
            if "id" not in req:  # notification
                continue
            result = self.handle(req)
            if result is None:
                resp = {"jsonrpc": "2.0", "id": req["id"],
                        "error": {"code": -32601,
                                  "message": f"method {req.get('method')!r} "
                                             f"not found"}}
            else:
                resp = {"jsonrpc": "2.0", "id": req["id"], "result": result}
            stdout.write(json.dumps(resp, ensure_ascii=False) + "\n")
            stdout.flush()


def main_cli(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", required=True)
    parser.add_argument("--vad-model", default=None)
    parser.add_argument("--punc-model", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)  # keep stdout clean for JSON-RPC
    kwargs = {"model": args.model, "log_level": "WARNING"}
    if args.vad_model:
        kwargs["vad_model"] = args.vad_model
    if args.punc_model:
        kwargs["punc_model"] = args.punc_model
    kwargs["device"] = args.device
    McpServer(kwargs).serve()


if __name__ == "__main__":
    main_cli()
