"""OpenAI-compatible transcription HTTP app (stdlib asyncio, no FastAPI dep; a copy of
``funasr_tpu/bin/_server_app.py`` over the port's ``AutoModel``).

Counterpart of FunASR ``funasr/bin/_server_app.py:213-562``: POST
``/v1/audio/transcriptions`` (multipart: file, model, language, response_format,
timestamp_granularities) -> {"text": ...} or verbose_json with segments; GET
``/v1/models``; GET ``/health``.
"""

from __future__ import annotations

import asyncio
import json
import logging
import re
from typing import Dict, Tuple


def parse_multipart(body: bytes, content_type: str) -> Dict[str, bytes]:
    """Minimal multipart/form-data parser -> {field_name: value_bytes}."""
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        raise ValueError("no multipart boundary")
    boundary = b"--" + m.group(1).encode()
    fields: Dict[str, bytes] = {}
    for part in body.split(boundary):
        part = part.strip(b"\r\n")
        if not part or part == b"--":
            continue
        if b"\r\n\r\n" not in part:
            continue
        head, _, value = part.partition(b"\r\n\r\n")
        nm = re.search(rb'name="([^"]+)"', head)
        if nm:
            fields[nm.group(1).decode()] = value
    return fields


class TranscriptionApp:
    def __init__(self, model, model_name: str = "funasr-tpu",
                 batch_wait_ms: float = 15.0, max_batch: int = 8):
        from funasr_tpu_torch.serving.batcher import BatchAggregator

        self.model = model  # AutoModel
        self.model_name = model_name
        # Triton-role cross-request dynamic batching: concurrent requests
        # decode as one batch instead of serializing (batch_wait_ms=0
        # still drains already-queued requests into one batch).
        self.batcher = BatchAggregator(model, max_batch=max_batch,
                                       max_wait_ms=batch_wait_ms)

    # -- request routing ----------------------------------------------------

    async def handle(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter):
        try:
            request = await reader.readuntil(b"\r\n\r\n")
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
            writer.close()
            return
        lines = request.decode("latin1").split("\r\n")
        try:
            method, path, _ = lines[0].split(" ", 2)
        except ValueError:
            writer.close()
            return
        headers = {}
        for line in lines[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        length = int(headers.get("content-length", 0))
        body = await reader.readexactly(length) if length else b""

        status, payload = await self.route(method, path, headers, body)
        data = json.dumps(payload, ensure_ascii=False).encode()
        writer.write(
            f"HTTP/1.1 {status}\r\nContent-Type: application/json\r\n"
            f"Content-Length: {len(data)}\r\nConnection: close\r\n\r\n".encode()
            + data)
        try:
            await writer.drain()
        finally:
            writer.close()

    async def route(self, method, path, headers, body) -> Tuple[str, dict]:
        if method == "GET" and path in ("/health", "/"):
            return "200 OK", {"status": "ok"}
        if method == "GET" and path == "/stats":
            return "200 OK", self.batcher.stats()
        if method == "GET" and path == "/v1/models":
            return "200 OK", {"object": "list", "data": [
                {"id": self.model_name, "object": "model",
                 "owned_by": "funasr-tpu"}]}
        if method == "POST" and path == "/v1/audio/transcriptions":
            try:
                return await self.transcribe(headers, body)
            except Exception as exc:  # noqa: BLE001 — surface as API error
                logging.exception("transcription failed")
                return "500 Internal Server Error", {
                    "error": {"message": str(exc), "type": "server_error"}}
        return "404 Not Found", {"error": {"message": f"no route {path}"}}

    async def transcribe(self, headers, body) -> Tuple[str, dict]:
        fields = parse_multipart(body, headers.get("content-type", ""))
        if "file" not in fields:
            return "400 Bad Request", {
                "error": {"message": "missing 'file' field", "type": "invalid_request_error"}}
        audio = fields["file"]
        language = fields.get("language", b"").decode() or None
        response_format = fields.get("response_format", b"json").decode()
        hotword = fields.get("hotword", b"").decode() or None

        kwargs = {}
        if language:
            kwargs["language"] = language
        if hotword:
            kwargs["hotword"] = hotword
        result = await self.batcher.submit(bytes(audio), **kwargs)
        results = [result]
        text = result.get("text", "")
        if response_format == "text":
            return "200 OK", {"text": text}
        if response_format == "verbose_json":
            segments = []
            sentence_info = results[0].get("sentence_info") if results else None
            if sentence_info:
                for i, s in enumerate(sentence_info):
                    segments.append({
                        "id": i, "start": s["start"] / 1000.0,
                        "end": s["end"] / 1000.0, "text": s["text"],
                        "speaker": s.get("spk")})
            elif results and results[0].get("timestamp"):
                ts = results[0]["timestamp"]
                segments.append({"id": 0, "start": ts[0][0] / 1000.0,
                                 "end": ts[-1][1] / 1000.0, "text": text})
            return "200 OK", {"task": "transcribe", "language": language or "zh",
                              "duration": segments[-1]["end"] if segments else None,
                              "text": text, "segments": segments}
        return "200 OK", {"text": text}


async def run_app(app: TranscriptionApp, host: str, port: int):
    server = await asyncio.start_server(app.handle, host, port)
    logging.info("funasr-tpu-torch server listening on %s:%d", host, port)
    async with server:
        await server.serve_forever()
