"""Realtime WebSocket ASR server: offline / online / 2pass modes (a copy of
``funasr_tpu/bin/funasr_wss_server.py`` over the port's ``AutoModel``s).

Rebuild of the reference service (FunASR ``runtime/python/websocket/
funasr_wss_server.py``): the client sends a JSON config frame
``{"mode": "2pass"|"online"|"offline", "chunk_size": [5,10,5], "wav_name": ...,
"is_speaking": true, "hotwords": ..., "itn": ...}`` then binary 16 kHz PCM16 frames;
the server streams ``{"mode": "2pass-online", "text", "wav_name", "is_final"}``
partials from the streaming model and, on VAD endpoints (or ``is_speaking`` false),
``{"mode": "2pass-offline", ...}`` finals from the offline model + punctuation.

Runs on the stdlib-only websocket implementation (``funasr_tpu_torch.serving.ws_protocol``).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging

import numpy as np

from funasr_tpu_torch.serving.ws_protocol import ConnectionClosed, serve


class TwoPassSession:
    """Per-connection streaming state."""

    def __init__(self, server):
        self.server = server
        self.mode = "2pass"
        self.wav_name = "microphone"
        self.chunk_size = [0, 10, 5]
        self.chunk_interval = 10
        self.is_speaking = True
        self.hotword = None
        self.online_cache: dict = {}
        self.punc_online_cache: dict = {}
        self.vad_cache: dict = {}
        self.audio_buffer = np.zeros((0,), np.float32)  # since last endpoint
        self.online_buffer = np.zeros((0,), np.float32)
        self.text_online = ""
        # server-side endpointing (reference 2pass server: offline finals fire
        # on VAD endpoints, not only on client is_speaking=false)
        self.vad = None
        if server.vad is not None:
            from funasr_tpu_torch.models.fsmn_vad_streaming.dynamic_vad import (
                DynamicStreamingVAD)
            self.vad = DynamicStreamingVAD(server.vad)

    def config(self, msg: dict):
        self.mode = msg.get("mode", self.mode)
        self.wav_name = msg.get("wav_name", self.wav_name)
        if msg.get("chunk_size"):
            cs = msg["chunk_size"]
            self.chunk_size = cs if isinstance(cs, list) else json.loads(str(cs))
        self.hotword = msg.get("hotwords") or msg.get("hotword")
        if "is_speaking" in msg:
            self.is_speaking = bool(msg["is_speaking"])


class WSServer:
    def __init__(self, asr_model=None, asr_model_online=None, vad_model=None,
                 punc_model=None, punc_model_online=None):
        self.asr = asr_model
        self.asr_online = asr_model_online
        self.vad = vad_model
        self.punc = punc_model
        # streaming punc for 2pass-online partials (reference 2pass recipe:
        # ct-punc-realtime with a per-session cache)
        self.punc_online = punc_model_online

    async def handle(self, ws):
        sess = TwoPassSession(self)
        loop = asyncio.get_event_loop()
        while True:
            try:
                msg = await ws.recv()
            except ConnectionClosed:
                break
            if isinstance(msg, str):
                try:
                    cfg = json.loads(msg)
                except json.JSONDecodeError:
                    continue
                sess.config(cfg)
                if not sess.is_speaking:  # end of utterance -> final pass
                    await loop.run_in_executor(None, self._finalize, sess)
                    await self._emit_final(ws, sess)
                    sess.is_speaking = True
                continue
            pcm = np.frombuffer(msg, np.int16).astype(np.float32) / 32768.0
            sess.audio_buffer = np.concatenate([sess.audio_buffer, pcm])
            sess.online_buffer = np.concatenate([sess.online_buffer, pcm])
            if sess.vad is not None and sess.mode in ("2pass", "offline") \
                    and self.asr is not None:
                events = await loop.run_in_executor(None, sess.vad.feed, pcm)
                if any(ev[1] != -1 for ev in events):  # utterance endpoint
                    await loop.run_in_executor(None, self._finalize, sess)
                    await self._emit_final(ws, sess, is_final=False)
            stride = int(sess.chunk_size[1] * 960)
            if sess.mode in ("2pass", "online") and self.asr_online is not None \
                    and len(sess.online_buffer) >= stride:
                chunk = sess.online_buffer[:stride]
                sess.online_buffer = sess.online_buffer[stride:]
                text = await loop.run_in_executor(None, self._online_chunk, sess,
                                                  chunk, False)
                if text and self.punc_online is not None:
                    text = await loop.run_in_executor(
                        None, self._punc_online, sess, text)
                if text:
                    await ws.send(json.dumps({
                        "mode": f"{sess.mode}-online" if sess.mode == "2pass"
                        else "online",
                        "text": text, "wav_name": sess.wav_name,
                        "is_final": False}, ensure_ascii=False))

    # -- blocking model work (run in executor) ------------------------------

    def _online_chunk(self, sess, chunk, is_final) -> str:
        res = self.asr_online.generate(input=chunk, cache=sess.online_cache,
                                       is_final=is_final,
                                       chunk_size=sess.chunk_size)
        text = res[0]["text"] if res else ""
        sess.text_online += text
        return text

    def _punc_online(self, sess, text) -> str:
        """Streaming punctuation over the chunk's new words (the cache carries
        the unterminated sentence tail between calls)."""
        res = self.punc_online.generate(input=text,
                                        cache=sess.punc_online_cache)
        return res[0]["text"] if res else text

    def _finalize(self, sess):
        # flush the streaming model first: leftover online_buffer (< one stride)
        # plus is_final=True triggers the CIF tail-threshold fire, else the last
        # words are dropped in online-only mode
        if self.asr_online is not None and sess.mode in ("2pass", "online") \
                and sess.online_cache:
            chunk = sess.online_buffer
            sess.online_buffer = np.zeros((0,), np.float32)
            self._online_chunk(sess, chunk, True)
        if self.asr is None or len(sess.audio_buffer) == 0:
            sess.final_text = sess.text_online
            return
        res = self.asr.generate(input=sess.audio_buffer, hotword=sess.hotword)
        text = res[0]["text"] if res else ""
        if self.punc is not None and text.strip():
            punc_res = self.punc.generate(input=text)
            text = punc_res[0]["text"] if punc_res else text
        sess.final_text = text

    async def _emit_final(self, ws, sess, is_final: bool = True):
        mode = "2pass-offline" if sess.mode == "2pass" else sess.mode
        await ws.send(json.dumps({
            "mode": mode, "text": getattr(sess, "final_text", ""),
            "wav_name": sess.wav_name, "is_final": is_final},
            ensure_ascii=False))
        sess.audio_buffer = np.zeros((0,), np.float32)
        sess.online_buffer = np.zeros((0,), np.float32)
        sess.online_cache = {}
        sess.punc_online_cache = {}
        sess.text_online = ""


def build_server(args) -> WSServer:
    from funasr_tpu_torch.auto.auto_model import AutoModel

    device = getattr(args, "device", "cuda")
    asr = AutoModel(model=args.asr_model, punc_model=args.punc_model or None,
                    device=device, disable_pbar=True) if args.asr_model else None
    punc = None  # punctuation is folded into the offline AutoModel above
    online = AutoModel(model=args.asr_model_online, device=device,
                       disable_pbar=True) if args.asr_model_online else None
    punc_online = AutoModel(model=args.punc_model_online, device=device,
                            disable_pbar=True) \
        if getattr(args, "punc_model_online", "") else None
    vad = AutoModel(model=args.vad_model, device=device,
                    disable_pbar=True) if args.vad_model else None
    return WSServer(asr_model=asr, asr_model_online=online, vad_model=vad,
                    punc_model=punc, punc_model_online=punc_online)


def main_cli(argv=None):
    parser = argparse.ArgumentParser(description="funasr-tpu-torch 2pass websocket server")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=10095)
    parser.add_argument("--asr_model", default="")
    parser.add_argument("--asr_model_online", default="")
    parser.add_argument("--punc_model", default="")
    parser.add_argument("--punc_model_online", default="",
                        help="streaming punc (ct-punc-realtime) for "
                             "2pass-online partials")
    parser.add_argument("--vad_model", default="")
    # TLS (reference funasr_wss_server.py --certfile/--keyfile); empty = ws://
    parser.add_argument("--certfile", default="")
    parser.add_argument("--keyfile", default="")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a GPU) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    server = build_server(args)
    ssl_ctx = None
    if args.certfile:
        import ssl as ssl_mod
        ssl_ctx = ssl_mod.SSLContext(ssl_mod.PROTOCOL_TLS_SERVER)
        ssl_ctx.load_cert_chain(args.certfile, args.keyfile or None)

    async def run():
        srv = await serve(server.handle, args.host, args.port, ssl=ssl_ctx)
        logging.info("funasr-tpu-torch wss server listening on %s:%d", args.host, args.port)
        async with srv:
            await srv.serve_forever()

    asyncio.run(run())


if __name__ == "__main__":
    main_cli()
