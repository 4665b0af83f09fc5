"""Realtime streaming ASR WebSocket server (the modern service; a copy of
``funasr_tpu/bin/realtime_ws.py`` over the port's ``AutoModel``s).

Rebuild of FunASR ``funasr/bin/realtime_ws.py`` (1261 LoC):

* **endpoint modes** (ref ``:450-460, :980-999``): ``server`` — utterances end
  on DynamicStreamingVAD endpoints; ``client`` — no server VAD, the client's
  ``COMMIT`` message finalizes the pending utterance while the session stays
  open (``commit()``, ref ``:676-695``). Selected by ``--endpoint-mode`` or a
  per-session config frame ``{"endpoint_mode": ...}``.
* **audio-driven decode cadence** (ref ``should_decode :604-607``): the first
  partial fires after ``first_chunk_ms`` (480 ms) of audio, then one per
  ``chunk_ms`` (960 ms) of NEW audio — wall-clock timers would decode silence.
* **throttling under load** (the partial path must never build a backlog): a
  partial decode already in flight causes later cadence points to be skipped,
  not queued; the next partial naturally covers the newer audio. Finals are
  never skipped.
* **bounded partial windows** (ref ``:463-477``): interim decodes re-encode at
  most the last ``partial_window_sec`` so a long un-endpointed segment costs
  O(L), not O(L²); finals always decode the full utterance.
* **partial stability** (ref ``_record_partial_text :548-601``): consecutive
  partials with the same normalized text bump a ``stable`` counter clients can
  use to lock display text early.
* ``HOTWORDS:`` / ``POSTPROCESS_HOTWORDS:`` control messages, ``STOP``,
  HybridSpeakerTracker online diarization, forced finalize at
  ``max_utterance_sec`` (memory bound for endpoint-less streams).

Runs on the stdlib websocket implementation. One departure from the JAX copy: a VAD
worker that fails (a CUDA error, say) logs the exception and closes the session with
code 1011 instead of ending silently, so that the session cannot go on without
endpoints.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import re
from typing import List, Optional

import numpy as np

from funasr_tpu_torch.serving.ws_protocol import ConnectionClosed, serve

logger = logging.getLogger("realtime_ws")


def _normalize_transcript(text: str) -> str:
    """Whitespace/punctuation-insensitive form for stability comparison
    (ref _normalize_transcript role)."""
    return re.sub(r"[\s,，。.!?！？、;；:：]+", "", text).lower()


class HybridSpeakerTracker:
    """Online diarization: per-utterance speaker embedding matched to running
    centroids by cosine; new speakers spawn when below threshold
    (role of reference ``realtime_ws.py:203-250``). ``spk_model`` is the port's CAM++
    (``model.inference([audio])``), which holds its own weights."""

    def __init__(self, spk_model=None, threshold: float = 0.6, max_speakers: int = 16):
        self.model = spk_model
        self.threshold = threshold
        self.max_speakers = max_speakers
        self.centroids: List[np.ndarray] = []
        self.counts: List[int] = []

    def assign(self, audio: np.ndarray) -> Optional[int]:
        if self.model is None or len(audio) < 8000:
            return None
        res, _ = self.model.inference([audio])
        emb = np.asarray(res[0]["spk_embedding"])[0]
        emb = emb / (np.linalg.norm(emb) + 1e-9)
        best, best_sim = -1, -1.0
        for i, c in enumerate(self.centroids):
            sim = float(emb @ c)
            if sim > best_sim:
                best, best_sim = i, sim
        if best >= 0 and (best_sim >= self.threshold
                          or len(self.centroids) >= self.max_speakers):
            n = self.counts[best]
            self.centroids[best] = (self.centroids[best] * n + emb) / (n + 1)
            self.centroids[best] /= np.linalg.norm(self.centroids[best]) + 1e-9
            self.counts[best] += 1
            return best
        self.centroids.append(emb)
        self.counts.append(1)
        return len(self.centroids) - 1

    def stats(self) -> dict:
        return {"speaker_centers": len(self.centroids),
                "speaker_center_limit": self.max_speakers}


class RealtimeSession:
    def __init__(self, server, endpoint_mode: str = "server"):
        if endpoint_mode not in ("server", "client"):
            raise ValueError(f"unsupported endpoint mode: {endpoint_mode}")
        self.server = server
        self.endpoint_mode = endpoint_mode
        self.audio = np.zeros((0,), np.float32)   # current utterance
        self.total_samples = 0
        self.last_decode_samples = 0
        self.first_decode_done = False
        self.hotword: Optional[str] = None
        self.postprocess_hotwords: Optional[str] = None
        self.vad = (server.make_vad() if endpoint_mode == "server" else None)
        self.vad_pending = np.zeros((0,), np.float32)
        self.vad_queue: Optional[asyncio.Queue] = None
        self.vad_task: Optional[asyncio.Task] = None
        self.fin_lock = asyncio.Lock()
        self.utt_index = 0
        self.start_ms = 0
        # partial stability tracking
        self.last_partial_norm = ""
        self.partial_stable_count = 0
        # in-flight partial decode guard (throttle, never a backlog)
        self.partial_busy = False


class RealtimeWSServer:
    def __init__(self, asr_model, vad_model=None, spk_model=None,
                 chunk_ms: int = 960, first_chunk_ms: int = 480,
                 partial_window_sec: float = 15.0,
                 max_utterance_sec: float = 300.0,
                 endpoint_mode: str = "server",
                 sample_rate: int = 16000,
                 decode_interval: Optional[float] = None,
                 vad_feed_ms: int = 60):
        self.asr = asr_model  # AutoModel (offline, may include punc)
        self.vad_model = vad_model
        self.spk_tracker_factory = (
            (lambda: HybridSpeakerTracker(spk_model.model))
            if spk_model is not None else (lambda: None))
        # back-compat: a wall-clock decode_interval maps onto the audio cadence
        if decode_interval is not None:
            chunk_ms = int(decode_interval * 1000)
        self.chunk_samples = max(int(sample_rate * chunk_ms / 1000), 1)
        self.first_chunk_samples = max(
            int(sample_rate * first_chunk_ms / 1000), 1)
        self.partial_window = int(partial_window_sec * sample_rate)
        self.max_utterance_samples = int(max_utterance_sec * sample_rate)
        self.default_endpoint_mode = (endpoint_mode
                                      if self.vad_model is not None
                                      else "client")
        self.sample_rate = sample_rate
        # audio batched per VAD model call (60 = per-VAD-frame, the reference
        # cadence; raise on high-latency devices to cut dispatch count at the
        # cost of up-to-vad_feed_ms later endpoints)
        self.vad_feed_samples = max(int(sample_rate * vad_feed_ms / 1000), 1)

    def make_vad(self):
        if self.vad_model is None:
            return None
        from funasr_tpu_torch.models.fsmn_vad_streaming.dynamic_vad import (
            DynamicStreamingVAD)
        return DynamicStreamingVAD(self.vad_model)

    # ------------------------------------------------------------------

    def _decode(self, audio: np.ndarray, hotword=None, **cfg) -> str:
        if len(audio) < 800:
            return ""
        kwargs = dict(cfg)
        if hotword:
            kwargs["hotword"] = hotword
        res = self.asr.generate(input=audio, **kwargs)
        return res[0]["text"] if res else ""

    def _should_decode(self, sess: RealtimeSession) -> bool:
        """Audio-driven cadence (ref should_decode): 480 ms to the first
        partial, then every 960 ms of fresh audio."""
        threshold = (self.chunk_samples if sess.first_decode_done
                     else self.first_chunk_samples)
        return sess.total_samples - sess.last_decode_samples >= threshold

    async def handle(self, ws):
        sess = RealtimeSession(self, self.default_endpoint_mode)
        tracker = self.spk_tracker_factory()
        loop = asyncio.get_event_loop()
        try:
            await self._handle_loop(ws, sess, tracker, loop)
        finally:
            if sess.vad_task is not None:
                sess.vad_task.cancel()

    async def _handle_loop(self, ws, sess, tracker, loop):
        while True:
            try:
                msg = await ws.recv()
            except ConnectionClosed:
                break
            if isinstance(msg, str):
                if not await self._handle_control(ws, sess, tracker, loop, msg):
                    break
                continue

            pcm = np.frombuffer(msg, np.int16).astype(np.float32) / 32768.0
            sess.audio = np.concatenate([sess.audio, pcm])
            sess.total_samples += len(pcm)

            # server VAD endpointing. Scaling rules learned from the
            # service-metrics harness (benchmarks/bench_realtime_ws.py):
            # (1) VAD runs in a PER-SESSION WORKER TASK — an inline await
            # per frame makes the socket reader lag the paced stream, so a
            # STOP arrives (and finalizes) seconds late even though decode
            # itself is fast; (2) frames batch up to vad_feed_samples per
            # model call; (3) the feed itself runs in the executor so the
            # event loop never blocks on a device dispatch. Endpoint finals
            # may lag under load (bounded by the worker queue), STOP finals
            # never do.
            if sess.vad is not None:
                if sess.vad_task is None:
                    sess.vad_queue = asyncio.Queue()
                    sess.vad_task = asyncio.ensure_future(
                        self._vad_worker(ws, sess, tracker, loop))
                sess.vad_pending = np.concatenate([sess.vad_pending, pcm])
                if len(sess.vad_pending) >= self.vad_feed_samples:
                    sess.vad_queue.put_nowait(sess.vad_pending)
                    sess.vad_pending = np.zeros((0,), np.float32)
            # memory/latency bound for endpoint-less streams
            if len(sess.audio) >= self.max_utterance_samples:
                logger.warning("utterance exceeded %ds; forcing finalize",
                               self.max_utterance_samples // self.sample_rate)
                await self._finalize(ws, sess, tracker, loop)

            # interim partial decode: audio-driven cadence, run as a
            # BACKGROUND task so socket reads keep draining; cadence points
            # hit while a previous partial is still decoding are skipped,
            # never queued (the next partial covers the newer audio anyway)
            if (self._should_decode(sess) and len(sess.audio)
                    and not sess.partial_busy):
                sess.last_decode_samples = sess.total_samples
                sess.partial_busy = True
                window = (sess.audio[-self.partial_window:]
                          if self.partial_window else sess.audio)
                asyncio.ensure_future(
                    self._partial_task(ws, sess, loop, window,
                                       sess.utt_index))

    async def _vad_worker(self, ws, sess, tracker, loop):
        """Per-session ordered VAD pipeline: consumes queued audio batches,
        scores them off-loop, and finalizes on endpoints (serialized against
        STOP/COMMIT finals via sess.fin_lock). Any other failure is logged and closes
        the session with 1011: a session whose worker died would never endpoint
        again."""
        try:
            while True:
                feed = await sess.vad_queue.get()
                if feed is None or getattr(sess, "vad_closing", False):
                    return
                events = await loop.run_in_executor(
                    None, lambda f=feed: sess.vad.feed(f))
                for ev in events:
                    if ev[1] != -1:  # endpoint
                        async with sess.fin_lock:
                            await self._finalize(ws, sess, tracker, loop)
        except asyncio.CancelledError:
            pass
        except ConnectionClosed:
            pass
        except Exception:  # noqa: BLE001 — the session's boundary: report and close
            logger.exception("VAD worker failed; closing the session")
            await ws.close(code=1011)

    async def _partial_task(self, ws, sess, loop, window, utt_index):
        try:
            text = await loop.run_in_executor(
                None, lambda: self._decode(window, sess.hotword))
        finally:
            sess.partial_busy = False
        # the utterance may have been finalized while we decoded — a stale
        # partial would arrive after its final, confusing clients
        if not text or sess.utt_index != utt_index:
            return
        sess.first_decode_done = True
        norm = _normalize_transcript(text)
        if norm and norm == sess.last_partial_norm:
            sess.partial_stable_count += 1
        else:
            sess.partial_stable_count = 1
        sess.last_partial_norm = norm
        try:
            await ws.send(json.dumps(
                {"type": "partial", "text": text, "utt": utt_index,
                 "stable": sess.partial_stable_count,
                 "is_final": False}, ensure_ascii=False))
        except ConnectionClosed:
            pass

    async def _handle_control(self, ws, sess, tracker, loop, msg) -> bool:
        """Returns False when the session should close."""
        stripped = msg.strip()
        if stripped.upper().startswith("STOP"):
            # retire the VAD worker first: queued batches are moot at STOP
            # (everything unfinalized decodes below), and any IN-FLIGHT
            # endpoint finalize completes before the worker returns, so no
            # utterance is half-finalized
            if sess.vad_task is not None:
                sess.vad_closing = True
                while not sess.vad_queue.empty():
                    sess.vad_queue.get_nowait()
                sess.vad_queue.put_nowait(None)
                await sess.vad_task
                sess.vad_task = None
            async with sess.fin_lock:
                await self._finalize(ws, sess, tracker, loop)
            return False
        if stripped.upper().startswith("COMMIT"):
            # client-delimited endpoint: finalize the pending utterance,
            # keep the session open (ref commit():676-695)
            if sess.endpoint_mode != "client":
                await ws.send(json.dumps(
                    {"error": "COMMIT requires endpoint_mode=client"}))
                return True
            async with sess.fin_lock:
                await self._finalize(ws, sess, tracker, loop)
            return True
        if stripped.startswith("HOTWORDS:"):
            sess.hotword = stripped[len("HOTWORDS:"):].strip() or None
            return True
        if stripped.startswith("POSTPROCESS_HOTWORDS:"):
            sess.postprocess_hotwords = \
                stripped[len("POSTPROCESS_HOTWORDS:"):].strip() or None
            return True
        try:
            cfg = json.loads(stripped)
        except json.JSONDecodeError:
            return True
        sess.hotword = cfg.get("hotwords", sess.hotword)
        mode = cfg.get("endpoint_mode")
        if mode:
            if mode not in ("server", "client"):
                await ws.send(json.dumps(
                    {"error": f"unsupported endpoint mode: {mode}"}))
                return True
            sess.endpoint_mode = mode
            if mode == "client":
                sess.vad = None
            elif sess.vad is None:
                sess.vad = self.make_vad()
        return True

    async def _finalize(self, ws, sess, tracker, loop):
        audio = sess.audio
        sess.audio = np.zeros((0,), np.float32)
        sess.last_decode_samples = sess.total_samples
        sess.first_decode_done = False
        sess.last_partial_norm = ""
        sess.partial_stable_count = 0
        if len(audio) < 800:
            return
        cfg = {}
        if sess.postprocess_hotwords:
            cfg["postprocess_hotwords"] = sess.postprocess_hotwords
        text = await loop.run_in_executor(
            None, lambda: self._decode(audio, sess.hotword, **cfg))
        spk = tracker.assign(audio) if tracker is not None else None
        end_ms = sess.total_samples * 1000 // self.sample_rate
        payload = {"type": "final", "text": text, "utt": sess.utt_index,
                   "start_ms": sess.start_ms, "end_ms": end_ms,
                   "is_final": True}
        if spk is not None:
            payload["spk"] = int(spk)
        sess.start_ms = end_ms
        sess.utt_index += 1
        await ws.send(json.dumps(payload, ensure_ascii=False))


def main_cli(argv=None):
    parser = argparse.ArgumentParser(description="funasr-tpu-torch realtime websocket server")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=10096)
    parser.add_argument("--model", required=True)
    parser.add_argument("--vad-model", default=None)
    parser.add_argument("--punc-model", default=None)
    parser.add_argument("--spk-model", default=None)
    parser.add_argument("--endpoint-mode", default="server",
                        choices=["server", "client"],
                        help="server: VAD endpoints; client: COMMIT messages "
                             "delimit utterances (no server VAD)")
    parser.add_argument("--chunk-ms", type=int, default=960,
                        help="fresh audio per interim partial decode")
    parser.add_argument("--first-chunk-ms", type=int, default=480,
                        help="audio before the first partial decode")
    parser.add_argument("--partial-window-sec", type=float, default=15.0)
    parser.add_argument("--max-utterance-sec", type=float, default=300.0)
    parser.add_argument("--certfile", default="", help="TLS cert; empty = ws://")
    parser.add_argument("--keyfile", default="")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a GPU) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from funasr_tpu_torch.auto.auto_model import AutoModel
    asr = AutoModel(model=args.model, punc_model=args.punc_model, device=args.device,
                    disable_pbar=True)
    vad = AutoModel(model=args.vad_model, device=args.device,
                    disable_pbar=True) if args.vad_model else None
    spk = AutoModel(model=args.spk_model, device=args.device,
                    disable_pbar=True) if args.spk_model else None
    server = RealtimeWSServer(asr, vad_model=vad, spk_model=spk,
                              chunk_ms=args.chunk_ms,
                              first_chunk_ms=args.first_chunk_ms,
                              partial_window_sec=args.partial_window_sec,
                              max_utterance_sec=args.max_utterance_sec,
                              endpoint_mode=args.endpoint_mode)

    ssl_ctx = None
    if args.certfile:
        import ssl as ssl_mod
        ssl_ctx = ssl_mod.SSLContext(ssl_mod.PROTOCOL_TLS_SERVER)
        ssl_ctx.load_cert_chain(args.certfile, args.keyfile or None)

    async def run():
        srv = await serve(server.handle, args.host, args.port, ssl=ssl_ctx)
        logger.info("realtime ws server on %s:%d (endpoint_mode=%s)",
                    args.host, args.port, server.default_endpoint_mode)
        async with srv:
            await srv.serve_forever()

    asyncio.run(run())


if __name__ == "__main__":
    main_cli()
