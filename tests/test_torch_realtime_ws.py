"""The port's realtime WebSocket server against the JAX package's (CPU).

The same client scripts go to ``funasr_tpu.bin.realtime_ws.RealtimeWSServer`` over the
JAX ``AutoModel`` and to the port's over the port's ``AutoModel`` (model directories
written from the port's seeded modules), over real localhost sockets. Only what is
deterministic is compared: in ``client`` endpoint mode the ``COMMIT`` and ``STOP`` finals
(text, utterance index, start / end ms), the ``COMMIT``-rejected error; partials, whose
cadence depends on timing, are held by their invariants (``stable`` >= 1, never after
their utterance's final), as ``tests/test_realtime_ws.py`` does. In ``server`` mode (VAD
endpoints, CAM++ speakers) the finals keep their order and spans, and every decode
equals the same decode alone. ``HybridSpeakerTracker`` assigns the same speakers as
JAX's on the same embeddings. A VAD worker that fails closes the session with 1011.
"""

import asyncio
import json

import numpy as np
import pytest

from funasr_tpu.auto import auto_model as jauto
from funasr_tpu.bin import realtime_ws as jrt
from funasr_tpu.serving import ws_protocol as jws
from funasr_tpu_torch import AutoModel
from funasr_tpu_torch.bin import realtime_ws as trt
from funasr_tpu_torch.serving import ws_protocol as tws
from torch_parity_util import (FS, free_port, one_torch_thread, pcm16, speech,  # noqa: F401
                               write_asr_dir, write_punc_dir, write_spk_dir, write_vad_dir)

# two COMMIT-delimited utterances and a tail that STOP finalizes
CLIENT_WAVES = [speech(1.6, [(0.1, 1.5, 220.0)], seed=1),
                speech(2.3, [(0.2, 2.1, 310.0)], seed=2),
                speech(0.9, [(0.1, 0.8, 150.0)], seed=3)]
# bursts 2.6 s apart: the dynamic VAD's first schedule step (2 s + 150 ms) endpoints each
SERVER_WAV = speech(9.0, [(0.3, 2.0, 220.0), (4.6, 6.2, 330.0)], seed=4)
FINAL_KEYS = ("type", "text", "utt", "start_ms", "end_ms", "is_final")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    mk = tmp_path_factory.mktemp
    return dict(asr=write_asr_dir(mk("asr")), vad=write_vad_dir(mk("vad")),
                punc=write_punc_dir(mk("punc")), spk=write_spk_dir(mk("spk")))


def build(auto_model, **kw):
    return auto_model(**kw, device="cpu", log_level="WARNING", disable_pbar=True)


@pytest.fixture(scope="module")
def asr_pair(dirs):
    kw = dict(model=dirs["asr"], punc_model=dirs["punc"])
    return build(AutoModel, **kw), build(jauto.AutoModel, **kw)


def talk(server, client_side, script):
    """Serve ``server`` on a free port and run ``script(ws)``; its result."""
    port = free_port()

    async def scenario():
        srv = await client_side.serve(server.handle, "127.0.0.1", port)
        try:
            ws = await client_side.connect("127.0.0.1", port)
            try:
                return await script(ws)
            finally:
                await ws.close()
        finally:
            srv.close()
            await srv.wait_closed()

    return asyncio.run(scenario())


async def drain_until_final(ws, msgs):
    while True:
        msgs.append(json.loads(await asyncio.wait_for(ws.recv(), 120)))
        if msgs[-1].get("is_final"):
            return


async def client_script(ws):
    """Each utterance in 100 ms frames then ``COMMIT`` (the last: ``STOP``); every
    message up to the last final."""
    msgs = []
    for i, wav in enumerate(CLIENT_WAVES):
        data = pcm16(wav)
        for j in range(0, len(data), 1600):
            await ws.send(data[j:j + 1600].tobytes())
        await ws.send("STOP" if i == len(CLIENT_WAVES) - 1 else "COMMIT")
        await drain_until_final(ws, msgs)
    return msgs


def check_partials(msgs):
    """Partials carry ``stable`` >= 1 and never arrive after their utterance's final."""
    finals_seen = set()
    for m in msgs:
        if m["type"] == "final":
            finals_seen.add(m["utt"])
        else:
            assert m["type"] == "partial" and m["stable"] >= 1 and m["text"]
            assert m["utt"] not in finals_seen, msgs


def test_client_mode_commit_and_stop_finals_match_jax(asr_pair):
    port, ref = asr_pair
    kw = dict(chunk_ms=200, first_chunk_ms=200, endpoint_mode="client")
    got = talk(trt.RealtimeWSServer(port, **kw), tws, client_script)
    want = talk(jrt.RealtimeWSServer(ref, **kw), jws, client_script)
    finals = [{k: m[k] for k in FINAL_KEYS} for m in got if m["type"] == "final"]
    assert finals == [{k: m[k] for k in FINAL_KEYS} for m in want if m["type"] == "final"]
    assert [f["utt"] for f in finals] == [0, 1, 2]
    assert all(f["text"] for f in finals)
    assert [f["end_ms"] for f in finals] == list(np.cumsum(
        [len(w) * 1000 // FS for w in CLIENT_WAVES]))
    # each COMMIT final is the decode of exactly the audio committed
    for f, wav in zip(finals, CLIENT_WAVES):
        assert f["text"] == port.generate(input=pcm16(wav).astype(np.float32) / 32768)[0]["text"]
    check_partials(got)
    check_partials(want)


@pytest.mark.parametrize("side", ["port", "jax"])
def test_commit_in_server_mode_is_rejected(asr_pair, side):
    am = asr_pair[0] if side == "port" else asr_pair[1]
    mod, ws_mod = (trt, tws) if side == "port" else (jrt, jws)

    async def script(ws):
        await ws.send(json.dumps({"endpoint_mode": "server"}))
        await ws.send("COMMIT")
        return json.loads(await asyncio.wait_for(ws.recv(), 30))

    assert talk(mod.RealtimeWSServer(am, chunk_ms=100), ws_mod, script) == {
        "error": "COMMIT requires endpoint_mode=client"}


def test_server_mode_finals_with_vad_endpoints_and_speakers(dirs, asr_pair):
    """VAD endpoints and CAM++ speakers: finals in order from utterance 0 with rising,
    contiguous time spans up to the stream's end (STOP finalizes the rest), an integer
    ``spk`` on the finals long enough for one, and every decode the server made (partial
    windows and finals, whose executor calls overlap) equal to the same decode alone.
    An endpoint final's span is not its audio: it ends where the stream had reached when
    its decode returned, as in the JAX server."""
    port = asr_pair[0]
    server = trt.RealtimeWSServer(port, vad_model=build(AutoModel, model=dirs["vad"]),
                                  spk_model=build(AutoModel, model=dirs["spk"]),
                                  chunk_ms=480, first_chunk_ms=480, vad_feed_ms=120)
    decodes, decode = [], server._decode

    def recorded(audio, hotword=None, **cfg):
        text = decode(audio, hotword, **cfg)
        decodes.append((audio, text))
        return text
    server._decode = recorded
    data = pcm16(SERVER_WAV)

    async def script(ws):
        msgs = []
        for j in range(0, len(data), 960):  # 60 ms frames
            await ws.send(data[j:j + 960].tobytes())
            if j == 960 * 80:  # 4.8 s: past the first endpoint (2.0 s + 2.15 s)
                await drain_until_final(ws, msgs)
        await ws.send("STOP")
        try:
            while True:
                msgs.append(json.loads(await asyncio.wait_for(ws.recv(), 120)))
        except tws.ConnectionClosed:
            return msgs

    msgs = talk(server, tws, script)
    finals = [m for m in msgs if m["type"] == "final"]
    assert len(finals) >= 2, msgs
    assert [f["utt"] for f in finals] == list(range(len(finals)))
    assert finals[0]["start_ms"] == 0 and finals[-1]["end_ms"] == len(data) * 1000 // FS
    for a, b in zip(finals, finals[1:]):
        assert b["start_ms"] == a["end_ms"] < b["end_ms"]
    assert all(isinstance(f.get("spk", 0), int) for f in finals)
    assert any("spk" in f for f in finals)
    assert len(decodes) > len(finals)
    for audio, text in decodes:
        assert text == port.generate(input=audio)[0]["text"]
    check_partials(msgs)


class StubSpeakerModel:
    """Returns the next of a fixed list of embeddings per call, in the calling contract
    of each package (JAX: ``inference(params, [audio])``, the port: ``inference([audio])``)."""

    def __init__(self, embeddings, jax_contract):
        self.embeddings, self.jax_contract = iter(embeddings), jax_contract

    def inference(self, *args):
        assert len(args) == (2 if self.jax_contract else 1)
        return [{"spk_embedding": next(self.embeddings)[None]}], {}


def test_hybrid_speaker_tracker_matches_jax():
    """Two speakers' embedding clouds, a third voice and near-threshold cases, at the
    default threshold and with a speaker cap: equal assignments and centroid counts."""
    r = np.random.default_rng(0)
    centers = r.standard_normal((3, 16))
    embs = [centers[i] + r.standard_normal(16) * s
            for i, s in zip(r.integers(0, 3, 40), r.uniform(0.1, 1.2, 40))]
    audio = np.zeros(8000, np.float32)
    for kw in (dict(), dict(threshold=0.3), dict(max_speakers=2)):
        port = trt.HybridSpeakerTracker(StubSpeakerModel(embs, False), **kw)
        ref = jrt.HybridSpeakerTracker(StubSpeakerModel(embs, True), None, **kw)
        got = [port.assign(audio) for _ in embs]
        assert got == [ref.assign(audio) for _ in embs]
        assert port.stats() == ref.stats() and port.counts == ref.counts
        assert port.assign(audio[:7999]) is None  # under 0.5 s: no speaker


def test_vad_worker_failure_closes_the_session_with_1011(asr_pair):
    """The JAX worker dies silently on any error but a closed connection, and its session
    never endpoints again; the port's logs it and closes the session with 1011."""

    class FailingVAD:
        def feed(self, pcm):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

    server = trt.RealtimeWSServer(asr_pair[0], vad_model=object(), vad_feed_ms=60)
    server.make_vad = FailingVAD

    async def script(ws):
        await ws.send(pcm16(SERVER_WAV[:1920]).tobytes())
        while True:
            opcode, _, payload = await asyncio.wait_for(ws._read_frame(), 30)
            if opcode == tws.OP_CLOSE:
                return int.from_bytes(payload[:2], "big")

    assert talk(server, tws, script) == 1011


def test_partial_stability_counter():
    """``tests/test_realtime_ws.py``'s stability test on the port: consecutive partials
    with the same normalized text bump ``stable``; a changed text resets it to 1."""
    server = trt.RealtimeWSServer(None, chunk_ms=50, first_chunk_ms=50, endpoint_mode="client")
    texts = iter(["你好", "你好。", "你好，", "你好 世界", "你好世界"])
    server._decode = lambda audio, hotword=None, **cfg: next(texts, "你好世界")
    pcm = pcm16(np.random.default_rng(2).standard_normal(1600) * 0.1)

    async def script(ws):
        partials = []
        for _ in range(6):
            await ws.send(pcm.tobytes())
            try:
                while len(partials) < 6:
                    m = json.loads(await asyncio.wait_for(ws.recv(), 2))
                    if m.get("type") == "partial":
                        partials.append(m)
                        break
            except asyncio.TimeoutError:
                pass
        await ws.send("STOP")
        return partials

    stables = [p["stable"] for p in talk(server, tws, script)]
    assert len(stables) >= 4 and stables[:3] == [1, 2, 3], stables
    assert 1 in stables[3:], stables
