"""Serving in the PyTorch port against the JAX package's servers (CPU).

The same client scripts go to a JAX server over the JAX ``AutoModel`` and to the port's
server over the port's ``AutoModel``, both on model directories written from the port's
seeded modules (``torch_parity_util.write_*_dir``), over real localhost sockets:

* ``serving/ws_protocol``: frames either side sends decode equal on the other (text,
  binary, 16- and 64-bit lengths, fragmentation, ping / pong); a frame over the cap
  closes with 1009;
* ``serving/batcher``: the stub-model batching test of ``tests/test_serving.py``; a real
  model's concurrent requests each get their own row of their group's ``generate``;
  ``parse_multipart`` and ``metrics/wer.py`` equal;
* ``bin/funasr_wss_server``: the 2-pass messages (online partials through the streaming
  model and realtime punctuation, offline finals at VAD endpoints and at
  ``is_speaking: false``) equal; two sessions at once equal the same two in sequence.

The HTTP responses are in ``test_torch_serving_http.py``, the CLIs in
``test_torch_serving_cli.py``, the realtime server in ``test_torch_realtime_ws.py``.
"""

import asyncio
import hashlib
import json
import os
import struct
import sys
import time

import numpy as np
import pytest

from funasr_tpu.auto import auto_model as jauto
from funasr_tpu.bin import _server_app as japp
from funasr_tpu.bin import funasr_wss_server as jwss
from funasr_tpu.serving import ws_protocol as jws
from funasr_tpu_torch import AutoModel
from funasr_tpu_torch.bin import _server_app as tapp
from funasr_tpu_torch.bin import funasr_wss_server as twss
from funasr_tpu_torch.serving import ws_protocol as tws
from torch_parity_util import (FS, free_port, multipart, one_torch_thread, pcm16,  # noqa: F401
                               serve_http, speech, wav_bytes, write_asr_dir, write_punc_dir,
                               write_punc_realtime_dir, write_streaming_dir, write_vad_dir)

TWO_PASS = dict(mode="2pass", chunk_size=[5, 10, 5])
FRAME = 9600  # 600 ms of PCM16 a binary frame, the 2-pass client's

# 2.5 s gaps: the dynamic VAD's first schedule step (2 s + 150 ms) ends each utterance
STREAM_WAV = speech(11.0, [(0.3, 2.4, 220.0), (4.9, 7.0, 330.0), (9.5, 10.6, 150.0)])


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    mk = tmp_path_factory.mktemp
    return dict(asr=write_asr_dir(mk("asr")), vad=write_vad_dir(mk("vad")),
                punc=write_punc_dir(mk("punc")), online=write_streaming_dir(mk("online")),
                punc_online=write_punc_realtime_dir(mk("punc_online")))


def build(auto_model, **kw):
    return auto_model(**kw, device="cpu", log_level="WARNING", disable_pbar=True)


# ---------------------------------------------------------------------------
# ws_protocol
# ---------------------------------------------------------------------------

# (messages the client sends, fragment size or None): text, binary at each length form
WS_CASES = {
    "text": (["你好 hello", "", "{\"is_speaking\": false}"], None),
    "binary_7_16_64bit": ([b"\x01" * 125, bytes(range(256)) * 200, b"\xab" * 70000], None),
    "fragmented": (["分片" * 300, b"\x02" * 5000], 700),
}


async def _send_fragmented(ws, message, size):
    """One message as a first frame and continuation frames of ``size`` bytes."""
    payload = message.encode() if isinstance(message, str) else message
    opcode = tws.OP_TEXT if isinstance(message, str) else tws.OP_BIN
    parts = [payload[i:i + size] for i in range(0, len(payload), size)] or [b""]
    for i, part in enumerate(parts):
        first = bytes([(0x80 if i == len(parts) - 1 else 0) | (opcode if i == 0 else 0)])
        n = len(part)
        head = first + (bytes([0x80 | n]) if n < 126 else
                        bytes([0x80 | 126]) + struct.pack(">H", n))
        mask = os.urandom(4)
        ws.writer.write(head + mask + bytes(b ^ mask[j % 4] for j, b in enumerate(part)))
    await ws.writer.drain()


@pytest.mark.parametrize("case", sorted(WS_CASES))
@pytest.mark.parametrize("server_side,client_side", [(tws, jws), (jws, tws)],
                         ids=["port_server", "jax_server"])
def test_ws_frames_decode_equal_across_packages(case, server_side, client_side):
    """Messages a client of one package sends (with a ping between them) reach a server
    of the other whole; the server echoes each, and the client reads the echo back."""
    messages, fragment = WS_CASES[case]
    port = free_port()
    got = []

    async def handler(ws):
        while True:
            msg = await ws.recv()
            got.append(msg)
            await ws.send(msg)

    async def scenario():
        srv = await server_side.serve(handler, "127.0.0.1", port)
        try:
            ws = await client_side.connect("127.0.0.1", port)
            echoes = []
            for msg in messages:
                await ws._send_frame(client_side.OP_PING, b"p")
                if fragment:
                    await _send_fragmented(ws, msg, fragment)
                else:
                    await ws.send(msg)
                echoes.append(await asyncio.wait_for(ws.recv(), 10))  # the pong is skipped
            await ws.close()
            return echoes
        finally:
            srv.close()
            await srv.wait_closed()

    echoes = asyncio.run(scenario())
    assert got == messages and echoes == messages


@pytest.mark.parametrize("server_side", [tws, jws], ids=["port", "jax"])
def test_ws_frame_over_the_cap_closes_with_1009(server_side):
    """A frame header declaring 2^33 bytes: the server closes with 1009 instead of
    buffering, in both packages; the cap is 64 MiB in both."""
    port = free_port()
    got = {}

    async def handler(ws):
        try:
            got["msg"] = await ws.recv()
        except server_side.ConnectionClosed:
            got["closed"] = True

    async def scenario():
        srv = await server_side.serve(handler, "127.0.0.1", port)
        try:
            ws = await tws.connect("127.0.0.1", port)
            ws.writer.write(bytes([0x82, 0xFF]) + struct.pack(">Q", 1 << 33) + b"\0" * 4)
            await ws.writer.drain()
            opcode, _, payload = await asyncio.wait_for(ws._read_frame(), 10)
            ws.writer.close()
            return opcode, payload
        finally:
            srv.close()
            await srv.wait_closed()

    opcode, payload = asyncio.run(scenario())
    assert opcode == tws.OP_CLOSE and struct.unpack(">H", payload)[0] == 1009
    assert got == {"closed": True}
    assert tws.MAX_MESSAGE_BYTES == jws.MAX_MESSAGE_BYTES == 64 * 1024 * 1024


# ---------------------------------------------------------------------------
# the HTTP app and its batcher
# ---------------------------------------------------------------------------

def test_parse_multipart_matches_jax(rng):
    for seed in range(4):
        r = np.random.default_rng(seed)
        data = r.integers(0, 256, int(r.integers(0, 3000)), dtype=np.uint8).tobytes()
        fields = {f"f{i}": "".join(chr(int(c)) for c in r.integers(0x4E00, 0x4E80, 5))
                  for i in range(int(r.integers(0, 4)))}
        body, ctype = multipart(data, **fields)
        assert tapp.parse_multipart(body, ctype) == japp.parse_multipart(body, ctype)
    with pytest.raises(ValueError, match="boundary"):
        tapp.parse_multipart(b"", "multipart/form-data")


def test_batcher_coalesces_concurrent_requests_and_keeps_rows_apart():
    """The stub-model test of ``tests/test_serving.py::test_cross_request_dynamic_batching``
    on the port's app: 8 concurrent requests decode in at most 4 ``generate`` calls, and
    each client gets the fingerprint of its own audio."""

    class StubModel:
        def generate(self, input, **kwargs):
            time.sleep(0.05)  # a decode long enough for requests to pile up
            return [{"text": hashlib.sha1(a).hexdigest()[:12]} for a in input]

    app = tapp.TranscriptionApp(StubModel(), batch_wait_ms=200, max_batch=8)
    data = [wav_bytes(np.random.default_rng(s).standard_normal(FS).astype(np.float32) * 0.1)
            for s in range(8)]
    out = serve_http(app, [(d, {}) for d in data])
    assert [p["text"] for _, p in out] == [hashlib.sha1(d).hexdigest()[:12] for d in data]
    stats = app.batcher.stats()
    assert stats["requests"] == 8 and stats["generate_calls"] <= 4, stats
    assert stats["max_batch_seen"] >= 2, stats


class GroupRecorder:
    """Wraps an ``AutoModel``'s ``generate``: keeps each call's input list."""

    def __init__(self, am):
        self.inner, self.groups = am.generate, []
        am.generate = self

    def __call__(self, input, **kwargs):
        self.groups.append(list(input))
        return self.inner(input=input, **kwargs)


def test_concurrent_requests_get_their_own_row_of_the_group(dirs):
    """Real model, 6 concurrent requests: fewer ``generate`` calls than requests, and
    each response equals that request's row of a direct ``generate`` over the same group
    in the same order."""
    am = build(AutoModel, model=dirs["asr"])
    rec = GroupRecorder(am)
    app = tapp.TranscriptionApp(am, batch_wait_ms=300, max_batch=4)
    data = [wav_bytes(speech(1.0 + 0.3 * s, [(0.1, 0.9 + 0.3 * s, 150.0 + 40 * s)], seed=s))
            for s in range(6)]
    out = serve_http(app, [(d, {}) for d in data], workers=6)
    assert all(status == 200 and p["text"] for status, p in out), out
    stats = app.batcher.stats()
    assert stats["generate_calls"] < stats["requests"] == 6 and stats["max_batch_seen"] >= 2
    assert sorted(len(g) for g in rec.groups) == sorted(
        s for s in app.batcher.batch_sizes)
    for group in rec.groups:
        direct = rec.inner(input=group, batch_size=len(group))
        for audio, row in zip(group, direct):
            assert out[data.index(audio)][1]["text"] == row["text"]


def two_pass_server(server_mod, auto_model, dirs):
    """``build_server`` of ``server_mod`` over ``dirs`` on the CPU."""
    class Args:
        asr_model, asr_model_online, vad_model = dirs["asr"], dirs["online"], dirs["vad"]
        punc_model, punc_model_online = dirs["punc"], dirs["punc_online"]
        device = "cpu"  # the JAX CLI has no such flag and runs where JAX runs
    return server_mod.build_server(Args)


async def two_pass_client(client_side, port, wav, name):
    """The FunASR 2-pass client: the config frame, PCM16 in 600 ms frames as fast as
    the socket takes them, ``is_speaking: false``; every message up to the final."""
    ws = await client_side.connect("127.0.0.1", port)
    await ws.send(json.dumps(dict(TWO_PASS, wav_name=name, is_speaking=True)))
    data = pcm16(wav)
    for i in range(0, len(data), FRAME):
        await ws.send(data[i:i + FRAME].tobytes())
    await ws.send(json.dumps({"is_speaking": False}))
    msgs = []
    while not (msgs and msgs[-1]["is_final"]):
        msgs.append(json.loads(await asyncio.wait_for(ws.recv(), 120)))
    await ws.close()
    return msgs


def run_sessions(server, server_side, client_side, waves, concurrent):
    """Each wave through its own 2-pass session, all at once or one after the other."""
    port = free_port()

    async def scenario():
        srv = await server_side.serve(server.handle, "127.0.0.1", port)
        try:
            sessions = [two_pass_client(client_side, port, w, f"s{i}")
                        for i, w in enumerate(waves)]
            if concurrent:
                return await asyncio.gather(*sessions)
            return [await s for s in sessions]
        finally:
            srv.close()
            await srv.wait_closed()

    return asyncio.run(scenario())


@pytest.fixture(scope="module")
def port_two_pass(dirs):
    return two_pass_server(twss, AutoModel, dirs)


def test_two_pass_messages_match_jax(dirs, port_two_pass):
    """One 11 s session: the online partials (streaming model + realtime punctuation),
    the VAD-endpoint finals (``is_final`` false) and the last final equal the JAX
    server's, message for message."""
    (got,) = run_sessions(port_two_pass, tws, jws, [STREAM_WAV], concurrent=False)
    (want,) = run_sessions(two_pass_server(jwss, jauto.AutoModel, dirs), jws, jws,
                           [STREAM_WAV], concurrent=False)
    assert got == want
    modes = [m["mode"] for m in got]
    assert "2pass-online" in modes and modes.count("2pass-offline") >= 2
    assert got[-1]["mode"] == "2pass-offline" and got[-1]["is_final"] is True
    assert all(m["wav_name"] == "s0" for m in got)


def test_concurrent_sessions_equal_sequential(port_two_pass):
    """Two 2-pass sessions at once on one set of port ``AutoModel``s (the executor
    threads interleave their streaming, VAD and offline calls) give the messages the
    same two sessions give one after the other. The interpreter switches threads every
    microsecond meanwhile, so that a shared per-call state would be hit."""
    waves = [STREAM_WAV, speech(8.0, [(0.5, 3.0, 280.0), (5.4, 7.5, 190.0)], seed=5)]
    sequential = run_sessions(port_two_pass, tws, tws, waves, concurrent=False)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        concurrent = [run_sessions(port_two_pass, tws, tws, waves, concurrent=True)
                      for _ in range(2)]
    finally:
        sys.setswitchinterval(interval)
    assert all(c == sequential for c in concurrent)
    assert all(any(m["mode"] == "2pass-online" for m in s) for s in sequential)


def test_compute_cer_and_wer_match_jax():
    from funasr_tpu.metrics import wer as jwer
    from funasr_tpu_torch.metrics import wer as twer

    r = np.random.default_rng(0)
    chars = list("一丁七万丈三上下 ab")
    refs = ["".join(r.choice(chars, int(r.integers(0, 20)))) for _ in range(30)]
    hyps = ["".join(r.choice(chars, int(r.integers(0, 20)))) for _ in range(30)]
    for remove_space in (True, False):
        assert (twer.compute_cer(refs, hyps, remove_space=remove_space)
                == jwer.compute_cer(refs, hyps, remove_space=remove_space))
    assert twer.compute_wer(refs, hyps) == jwer.compute_wer(refs, hyps)
    for a, b in zip(refs, hyps):
        assert twer.edit_distance(list(a), list(b)) == jwer.edit_distance(list(a), list(b))



def test_kernel_library_builds_once_under_concurrent_first_calls(monkeypatch, tmp_path):
    """A server's first requests reach ``load_library`` on several executor threads at
    once (its ``lru_cache`` lets each run the body): one builds, the others wait and
    load what it built. The compiler is a stand-in that writes the outputs slowly."""
    import threading
    import types

    from funasr_tpu_torch.ops import cuda_lib

    runs = []

    def fake_run_all(cmds):
        runs.append(len(cmds))
        time.sleep(0.2)
        for c in cmds:
            open(c[c.index("-o") + 1], "wb").close()
        return [(0, "") for _ in cmds]

    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_lib, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_lib, "_run_all", fake_run_all)
    monkeypatch.setattr(cuda_lib.ctypes, "CDLL", lambda path: types.SimpleNamespace(**{
        name: types.SimpleNamespace() for name in cuda_lib._SIGNATURES}))
    libs = []
    threads = [threading.Thread(target=lambda: libs.append(cuda_lib.load_library.__wrapped__()))
               for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads) and len(libs) == 4
    assert runs == [len(list(cuda_lib.CSRC.glob("*.cu"))), 1]  # the sources, then the link
    assert sorted(lib.build_seconds > 0 for lib in libs) == [False, False, False, True]
