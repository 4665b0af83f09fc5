"""The port's MCP stdio server (``funasr_tpu_torch/bin/mcp_server.py``) against the JAX
package's, each in a subprocess with ``--device cpu``.

``initialize``, ``tools/list``, ``ping``, ``inverse_normalize``, an unknown tool, an
unknown method, a notification and a line that is not JSON give the same messages from
both servers. ``transcribe`` on a small numerals model directory, with and without
``itn``, gives the port ``AutoModel``'s text, and the JAX server the same text.
"""

import json
import os
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest

from funasr_tpu_torch import AutoModel
from pipeline_parity_util import multi_segment_wav
from torch_parity_util import NUMBER_TOKENS, write_asr_dir
from torch_parity_util import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent


def _serve(package, model, requests):
    """One server process over ``requests`` (dicts, or raw lines) -> responses by id."""
    lines = [r if isinstance(r, str) else json.dumps(r, ensure_ascii=False) for r in requests]
    proc = subprocess.run(
        [sys.executable, "-m", f"{package}.bin.mcp_server", "--model", model,
         "--device", "cpu"], input="\n".join(lines) + "\n", capture_output=True, text=True,
        timeout=300, cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr
    out = [json.loads(x) for x in proc.stdout.strip().splitlines()]
    return {r["id"]: r for r in out}, len(out)


def _call(i, name, **arguments):
    return {"jsonrpc": "2.0", "id": i, "method": "tools/call",
            "params": {"name": name, "arguments": arguments}}


PROTOCOL = [
    {"jsonrpc": "2.0", "id": 1, "method": "initialize", "params": {}},
    {"jsonrpc": "2.0", "method": "notifications/initialized"},
    {"jsonrpc": "2.0", "id": 2, "method": "tools/list"},
    {"jsonrpc": "2.0", "id": 3, "method": "ping"},
    _call(4, "inverse_normalize", text="三百二十五", language="zh"),
    _call(5, "inverse_normalize", text="twenty five apples", language="en"),
    _call(6, "inverse_normalize", text="三百", language="xx"),
    _call(7, "no_such_tool"),
    {"jsonrpc": "2.0", "id": 8, "method": "nope"},
    "this is not json",
    "",
]


def test_protocol_messages_match_jax():
    """No model is built for these: ``--model`` names nothing."""
    got, n_got = _serve("funasr_tpu_torch", "x", PROTOCOL)
    want, n_want = _serve("funasr_tpu", "x", PROTOCOL)
    assert got == want and n_got == n_want == 8
    assert got[1]["result"]["serverInfo"]["name"] == "funasr-tpu"
    assert [t["name"] for t in got[2]["result"]["tools"]] == ["transcribe", "inverse_normalize"]
    assert got[4]["result"]["content"][0]["text"] == "325"
    assert got[6]["result"]["isError"] and got[7]["result"]["isError"]
    assert got[8]["error"]["code"] == -32601


@pytest.fixture(scope="module")
def numbers(tmp_path_factory):
    d = tmp_path_factory.mktemp("mcp")
    (d / "model").mkdir()
    model = write_asr_dir(str(d / "model"), tokens=NUMBER_TOKENS)
    pcm = np.clip(multi_segment_wav() * 32768, -32768, 32767).astype(np.int16)
    path = str(d / "a.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    return model, path


def test_transcribe_matches_automodel(numbers):
    model, wav = numbers
    reqs = [_call(1, "transcribe", audio_path=wav), _call(2, "transcribe", audio_path=wav,
                                                           itn=True),
            _call(3, "transcribe", audio_path=wav, itn=True, language="en"),
            _call(4, "transcribe", audio_path=os.path.join(os.path.dirname(wav), "none.wav"))]
    got, _ = _serve("funasr_tpu_torch", model, reqs)
    want, _ = _serve("funasr_tpu", model, reqs)
    am = AutoModel(model=model, device="cpu", log_level="WARNING")
    texts = [got[i]["result"]["content"][0]["text"] for i in (1, 2, 3)]
    assert texts == [am.generate(input=wav)[0]["text"],
                     am.generate(input=wav, itn=True)[0]["text"],
                     am.generate(input=wav, itn=True, language="en")[0]["text"]]
    assert texts[1] != texts[0] and any(ch.isdigit() for ch in texts[1])
    assert [want[i]["result"]["content"][0]["text"] for i in (1, 2, 3)] == texts
    assert got[4]["result"]["isError"] and want[4]["result"]["isError"]


def test_device_defaults_to_cuda(monkeypatch):
    from funasr_tpu_torch.bin import mcp_server

    seen = {}
    monkeypatch.setattr(mcp_server.McpServer, "serve",
                        lambda self: seen.update(self._model_kwargs))
    mcp_server.main_cli(["--model", "m"])
    assert seen == {"model": "m", "log_level": "WARNING", "device": "cuda"}
