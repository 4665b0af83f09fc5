"""The port's command-line entry points and package boundary (CPU, in subprocesses).

``python -m funasr_tpu_torch.bin.inference ++model=<dir> ++input=<wav> ++device=cpu``
prints the text the port's ``AutoModel`` gives; each argparse server CLI has ``--device``
(default cuda); the ``++`` CLIs refuse to run without ``++model``; importing any serving
module leaves jax, the JAX package and scikit-learn out of ``sys.modules``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from funasr_tpu_torch import AutoModel
from torch_parity_util import speech, wav_bytes, write_asr_dir

REPO = Path(__file__).resolve().parent.parent


def _run(args, timeout=180):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, *args], cwd=REPO, capture_output=True,
                          text=True, timeout=timeout, env=env)


def test_inference_cli_on_the_cpu(tmp_path):
    """``python -m funasr_tpu_torch.bin.inference ++model=<dir> ++input=<wav>
    ++device=cpu``: one JSON row with the text the port's ``AutoModel`` gives."""
    (tmp_path / "asr").mkdir()
    asr = write_asr_dir(tmp_path / "asr")
    path = tmp_path / "a.wav"
    path.write_bytes(wav_bytes(speech(3.0, [(0.2, 2.8, 200.0)], seed=1)))
    proc = _run(["-m", "funasr_tpu_torch.bin.inference", f"++model={asr}",
                 f"++input={path}", "++device=cpu"])
    assert proc.returncode == 0, proc.stderr
    (row,) = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    want = AutoModel(model=asr, device="cpu", log_level="WARNING").generate(input=str(path))[0]
    assert row["key"] == "a" and row["text"] == want["text"]


@pytest.mark.parametrize("module", ["server", "funasr_wss_server", "realtime_ws",
                                    "inference", "benchmark"])
def test_cli_help_and_device_flag(module):
    """Each argparse CLI prints its help with ``--device`` (default cuda); the ``++``
    CLIs refuse to run without ``++model``."""
    proc = _run(["-m", f"funasr_tpu_torch.bin.{module}", "--help"])
    if module in ("inference", "benchmark"):
        assert proc.returncode != 0 and "model" in proc.stderr + proc.stdout
    else:
        assert proc.returncode == 0, proc.stderr
        assert "--device" in proc.stdout and "cuda" in proc.stdout


SERVING_MODULES = ["funasr_tpu_torch.serving.ws_protocol", "funasr_tpu_torch.serving.batcher",
                   "funasr_tpu_torch.bin._server_app", "funasr_tpu_torch.bin.server",
                   "funasr_tpu_torch.bin.inference", "funasr_tpu_torch.bin.funasr_wss_server",
                   "funasr_tpu_torch.bin.realtime_ws", "funasr_tpu_torch.bin.benchmark",
                   "funasr_tpu_torch.bin._overrides", "funasr_tpu_torch.metrics.wer",
                   "funasr_tpu_torch.auto.auto_frontend"]


def test_serving_modules_pull_in_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {SERVING_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "import funasr_tpu_torch\n"
            "assert funasr_tpu_torch.AutoFrontend.__module__.endswith('auto_frontend')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'funasr_tpu', 'sklearn'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    proc = _run(["-c", code], timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
