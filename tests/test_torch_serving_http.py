"""The port's OpenAI-compatible HTTP app, ``AutoFrontend`` and the benchmark harness
against the JAX package's (CPU).

The same requests (``json``, ``text``, ``verbose_json``) go to the JAX app over the JAX
``AutoModel`` and to the port's app over the port's ``AutoModel``, the model alone and
behind the VAD and punctuation, on model directories written from the port's seeded
modules, over a real localhost socket: the responses are equal. ``AutoFrontend``'s
features and the benchmark harness's scored fields equal JAX's.
"""

import numpy as np
import pytest

from funasr_tpu.auto import auto_model as jauto
from funasr_tpu.bin import _server_app as japp
from funasr_tpu_torch import AutoModel
from funasr_tpu_torch.bin import _server_app as tapp
from torch_parity_util import (one_torch_thread, pcm16, serve_http, speech,  # noqa: F401
                               wav_bytes, write_asr_dir, write_punc_dir, write_vad_dir)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    mk = tmp_path_factory.mktemp
    return dict(asr=write_asr_dir(mk("asr")), vad=write_vad_dir(mk("vad")),
                punc=write_punc_dir(mk("punc")))


FEAT_ATOL = 1e-3  # log-mel, fp32 both sides (tests/test_torch_frontend.py's budget)


def build(auto_model, **kw):
    return auto_model(**kw, device="cpu", log_level="WARNING", disable_pbar=True)


HTTP_REQUESTS = [
    (speech(3.0, [(0.2, 2.8, 200.0)], seed=1), {"response_format": "json"}),
    (speech(2.0, [(0.1, 1.9, 310.0)], seed=2), {"response_format": "text"}),
    (speech(9.0, [(0.3, 2.4, 220.0), (3.6, 5.9, 330.0), (7.0, 8.6, 150.0)], seed=3),
     {"response_format": "verbose_json"}),
]


@pytest.fixture(scope="module")
def pairs(dirs):
    """(port, JAX) ``AutoModel``s: the model alone, and behind the VAD and punctuation
    built with ``pred_timestamp`` and ``sentence_timestamp`` (so ``verbose_json`` carries
    sentence segments)."""
    pipe = dict(model=dirs["asr"], vad_model=dirs["vad"], punc_model=dirs["punc"],
                pred_timestamp=True, sentence_timestamp=True, max_end_silence_time=800)
    return {name: (build(AutoModel, **kw), build(jauto.AutoModel, **kw))
            for name, kw in (("model_alone", dict(model=dirs["asr"])), ("vad_punc", pipe))}


@pytest.mark.parametrize("pipeline", ["model_alone", "vad_punc"])
def test_http_responses_match_jax(pairs, pipeline):
    """The same three requests (json, text, verbose_json) to the JAX app and the port's,
    one at a time: equal responses."""
    port, ref = (app(am) for app, am in zip((tapp.TranscriptionApp, japp.TranscriptionApp),
                                            pairs[pipeline]))
    requests = [(wav_bytes(w), f) for w, f in HTTP_REQUESTS]
    got = serve_http(port, requests, workers=1)
    want = serve_http(ref, requests, workers=1)
    assert got == want
    assert all(status == 200 and p["text"] for status, p in got)
    verbose = got[2][1]
    assert verbose["task"] == "transcribe"
    if pipeline == "vad_punc":
        assert len(verbose["segments"]) >= 2 and verbose["duration"] > 0


def test_vad_pipeline_serves_a_batch_of_requests(pairs):
    """Three concurrent requests the batcher groups behind the VAD: the port's app
    answers each as the JAX app answers it alone. The batcher hands the group's size on
    as ``batch_size``; the JAX ``AutoModel`` passes it to its VAD, whose batch-1 assertion
    fails (so the JAX app answers 500 to such a group); the port runs its VAD one input
    a call."""
    port, ref = pairs["vad_punc"]
    app = tapp.TranscriptionApp(port, batch_wait_ms=500)
    requests = [(wav_bytes(w), {}) for w, _ in HTTP_REQUESTS]
    got = serve_http(app, requests)
    assert app.batcher.stats()["max_batch_seen"] >= 2
    assert got == serve_http(japp.TranscriptionApp(ref), requests, workers=1)
    waves = [w for w, _ in HTTP_REQUESTS[:2]]
    with pytest.raises(AssertionError, match="batch_size must be 1 for VAD"):
        ref.generate(input=waves, batch_size=2)
    got = port.generate(input=waves, key=["a", "b"], batch_size=2)
    assert got == [port.generate(input=w, key=[k])[0] for w, k in zip(waves, "ab")]


def test_auto_frontend_matches_jax(dirs, tmp_path):
    from funasr_tpu.auto.auto_frontend import AutoFrontend as JaxAutoFrontend
    from funasr_tpu_torch import AutoFrontend

    path = tmp_path / "a.wav"
    path.write_bytes(wav_bytes(HTTP_REQUESTS[0][0]))
    inputs = [str(path), HTTP_REQUESTS[1][0], pcm16(HTTP_REQUESTS[2][0])]
    got = AutoFrontend(model=dirs["asr"], device="cpu")(inputs, batch_size=2, key=list("abc"))
    want = JaxAutoFrontend(model=dirs["asr"])(inputs, batch_size=2, key=list("abc"))
    assert [(r["key"], r["input_len"]) for r in got] == [(r["key"], r["input_len"])
                                                         for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["input"].numpy(), np.asarray(w["input"]), atol=FEAT_ATOL,
                                   rtol=0)


def test_benchmark_reports_match_jax(dirs, tmp_path):
    """``run_cer_eval`` over a Kaldi pair and ``run_benchmark`` over WAV files: the
    scored fields (CER, sub / del / ins, counts, audio seconds) equal JAX's."""
    from funasr_tpu.bin import benchmark as jbench
    from funasr_tpu_torch.bin import benchmark as tbench

    paths = []
    for i, (w, _) in enumerate(HTTP_REQUESTS[:2]):
        paths.append(tmp_path / f"u{i}.wav")
        paths[-1].write_bytes(wav_bytes(w))
    (tmp_path / "wav.scp").write_text("".join(f"u{i} {p}\n" for i, p in enumerate(paths)))
    (tmp_path / "text").write_text("u0 一丁七\nu1 万 丈\n")
    labels = {"u0": "一丁七", "u1": "万丈"}
    scored = ("n_utts", "n_files", "audio_seconds", "cer", "sub", "dele", "del", "ins",
              "n_scored")
    reports = []
    for bench, am in ((tbench, build(AutoModel, model=dirs["asr"])),
                      (jbench, build(jauto.AutoModel, model=dirs["asr"]))):
        cer = bench.run_cer_eval(am, str(tmp_path / "wav.scp"), str(tmp_path / "text"),
                                 batch_size=2)
        rtfx, results = bench.run_benchmark(am, [str(p) for p in paths], labels, warmup=0)
        reports.append(({k: v for k, v in cer.items() if k in scored},
                        {k: v for k, v in rtfx.items() if k in scored}, results))
    assert reports[0] == reports[1]
    assert reports[0][0]["n_utts"] == 2 and reports[0][1]["n_scored"] == 2
