"""Speaker-attributed transcription: the PyTorch port's
``AutoModel(model, vad_model, punc_model, spk_model)`` against the JAX package's (CPU).

Four model directories written from the port's seeded modules: a small BiCifParaformer
with the published CifPredictorV3 head (d 64), FSMN-VAD at its published widths crafted
into an energy detector, CT-Transformer at ct-punc-c widths, and a small CAM++ (embedding
16, seeded batch-norm statistics). The audio is two synthetic voices taking turns over
32 s (``two_voice_wav``: 20 or more chunks of 1.5 s). With ``np.random.seed`` set before each
``generate``, the results must be equal: ``text``, ms ``timestamp`` and
``sentence_info`` (``text``, ``spk``, ``start``, ``end``, ``timestamp``), with and without
``preset_spk_num``, without the punctuation model (one sentence), and with
``return_spk_res=False``.

The JAX ``AutoModel`` is built under ``shape_only_init`` (its random draws, which the
checkpoint replaces, become shapes only).
"""

import os

import numpy as np
import pytest

from funasr_tpu.auto import auto_model as jauto
from funasr_tpu_torch import AutoModel
from torch_parity_util import (shape_only_init, two_voice_wav, write_bicif_dir,
                               write_punc_dir, write_spk_dir, write_vad_dir)
from torch_parity_util import one_torch_thread  # noqa: F401 (autouse)

@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    out = {}
    for name, write in (("model", write_bicif_dir), ("vad_model", write_vad_dir),
                        ("punc_model", write_punc_dir), ("spk_model", write_spk_dir)):
        out[name] = write(tmp_path_factory.mktemp(name))
    return out


@pytest.fixture(scope="module")
def pipelines(dirs):
    kw = dict(dirs, device="cpu", log_level="WARNING")
    with shape_only_init():
        return AutoModel(**kw), jauto.AutoModel(**kw)


@pytest.fixture(scope="module")
def recording():
    return two_voice_wav(32.0)


def _generate(am, wav, **cfg):
    np.random.seed(0)
    return am.generate(input=[wav], key=["meeting"], max_end_silence_time=800, **cfg)


@pytest.mark.parametrize("cfg", [dict(), dict(preset_spk_num=2),
                                 dict(preset_spk_num=2, return_raw_text=True),
                                 dict(return_spk_res=False, sentence_timestamp=True)])
def test_speaker_pipeline_matches_jax(pipelines, recording, cfg):
    port, ref = pipelines
    wav, turns = recording
    clustered = []
    backend = port.cb_model
    port.cb_model = lambda x, **kw: clustered.append(len(x)) or backend(x, **kw)
    try:
        got = _generate(port, wav, **cfg)
    finally:
        port.cb_model = backend
    want = _generate(ref, wav, **cfg)
    assert got == want
    if cfg.get("return_spk_res", True):
        assert clustered[0] >= 20  # enough chunks for the spectral backend
    row = got[0]
    assert row["key"] == "meeting" and row["text"] and row["timestamp"]
    assert "spk_embedding" not in row
    stamps = [t for ts in row["timestamp"] for t in ts]
    assert stamps == sorted(stamps) and 0 <= stamps[0] and stamps[-1] <= len(wav) / 16
    info = row["sentence_info"]
    assert info and all(set(s) >= {"text", "start", "end"} for s in info)
    if cfg.get("return_spk_res", True):
        assert all(isinstance(s["spk"], int) for s in info)
        if cfg.get("preset_spk_num") == 2:
            assert {s["spk"] for s in info} == {0, 1}
    else:
        assert all("spk" not in s for s in info)


def test_speaker_pipeline_without_punctuation_matches_jax(pipelines, recording):
    """No punctuation model (the same pipelines with theirs taken out): ``spk_mode``
    falls back to the whole text as one sentence."""
    port, ref = pipelines
    models = port.punc_model, ref.punc_model
    port.punc_model = ref.punc_model = None
    try:
        wav, _ = recording
        got, want = (_generate(am, wav, preset_spk_num=2) for am in (port, ref))
    finally:
        port.punc_model, ref.punc_model = models
    assert port.spk_mode == "punc_segment" and got == want
    info = got[0]["sentence_info"]
    assert len(info) == 1 and info[0]["text"] == got[0]["text"]
    assert (info[0]["start"], info[0]["end"]) == (got[0]["timestamp"][0][0],
                                                  got[0]["timestamp"][-1][1])


def test_speaker_model_is_built_on_the_main_device_with_its_kwargs(dirs):
    port = AutoModel(**dirs, device="cpu", log_level="WARNING",
                     spk_kwargs=dict(batch_size=8, cb_kwargs=dict(merge_thr=0.9)))
    assert type(port.spk_model).__name__ == "CAMPPlus"
    assert next(port.spk_model.parameters()).device.type == "cpu"
    assert port.spk_kwargs["batch_size"] == 8 and port.cb_model.merge_thr == 0.9
    assert os.path.samefile(port.spk_kwargs["model_path"], dirs["spk_model"])
