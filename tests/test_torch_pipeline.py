"""The VAD -> ASR -> punctuation pipeline of the PyTorch port's ``AutoModel`` against
the JAX package's, on the CPU.

Three model directories written from the port's seeded modules (FunASR names, which the
JAX package converts): a small Paraformer (d 64, 2 + 2 blocks, 64 tokens), FSMN-VAD at
its published widths crafted into an energy detector (small seeded memory taps), and
CT-Transformer at ct-punc-c widths with the ASR's 64 tokens. Both ``AutoModel``s load
the same directories; their results must be equal: texts, keys, ``raw_text`` and
``sentence_info``, with and without ``merge_vad``; and the punctuation branch without a
VAD. The audio is tone bursts over near silence (``multi_segment_wav``).
"""

import numpy as np
import pytest
import torch

from funasr_tpu.auto import auto_model as jauto
from funasr_tpu_torch import AutoModel
from funasr_tpu_torch.auto import auto_model as tauto
from pipeline_parity_util import multi_segment_wav
from torch_parity_util import write_asr_dir, write_punc_dir, write_vad_dir
from torch_parity_util import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return dict(model=write_asr_dir(tmp_path_factory.mktemp("asr")),
                vad_model=write_vad_dir(tmp_path_factory.mktemp("vad")),
                punc_model=write_punc_dir(tmp_path_factory.mktemp("punc")))


@pytest.fixture(scope="module")
def pipelines(dirs):
    kw = dict(dirs, device="cpu", log_level="WARNING")
    return AutoModel(**kw), jauto.AutoModel(**kw)


def _waves():
    wav = multi_segment_wav()
    return [wav, np.clip(multi_segment_wav(9.0, seed=3) * 32768, -32768, 32767).astype(np.int16)]


# the default dynamic end-silence schedule (1850 ms at a chunk's start) keeps each input
# one segment; a fixed 800 ms cuts every burst (4 and 3 segments)
@pytest.mark.parametrize("cfg", [
    dict(),
    dict(max_end_silence_time=800, batch_size_s=4),
    dict(max_end_silence_time=800, merge_vad=True, merge_length_s=5),
    dict(max_end_silence_time=800, sentence_timestamp=True, return_raw_text=True)])
def test_vad_asr_punc_texts_match_jax(pipelines, cfg):
    port, ref = pipelines
    got = port.generate(input=_waves(), key=["a", "b"], **cfg)
    want = ref.generate(input=_waves(), key=["a", "b"], **cfg)
    assert [r["key"] for r in got] == ["a", "b"]
    assert got == want
    assert all(r["text"] and r["text"][-1] in "。？." for r in got)
    if cfg.get("return_raw_text"):
        assert all("raw_text" in r and "sentence_info" in r for r in got)


def test_punc_without_vad_matches_jax(dirs):
    kw = dict(model=dirs["model"], punc_model=dirs["punc_model"], device="cpu",
              log_level="WARNING")
    port, ref = AutoModel(**kw), jauto.AutoModel(**kw)
    waves = [multi_segment_wav(4.0, seed=s) for s in (1, 2)]
    got = port.generate(input=waves, batch_size=2, return_raw_text=True)
    want = ref.generate(input=waves, batch_size=2, return_raw_text=True)
    assert [r["text"] for r in got] == [r["text"] for r in want]
    assert [r["raw_text"] for r in got] == [r["raw_text"] for r in want]


def test_vad_only_pipeline_and_sub_model_kwargs(dirs):
    """A VAD without punctuation joins the segment texts with spaces; sub-models take
    their own kwargs (bf16 only where their kwargs carry it) on the main device."""
    kw = dict(model=dirs["model"], vad_model=dirs["vad_model"], device="cpu",
              log_level="WARNING")
    port = AutoModel(**kw, vad_kwargs=dict(bf16=True))
    ref = jauto.AutoModel(**kw)
    assert port.punc_model is None and port.vad_kwargs["bf16"] is True
    assert next(port.vad_model.parameters()).dtype == torch.bfloat16
    assert next(port.model.parameters()).dtype == torch.float32
    port32 = AutoModel(**kw)
    wav = [multi_segment_wav()]
    got = port32.generate(input=wav, key=["x"], max_end_silence_time=800)
    assert got == ref.generate(input=wav, key=["x"], max_end_silence_time=800)
    assert got[0]["text"].count(" ") >= 3  # four segments
    assert port.generate(input=wav, key=["x"], max_end_silence_time=800)[0]["key"] == "x"


def test_join_vad_texts_matches_jax():
    for texts in (["一丁", "七万"], ["ab", "一"], ["<|zh|>一", "", "  ", "丁 x"], [], ["x"]):
        assert tauto._join_vad_texts(texts) == jauto._join_vad_texts(texts)
