"""``AutoModel.generate(itn=True)`` of the PyTorch port against the JAX package's.

A small Paraformer directory whose vocabulary starts with the Chinese numerals and units
(``torch_parity_util.NUMBER_TOKENS``), so that its seeded decodes hold numbers for the
inverse text normalization to rewrite; both ``AutoModel``s load it on the CPU. Texts
must be equal with ``itn=True`` alone, under other languages, with the model's own
``use_itn``, and behind the VAD and the punctuation model; and equal to
``InverseNormalizer(lang).inverse_normalize`` of the text without ITN.
"""

import numpy as np
import pytest

from funasr_tpu.auto import auto_model as jauto
from funasr_tpu_torch import AutoModel
from funasr_tpu_torch.text.inverse_normalize import InverseNormalizer
from pipeline_parity_util import multi_segment_wav
from torch_parity_util import NUMBER_TOKENS, write_asr_dir, write_punc_dir, write_vad_dir
from torch_parity_util import one_torch_thread  # noqa: F401 (autouse)

KW = dict(device="cpu", log_level="WARNING")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return dict(model=write_asr_dir(tmp_path_factory.mktemp("asr"), tokens=NUMBER_TOKENS),
                vad_model=write_vad_dir(tmp_path_factory.mktemp("vad")),
                punc_model=write_punc_dir(tmp_path_factory.mktemp("punc"),
                                          tokens=NUMBER_TOKENS))


@pytest.fixture(scope="module")
def pair(dirs):
    return (AutoModel(model=dirs["model"], **KW),
            jauto.AutoModel(model=dirs["model"], **KW))


def _waves():
    """Tone bursts over near silence: the seeded model decodes numerals from them."""
    return [multi_segment_wav(), multi_segment_wav(9.0, seed=3),
            np.clip(multi_segment_wav(5.0, seed=5) * 32768, -32768, 32767).astype(np.int16),
            multi_segment_wav(7.0, seed=7)]


@pytest.mark.parametrize("cfg", [dict(itn=True), dict(itn=True, language="zh"),
                                 dict(itn=True, language="ZH-cn"), dict(itn=True, language=None),
                                 dict(itn=True, language="en"), dict(itn=True, language="xx"),
                                 dict(itn=True, use_itn=True)])
def test_itn_texts_match_jax(pair, cfg):
    port, ref = pair
    got = port.generate(input=_waves(), batch_size=2, key=list("abcd"), **cfg)
    assert got == ref.generate(input=_waves(), batch_size=2, key=list("abcd"), **cfg)
    plain = port.generate(input=_waves(), batch_size=2, key=list("abcd"))
    lang = (cfg.get("language") or "zh").lower()[:2]
    if cfg.get("use_itn") or lang == "xx":
        assert got == plain
    else:
        inv = InverseNormalizer(lang=lang)
        assert [r["text"] for r in got] == [inv.inverse_normalize(r["text"]) for r in plain]
    if cfg == dict(itn=True):  # the seeded decodes hold numbers that ITN rewrites
        assert any(g["text"] != p["text"] for g, p in zip(got, plain))
        assert any(ch.isdigit() for r in got for ch in r["text"])


def test_itn_behind_vad_and_punctuation_matches_jax(dirs):
    """ITN runs on every ``inference`` result: each VAD segment's text and the
    punctuated text, as in the JAX package."""
    port, ref = AutoModel(**dirs, **KW), jauto.AutoModel(**dirs, **KW)
    waves = [multi_segment_wav(), multi_segment_wav(9.0, seed=3)]
    cfg = dict(max_end_silence_time=800, itn=True)
    got = port.generate(input=waves, key=["a", "b"], **cfg)
    assert got == ref.generate(input=waves, key=["a", "b"], **cfg)
    assert all(r["text"] for r in got)
