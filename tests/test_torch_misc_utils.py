"""The port's copies of ``metrics/compute_eer.py``, ``utils/datadir_writer.py``,
``utils/version_checker.py`` and ``integrations/langchain_tool.py`` against the JAX
package's, on the same inputs (``langchain_core``'s adapter only where it imports; the
version check with ``disable=True``: no network)."""

import numpy as np
import pytest

from funasr_tpu.integrations import langchain_tool as jlc
from funasr_tpu.metrics import compute_eer as jeer
from funasr_tpu.utils import datadir_writer as jdw
from funasr_tpu.utils import version_checker as jvc
from funasr_tpu_torch.integrations import langchain_tool as tlc
from funasr_tpu_torch.metrics import compute_eer as teer
from funasr_tpu_torch.utils import datadir_writer as tdw
from funasr_tpu_torch.utils import version_checker as tvc


def _scores(seed, n):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n)
    scores = rng.standard_normal(n) + labels * rng.uniform(0.5, 3.0)
    return scores, labels


@pytest.mark.parametrize("seed,n", [(0, 10), (1, 200), (2, 1000), (3, 7)])
@pytest.mark.parametrize("fn", ["compute_eer", "compute_min_dcf"])
def test_eer_min_dcf_equal(seed, n, fn):
    scores, labels = _scores(seed, n)
    assert getattr(teer, fn)(scores, labels) == getattr(jeer, fn)(scores, labels)


def test_min_dcf_options_equal():
    scores, labels = _scores(4, 300)
    kw = dict(p_target=0.05, c_miss=10.0, c_fa=1.0)
    assert teer.compute_min_dcf(scores, labels, **kw) == jeer.compute_min_dcf(scores, labels, **kw)


def test_datadir_writer_equal(tmp_path):
    rows = [("1best_recog", "text", "utt1", "你好"), ("1best_recog", "token", "utt1", "你 好"),
            ("1best_recog", "text", "utt2", "世界"), ("nbest", "score", "utt1", -1.5)]
    for name, module in (("jax", jdw), ("port", tdw)):
        writer = module.DatadirWriter(str(tmp_path / name))
        for d, f, k, v in rows:
            writer[d][f][k] = v
        writer.close()
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert len(files) == 3
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()


def test_version_check_disabled():
    assert tvc.check_for_update(disable=True) is jvc.check_for_update(disable=True) is None


class _StubAutoModel:
    def __init__(self):
        self.calls = []

    def generate(self, input, **kwargs):
        self.calls.append((input, kwargs))
        return [{"text": "你好"}, {"text": "世界 "}]


def test_funasr_tool_equal():
    port, ref = _StubAutoModel(), _StubAutoModel()
    pt, jt = tlc.FunASRTool(auto_model=port), jlc.FunASRTool(auto_model=ref)
    assert (pt.name, pt.description) == (jt.name, jt.description)
    assert pt.as_openai_function() == jt.as_openai_function()
    assert pt.run("a.wav", hotword="x") == jt.run("a.wav", hotword="x") == "你好 世界"
    assert pt.call_openai_function({"audio": "b.wav"}) == \
        jt.call_openai_function({"audio": "b.wav"})
    assert port.calls == ref.calls


def test_langchain_adapter_equal():
    pytest.importorskip("langchain_core")
    pt = tlc.FunASRTool(auto_model=_StubAutoModel()).as_langchain_tool()
    jt = jlc.FunASRTool(auto_model=_StubAutoModel()).as_langchain_tool()
    assert (pt.name, pt.description) == (jt.name, jt.description)
    assert pt.run("a.wav") == jt.run("a.wav")
