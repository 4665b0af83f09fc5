"""``AutoModel`` of the PyTorch port against the JAX package's, on one model directory.

The directory is written from the port's seeded Paraformer (d = 256, 2 + 2 blocks, 304
tokens, so every FFN, attention and output projection is large enough to quantize):
``config.yaml``, ``tokens.txt``, an identity ``am.mvn`` and ``model.pt`` (FunASR names,
which the JAX package converts). Both ``AutoModel``s run on the CPU. Texts must be equal
for ``quant=None``, ``"int8"`` and ``"w8a8"``.

W8A8 with random weights can flip a token where a last-bit float difference upstream
moves an activation across a rounding boundary of its int8 quantization (measured over
48 utterances of this config: 6 of 434 tokens); the inputs here are fixed, and
``tests/test_torch_quant.py`` bounds the encoder drift itself.

Also: the framework-free copies (``prepare_data_iterator``, ``download_model``,
``deep_update``, post-processing hotwords) against their originals, the error paths,
and that the package import keeps jax out.
"""

import os
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from funasr_tpu.auto import auto_model as jauto
from funasr_tpu.download import download_model_from_hub as jdl
from funasr_tpu.utils import misc as jmisc
from funasr_tpu.utils import postprocess_hotwords as jhot
from funasr_tpu_torch import AutoModel
from funasr_tpu_torch.auto import auto_model as tauto
from funasr_tpu_torch.download import download_model_from_hub as tdl
from funasr_tpu_torch.models.paraformer.model import Paraformer
from funasr_tpu_torch.utils import misc as tmisc
from funasr_tpu_torch.utils import postprocess_hotwords as thot

REPO = Path(__file__).resolve().parent.parent
TOKENS = ["<blank>", "<s>", "</s>"] + [chr(0x4E00 + i) for i in range(300)] + ["<unk>"]
ENC = dict(output_size=256, attention_heads=4, linear_units=256, num_blocks=2,
           input_layer="pe", kernel_size=11, sanm_shfit=0)
DEC = dict(attention_heads=4, linear_units=256, num_blocks=2, att_layer_num=2,
           kernel_size=11, sanm_shfit=0)
PRED = dict(idim=256, l_order=1, r_order=1, threshold=1.0, tail_threshold=0.45)
MODEL_CONF = dict(sos=1, eos=2, predictor_bias=1, ctc_weight=0.0)
CMVN_DIM = 560


def _write_cmvn(path, dim):
    means = " ".join(["0.0"] * dim)
    istd = " ".join(["1.0"] * dim)
    with open(path, "w") as f:
        f.write(f"<Nnet>\n<Splice> {dim} {dim}\n[ 0 ]\n"
                f"<AddShift> {dim} {dim}\n<LearnRateCoef> 0 [ {means} ]\n"
                f"<Rescale> {dim} {dim}\n<LearnRateCoef> 0 [ {istd} ]\n</Nnet>\n")


def _write_model_dir(d, with_weights=True):
    if with_weights:
        model = Paraformer(input_size=CMVN_DIM, vocab_size=len(TOKENS), encoder_conf=ENC,
                           decoder_conf=DEC, predictor_conf=PRED, **MODEL_CONF,
                           generator=torch.Generator().manual_seed(0))
        torch.save(model.state_dict(), d / "model.pt")
    with open(d / "tokens.txt", "w") as f:
        f.write("\n".join(TOKENS) + "\n")
    _write_cmvn(d / "am.mvn", CMVN_DIM)
    cfg = dict(
        model="Paraformer", model_conf=MODEL_CONF,
        encoder="SANMEncoder", encoder_conf=ENC,
        decoder="ParaformerSANMDecoder", decoder_conf=DEC,
        predictor="CifPredictorV2", predictor_conf=PRED,
        frontend="WavFrontend",
        frontend_conf=dict(fs=16000, window="hamming", n_mels=80, frame_length=25,
                           frame_shift=10, lfr_m=7, lfr_n=6, cmvn_file="am.mvn",
                           dither=0.0),
        tokenizer="CharTokenizer",
        tokenizer_conf=dict(token_list="tokens.txt", unk_symbol="<unk>"),
    )
    with open(d / "config.yaml", "w") as f:
        yaml.safe_dump(cfg, f, allow_unicode=True)
    return str(d)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return _write_model_dir(tmp_path_factory.mktemp("paraformer_d256"))


def _pcm(seed, lengths):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(n) * 3000).astype(np.int16) for n in lengths]


def _pair(model_dir, **kw):
    return (AutoModel(model=model_dir, device="cpu", log_level="WARNING", **kw),
            jauto.AutoModel(model=model_dir, device="cpu", log_level="WARNING", **kw))


@pytest.mark.parametrize("quant", [None, "int8", "w8a8"])
def test_generate_texts_match_jax(model_dir, quant):
    port, ref = _pair(model_dir, quant=quant)
    fetches = []
    fetch = port.model.inference_fetch
    port.model.inference_fetch = lambda h: fetches.append(h["b"]) or fetch(h)
    pcm = _pcm(11, (16000, 17500, 15000))
    got = port.generate(input=pcm, batch_size=2, key=["a", "b", "c"])
    want = ref.generate(input=pcm, batch_size=2, key=["a", "b", "c"])
    assert fetches == [2, 1]  # 3 inputs in batches of 2: the dispatch / fetch loop
    assert [r["key"] for r in got] == ["a", "b", "c"]
    assert got == want
    assert all(r["text"] for r in got)


def test_generate_wav_path_and_bytes_match_jax(model_dir, tmp_path):
    port, ref = _pair(model_dir, quant="w8a8")
    pcm = _pcm(12, (16500, 15500))
    path = tmp_path / "utt_a.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm[0].tobytes())
    raw = tmp_path / "utt_b.pcm"
    raw.write_bytes(pcm[1].tobytes())
    got = port.generate(input=[str(path), pcm[1].tobytes(), str(raw)], batch_size=3)
    want = ref.generate(input=[str(path), pcm[1].tobytes(), str(raw)], batch_size=3)
    assert [r["key"] for r in got[::2]] == [r["key"] for r in want[::2]] == ["utt_a", "utt_b"]
    assert [r["text"] for r in got] == [r["text"] for r in want]
    assert got[1]["text"] == got[2]["text"]
    got = port.generate(input=pcm[1].tobytes(), key="raw")  # top-level bytes -> load_bytes
    want = ref.generate(input=pcm[1].tobytes(), key="raw")
    assert got == want and got[0]["key"] == "raw"


def test_no_checkpoint_draws_the_seed_weights(tmp_path):
    d = _write_model_dir(tmp_path, with_weights=False)
    am = AutoModel(model=d, device="cpu", seed=3, log_level="WARNING")
    want = Paraformer(input_size=CMVN_DIM, vocab_size=len(TOKENS), encoder_conf=ENC,
                      decoder_conf=DEC, predictor_conf=PRED, **MODEL_CONF,
                      generator=torch.Generator().manual_seed(3)).state_dict()
    got = am.model.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_checkpoint_loading(tmp_path):
    """model.pt: missing keys raise, keys of unported branches are dropped; a Trainer
    pickle of JAX params goes through params_from_jax."""
    import pickle

    from funasr_tpu.convert.torch_to_jax import convert_paraformer, load_native_checkpoint
    from funasr_tpu.models.paraformer.model import Paraformer as JaxParaformer
    from funasr_tpu_torch.utils import load_utils

    conf = dict(input_size=CMVN_DIM, vocab_size=len(TOKENS), encoder_conf=ENC,
                decoder_conf=DEC, predictor_conf=PRED, **MODEL_CONF)
    src = Paraformer(**conf, generator=torch.Generator().manual_seed(5))
    sd = {f"module.{k}": v for k, v in src.state_dict().items()}  # a DDP prefix
    sd["module.ctc.ctc_lo.weight"] = torch.zeros(3, 3)
    torch.save(sd, tmp_path / "model.pt")
    dst = load_utils.load_pretrained(Paraformer(**conf), str(tmp_path / "model.pt"))
    assert all(torch.equal(dst.state_dict()[k], v) for k, v in src.state_dict().items())

    del sd["module.decoder.after_norm.bias"]
    torch.save(sd, tmp_path / "partial.pt")
    with pytest.raises(KeyError, match="after_norm"):
        load_utils.load_pretrained(Paraformer(**conf), str(tmp_path / "partial.pt"))

    params = convert_paraformer(src.state_dict(), JaxParaformer(**conf))
    with open(tmp_path / "model.pt.avg", "wb") as f:
        pickle.dump({"params": params, "step": 7}, f)
    path = str(tmp_path / "model.pt.avg")
    assert load_utils.load_native_checkpoint(path) is not None
    assert load_native_checkpoint(path) is not None
    assert load_utils.load_native_checkpoint(str(tmp_path / "model.pt")) is None
    dst = load_utils.load_pretrained(Paraformer(**conf), path)
    assert all(torch.equal(dst.state_dict()[k], v) for k, v in src.state_dict().items())


def test_prepare_data_iterator_matches_jax(tmp_path):
    wav = tmp_path / "spk1.wav"
    wav.write_bytes(b"")
    scp = tmp_path / "in.scp"
    scp.write_text(f"u1 {wav}\nu2 {wav}\n")
    jsonl = tmp_path / "in.jsonl"
    jsonl.write_text('{"source": "a.wav", "key": "k1"}\n{"source": "b.wav"}\n')
    arr = np.zeros(4, np.float32)
    cases = [dict(data_in=[arr, arr], key=["x", "y"]), dict(data_in=[str(wav), arr]),
             dict(data_in=str(scp)), dict(data_in=str(jsonl)), dict(data_in=str(wav)),
             dict(data_in=arr, key=["only"]), dict(data_in=b"\x01\x00\x02\x00")]
    for case in cases:
        gk, gd = tauto.prepare_data_iterator(**case)
        wk, wd = jauto.prepare_data_iterator(**case)
        assert [k.startswith("rand_key_") for k in gk] == [k.startswith("rand_key_") for k in wk]
        assert [k for k in gk if not k.startswith("rand_key_")] == \
               [k for k in wk if not k.startswith("rand_key_")]
        assert len(gd) == len(wd)
        for a, b in zip(gd, wd):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_download_model_on_a_local_dir_matches_jax(model_dir, monkeypatch):
    monkeypatch.setenv("FUNASR_TPU_OFFLINE", "1")
    assert tdl.resolve_model_dir(model_dir) == jdl.resolve_model_dir(model_dir) == model_dir
    got = tdl.download_model(model=model_dir, batch_size=4)
    assert got == jdl.download_model(model=model_dir, batch_size=4)
    assert got["model"] == "Paraformer" and got["batch_size"] == 4
    assert got["init_param"] == os.path.join(model_dir, "model.pt")
    assert got["frontend_conf"]["cmvn_file"] == os.path.join(model_dir, "am.mvn")
    with pytest.raises(FileNotFoundError, match="FUNASR_TPU_OFFLINE"):
        tdl.resolve_model_dir("no-such-model-alias")


def test_deep_update_and_hotwords_copies_match():
    for orig, upd in (({"a": {"b": 1, "c": 2}, "d": 3}, {"a": {"b": 5}, "e": [1]}),
                      ({"a": 1}, {"a": {"x": 1}})):
        assert tmisc.deep_update(dict(orig), upd) == jmisc.deep_update(dict(orig), upd)
    results = [{"key": "k", "text": "我们去北京天安们看看"}, {"key": "j", "text": "魔搭社区"}]
    for cfg in ({"postprocess_hotwords": "天安门 魔塔=>魔搭"},
                {"postprocess_hotwords": {"北京": "北平"},
                 "return_postprocess_hotword_matches": True},
                {"postprocess_hotwords": ["天安门"], "postprocess_hotword_threshold": 0.99},
                {}):
        got = thot.apply_postprocess_hotwords_to_results([dict(r) for r in results], cfg)
        want = jhot.apply_postprocess_hotwords_to_results([dict(r) for r in results], cfg)
        assert got == want


def test_unported_options_raise(model_dir, monkeypatch):
    """vad_model / punc_model / spk_model build (tests/test_torch_pipeline.py,
    tests/test_torch_spk_pipeline.py); ITN and export still raise."""
    monkeypatch.setenv("FUNASR_TPU_OFFLINE", "1")
    with pytest.raises(FileNotFoundError, match="cam"):  # a hub alias, not a directory
        AutoModel(model=model_dir, device="cpu", spk_model="cam++", log_level="WARNING")
    am = AutoModel(model=model_dir, device="cpu", log_level="WARNING")
    with pytest.raises(NotImplementedError, match="slice 9"):
        am.generate(input=_pcm(1, (8000,)), itn=True)
    with pytest.raises(NotImplementedError, match="export"):
        am.export()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        AutoModel(model=model_dir)  # device defaults to "cuda"; no CPU fallback


def test_import_of_auto_model_pulls_in_no_jax():
    """Neither jax, nor the JAX package, nor scikit-learn (the port's clustering,
    imported here too, is numpy)."""
    code = ("import sys\n"
            "import funasr_tpu_torch\n"
            "from funasr_tpu_torch import AutoModel\n"
            "from funasr_tpu_torch.models.campplus import cluster_backend\n"
            "assert AutoModel is funasr_tpu_torch.AutoModel\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'funasr_tpu', 'sklearn'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
