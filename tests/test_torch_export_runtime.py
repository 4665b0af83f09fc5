"""The port's C++-runtime writers (``funasr_tpu_torch/export_runtime.py``) and bindings
(``funasr_tpu_torch/runtime_bins.py``) against the JAX package's.

The FTR files written from port modules are byte-equal to the JAX writers' given the
same weights (the JAX parameter tree that ``funasr_tpu/convert/torch_to_jax.py`` builds
from the port module's state dict): Paraformer at fp32, int8, int4, int3 and int2,
BiCif-Paraformer, the VAD, the punctuation model (offline and streaming), SenseVoice,
and ``export_native_dir``'s directory. A build of the C++ runtime transcribing from
port-written files is marked as ``tests/test_cpp_runtime.py`` marks its tests.
"""

import filecmp
import inspect
import os
import shutil
import struct
import subprocess
import wave

import numpy as np
import pytest
import torch

import funasr_tpu  # noqa: F401  (fills the JAX tables)
from funasr_tpu import export_runtime as jexport
from funasr_tpu import runtime_bins as jbins
from funasr_tpu.convert.torch_to_jax import convert_state_dict
from funasr_tpu.register import tables as jtables
from funasr_tpu_torch import export_runtime as pexport
from funasr_tpu_torch import runtime_bins as pbins
from funasr_tpu_torch import tables
from torch_parity_util import (BICIF_PREDICTOR, PIPE_ASR_CONF, PIPE_TOKENS, PUNC_ENC,
                               PUNC_MODEL_CONF, SV_CONF, VAD_CONF, to_jax, write_asr_dir)

GEN = torch.Generator


def _pair(name, conf, seed=0, convert_as=None):
    """(port module, JAX model, JAX params) of one class and config, same weights."""
    pt = tables.model_classes[name](**conf, generator=GEN().manual_seed(seed)).eval()
    jm = jtables.model_classes[name](**conf)
    params = convert_state_dict(pt.state_dict(), jm, convert_as or name)
    return pt, jm, to_jax(params)


def _paraformer():
    return _pair("Paraformer", PIPE_ASR_CONF)


def _bicif():
    return _pair("BiCifParaformer", dict(PIPE_ASR_CONF, predictor="CifPredictorV3",
                                         predictor_conf=BICIF_PREDICTOR))


def _vad():
    conf = dict(encoder_conf=VAD_CONF, max_end_silence_time=800, speech_noise_thres=0.6)
    return _pair("FsmnVADStreaming", conf, seed=1)


def _punc(name="CTTransformer"):
    conf = dict(encoder_conf=PUNC_ENC, vocab_size=len(PIPE_TOKENS), **PUNC_MODEL_CONF)
    if name == "CTTransformerStreaming":
        conf = dict(conf, encoder="SANMVadEncoder")
    return _pair(name, conf, seed=2)


def _sense_voice():
    return _pair("SenseVoiceSmall", SV_CONF)


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


@pytest.mark.parametrize("build,quant", [
    (_paraformer, None), (_paraformer, "int8"), (_paraformer, "int4"),
    (_paraformer, "int3"), (_paraformer, "int2"), (_bicif, None), (_bicif, "int8")])
def test_export_ftr_byte_equal(tmp_path, build, quant):
    pt, jm, params = build()
    meta = {"lfr_m": 7, "lfr_n": 6, "n_mels": 80}
    jexport.export_ftr(jm, params, str(tmp_path / "jax.ftr"), quant=quant, extra_meta=meta)
    pexport.export_ftr(pt, str(tmp_path / "port.ftr"), quant=quant, extra_meta=meta)
    assert _same_bytes(tmp_path / "jax.ftr", tmp_path / "port.ftr")


def test_export_vad_ftr_byte_equal(tmp_path):
    pt, jm, params = _vad()
    jexport.export_vad_ftr(jm, params, str(tmp_path / "jax.ftr"))
    pexport.export_vad_ftr(pt, str(tmp_path / "port.ftr"))
    assert _same_bytes(tmp_path / "jax.ftr", tmp_path / "port.ftr")


@pytest.mark.parametrize("name,quant", [("CTTransformer", None), ("CTTransformer", "int8"),
                                        ("CTTransformerStreaming", None)])
def test_export_punc_ftr_byte_equal(tmp_path, name, quant):
    pt, jm, params = _punc(name)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jexport.export_punc_ftr(jm, params, str(tmp_path / "jax" / "punc.ftr"),
                            token_list=PIPE_TOKENS, quant=quant)
    pexport.export_punc_ftr(pt, str(tmp_path / "port" / "punc.ftr"), token_list=PIPE_TOKENS,
                            quant=quant)
    for f in ("punc.ftr", "punc_tokens.txt"):
        assert _same_bytes(tmp_path / "jax" / f, tmp_path / "port" / f), f


@pytest.mark.parametrize("quant", [None, "int8"])
def test_export_sensevoice_ftr_byte_equal(tmp_path, quant):
    pt, jm, params = _sense_voice()
    jexport.export_sensevoice_ftr(jm, params, str(tmp_path / "jax.ftr"), quant=quant)
    pexport.export_sensevoice_ftr(pt, str(tmp_path / "port.ftr"), quant=quant)
    assert _same_bytes(tmp_path / "jax.ftr", tmp_path / "port.ftr")


@pytest.mark.parametrize("quant", [None, "int4"])
def test_export_native_dir_equal(tmp_path, quant):
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    write_asr_dir(str(model_dir))
    pt, jm, params = _paraformer()
    pt.load_state_dict(torch.load(model_dir / "model.pt"))
    params = to_jax(convert_state_dict(pt.state_dict(), jm, "Paraformer"))
    jexport.export_native_dir(jm, params, str(model_dir), str(tmp_path / "jax"), quant=quant)
    pexport.export_native_dir(pt, str(model_dir), str(tmp_path / "port"), quant=quant)
    cmp = filecmp.dircmp(tmp_path / "jax", tmp_path / "port")
    assert sorted(os.listdir(tmp_path / "port")) == ["am.mvn", "tokens.txt", "weights.ftr"]
    assert not cmp.left_only and not cmp.right_only
    for f in cmp.common_files:
        assert _same_bytes(tmp_path / "jax" / f, tmp_path / "port" / f), f


def test_save_params_npz_equal(tmp_path):
    """The npz holds the same names, order, shapes and values as the JAX package's."""
    pt, jm, params = _paraformer()
    jexport.save_params_npz(params, str(tmp_path / "jax.npz"))
    pexport.save_params_npz(pt, str(tmp_path / "port.npz"))
    want, got = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert got.files == want.files
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k])


def test_params_tree_rejects_an_int8_model():
    from funasr_tpu_torch.ops.quant import quantize_params_int8
    pt, _, _ = _pair("Paraformer", dict(PIPE_ASR_CONF, encoder_conf=dict(
        PIPE_ASR_CONF["encoder_conf"], output_size=256, linear_units=256),
        predictor_conf=dict(PIPE_ASR_CONF["predictor_conf"], idim=256)))
    quantize_params_int8(pt, mode="w8a8")
    with pytest.raises(ValueError, match="int8"):
        pexport.params_tree(pt)


def test_ftr_int4_pack_exact(tmp_path, rng):
    """int4 FTR nibble packing of the port's writer is bit-exact against a reference
    unpacker (``tests/test_export_runtime_mcp.py::test_ftr_int4_pack_exact``)."""
    w = rng.standard_normal((96, 64)).astype(np.float32)
    path = str(tmp_path / "w.ftr")
    pexport._write_ftr(path, {"model": "T"}, {"lin/w": w}, quant="int4")
    with open(path, "rb") as f:
        assert f.read(4) == b"FTR1"
        (meta_len,) = struct.unpack("<I", f.read(4))
        f.read(meta_len)
        (n,) = struct.unpack("<I", f.read(4))
        assert n == 1
        (name_len,) = struct.unpack("<I", f.read(4))
        assert f.read(name_len) == b"lin/w"
        dtype, ndim = struct.unpack("<BB", f.read(2))
        assert dtype == 2 and ndim == 2
        assert struct.unpack("<2q", f.read(16)) == (96, 64)
        (n_scales,) = struct.unpack("<q", f.read(8))
        scales = np.frombuffer(f.read(4 * n_scales), "<f4")
        packed = np.frombuffer(f.read((96 * 64 + 1) // 2), np.uint8)
    lo = (packed & 0x0F).astype(np.int16)
    hi = (packed >> 4).astype(np.int16)
    q = np.empty(96 * 64, np.int16)
    q[0::2] = lo
    q[1::2] = hi
    q = ((q ^ 8) - 8).astype(np.float32).reshape(96, 64)
    np.testing.assert_array_equal(q, np.clip(np.round(w / scales[None, :]), -7, 7))
    np.testing.assert_allclose(q * scales[None, :], w, atol=float(scales.max()) * 0.5 + 1e-7)


def _public(module):
    return {n: v for n, v in vars(module).items()
            if not n.startswith("_") and inspect.isclass(v) and v.__module__ == module.__name__}


def test_runtime_bins_surface():
    """The same classes, methods and signatures as the JAX package's bindings, the same
    library path, and the same ctypes declarations (a stub library records them)."""
    want, got = _public(jbins), _public(pbins)
    assert sorted(got) == sorted(want)
    for name, cls in want.items():
        for meth, fn in vars(cls).items():
            if callable(fn):
                assert str(inspect.signature(getattr(got[name], meth))) == \
                    str(inspect.signature(fn)), (name, meth)
    assert pbins._default_lib() == jbins._default_lib()

    class Fn:
        argtypes = restype = None

    class Lib:
        def __init__(self, path):
            self.fns = {}

        def __getattr__(self, name):
            return self.__dict__["fns"].setdefault(name, Fn())

    declared = []
    for module in (jbins, pbins):
        original = module.ctypes.CDLL
        module.ctypes.CDLL = Lib
        try:
            lib = module._load_lib("stub.so")
        finally:
            module.ctypes.CDLL = original
        declared.append({n: (f.argtypes, f.restype) for n, f in lib.fns.items()})
    assert declared[1] == declared[0] and len(declared[0]) >= 19
    with pytest.raises(OSError):
        pbins._load_lib(os.path.join(os.sep, "nonexistent", "libfunasr_tpu_runtime.so"))


RUNTIME_DIR = os.path.join(os.path.dirname(__file__), "..", "runtime", "funasr_tpu_runtime")


@pytest.mark.slow
@pytest.mark.skipif(shutil.which("cmake") is None or shutil.which("g++") is None,
                    reason="no C++ toolchain")
def test_cpp_runtime_transcribes_port_files(tmp_path):
    """The C++ runtime, built from the checkout, transcribes from port-written files as
    the port's ``AutoModel`` does, through its CLI and through ``runtime_bins``."""
    from funasr_tpu_torch import AutoModel

    build = tmp_path / "build"
    subprocess.run(["cmake", "-S", RUNTIME_DIR, "-B", str(build),
                    "-DCMAKE_BUILD_TYPE=Release"], check=True, capture_output=True)
    subprocess.run(["cmake", "--build", str(build), "-j4"], check=True, capture_output=True)
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    write_asr_dir(str(model_dir))
    am = AutoModel(model=str(model_dir), device="cpu", log_level="WARNING")
    out_dir = str(tmp_path / "native")
    pexport.export_native_dir(am.model, str(model_dir), out_dir)
    sig = (np.random.default_rng(9).standard_normal(24000) * 0.1 * 32767).astype(np.int16)
    wav_path = str(tmp_path / "t.wav")
    with wave.open(wav_path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(sig.tobytes())
    py_text = am.generate(input=wav_path)[0]["text"]
    assert py_text.strip()
    r = subprocess.run([str(build / "funasr-tpu-offline"), out_dir, wav_path],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().split("\t")[-1].replace(" ", "") == py_text.replace(" ", "")
    out = pbins.Paraformer(out_dir, lib_path=str(build / "libfunasr_tpu_runtime.so"))(
        [wav_path])
    assert out[0]["preds"].replace(" ", "") == py_text.replace(" ", "")
