"""Compressed containers through the port's ``load_audio`` against the JAX package's.

The native runtime's codec (``runtime/funasr_tpu_runtime/src/codec.cc``, libav*) is built
with g++ into a temporary directory (never the runtime's own ``build/``), as the one
source the decode needs, and both packages find it through ``FUNASR_TPU_RUNTIME_LIB``.
A FLAC file written by the test (VERBATIM subframes, 16-bit mono) decodes bit-equal in
both, as a path and as bytes, at 16 kHz (equal to its PCM source) and at 8 kHz (half the
samples). Skips where g++ or the libav headers are absent.
"""

import os
import shutil
import struct
import subprocess
from pathlib import Path

import numpy as np
import pytest

from funasr_tpu.utils import load_utils as jload
from funasr_tpu.utils import native_codec as jcodec
from funasr_tpu_torch.utils import load_utils as tload
from funasr_tpu_torch.utils import native_codec as tcodec

RUNTIME = Path(__file__).resolve().parent.parent / "runtime" / "funasr_tpu_runtime"
LIBAV = ("libavformat", "libavcodec", "libavutil", "libswresample")


@pytest.fixture(scope="module")
def codec_lib(tmp_path_factory):
    inc = [d for d in ("/usr/include", "/usr/include/x86_64-linux-gnu")
           if all(os.path.isdir(os.path.join(d, h)) for h in LIBAV)]
    if shutil.which("g++") is None or not inc:
        pytest.skip("g++ or the libav headers are absent")
    out = tmp_path_factory.mktemp("codec") / "libfunasr_tpu_runtime.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-DFUNASR_TPU_HAVE_FFMPEG",
                    f"-I{RUNTIME / 'include'}", str(RUNTIME / "src" / "codec.cc"), "-o", str(out),
                    "-lavformat", "-lavcodec", "-lswresample", "-lavutil"],
                   check=True, capture_output=True, timeout=120)
    return str(out)


@pytest.fixture
def with_codec(codec_lib, monkeypatch):
    monkeypatch.setenv("FUNASR_TPU_RUNTIME_LIB", codec_lib)
    for mod in (jcodec, tcodec):  # both cache the library they found
        monkeypatch.setattr(mod, "_LIB", None)
        monkeypatch.setattr(mod, "_TRIED", False)
    yield
    assert tcodec._LIB is not None and tcodec._LIB._name == codec_lib


def _bits(writer_bits):
    out, acc, n = bytearray(), 0, 0
    for value, width in writer_bits:
        acc, n = (acc << width) | (value & ((1 << width) - 1)), n + width
        while n >= 8:
            n -= 8
            out.append((acc >> n) & 0xFF)
    if n:
        out.append((acc << (8 - n)) & 0xFF)
    return bytes(out)


def _crc(data, poly, width):
    crc, top, mask = 0, 1 << (width - 1), (1 << width) - 1
    for byte in data:
        crc ^= byte << (width - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) & mask if crc & top else (crc << 1) & mask
    return crc


def write_flac(pcm: np.ndarray, rate: int = 16000, block: int = 4096) -> bytes:
    """Mono 16-bit PCM -> a FLAC stream of fixed-size frames with VERBATIM subframes."""
    n = len(pcm)
    info = struct.pack(">HH", block, block) + b"\x00\x00\x00" * 2 + _bits(
        [(rate, 20), (0, 3), (15, 5), (n >> 32, 4), (n & 0xFFFFFFFF, 32)]) + b"\x00" * 16
    out = bytearray(b"fLaC") + bytes([0x80]) + len(info).to_bytes(3, "big") + info
    for f, start in enumerate(range(0, n, block)):
        chunk = pcm[start:start + block]
        size_code = (7, 8) if len(chunk) != block else (12, 0)  # 4096 or explicit 16-bit
        head = _bits([(0x3FFE, 14), (0, 1), (0, 1), (size_code[0], 4), (0, 4), (0, 4),
                      (4, 3), (0, 1)])
        head += bytes([f]) if f < 128 else b""
        assert f < 128
        if size_code[0] == 7:
            head += struct.pack(">H", len(chunk) - 1)
        head += bytes([_crc(head, 0x07, 8)])
        body = _bits([(0, 1), (1, 6), (0, 1)] + [(int(v), 16) for v in chunk])
        frame = head + body
        out += frame + struct.pack(">H", _crc(frame, 0x8005, 16))
    return bytes(out)


@pytest.fixture(scope="module")
def flac(tmp_path_factory):
    rng = np.random.default_rng(0)
    t = np.arange(32000) / 16000.0
    pcm = np.clip(0.5 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(32000),
                  -1, 1)
    pcm = (pcm * 32767).astype(np.int16)
    path = tmp_path_factory.mktemp("flac") / "a.flac"
    path.write_bytes(write_flac(pcm))
    return path, pcm


@pytest.mark.parametrize("fs", [16000, 8000])
def test_flac_decodes_bit_equal_to_jax(with_codec, flac, fs):
    path, pcm = flac
    data = path.read_bytes()
    for source in (str(path), data):
        got = tload.load_audio(source, fs=fs)
        want = jload.load_audio(source, fs=fs)
        assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    if fs == 16000:
        np.testing.assert_array_equal(got, pcm.astype(np.float32) / 32768.0)
    else:
        assert len(got) == len(pcm) // 2
    assert tcodec.available() and jcodec.available()


def test_decode_bytes_rejects_garbage(with_codec):
    assert tcodec.decode_bytes(b"fLaC" + b"\x00" * 64) is None
    assert tcodec.decode_bytes(b"\x00" * 64) is None
    assert jcodec.decode_bytes(b"\x00" * 64) is None
