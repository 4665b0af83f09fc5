"""``load_audio`` of the PyTorch port against the JAX package's, bit for bit.

WAV files are written with ``struct`` from one seeded signal in every sample format the
JAX parser reads (8 / 16 / 24 / 32-bit integer PCM, float32, the extensible float32
header, G.711 mu-law and A-law), mono and stereo, at 16 and 8 kHz (resampled to 16 kHz),
and loaded as paths and as bytes; lists and tuples of samples too. URLs raise in the port
(no network); compressed containers raise when neither the native codec nor ``ffmpeg``
is there (``tests/test_torch_native_codec.py`` decodes them with the codec).
"""

import struct

import numpy as np
import pytest

from funasr_tpu.utils import load_utils as jload
from funasr_tpu_torch.utils import load_utils as tload

FORMATS = ["u8", "s16", "s24", "s32", "f32", "f32_extensible", "ulaw", "alaw"]


def _signal(n, channels, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    x = 0.6 * np.sin(2 * np.pi * 330.0 * t)[:, None] + 0.2 * rng.standard_normal((n, channels))
    return np.clip(x, -0.999, 0.999)


def _encode(x, fmt):
    """(n, channels) in (-1, 1) -> (format code, bits, interleaved sample bytes)."""
    if fmt == "u8":
        return 1, 8, np.round(x * 127 + 128).astype(np.uint8).tobytes()
    if fmt == "s16":
        return 1, 16, np.round(x * 32767).astype("<i2").tobytes()
    if fmt == "s24":
        v = np.round(x * 8388607).astype("<i4").reshape(-1, 1).view(np.uint8)
        return 1, 24, v.reshape(-1, 4)[:, :3].tobytes()
    if fmt == "s32":
        return 1, 32, np.round(x * 2147483000).astype("<i4").tobytes()
    if fmt in ("f32", "f32_extensible"):
        return (3 if fmt == "f32" else 0xFFFE), 32, x.astype("<f4").tobytes()
    # G.711: every byte is a code; take the signal's top 8 bits as the codes
    return (7 if fmt == "ulaw" else 6), 8, np.round(x * 127 + 128).astype(np.uint8).tobytes()


def wav_bytes(x, fmt, sr):
    code, bits, data = _encode(x, fmt)
    channels = x.shape[1]
    block = channels * bits // 8
    fmt_chunk = struct.pack("<HHIIHH", code, channels, sr, sr * block, block, bits)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk
            + b"LIST" + struct.pack("<I", 3) + b"abc\x00"  # an odd-sized chunk, padded
            + b"data" + struct.pack("<I", len(data)) + data + b"\x00" * (len(data) & 1))
    return b"RIFF" + struct.pack("<I", len(body)) + body


@pytest.mark.parametrize("sr", [16000, 8000])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("fmt", FORMATS)
def test_wav_formats_load_as_in_jax(tmp_path, fmt, channels, sr):
    data = wav_bytes(_signal(4001, channels), fmt, sr)  # odd length: a pad byte for u8
    path = tmp_path / f"{fmt}.wav"
    path.write_bytes(data)
    for source in (str(path), data, bytearray(data)):
        got = tload.load_audio(source, fs=16000)
        want = jload.load_audio(source, fs=16000)
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want)
    assert len(got) == (4001 if sr == 16000 else 8002)


@pytest.mark.parametrize("audio_fs", [16000, 8000])
def test_lists_and_tuples_of_samples_load_as_in_jax(audio_fs):
    x = _signal(1601, 1)[:, 0]
    for source in (list(x), tuple(float(v) for v in x), [int(v) for v in x * 100]):
        got = tload.load_audio(source, fs=16000, audio_fs=audio_fs)
        want = jload.load_audio(source, fs=16000, audio_fs=audio_fs)
        assert np.array_equal(got, want)
    batch = tload.load_audio_text_image_video([tuple(x[:800]), x[:800]], fs=16000)
    assert np.array_equal(batch[0], batch[1])


def test_raw_pcm_bytes_and_path_load_as_in_jax(tmp_path):
    pcm = np.round(_signal(3000, 1)[:, 0] * 32767).astype("<i2").tobytes()
    path = tmp_path / "raw.pcm"
    path.write_bytes(pcm)
    for source in (pcm, str(path)):
        assert np.array_equal(tload.load_audio(source, audio_fs=8000),
                              jload.load_audio(source, audio_fs=8000))


def test_container_sniff_and_unported_sources(tmp_path, monkeypatch):
    samples = [b"RIFF\x00\x00\x00\x00WAVEfmt ", b"fLaC" + b"\x00" * 12, b"OggS" + b"\x00" * 12,
               b"ID3\x03" + b"\x00" * 12, b"\xff\xfb" + b"\x00" * 14,
               b"\x00\x00\x00\x18ftypmp42", b"\x01\x02" * 8, b"short"]
    for data in samples:
        assert tload.is_audio_container(data) == jload.is_audio_container(data)
    # no decoder present: neither the native codec nor ffmpeg (as in JAX)
    import shutil
    from funasr_tpu_torch.utils import native_codec
    monkeypatch.setattr(native_codec, "_load", lambda: None)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="cannot decode compressed audio"):
        tload.load_audio(b"fLaC" + b"\x00" * 64)
    mp3 = tmp_path / "a.mp3"
    mp3.write_bytes(b"\x00" * 64)
    with pytest.raises(RuntimeError, match="cannot decode compressed audio"):
        tload.load_audio(str(mp3))
    with pytest.raises(NotImplementedError, match="URL"):
        tload.load_audio("https://example.invalid/a.wav")
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav file at all")
    for load in (tload.load_audio, jload.load_audio):
        with pytest.raises(ValueError, match="RIFF"):
            load(str(bad))
