"""Audio loading for the port's offline decode (the subset of
``funasr_tpu/utils/load_utils.py::load_audio`` that slice 1 needs).

Inputs are numpy arrays (float32 in [-1, 1), or raw int16 PCM, which passes through as
int16 so the frontend converts it itself) and ``.wav`` paths read with the stdlib
``wave`` module (PCM16, any channel count, resampled with ``scipy.signal.resample_poly``
as the JAX package does). Compressed containers, raw bytes and URLs are slice 2.
"""

from __future__ import annotations

import math
import os
import wave

import numpy as np


def resample(wav: np.ndarray, orig_fs: int, target_fs: int) -> np.ndarray:
    if orig_fs == target_fs:
        return wav
    from scipy.signal import resample_poly
    g = math.gcd(orig_fs, target_fs)
    return resample_poly(wav, target_fs // g, orig_fs // g).astype(np.float32)


def read_wav(path, fs: int = 16000) -> np.ndarray:
    """PCM16 ``.wav`` -> mono float32 in [-1, 1) at ``fs``."""
    with wave.open(os.fspath(path), "rb") as w:
        if w.getsampwidth() != 2:
            raise ValueError(f"{path}: only 16-bit PCM wav is supported")
        channels, sr = w.getnchannels(), w.getframerate()
        pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    wav = pcm.astype(np.float32) / 32768.0
    if channels > 1:
        wav = wav.reshape(-1, channels).mean(axis=1)
    return resample(np.ascontiguousarray(wav), sr, fs)


def load_audio(source, fs: int = 16000, audio_fs: int = 16000) -> np.ndarray:
    """One source (ndarray or ``.wav`` path) -> mono waveform at ``fs``.

    float32 in [-1, 1), except a 1-D int16 array at the target rate, which is returned
    as int16 (the frontend's PCM16 path; bit-identical features).
    """
    if isinstance(source, np.ndarray):
        if source.dtype == np.int16:
            if source.ndim == 1 and audio_fs == fs:
                return source
            source = source.astype(np.float32) / 32768.0
        wav = source.astype(np.float32)
        if wav.ndim > 1:
            wav = wav.mean(axis=-1 if wav.shape[-1] <= 8 else 0)
        return resample(wav, audio_fs, fs)
    if isinstance(source, (str, os.PathLike)):
        return read_wav(source, fs)
    raise TypeError(f"unsupported audio source type {type(source)}")
