"""ctypes binding to the native runtime's compressed-audio decoder (a framework-free copy
of ``funasr_tpu/utils/native_codec.py``).

``runtime/funasr_tpu_runtime/src/codec.cc`` links the system libav* and decodes
mp3/flac/ogg/mp4/webm/opus to mono float32 at a target rate (FunASR
``funasr/utils/load_utils.py:48,272-306``). The library is found as the JAX package finds
it: ``FUNASR_TPU_RUNTIME_LIB``, then the runtime's own build directory, then the loader's
search path.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB = None
_TRIED = False


def _candidate_paths():
    env = os.environ.get("FUNASR_TPU_RUNTIME_LIB")
    if env:
        yield env
    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(os.path.dirname(here))
    yield os.path.join(repo, "runtime", "funasr_tpu_runtime", "build",
                       "libfunasr_tpu_runtime.so")
    yield "libfunasr_tpu_runtime.so"


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    for path in _candidate_paths():
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            continue
        try:
            lib.FunASRDecodeAudio.restype = ctypes.c_int
            lib.FunASRDecodeAudio.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.c_int64)]
            lib.FunASRFreeAudio.argtypes = [ctypes.POINTER(ctypes.c_float)]
            if lib.FunASRHasCodec() != 1:
                continue
        except AttributeError:
            continue
        _LIB = lib
        break
    return _LIB


def available() -> bool:
    return _load() is not None


def decode_bytes(data: bytes, target_rate: int = 16000) -> Optional[np.ndarray]:
    """Compressed container bytes -> mono float32 at target_rate, or None."""
    lib = _load()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_float)()
    out_len = ctypes.c_int64(0)
    rc = lib.FunASRDecodeAudio(data, len(data), int(target_rate),
                               ctypes.byref(out), ctypes.byref(out_len))
    if rc != 0 or out_len.value <= 0:
        return None
    try:
        wav = np.ctypeslib.as_array(out, shape=(out_len.value,)).copy()
    finally:
        lib.FunASRFreeAudio(out)
    return wav.astype(np.float32)
