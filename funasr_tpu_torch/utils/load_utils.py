"""Input and checkpoint loading for the port (the sound subset of
``funasr_tpu/utils/load_utils.py`` and the loaders of
``funasr_tpu/convert/torch_to_jax.py:1038-1079``).

Audio sources: numpy arrays (float32 in [-1, 1), or raw int16 PCM, which passes through
as int16 so the frontend converts it itself), ``.wav`` paths and RIFF bytes read with
the stdlib ``wave`` module (PCM16, any channel count, resampled with
``scipy.signal.resample_poly`` as the JAX package does), ``.pcm`` paths and raw PCM16
bytes. The "text" data type passes text through (or encodes it with a tokenizer).
Compressed containers, other WAV sample formats, URLs and the fbank data type are not
ported.

Checkpoints: a FunASR ``model.pt`` state dict loads through ``load_state_dict``; a
pickle of the JAX package's Trainer goes through ``convert.params_from_jax``.
"""

from __future__ import annotations

import io
import logging
import math
import os
import pickle
import wave
import zipfile
from typing import Any, Dict, List

import numpy as np
import torch


def resample(wav: np.ndarray, orig_fs: int, target_fs: int) -> np.ndarray:
    if orig_fs == target_fs:
        return wav
    from scipy.signal import resample_poly
    g = math.gcd(orig_fs, target_fs)
    return resample_poly(wav, target_fs // g, orig_fs // g).astype(np.float32)


def read_wav(source, fs: int = 16000) -> np.ndarray:
    """PCM16 ``.wav`` (a path or a binary file object) -> mono float32 in [-1, 1) at
    ``fs``."""
    with wave.open(source if hasattr(source, "read") else os.fspath(source), "rb") as w:
        if w.getsampwidth() != 2:
            raise ValueError(f"{source}: only 16-bit PCM wav is supported")
        channels, sr = w.getnchannels(), w.getframerate()
        pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    wav = pcm.astype(np.float32) / 32768.0
    if channels > 1:
        wav = wav.reshape(-1, channels).mean(axis=1)
    return resample(np.ascontiguousarray(wav), sr, fs)


def load_bytes(data: bytes) -> np.ndarray:
    """Raw 16-bit PCM bytes -> float32 (reference ``load_bytes:306``)."""
    return np.frombuffer(data, dtype=np.int16).astype(np.float32) / 32768.0


def load_audio(source, fs: int = 16000, audio_fs: int = 16000) -> np.ndarray:
    """One source (ndarray, path or bytes) -> mono waveform at ``fs``.

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
    if isinstance(source, (bytes, bytearray)):
        data = bytes(source)
        if data[:4] == b"RIFF" and data[8:12] == b"WAVE":
            return read_wav(io.BytesIO(data), fs)
        return resample(load_bytes(data), audio_fs, fs)
    if isinstance(source, (str, os.PathLike)):
        if os.path.splitext(os.fspath(source))[1].lower() == ".pcm":
            with open(source, "rb") as f:
                return resample(load_bytes(f.read()), audio_fs, fs)
        return read_wav(source, fs)
    raise TypeError(f"unsupported audio source type {type(source)}")


def as_unit_f32(wav: np.ndarray) -> np.ndarray:
    """Any loaded waveform -> float32 in [-1, 1) (int16 PCM rescaled by 1/32768).

    Consumers that bypass ``extract_fbank`` (the streaming VAD) call this to undo the
    int16 passthrough that ``load_audio`` keeps for PCM16-capable frontends."""
    if getattr(wav, "dtype", None) == np.int16:
        return wav.astype(np.float32) / 32768.0
    return np.asarray(wav, np.float32)


def as_pcm16_f32(wav: np.ndarray) -> np.ndarray:
    """Any loaded waveform -> float32 at PCM16 scale (unit floats x32768), the scale
    kaldi-style fbank expects."""
    if getattr(wav, "dtype", None) == np.int16:
        return wav.astype(np.float32)
    return np.asarray(wav, np.float32) * 32768.0


def load_audio_text_image_video(data_in, fs: int = 16000, audio_fs: int = 16000,
                                data_type: str = "sound", tokenizer=None) -> List[Any]:
    """One input or a list of them -> a list (reference ``load_audio_text_image_video:48``):
    "sound" -> waveforms; "text" -> token-id arrays with a tokenizer, else the items as
    they are."""
    if data_type not in ("sound", "text"):
        raise NotImplementedError(f"data_type={data_type!r} is not ported (sound, text)")
    items = list(data_in) if isinstance(data_in, (list, tuple)) else [data_in]
    if data_type == "text":
        return [np.asarray(tokenizer.encode(item), dtype=np.int32)
                if tokenizer is not None and isinstance(item, str) else item
                for item in items]
    return [load_audio(item, fs=fs, audio_fs=audio_fs) for item in items]


def extract_fbank(audio_list: List[np.ndarray], data_type: str = "sound", frontend=None,
                  device=None):
    """Waveforms -> (feats (B, T, D), lens (B,)) through the frontend's batched path:
    numpy on the CPU when ``device`` is None, else tensors left on ``device`` (the
    decode pads them to its own bucket)."""
    if data_type != "sound":
        raise NotImplementedError(f"data_type={data_type!r} is not ported (sound only)")
    return frontend.extract(audio_list, device=device)


def _strip_module_prefix(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Tolerate DDP 'module.' prefixes (reference ``trainer.py:303-323`` behavior)."""
    if any(k.startswith("module.") for k in sd):
        return {k[len("module."):] if k.startswith("module.") else k: v
                for k, v in sd.items()}
    return dict(sd)


def load_native_checkpoint(path: str):
    """The params tree of a pickle written by the JAX package's Trainer
    (``{"params": <numpy tree>, ...}``), or None if ``path`` is not one. Torch
    checkpoints are zip archives or torch-only legacy pickles, so a plain pickle of a
    dict with a "params" dict is unambiguous. The pickle is trusted, as in the JAX
    package: it is the repository's own training output."""
    if zipfile.is_zipfile(path):
        return None
    try:
        with open(path, "rb") as f:
            obj = pickle.load(f)
    except (pickle.UnpicklingError, EOFError, AttributeError, ImportError, IndexError,
            TypeError, ValueError):
        return None
    if isinstance(obj, dict) and isinstance(obj.get("params"), dict):
        return obj["params"]
    return None


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """Load a ``model.pt`` state dict onto the CPU."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if isinstance(obj, dict) and "model_state_dict" in obj:  # openai whisper .pt
        obj = obj["model_state_dict"]
    return obj


def load_pretrained(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load ``path`` into ``model`` in place: a Trainer pickle through
    ``params_from_jax``, else a torch state dict through ``load_state_dict``. Missing
    keys raise; keys of branches the port does not build (e.g. ``ctc.*``) are logged
    and dropped, as the JAX converter ignores them."""
    native = load_native_checkpoint(path)
    if native is not None:
        from funasr_tpu_torch.convert import params_from_jax
        model.load_state_dict(params_from_jax(native, model))
        return model
    sd = _strip_module_prefix(load_torch_checkpoint(path))
    missing, unexpected = model.load_state_dict(sd, strict=False)
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} of the model's tensors: "
                       f"{missing[:8]}{' ...' if len(missing) > 8 else ''}")
    if unexpected:
        logging.info("%s: dropped %d tensors the model does not use (%s%s)", path,
                     len(unexpected), unexpected[:4], " ..." if len(unexpected) > 4 else "")
    return model
