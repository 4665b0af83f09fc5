"""Input and checkpoint loading for the port (the sound and text parts of
``funasr_tpu/utils/load_utils.py`` and the loaders of
``funasr_tpu/convert/torch_to_jax.py:1038-1079``).

Audio sources: numpy arrays (float32 in [-1, 1), or raw int16 PCM, which passes through
as int16 so the frontend converts it itself), lists and tuples of samples, ``.wav``
paths and RIFF bytes (copies of the JAX package's parser: 8/16/24/32-bit integer,
float32, G.711 mu-law and A-law, any channel count), ``.pcm`` paths and raw PCM16 bytes,
all resampled with ``scipy.signal.resample_poly`` as the JAX package does. The "text"
data type passes text through (or encodes it with a tokenizer). Compressed containers
(mp3, flac, ogg, mp4, ...) decode through the native runtime's libav codec
(``utils/native_codec.py``), else an ``ffmpeg`` subprocess, and raise when neither is
there. URLs raise: the port fetches nothing. The fbank data type is not ported.

Checkpoints: a FunASR ``model.pt`` state dict loads through ``load_state_dict``; a
pickle of the JAX package's Trainer goes through ``convert.params_from_jax``.
"""

from __future__ import annotations

import logging
import math
import os
import pickle
import struct
import zipfile
from typing import Any, Dict, List, Tuple

import numpy as np
import torch


def _g711_ulaw_decode(u8: np.ndarray) -> np.ndarray:
    """ITU-T G.711 mu-law -> float32 in [-1, 1] (telephony WAV format 7)."""
    u = (~u8).astype(np.int32) & 0xFF
    sign = u & 0x80
    exponent = (u >> 4) & 0x07
    mantissa = u & 0x0F
    mag = ((mantissa << 3) + 0x84 << exponent) - 0x84
    return np.where(sign, -mag, mag).astype(np.float32) / 32768.0


def _g711_alaw_decode(a8: np.ndarray) -> np.ndarray:
    """ITU-T G.711 A-law -> float32 in [-1, 1] (telephony WAV format 6)."""
    a = (a8.astype(np.int32) ^ 0x55) & 0xFF
    sign = a & 0x80
    exponent = (a >> 4) & 0x07
    mantissa = a & 0x0F
    mag = np.where(exponent == 0, (mantissa << 4) + 8,
                   ((mantissa << 4) + 0x108) << (exponent - 1))
    # A-law transmits bit 7 = 1 for POSITIVE samples (opposite of mu-law)
    return np.where(sign, mag, -mag).astype(np.float32) / 32768.0


def _parse_wav_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """Minimal RIFF/WAVE parser: PCM 8/16/24/32, float32, G.711 mu-law/A-law,
    mono/multi-channel -> (float32 mono, sample rate)."""
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE stream")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif chunk_id == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError("missing fmt/data chunk")
    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == 3 or (audio_format == 0xFFFE and bits == 32):
        wav = np.frombuffer(raw, dtype=np.float32)
    elif audio_format == 7:  # G.711 mu-law
        wav = _g711_ulaw_decode(np.frombuffer(raw, dtype=np.uint8))
    elif audio_format == 6:  # G.711 A-law
        wav = _g711_alaw_decode(np.frombuffer(raw, dtype=np.uint8))
    elif bits == 16:
        wav = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    elif bits == 32:
        wav = np.frombuffer(raw, dtype=np.int32).astype(np.float32) / 2147483648.0
    elif bits == 8:
        wav = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif bits == 24:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        vals = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16))
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        wav = vals.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"unsupported wav: format={audio_format} bits={bits}")
    if channels > 1:
        wav = wav.reshape(-1, channels).mean(axis=1)
    return np.ascontiguousarray(wav), sample_rate


def is_audio_container(data: bytes) -> bool:
    """Container sniff (reference ``_is_audio_container:272``)."""
    if len(data) < 12:
        return False
    if data[:4] == b"RIFF" and data[8:12] == b"WAVE":
        return True
    if data[:4] == b"fLaC" or data[:4] == b"OggS" or data[:3] == b"ID3":
        return True
    if data[:2] in (b"\xff\xfb", b"\xff\xf3", b"\xff\xf2", b"\xff\xe3"):
        return True  # mp3 frame sync
    if data[4:8] == b"ftyp":
        return True  # mp4/m4a
    return False


def _ffmpeg_decode(data: bytes, fs: int) -> np.ndarray:
    """ffmpeg-subprocess fallback (reference load_utils.py:272-306 role)."""
    import shutil
    import subprocess
    if shutil.which("ffmpeg") is None:
        raise RuntimeError("ffmpeg binary not found")
    proc = subprocess.run(
        ["ffmpeg", "-nostdin", "-v", "error", "-i", "pipe:0", "-f", "f32le",
         "-ac", "1", "-ar", str(fs), "pipe:1"],
        input=data, stdout=subprocess.PIPE, stderr=subprocess.PIPE, check=False)
    if proc.returncode != 0 or not proc.stdout:
        raise RuntimeError(f"ffmpeg decode failed: {proc.stderr[:200]!r}")
    return np.frombuffer(proc.stdout, np.float32).copy()


def decode_container(data: bytes, fs: int) -> np.ndarray:
    """Compressed container bytes (mp3/flac/ogg/mp4/webm/opus) -> mono f32 @ fs, by the
    JAX package's chain (``load_utils.py:122-138``): the native runtime's codec (libav*
    through ctypes, ``utils/native_codec.py``), then an ``ffmpeg`` subprocess. WAV is
    parsed before reaching here."""
    from funasr_tpu_torch.utils import native_codec
    wav = native_codec.decode_bytes(data, target_rate=fs)
    if wav is not None:
        return wav
    try:
        return _ffmpeg_decode(data, fs)
    except RuntimeError as e:
        raise RuntimeError(
            "cannot decode compressed audio: build the native runtime "
            "(runtime/funasr_tpu_runtime, links system libav*) or install "
            f"ffmpeg ({e})") from e


def resample(wav: np.ndarray, orig_fs: int, target_fs: int) -> np.ndarray:
    if orig_fs == target_fs:
        return wav
    from scipy.signal import resample_poly
    g = math.gcd(orig_fs, target_fs)
    return resample_poly(wav, target_fs // g, orig_fs // g).astype(np.float32)


def load_bytes(data: bytes) -> np.ndarray:
    """Raw 16-bit PCM bytes -> float32 (reference ``load_bytes:306``)."""
    return np.frombuffer(data, dtype=np.int16).astype(np.float32) / 32768.0


def load_audio(source: Any, fs: int = 16000, audio_fs: int = 16000) -> np.ndarray:
    """One source (ndarray, list / tuple of samples, path or bytes) -> mono waveform at
    ``fs`` (``funasr_tpu/utils/load_utils.py:170-226``).

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
        if is_audio_container(data):
            if data[:4] == b"RIFF":
                wav, sr = _parse_wav_bytes(data)
                return resample(wav, sr, fs)
            return decode_container(data, fs)
        return resample(load_bytes(data), audio_fs, fs)
    if isinstance(source, (str, os.PathLike)):
        source = os.fspath(source)
        if source.startswith(("http://", "https://")):
            raise NotImplementedError(f"{source}: URLs are not fetched; download the "
                                      "file and pass its path")
        ext = os.path.splitext(source)[1].lower()
        with open(source, "rb") as f:
            data = f.read()
        if ext == ".pcm":
            return resample(load_bytes(data), audio_fs, fs)
        if data[:4] == b"RIFF":
            wav, sr = _parse_wav_bytes(data)
            return resample(wav, sr, fs)
        if is_audio_container(data) or ext in (".mp3", ".flac", ".ogg", ".m4a",
                                               ".mp4", ".webm", ".opus", ".aac"):
            return decode_container(data, fs)
        wav, sr = _parse_wav_bytes(data)
        return resample(wav, sr, fs)
    if isinstance(source, (list, tuple)):
        return resample(np.asarray(source, dtype=np.float32), audio_fs, fs)
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
                  device=None, cache=None, is_final: bool = True):
    """Waveforms -> (feats (B, T, D), lens (B,)) through the frontend's batched path:
    numpy on the CPU when ``device`` is None, else tensors left on ``device`` (the
    decode pads them to its own bucket). With a streaming ``cache`` the waveforms go to
    ``frontend.forward_streaming`` (``WavFrontendOnline``) as floats in [-1, 1) (int16 PCM
    scaled by 1/32768, ``load_utils.py:266-272``) and come back as host numpy."""
    if data_type != "sound":
        raise NotImplementedError(f"data_type={data_type!r} is not ported (sound only)")
    if cache is not None:
        return frontend.forward_streaming([as_unit_f32(w) for w in audio_list], cache=cache,
                                          is_final=is_final)
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


#: the model names whose checkpoints get their peft LoRA adapters merged on load: those
#: the JAX package converts with ``convert_fun_asr_nano``
#: (``funasr_tpu/convert/torch_to_jax.py:1489-1490``)
LORA_MERGED_MODELS = ("FunASRNano", "LLMASR")


def merge_lora_weights(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Fold peft-style LoRA adapters into their base weights and strip peft's wrapper
    names (a copy of ``funasr_tpu/convert/torch_to_jax.py:660-685`` in torch layout;
    the reference loads LoRA through peft, ``fun_asr_nano/model.py:133-147``):
    ``base_model.model.`` and ``.base_layer.`` go, W <- W + B @ A in fp32 for each
    ``lora_A`` / ``lora_B`` pair with a base weight, at scale 1.0 (the JAX package's:
    lora_alpha / r is not in the keys), and the adapters' keys are dropped."""
    out: Dict[str, Any] = {}
    loras: Dict[str, Dict[str, Any]] = {}
    for k, v in sd.items():
        k2 = k.replace("base_model.model.", "")
        if ".lora_A." in k2 or ".lora_B." in k2:
            for tag in (".lora_A.", ".lora_B."):
                if tag in k2:
                    loras.setdefault(k2.partition(tag)[0], {})[tag.strip(".")] = v
            continue
        out[k2.replace(".base_layer.", ".")] = v
    for base, ab in loras.items():
        wkey = base + ".weight"
        if "lora_A" in ab and "lora_B" in ab and wkey in out:
            out[wkey] = out[wkey].float() + ab["lora_B"].float() @ ab["lora_A"].float()
    return out


def load_pretrained(model: torch.nn.Module, path: str,
                    model_name: str | None = None) -> torch.nn.Module:
    """Load ``path`` into ``model`` in place: a Trainer pickle through
    ``params_from_jax``, else a torch state dict through ``load_state_dict``, its LoRA
    adapters merged first where ``model_name`` is one of ``LORA_MERGED_MODELS``. Missing
    keys raise; keys of branches the port does not build (e.g. ``ctc.*``) are logged
    and dropped, as the JAX converter ignores them."""
    native = load_native_checkpoint(path)
    if native is not None:
        from funasr_tpu_torch.convert import params_from_jax
        model.load_state_dict(params_from_jax(native, model))
        return model
    sd = _strip_module_prefix(load_torch_checkpoint(path))
    if model_name in LORA_MERGED_MODELS:
        sd = merge_lora_weights(sd)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} of the model's tensors: "
                       f"{missing[:8]}{' ...' if len(missing) > 8 else ''}")
    if unexpected:
        logging.info("%s: dropped %d tensors the model does not use (%s%s)", path,
                     len(unexpected), unexpected[:4], " ..." if len(unexpected) > 4 else "")
    return model
