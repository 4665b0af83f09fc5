"""funasr_onnx-style python bindings over the native C++ runtime.

Counterpart of the reference ``funasr_onnx`` pip package
(``runtime/python/onnxruntime/funasr_onnx/{paraformer_bin,
paraformer_online_bin, vad_bin, punc_bin, sensevoice_bin}.py``): the same
class-per-model surface, but executing the pure-C++ engines in
``libfunasr_tpu_runtime.so`` via ctypes — no JAX, no PyTorch, no model code, no Python
compute. Model dirs are produced by :mod:`funasr_tpu_torch.export_runtime`
(``export_native_dir`` / ``export_vad_ftr`` / ``export_punc_ftr``).

    from funasr_tpu_torch.runtime_bins import Paraformer
    model = Paraformer("exported_dir/")
    print(model(["a.wav"]))          # [{"preds": "..."}]
"""

from __future__ import annotations

import ctypes
import json
import os
from typing import List, Optional, Union


def _default_lib() -> str:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(here, "runtime", "funasr_tpu_runtime", "build",
                        "libfunasr_tpu_runtime.so")


def _load_lib(lib_path: Optional[str] = None):
    lib = ctypes.CDLL(lib_path or os.environ.get("FUNASR_TPU_RUNTIME_LIB")
                      or _default_lib())
    lib.FunASRInit.restype = ctypes.c_void_p
    lib.FunASRInit.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.FunOfflineInfer.restype = ctypes.c_void_p
    lib.FunOfflineInfer.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.FunOfflineInferHotword.restype = ctypes.c_void_p
    lib.FunOfflineInferHotword.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    lib.FunOfflineInferHotwordBeam.restype = ctypes.c_void_p
    lib.FunOfflineInferHotwordBeam.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    lib.FunASRBiasBeamDecode.restype = ctypes.c_int
    lib.FunASRBiasBeamDecode.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.FunASRHotwordCompile.restype = ctypes.c_void_p
    lib.FunASRHotwordCompile.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                         ctypes.c_float]
    lib.FunASRHotwordFree.argtypes = [ctypes.c_void_p]
    lib.FunASRGetResult.restype = ctypes.c_char_p
    lib.FunASRGetResult.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.FunASRGetStamp.restype = ctypes.c_char_p
    lib.FunASRGetStamp.argtypes = [ctypes.c_void_p]
    lib.FunASRFreeResult.argtypes = [ctypes.c_void_p]
    lib.FunASRUninit.argtypes = [ctypes.c_void_p]
    lib.FunVadInfer.restype = ctypes.c_void_p
    lib.FunVadInfer.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_int, ctypes.c_int]
    lib.FunPuncInfer.restype = ctypes.c_void_p
    lib.FunPuncInfer.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.FunPuncCacheCreate.restype = ctypes.c_void_p
    lib.FunPuncCacheFree.argtypes = [ctypes.c_void_p]
    lib.FunPuncInferOnline.restype = ctypes.c_void_p
    lib.FunPuncInferOnline.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_void_p]
    lib.FunASRStreamCreate.restype = ctypes.c_void_p
    lib.FunASRStreamCreate.argtypes = [ctypes.c_void_p]
    lib.FunASRStreamInfer.restype = ctypes.c_void_p
    lib.FunASRStreamInfer.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int]
    lib.FunASRStreamFree.argtypes = [ctypes.c_void_p]
    return lib


def _read_audio(item: Union[str, bytes]) -> bytes:
    if isinstance(item, bytes):
        return item
    with open(item, "rb") as f:
        return f.read()


class _Handle:
    def __init__(self, model_dir: str, lib_path: Optional[str] = None,
                 quantize: bool = False, **kwargs):
        del quantize  # quantization is baked into the export, kept for parity
        self.lib = _load_lib(lib_path)
        self.handle = self.lib.FunASRInit(str(model_dir).encode(), 1)
        if not self.handle:
            raise RuntimeError(f"FunASRInit failed for {model_dir}")

    def __del__(self):
        try:
            if getattr(self, "handle", None):
                self.lib.FunASRUninit(ctypes.c_void_p(self.handle))
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass

    def _result_text(self, res) -> str:
        if not res:
            return ""
        text = self.lib.FunASRGetResult(res, 0)
        out = text.decode() if text else ""
        self.lib.FunASRFreeResult(ctypes.c_void_p(res))
        return out


class Paraformer(_Handle):
    """Offline ASR (funasr_onnx ``Paraformer`` role): also serves SenseVoice
    exports — FunASRInit picks the engine from the weights.ftr meta. A
    ``hotword="word1 word2"`` kwarg biases the greedy decode through the
    compiled trie (reference CompileHotwordEmbedding/wfst-decoder role)."""

    def __init__(self, model_dir: str, **kwargs):
        super().__init__(model_dir, **kwargs)
        self._tokens_file = os.path.join(str(model_dir), "tokens.txt")
        self._hw_cache = {}

    _HW_CACHE_MAX = 16  # bounded: per-request hotword strings must not leak

    def _trie(self, hotword: str, boost: float):
        key = (hotword, boost)
        if key not in self._hw_cache:
            while len(self._hw_cache) >= self._HW_CACHE_MAX:
                _, old = self._hw_cache.popitem()
                if old:
                    self.lib.FunASRHotwordFree(ctypes.c_void_p(old))
            self._hw_cache[key] = self.lib.FunASRHotwordCompile(
                hotword.encode(), self._tokens_file.encode(),
                ctypes.c_float(boost))
        return self._hw_cache[key]

    def __del__(self):
        for trie in getattr(self, "_hw_cache", {}).values():
            try:
                if trie:
                    self.lib.FunASRHotwordFree(ctypes.c_void_p(trie))
            except Exception:  # noqa: BLE001 — interpreter shutdown
                pass
        self._hw_cache = {}
        super().__del__()

    def __call__(self, wav_content: Union[str, bytes, List], fs: int = 16000,
                 hotword: Optional[str] = None, hotword_boost: float = 3.0,
                 beam: int = 1, **kwargs) -> List[dict]:
        items = wav_content if isinstance(wav_content, list) else [wav_content]
        trie = self._trie(hotword, hotword_boost) if hotword else None
        results = []
        for item in items:
            data = _read_audio(item)
            # beam > 1 runs the bias-LM beam search (wfst-decoder lattice
            # role); beam <= 1 is the bias-aware greedy decode
            res = self.lib.FunOfflineInferHotwordBeam(
                self.handle, data, len(data), 0, fs, trie, int(beam))
            out = {"preds": ""}
            if res:
                text = self.lib.FunASRGetResult(res, 0)
                out["preds"] = text.decode() if text else ""
                stamp = self.lib.FunASRGetStamp(res)
                if stamp and stamp != b"":
                    # BiCif exports carry per-token [start_ms, end_ms]
                    out["timestamp"] = json.loads(stamp.decode())
                self.lib.FunASRFreeResult(ctypes.c_void_p(res))
            results.append(out)
        return results


SenseVoiceSmall = Paraformer  # same surface; engine dispatch is in the lib


class ParaformerOnline(_Handle):
    """Streaming ASR (funasr_onnx ``Paraformer`` online role): feed PCM16
    chunks, collect incremental token strings."""

    def __init__(self, model_dir: str, **kwargs):
        super().__init__(model_dir, **kwargs)
        self.stream = self.lib.FunASRStreamCreate(self.handle)
        if not self.stream:
            raise RuntimeError("streaming engine unavailable (weights.ftr "
                               "missing streaming meta?)")

    def __call__(self, pcm_chunk: bytes, is_final: bool = False,
                 fs: int = 16000) -> List[dict]:
        res = self.lib.FunASRStreamInfer(self.stream, pcm_chunk,
                                         len(pcm_chunk), int(is_final), fs)
        return [{"preds": self._result_text(res)}]

    def __del__(self):
        try:
            if getattr(self, "stream", None):
                self.lib.FunASRStreamFree(ctypes.c_void_p(self.stream))
        except Exception:  # noqa: BLE001
            pass
        super().__del__()


class Fsmn_vad(_Handle):
    """VAD (funasr_onnx ``Fsmn_vad`` role): wav -> [[start_ms, end_ms], ...]."""

    def __call__(self, wav_content: Union[str, bytes], fs: int = 16000,
                 **kwargs) -> List[list]:
        data = _read_audio(wav_content)
        res = self.lib.FunVadInfer(self.handle, data, len(data), fs)
        text = self._result_text(res)
        return [json.loads(text)] if text else [[]]


class Fsmn_vad_online(_Handle):
    """Streaming VAD (funasr_onnx ``Fsmn_vad_online`` role): feed PCM16
    chunks; events are [[beg_ms, -1]] on open and [[-1, end_ms]] on close."""

    def __init__(self, model_dir: str, **kwargs):
        super().__init__(model_dir, **kwargs)
        self.lib.FunVadStreamCreate.restype = ctypes.c_void_p
        self.lib.FunVadStreamCreate.argtypes = [ctypes.c_void_p]
        self.lib.FunVadStreamInfer.restype = ctypes.c_void_p
        self.lib.FunVadStreamInfer.argtypes = [ctypes.c_void_p,
                                               ctypes.c_char_p, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_int]
        self.lib.FunVadStreamFree.argtypes = [ctypes.c_void_p]
        self.stream = self.lib.FunVadStreamCreate(self.handle)
        if not self.stream:
            raise RuntimeError("no vad.ftr in model dir")

    def __call__(self, pcm_chunk: bytes, is_final: bool = False,
                 fs: int = 16000) -> List[list]:
        res = self.lib.FunVadStreamInfer(self.stream, pcm_chunk,
                                         len(pcm_chunk), int(is_final), fs)
        text = self._result_text(res)
        return json.loads(text) if text else []

    def __del__(self):
        try:
            if getattr(self, "stream", None):
                self.lib.FunVadStreamFree(ctypes.c_void_p(self.stream))
        except Exception:  # noqa: BLE001
            pass
        super().__del__()


class CT_Transformer(_Handle):
    """Punctuation (funasr_onnx ``CT_Transformer`` role)."""

    def __call__(self, text: str, **kwargs):
        res = self.lib.FunPuncInfer(self.handle, text.encode())
        return self._result_text(res), None


class CT_Transformer_VadRealtime(_Handle):
    """Streaming punctuation (funasr_onnx ``CT_Transformer_VadRealtime``
    role): a cache carries the sentence tail between calls."""

    def __init__(self, model_dir: str, **kwargs):
        super().__init__(model_dir, **kwargs)
        self.cache = self.lib.FunPuncCacheCreate()

    def __call__(self, text: str, param_dict: Optional[dict] = None, **kwargs):
        res = self.lib.FunPuncInferOnline(self.handle, text.encode(),
                                          ctypes.c_void_p(self.cache))
        return self._result_text(res), None

    def __del__(self):
        try:
            if getattr(self, "cache", None):
                self.lib.FunPuncCacheFree(ctypes.c_void_p(self.cache))
        except Exception:  # noqa: BLE001
            pass
        super().__del__()
