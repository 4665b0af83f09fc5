"""AutoModel, the user-facing pipeline API of the port (counterpart of
``funasr_tpu/auto/auto_model.py``; reference FunASR ``funasr/auto/auto_model.py``).

    model = AutoModel(model="<local model dir>", device="cuda", bf16=True, quant="w8a8")
    results = model.generate(input=[wave, "a.wav", pcm_bytes], batch_size=32)

``build_model`` follows the JAX order: model dir -> tokenizer -> frontend -> model class
-> weights (``init_param``, else drawn from a seeded ``torch.Generator``) -> ``bf16``
cast -> ``quant`` ("int8": weight-only int8; "w8a8": int8 weights and activations, whose
linears run the hand-written kernel of ``ops/w8a8.py`` on CUDA). ``device`` defaults to
"cuda"; "cuda" without a GPU raises, it never falls back to the CPU.

Ported: the main model's ``generate`` without VAD. The VAD / punctuation / speaker
pipeline (slice 2, ROADMAP items 11-12), ITN (slice 9) and ``export`` raise
``NotImplementedError``.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import random
import string
import time
from typing import Any, Dict, List

import torch

from funasr_tpu_torch.download.download_model_from_hub import download_model
from funasr_tpu_torch.register import tables
from funasr_tpu_torch.utils.misc import deep_update

_NOT_PORTED = {
    "vad_model": "the VAD pipeline (slice 2, ROADMAP item 11)",
    "punc_model": "the punctuation model (slice 2, ROADMAP item 11)",
    "spk_model": "the speaker model (slice 2, ROADMAP item 12)",
}


def _rand_key() -> str:
    chars = string.ascii_letters + string.digits
    return "rand_key_" + "".join(random.choice(chars) for _ in range(13))


def prepare_data_iterator(data_in, input_len=None, data_type=None, key=None):
    """Normalize input (path/scp/jsonl/list/bytes/array) to (keys, data) lists
    (reference ``prepare_data_iterator:347`` behavior)."""
    data_list, key_list = [], []
    filelist = (".scp", ".txt", ".json", ".jsonl", ".text")

    if isinstance(data_in, str) and os.path.exists(data_in):
        ext = os.path.splitext(data_in)[1].lower()
        if ext in filelist:
            with open(data_in, encoding="utf-8") as fin:
                for line in fin:
                    k = _rand_key()
                    if data_in.endswith(".jsonl"):
                        obj = json.loads(line.strip())
                        data = obj["source"]
                        k = obj.get("key", k)
                    else:
                        parts = line.strip().split(maxsplit=1)
                        data = parts[1] if len(parts) > 1 else parts[0]
                        k = parts[0] if len(parts) > 1 else k
                    data_list.append(data)
                    key_list.append(k)
        else:
            if isinstance(key, (list, tuple)):
                key = key[0] if key else None
            k = key if key is not None else os.path.splitext(
                os.path.basename(data_in))[0]
            data_list, key_list = [data_in], [k]
    elif isinstance(data_in, (list, tuple)):
        data_list = list(data_in)
        keys = (list(key) if isinstance(key, (list, tuple)) else None)
        for i, d in enumerate(data_list):
            if keys is not None and i < len(keys):
                key_list.append(keys[i])
            elif isinstance(d, str) and os.path.exists(d):
                key_list.append(os.path.splitext(os.path.basename(d))[0])
            else:
                key_list.append(_rand_key())
    else:
        if isinstance(data_in, bytes):
            from funasr_tpu_torch.utils.load_utils import load_bytes
            data_in = load_bytes(data_in)
        if isinstance(key, (list, tuple)):
            key = key[0] if key else None
        key_list = [key if key is not None else _rand_key()]
        data_list = [data_in]
    return key_list, data_list


class AutoModel:
    def __init__(self, **kwargs):
        log_level = getattr(logging, kwargs.get("log_level", "INFO").upper())
        logging.basicConfig(level=log_level)
        for name, what in _NOT_PORTED.items():
            if kwargs.get(name) is not None:
                raise NotImplementedError(f"{name}: {what} is not ported yet")

        model, kwargs = self.build_model(**kwargs)
        self.kwargs = kwargs
        self.model = model
        self.model_path = kwargs.get("model_path")
        self._store_base_configs()

    # ------------------------------------------------------------------

    def _store_base_configs(self):
        self._base_kwargs = copy.deepcopy(
            {k: v for k, v in self.kwargs.items()
             if isinstance(v, (str, int, float, bool, list, dict, type(None)))})

    def _reset_runtime_configs(self):
        snapshot = copy.deepcopy(self._base_kwargs)
        for k in list(self.kwargs):
            if k not in snapshot and isinstance(
                    self.kwargs[k], (str, int, float, bool, list, dict, type(None))):
                del self.kwargs[k]  # runtime-added override from a previous call
        self.kwargs.update(snapshot)

    @staticmethod
    def build_model(**kwargs):
        if "model" not in kwargs:
            raise ValueError("AutoModel needs model=<model dir or hub alias>")
        device = torch.device(kwargs.get("device") or "cuda")
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but torch.cuda.is_available() is false; "
                               "pass device='cpu' to run on the CPU")
        kwargs["device"] = str(device)
        quantization = kwargs.get("quant") or kwargs.get("quantization")
        if "model_conf" not in kwargs:
            kwargs = download_model(**kwargs)

        # tokenizer
        tokenizer = kwargs.get("tokenizer")
        kwargs["vocab_size"] = -1
        if tokenizer is not None and isinstance(tokenizer, str):
            tok_cls = tables.tokenizer_classes[tokenizer]
            tokenizer = tok_cls(**(kwargs.get("tokenizer_conf") or {}))
            vocab = getattr(tokenizer, "token_list", None)
            if vocab:
                kwargs["vocab_size"] = len(vocab)
                kwargs["token_list"] = vocab
            elif hasattr(tokenizer, "get_vocab_size"):
                kwargs["vocab_size"] = tokenizer.get_vocab_size()
        kwargs["tokenizer"] = tokenizer

        # frontend
        frontend = kwargs.get("frontend")
        kwargs["input_size"] = None
        if frontend is not None and isinstance(frontend, str):
            fe_cls = tables.frontend_classes[frontend]
            frontend = fe_cls(**(kwargs.get("frontend_conf") or {}))
            if hasattr(frontend, "output_size"):
                kwargs["input_size"] = frontend.output_size()
        kwargs["frontend"] = frontend

        model_class_name = kwargs["model"]
        model_class = tables.model_classes.get(model_class_name)
        if model_class is None:
            raise RuntimeError(f"model '{model_class_name}' is not ported. Ported: "
                               f"{sorted(tables.model_classes)}")
        model_conf: Dict[str, Any] = {}
        deep_update(model_conf, kwargs.get("model_conf", {}))
        deep_update(model_conf, kwargs)
        init_param = kwargs.get("init_param")
        pretrained = init_param is not None and os.path.exists(init_param)
        # no checkpoint: the seed's weights, drawn on the CPU so every device gets the
        # same ones (the JAX package draws them from jax.random.PRNGKey(seed))
        model_conf["generator"] = (None if pretrained else
                                   torch.Generator().manual_seed(kwargs.get("seed", 0)))
        model = model_class(**model_conf)

        if pretrained:
            from funasr_tpu_torch.utils.load_utils import load_pretrained
            logging.info("loading pretrained params from %s", init_param)
            load_pretrained(model, init_param)

        if kwargs.get("bf16", False) or kwargs.get("fp16", False):
            from funasr_tpu_torch.core.module import cast_floats
            model = cast_floats(model, torch.bfloat16)
        if quantization and quantization not in ("int8", "w8", "w8a8"):
            logging.warning("unknown quant=%r (supported: int8, w8a8); params "
                            "stay unquantized", quantization)
        if quantization in ("int8", "w8"):
            from funasr_tpu_torch.ops.quant import quantize_params_int8
            quantize_params_int8(model)
            logging.info("quantized linear weights to int8 (weight-only)")
        elif quantization == "w8a8":
            from funasr_tpu_torch.ops.quant import quantize_params_int8
            quantize_params_int8(model, mode="w8a8")
            logging.info("quantized linears to W8A8 dynamic int8 serving mode")
        return model.eval(), kwargs

    # ------------------------------------------------------------------

    def generate(self, input, input_len=None, progress_callback=None, **cfg):
        from funasr_tpu_torch.utils.postprocess_hotwords import (
            apply_postprocess_hotwords_to_results)

        results = self.inference(input, input_len=input_len,
                                 progress_callback=progress_callback, **cfg)
        return apply_postprocess_hotwords_to_results(results, cfg)

    def inference(self, input, input_len=None, key=None, progress_callback=None, **cfg):
        """The main model over ``input`` in batches of ``batch_size``; ``cfg`` overrides
        the build kwargs for this call only."""
        self._reset_runtime_configs()
        kwargs = self.kwargs
        deep_update(kwargs, cfg)
        if kwargs.get("itn") and not kwargs.get("use_itn"):
            raise NotImplementedError("itn=True: inverse text normalization (slice 9, "
                                      "ROADMAP item 23) is not ported yet")
        model = self.model

        batch_size = kwargs.get("batch_size", 1)
        key_list, data_list = prepare_data_iterator(
            input, input_len=input_len, data_type=kwargs.get("data_type"), key=key)

        results_all: List[dict] = []
        speed_stats: Dict[str, Any] = {}
        n = len(data_list)
        time_speech, time_escape = 1e-9, 0.0
        # double-buffered batch loop (auto_model.py:317-357): batch k + 1 is loaded,
        # featurized and launched before batch k's results are fetched, so the host
        # work of one overlaps the device work of the other. Launches are
        # asynchronous, so one stream suffices.
        dispatch = getattr(model, "inference_dispatch", None)
        pipelined = dispatch is not None and n > batch_size

        def _finish(res, t1, end):
            nonlocal time_speech, time_escape
            results, meta = (res if isinstance(res, tuple) else (res, {}))
            t2 = time.perf_counter()
            results_all.extend(results)
            bdt = meta.get("batch_data_time", -1)
            speed_stats.update(load_data=meta.get("load_data", 0.0),
                               extract_feat=meta.get("extract_feat", 0.0),
                               forward=f"{t2 - t1:0.3f}", batch_size=len(results),
                               rtf=f"{(t2 - t1) / bdt:0.3f}" if bdt and bdt > 0 else "-")
            if progress_callback:
                progress_callback(end, n)
            if bdt and bdt > 0:
                time_speech += bdt
            time_escape += t2 - t1

        pending = None  # (handle, t1, end) of the in-flight batch
        for beg in range(0, n, batch_size):
            end = min(n, beg + batch_size)
            batch = {"data_in": data_list[beg:end], "key": key_list[beg:end]}
            t1 = time.perf_counter()
            if pipelined:
                handle = dispatch(**batch, **_strip(kwargs))
                if pending is not None:
                    _finish(model.inference_fetch(pending[0]), pending[1], pending[2])
                pending = (handle, t1, end)
            else:
                _finish(model.inference(**batch, **_strip(kwargs)), t1, end)
        if pending is not None:
            _finish(model.inference_fetch(pending[0]), pending[1], pending[2])
        logging.debug("speed_stats: %s rtf_avg=%.3f", speed_stats,
                      time_escape / time_speech)
        return results_all

    def export(self, input=None, **cfg):
        raise NotImplementedError("export is not ported yet (slice 5 with the serving "
                                  "binaries, ROADMAP item 17)")


def _strip(kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """Drop orchestration-only keys before forwarding to model.inference."""
    # "key" is carried per-batch (already in ``batch``); a user-level key list
    # merged into kwargs via deep_update would collide with it
    drop = {"model", "model_conf", "init_param", "vad_model", "vad_kwargs",
            "punc_model", "punc_kwargs", "spk_model", "spk_kwargs", "model_path",
            "key"}
    return {k: v for k, v in kwargs.items() if k not in drop}
