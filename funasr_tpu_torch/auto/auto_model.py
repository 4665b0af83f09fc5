"""AutoModel, the user-facing pipeline API of the port (counterpart of
``funasr_tpu/auto/auto_model.py``; reference FunASR ``funasr/auto/auto_model.py``).

    model = AutoModel(model="<asr dir>", vad_model="<vad dir>", punc_model="<punc dir>",
                      device="cuda")
    results = model.generate(input=[wave, "a.wav", pcm_bytes], batch_size_s=300)

``build_model`` follows the JAX order: model dir -> tokenizer -> frontend -> model class
-> weights (``init_param``, else drawn from a seeded ``torch.Generator``) -> ``bf16``
cast -> ``quant`` ("int8": weight-only int8; "w8a8": int8 weights and activations, whose
linears run the hand-written kernel of ``ops/w8a8.py`` on CUDA). ``device`` defaults to
"cuda"; "cuda" without a GPU raises, it never falls back to the CPU. ``vad_model`` and
``punc_model`` are built the same way from their own kwargs (``vad_kwargs``,
``punc_kwargs``) on the main model's device; ``bf16`` / ``quant`` apply to them only when
their own kwargs carry them.

``spk_model`` (CAM++) is built the same way from ``spk_kwargs``, with a
``ClusterBackend(**spk_kwargs["cb_kwargs"])`` and ``spk_mode`` ("punc_segment" by default).

``generate`` without a VAD runs the main model over the inputs, then the punctuation
model over each text; with a VAD it runs ``inference_with_vad``: VAD segments -> length
sorted ``batch_size_s`` batches of segments -> ASR (and, with a speaker model, CAM++ over
each segment's 1.5 s chunks at ``spk_kwargs["batch_size"]``, default 1) -> texts joined
(timestamps offset by their segment's start) -> punctuation -> with a speaker model the
chunk embeddings clustered (``preset_spk_num`` speakers, else found), the speaker turns
distributed over the sentences into ``sentence_info`` (``spk``, ``start``, ``end``,
``text``), else ``sentence_info`` when ``sentence_timestamp``. ``itn=True`` (without the
model's own ``use_itn``) rewrites every text that ``inference`` returns through
``text/inverse_normalize.py`` in ``language``'s grammar (zh by default): the VAD
pipeline's segments and the punctuated text too. ``export`` writes ``torch.export``
programs, one per (batch, frames) bucket (``bin/export.py``), that
``export_runtime.py::ExportedModel`` runs without the model code.

``inference`` keeps each batch's speed stats (load and feature seconds, ``forward``:
that batch's own dispatch plus its own fetch, ``rtf``) of its last call in
``self.batch_stats``.

``generate`` keeps each call's configuration in ``self.kwargs`` (reset and rewritten by
every call, the streaming ``cache`` included), as the JAX package does; the port's servers
call one ``AutoModel`` from several executor threads, so ``generate``, ``inference`` and
``inference_with_vad`` run under one re-entrant lock per ``AutoModel``: calls from
different threads take turns, and each gives what it gives alone.
"""

from __future__ import annotations

import copy
import functools
import json
import logging
import os
import random
import re
import string
import threading
import time
from typing import Any, Dict, List

import numpy as np
import torch

from funasr_tpu_torch.download.download_model_from_hub import download_model
from funasr_tpu_torch.register import tables
from funasr_tpu_torch.utils.misc import deep_update
from funasr_tpu_torch.utils.vad_utils import merge_vad, slice_padding_audio_samples

def _join_vad_texts(texts) -> str:
    """Strip rich tags and join per-VAD-segment texts, inserting a space only when the
    join boundary is not CJK-to-CJK (reference ``funasr/auto/auto_model.py:56-68``).
    This surface feeds the punctuation model and sentence segmentation."""
    cleaned = [re.sub(r"<\|[^|]*\|>", "", str(t)).strip() for t in texts]
    cleaned = [t for t in cleaned if t]
    if not cleaned:
        return ""
    joined = cleaned[0]
    for text in cleaned[1:]:
        sep = "" if ("㐀" <= joined[-1] <= "鿿"
                     and "㐀" <= text[0] <= "鿿") else " "
        joined += sep + text
    return joined


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


def _serialized(method):
    """Run ``method`` under the instance's lock (see the module docstring)."""
    @functools.wraps(method)
    def locked(self, *args, **kwargs):
        with self._lock:
            return method(self, *args, **kwargs)
    return locked


class AutoModel:
    def __init__(self, **kwargs):
        self._lock = threading.RLock()
        log_level = getattr(logging, kwargs.get("log_level", "INFO").upper())
        logging.basicConfig(level=log_level)

        model, kwargs = self.build_model(**kwargs)
        self.vad_model, self.vad_kwargs = self._build_sub_model(kwargs, "vad")
        self.punc_model, self.punc_kwargs = self._build_sub_model(kwargs, "punc")
        self.spk_model, self.spk_kwargs = self._build_sub_model(kwargs, "spk")
        if self.spk_model is not None:
            from funasr_tpu_torch.models.campplus.cluster_backend import ClusterBackend
            self.cb_model = ClusterBackend(**(self.spk_kwargs.get("cb_kwargs") or {}))
            self.spk_mode = kwargs.get("spk_mode", "punc_segment")
        self.kwargs = kwargs
        self.model = model
        self.model_path = kwargs.get("model_path")
        self._store_base_configs()

    def _build_sub_model(self, kwargs, name: str):
        """(``{name}_model`` built from ``{name}_kwargs`` on the main model's device, its
        kwargs), or (None, ``{name}_kwargs``) when no such model is asked for."""
        sub_kwargs = dict(kwargs.get(f"{name}_kwargs") or {})
        if kwargs.get(f"{name}_model") is None:
            return None, sub_kwargs
        sub_kwargs.update(model=kwargs[f"{name}_model"], device=kwargs["device"])
        if "hub" in kwargs:
            sub_kwargs.setdefault("hub", kwargs["hub"])
        return self.build_model(**sub_kwargs)

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
            # a frontend that computes on a device (S3PRL, fused) takes the model's
            frontend = fe_cls(**dict(kwargs.get("frontend_conf") or {}, device=kwargs["device"]))
            if hasattr(frontend, "output_size"):
                kwargs["input_size"] = frontend.output_size()
        kwargs["frontend"] = frontend

        model_class_name = kwargs["model"]
        model_class = tables.model_classes.get(model_class_name)
        if model_class is None:
            raise RuntimeError(f"model '{model_class_name}' is not ported. "
                               f"Ported: {sorted(tables.model_classes)}")
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
            load_pretrained(model, init_param, model_class_name)

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

    @_serialized
    def generate(self, input, input_len=None, progress_callback=None, **cfg):
        from funasr_tpu_torch.utils.postprocess_hotwords import (
            apply_postprocess_hotwords_to_results)

        self._reset_runtime_configs()
        if self.vad_model is not None:
            results = self.inference_with_vad(input, input_len=input_len,
                                              progress_callback=progress_callback, **cfg)
            return apply_postprocess_hotwords_to_results(results, cfg)
        results = self.inference(input, input_len=input_len,
                                 progress_callback=progress_callback, **cfg)
        if self.punc_model is not None:
            deep_update(self.punc_kwargs, cfg)
            for result in results:
                punc_res = self.inference(result["text"], model=self.punc_model,
                                          kwargs=self.punc_kwargs, **cfg)
                if cfg.get("return_raw_text", self.kwargs.get("return_raw_text", False)):
                    result["raw_text"] = copy.copy(result["text"])
                result["text"] = punc_res[0]["text"]
        return apply_postprocess_hotwords_to_results(results, cfg)

    @_serialized
    def inference(self, input, input_len=None, model=None, kwargs=None, key=None,
                  progress_callback=None, **cfg):
        """``model`` (the main model unless given) over ``input`` in batches of
        ``batch_size``; ``kwargs`` are that model's build kwargs (the main model's unless
        given), ``cfg`` overrides them for this call."""
        if kwargs is None:
            self._reset_runtime_configs()
        kwargs = self.kwargs if kwargs is None else kwargs
        kwargs.pop("cache", None)
        deep_update(kwargs, cfg)
        model = self.model if model is None else model

        batch_size = kwargs.get("batch_size", 1)
        key_list, data_list = prepare_data_iterator(
            input, input_len=input_len, data_type=kwargs.get("data_type"), key=key)

        results_all: List[dict] = []
        self.batch_stats: List[Dict[str, Any]] = []
        n = len(data_list)
        time_speech, time_escape = 1e-9, 0.0
        # double-buffered batch loop (auto_model.py:317-357): batch k + 1 is loaded,
        # featurized and launched before batch k's results are fetched, so the host
        # work of one overlaps the device work of the other. Launches are
        # asynchronous, so one stream suffices. A batch's ``forward`` time is its own
        # dispatch plus its own fetch: the dispatch of batch k + 1, which runs between
        # them, is not counted in batch k's (the JAX package times batch k from its
        # dispatch to its fetch, ``auto_model.py:329-345``).
        dispatch = dispatch_pair(model)
        pipelined = dispatch is not None and n > batch_size

        def _finish(res, forward_s, end):
            nonlocal time_speech, time_escape
            results, meta = (res if isinstance(res, tuple) else (res, {}))
            results_all.extend(results)
            bdt = meta.get("batch_data_time", -1)
            self.batch_stats.append(dict(
                load_data=meta.get("load_data", 0.0), extract_feat=meta.get("extract_feat", 0.0),
                forward=f"{forward_s:0.3f}", batch_size=len(results),
                rtf=f"{forward_s / bdt:0.3f}" if bdt and bdt > 0 else "-"))
            if progress_callback:
                progress_callback(end, n)
            if bdt and bdt > 0:
                time_speech += bdt
            time_escape += forward_s

        def _fetch(pending):
            handle, dispatch_s, end = pending
            t0 = time.perf_counter()
            res = dispatch[1](handle)
            _finish(res, dispatch_s + time.perf_counter() - t0, end)

        pending = None  # (handle, dispatch seconds, end) of the in-flight batch
        for beg in range(0, n, batch_size):
            end = min(n, beg + batch_size)
            batch = {"data_in": data_list[beg:end], "key": key_list[beg:end]}
            t1 = time.perf_counter()
            if pipelined:
                handle = dispatch[0](**batch, **_strip(kwargs))
                dispatched = (handle, time.perf_counter() - t1, end)
                if pending is not None:
                    _fetch(pending)
                pending = dispatched
            else:
                res = model.inference(**batch, **_strip(kwargs))
                _finish(res, time.perf_counter() - t1, end)
        if pending is not None:
            _fetch(pending)
        logging.debug("speed_stats: %s rtf_avg=%.3f", self.batch_stats[-1:],
                      time_escape / time_speech)
        if kwargs.get("itn") and not kwargs.get("use_itn"):
            apply_itn(results_all, kwargs.get("language", "zh"))
        return results_all

    # ------------------------------------------------------------------

    @_serialized
    def inference_with_vad(self, input, input_len=None, **cfg):
        """VAD -> per-segment ASR in length-sorted ``batch_size_s`` batches (+ CAM++ over
        each segment's chunks) -> merged text and timestamps -> punctuation -> speaker
        clustering and sentence assembly (``auto_model.py:378-538``)."""
        from funasr_tpu_torch.utils.load_utils import load_audio

        self._reset_runtime_configs()
        kwargs = self.kwargs

        # step 1: VAD, one input a call: the VAD takes batch 1, and a caller's batch_size
        # (the HTTP batcher's, the group's size) is the ASR's. The JAX package hands it
        # on, and its VAD's batch-1 assertion fails (ROADMAP section 3).
        deep_update(self.vad_kwargs, cfg)
        res = self.inference(input, input_len=input_len, model=self.vad_model,
                             kwargs=self.vad_kwargs, **dict(cfg, batch_size=1))
        if cfg.get("merge_vad", False):
            for r in res:
                r["value"] = merge_vad(r["value"], kwargs.get("merge_length_s", 15) * 1000)

        # step 2: per-segment ASR with batch_size_s dynamic batching
        deep_update(kwargs, cfg)
        batch_size = max(int(kwargs.get("batch_size_s", 300)) * 1000, 1)
        batch_threshold_ms = int(kwargs.get("batch_size_threshold_s", 60)) * 1000
        kwargs["batch_size"] = batch_size

        key_list, data_list = prepare_data_iterator(
            input, input_len=input_len, data_type=kwargs.get("data_type"))

        results_ret = []
        for i, r in enumerate(res):
            key = r["key"]
            vadsegments = r["value"]
            fs = kwargs["frontend"].fs if hasattr(kwargs.get("frontend"), "fs") else 16000
            speech = load_audio(data_list[i], fs=fs, audio_fs=kwargs.get("fs", 16000))
            speech_length = len(speech)
            n = len(vadsegments)
            sorted_data = sorted([(seg, idx) for idx, seg in enumerate(vadsegments)],
                                 key=lambda x: x[0][1] - x[0][0])
            if not sorted_data:
                results_ret.append({"key": key, "text": "", "timestamp": []})
                continue
            batch_ms = max(batch_size, sorted_data[0][0][1] - sorted_data[0][0][0])

            results_sorted: List[dict] = []
            all_segments: List = []
            beg_idx, end_idx, max_len = 0, 1, 0
            for j in range(n):
                sample_len = sorted_data[j][0][1] - sorted_data[j][0][0]
                potential = max(max_len, sample_len) * (j + 1 - beg_idx)
                if (j < n - 1 and sample_len < batch_threshold_ms
                        and potential < batch_ms):
                    max_len = max(max_len, sample_len)
                    end_idx += 1
                    continue
                speech_j, _ = slice_padding_audio_samples(
                    speech, speech_length, sorted_data[beg_idx:end_idx])
                results = self.inference(speech_j, input_len=None, model=self.model,
                                         kwargs=kwargs, **cfg)
                if self.spk_model is not None:
                    all_segments.extend(self._speaker_embeddings(
                        speech_j, sorted_data[beg_idx:end_idx], results, cfg))
                results_sorted.extend(results)
                beg_idx, end_idx = end_idx, end_idx + 1
                max_len = sample_len

            if len(results_sorted) != n:
                results_ret.append({"key": key, "text": "", "timestamp": []})
                continue
            restored = [None] * n
            for j in range(n):
                restored[sorted_data[j][1]] = results_sorted[j]

            # merge texts / offset timestamps (reference :992-1038)
            result: Dict[str, Any] = {}
            for j in range(n):
                for k, v in restored[j].items():
                    if k.startswith("timestamp"):
                        result.setdefault(k, [])
                        for t in v:
                            t[0] = int(t[0]) + int(vadsegments[j][0])
                            t[1] = int(t[1]) + int(vadsegments[j][0])
                        result[k].extend(v)
                    elif k == "spk_embedding":
                        result[k] = (v if k not in result
                                     else np.concatenate([result[k], v], 0))
                    elif "text" in k:
                        result[k] = v if k not in result else result[k] + " " + v
                    else:
                        result[k] = v if k not in result else result[k] + v

            if not result.get("text", "").strip():
                # still one row per input key, so output aligns with inputs
                result.pop("spk_embedding", None)
                result["key"] = key
                result.setdefault("text", "")
                results_ret.append(result)
                continue
            return_raw_text = kwargs.get("return_raw_text", False)

            # step 3: punctuation over the _join_vad_texts surface (no space at CJK
            # segment joins), as the reference pipeline does (:1063-1082)
            punc_array = None
            punc_input_text = _join_vad_texts(restored[j].get("text", "") for j in range(n))
            if self.punc_model is not None:
                deep_update(self.punc_kwargs, cfg)
                raw_text = copy.copy(result["text"])
                punc_res = self.inference(punc_input_text, model=self.punc_model,
                                          kwargs=self.punc_kwargs, **cfg)
                if return_raw_text:
                    result["raw_text"] = raw_text
                result["text"] = punc_res[0]["text"]
                punc_array = punc_res[0].get("punc_array")

            # step 4: speaker clustering + sentence assembly (:502-533)
            if (self.spk_model is not None and kwargs.get("return_spk_res", True)
                    and "spk_embedding" in result):
                result["sentence_info"] = self._speaker_sentences(
                    result, all_segments, punc_array, punc_input_text, return_raw_text,
                    kwargs.get("preset_spk_num"))
            elif kwargs.get("sentence_timestamp", False) and punc_array is not None:
                from funasr_tpu_torch.utils.timestamp_tools import timestamp_sentence
                result["sentence_info"] = timestamp_sentence(
                    punc_array, result.get("timestamp", []),
                    punc_input_text or result["text"], return_raw_text=return_raw_text)
            result.pop("spk_embedding", None)

            result["key"] = key
            results_ret.append(result)

        return results_ret

    def _speaker_embeddings(self, speech_j, segments, results, cfg):
        """CAM++ over each ASR segment's 1.5 s / 0.75 s chunks (``sv_chunk``) in batches
        of ``spk_kwargs["batch_size"]`` (default 1), the embeddings stored on that
        segment's result (``auto_model.py:431-444``). Returns the chunks
        ([start s, end s, samples])."""
        from funasr_tpu_torch.models.campplus.utils import sv_chunk

        chunks = []
        for b, wav in enumerate(speech_j):
            seg = segments[b][0]
            seg_chunks = sv_chunk([[seg[0] / 1000.0, seg[1] / 1000.0, np.asarray(wav)]])
            chunks.extend(seg_chunks)
            spk_res = self.inference([c[2] for c in seg_chunks], input_len=None,
                                     model=self.spk_model, kwargs=self.spk_kwargs, **cfg)
            results[b]["spk_embedding"] = np.concatenate(
                [np.asarray(r["spk_embedding"]) for r in spk_res], 0)
        return chunks

    def _speaker_sentences(self, result, all_segments, punc_array, punc_input_text,
                           return_raw_text, preset_spk_num):
        """Cluster the chunk embeddings, merge the chunk labels into speaker turns and
        give each sentence the speaker it overlaps most (``auto_model.py:503-526``): the
        punctuation's sentences under ``spk_mode="punc_segment"``, else the whole text as
        one sentence."""
        from funasr_tpu_torch.models.campplus.utils import distribute_spk
        from funasr_tpu_torch.models.campplus.utils import postprocess as spk_postprocess
        from funasr_tpu_torch.utils.timestamp_tools import timestamp_sentence

        all_segments = sorted(all_segments, key=lambda x: x[0])
        embeddings = np.asarray(result["spk_embedding"])
        labels = self.cb_model(embeddings, oracle_num=preset_spk_num)
        sv_output = spk_postprocess(all_segments, None, labels, embeddings)
        timestamp = result.get("timestamp", [])
        if self.spk_mode == "punc_segment" and punc_array is not None:
            sentence_list = timestamp_sentence(punc_array, timestamp, punc_input_text,
                                               return_raw_text=return_raw_text)
        else:
            sentence_list = [dict(text=result["text"],
                                  start=timestamp[0][0] if timestamp else 0,
                                  end=timestamp[-1][1] if timestamp else 0,
                                  timestamp=timestamp)]
        distribute_spk(sentence_list, sv_output)
        return sentence_list

    def export(self, input=None, **cfg):
        """Write ``torch.export`` programs of the main model, one per (batch, frames)
        bucket (``buckets``, default ``[(4, 168)]``), its weights once, a manifest and the
        model dir's sidecars to ``output_dir`` (default "exported"), on the model's
        device (``bin/export.py``; ``auto_model.py:540-547``). Returns the manifest's
        functions."""
        from funasr_tpu_torch.bin.export import copy_sidecars, export_model

        output_dir = cfg.get("output_dir", "exported")
        functions = export_model(self.model, output_dir, cfg.get("buckets", [(4, 168)]))
        copy_sidecars(self.model_path, output_dir)
        return functions


def apply_itn(results, language):
    """Inverse text normalization of each result's text in place, on the host
    (``auto_model.py:360-373``): any model's text, in ``language``'s first two letters
    (default zh); a language the normalizer rejects leaves the text as it is."""
    from funasr_tpu_torch.text.inverse_normalize import InverseNormalizer

    try:
        inv = InverseNormalizer(lang=str(language or "zh").lower()[:2])
    except ValueError:
        return
    for r in results:
        if isinstance(r.get("text"), str):
            r["text"] = inv.inverse_normalize(r["text"])


def dispatch_pair(model):
    """(``inference_dispatch``, ``inference_fetch``) of ``model`` when the class that
    defines its ``inference`` also defines both, else None. A subclass that overrides
    ``inference`` without its own pair then runs its ``inference``: the JAX package takes
    the inherited pair whenever it exists (``auto_model.py:323-324``) and so loses the
    subclass's results (ROADMAP section 3). ``BiCifParaformer`` keeps Paraformer's
    ``inference`` and pair, whose hooks it overrides, so its timestamps survive; so do
    ``SeacoParaformer`` and ``ContextualParaformer`` (their hook ``decode_context``
    carries the call's hotwords), so their bias survives."""
    owner = next((c for c in type(model).__mro__ if "inference" in vars(c)), None)
    if owner is None or not all(f in vars(owner) for f in ("inference_dispatch",
                                                             "inference_fetch")):
        return None
    return model.inference_dispatch, model.inference_fetch


def _strip(kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """Drop orchestration-only keys before forwarding to model.inference."""
    # "key" is carried per-batch (already in ``batch``); a user-level key list
    # merged into kwargs via deep_update would collide with it
    drop = {"model", "model_conf", "init_param", "vad_model", "vad_kwargs",
            "punc_model", "punc_kwargs", "spk_model", "spk_kwargs", "model_path",
            "key"}
    return {k: v for k, v in kwargs.items() if k not in drop}
