"""Model resolution: alias -> hub id -> snapshot download -> merged config kwargs.

Counterpart of FunASR ``funasr/download/download_model_from_hub.py:9-160``
(``download_from_ms:44`` / ``download_from_hf:122``): aliases resolve through a local
cache (``FUNASR_TPU_CACHE`` or ``~/.cache/funasr_tpu`` / modelscope cache layouts); on
a cache miss the snapshot is downloaded from ModelScope or HuggingFace via stdlib
urllib (no modelscope/huggingface_hub dependency), falling back gracefully to a clear
offline error. ``FUNASR_TPU_OFFLINE=1`` disables network entirely. A local directory
containing ``config.yaml`` is always accepted directly.

Framework-free copy of ``funasr_tpu/download/download_model_from_hub.py`` (the network
branch as it is), held to the original by ``tests/test_torch_auto_model.py``.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict

import yaml

from funasr_tpu_torch.download.name_maps_from_hub import name_maps_hf, name_maps_ms
from funasr_tpu_torch.utils.misc import deep_update

_FILE_KEYS = (
    "cmvn_file", "seg_dict_file", "seg_dict", "bpemodel", "token_list",
    "jieba_usr_dict", "init_param", "tokenizer_conf.token_list",
)


def _candidate_cache_dirs(model_id: str):
    for env in ("FUNASR_TPU_CACHE", "MODELSCOPE_CACHE"):
        base = os.environ.get(env)
        if base:
            yield os.path.join(base, model_id)
            yield os.path.join(base, "hub", model_id)
    home = os.path.expanduser("~")
    yield os.path.join(home, ".cache", "funasr_tpu", model_id)
    yield os.path.join(home, ".cache", "modelscope", "hub", model_id)


def _http_get(url: str, timeout: int = 60) -> bytes:
    import urllib.request
    req = urllib.request.Request(url, headers={"User-Agent": "funasr-tpu"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read()


def _list_ms_files(model_id: str):
    """ModelScope repo file listing (reference ``download_from_ms:44`` role)."""
    import json
    url = (f"https://modelscope.cn/api/v1/models/{model_id}/repo/files"
           f"?Recursive=true")
    data = json.loads(_http_get(url))
    files = data.get("Data", {}).get("Files", [])
    return [(f["Path"],
             f"https://modelscope.cn/api/v1/models/{model_id}/repo?"
             f"FilePath={f['Path']}")
            for f in files if f.get("Type") != "tree"]


def _list_hf_files(model_id: str):
    """HuggingFace repo file listing (reference ``download_from_hf:122`` role)."""
    import json
    data = json.loads(_http_get(f"https://huggingface.co/api/models/{model_id}"))
    return [(s["rfilename"],
             f"https://huggingface.co/{model_id}/resolve/main/{s['rfilename']}")
            for s in data.get("siblings", [])]


def snapshot_download(model_id: str, hub: str = "ms",
                      cache_dir: str = None) -> str:
    """Download every repo file into the cache; atomic via a .partial dir."""
    import shutil
    cache_dir = cache_dir or os.environ.get("FUNASR_TPU_CACHE") or os.path.join(
        os.path.expanduser("~"), ".cache", "funasr_tpu")
    target = os.path.join(cache_dir, model_id)
    partial = target + ".partial"
    files = _list_hf_files(model_id) if hub == "hf" else _list_ms_files(model_id)
    if not files:
        raise FileNotFoundError(f"hub '{hub}' lists no files for {model_id}")
    os.makedirs(partial, exist_ok=True)
    for rel, url in files:
        dst = os.path.join(partial, rel)
        os.makedirs(os.path.dirname(dst) or partial, exist_ok=True)
        logging.info("downloading %s", rel)
        with open(dst, "wb") as f:
            f.write(_http_get(url, timeout=600))
    if os.path.isdir(target):
        shutil.rmtree(target)
    os.replace(partial, target)
    return target


def resolve_model_dir(model: str, hub: str = "ms") -> str:
    if os.path.isdir(model) and os.path.exists(os.path.join(model, "config.yaml")):
        return model
    name_map = name_maps_hf if hub == "hf" else name_maps_ms
    model_id = name_map.get(model, name_map.get(model.lower(), model))
    for cand in _candidate_cache_dirs(model_id):
        if os.path.isdir(cand) and os.path.exists(os.path.join(cand, "config.yaml")):
            return cand
    offline = os.environ.get("FUNASR_TPU_OFFLINE", "").lower() in ("1", "true")
    net_err = "network download disabled (FUNASR_TPU_OFFLINE)"
    if not offline and "/" in model_id:
        try:
            snap = snapshot_download(model_id, hub=hub)
            if os.path.exists(os.path.join(snap, "config.yaml")):
                return snap
            net_err = f"snapshot at {snap} has no config.yaml"
        except Exception as e:  # URLError/timeout/API shape — degrade offline
            net_err = f"hub download failed: {e}"
            logging.warning("%s", net_err)
    raise FileNotFoundError(
        f"model '{model}' (id '{model_id}') not found locally ({net_err}); place "
        f"the snapshot (config.yaml + model.pt + assets) under "
        f"$FUNASR_TPU_CACHE/{model_id} or pass a local directory path")


def _rewrite_paths(cfg: Dict[str, Any], model_dir: str):
    """Make file-valued config entries absolute against the model dir."""
    def fix(d: Dict[str, Any]):
        for k, v in list(d.items()):
            if isinstance(v, dict):
                fix(v)
            elif isinstance(v, str) and not os.path.isabs(v):
                if k in ("cmvn_file", "seg_dict_file", "seg_dict", "bpemodel",
                         "token_list", "jieba_usr_dict", "stats_file"):
                    cand = os.path.join(model_dir, v)
                    if os.path.exists(cand):
                        d[k] = cand
    fix(cfg)


def download_model(**kwargs) -> Dict[str, Any]:
    """Resolve ``kwargs['model']`` and merge its config.yaml under the user kwargs."""
    model = kwargs.get("model")
    assert model is not None, "model is required"
    model_dir = resolve_model_dir(model, hub=kwargs.get("hub", "ms"))
    with open(os.path.join(model_dir, "config.yaml"), "r", encoding="utf-8") as f:
        cfg = yaml.safe_load(f) or {}
    _rewrite_paths(cfg, model_dir)
    merged: Dict[str, Any] = {}
    deep_update(merged, cfg)
    deep_update(merged, kwargs)  # user overrides win
    merged["model_path"] = model_dir
    if "model" in cfg:
        merged["model"] = cfg["model"]  # config names the model CLASS
    if "init_param" not in merged:
        for name in ("model.pt", "model.pb", "model.safetensors"):
            cand = os.path.join(model_dir, name)
            if os.path.exists(cand):
                merged["init_param"] = cand
                break
    logging.info("resolved model %s -> %s", model, model_dir)
    return merged
