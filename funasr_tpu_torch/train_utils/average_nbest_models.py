"""N-best checkpoint averaging (counterpart of
``funasr_tpu/train_utils/average_nbest_models.py``; FunASR
``funasr/train_utils/average_nbest_models.py:61``) over the trainer's ``torch.save``
checkpoints."""

from __future__ import annotations

import logging
import os
from typing import List, Optional

import torch


def average_checkpoints(output_dir: str, avg_nbest_model: int = 5,
                        ckpt_paths: Optional[List[str]] = None,
                        out_name: str = "model.pt.avg",
                        avg_keep_nbest_models_type: str = "acc") -> str:
    """Average the state dicts of the ``avg_nbest_model`` best checkpoints in
    ``output_dir`` (by their recorded validation metric, as the trainer's pruning ranks
    them: highest first where the checkpoint's ``metric_name`` is an accuracy, lowest
    first for a loss; a checkpoint without the name is taken to hold
    ``avg_keep_nbest_models_type``) and write ``{"state_dict": <average>,
    "averaged_from": [...]}`` to ``out_name``. Floating-point tensors are summed in
    float64 and cast back to their dtype; others are taken from the first. Returns the
    output path. The checkpoints are memory-mapped, so the optimizer state they also hold
    is never read. (The JAX package ranks lowest first whatever the metric, which for
    accuracy picks the worst checkpoints: ROADMAP section 3.)"""
    from funasr_tpu_torch.train_utils.trainer import higher_is_better
    if ckpt_paths is None:
        cands = []
        for name in os.listdir(output_dir):
            if not name.startswith("model.pt.ep"):
                continue
            path = os.path.join(output_dir, name)
            state = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
            metric = state.get("metric")
            if metric is not None:
                best_high = higher_is_better(state.get("metric_name")
                                             or avg_keep_nbest_models_type)
                cands.append((-metric if best_high else metric, path))
        cands.sort(key=lambda x: x[0])
        ckpt_paths = [p for _, p in cands[:avg_nbest_model]]
    if not ckpt_paths:
        raise FileNotFoundError(f"no rankable checkpoints in {output_dir}")
    avg, first = None, None
    for path in ckpt_paths:
        sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)["state_dict"]
        if avg is None:
            first = sd
            avg = {k: v.double() for k, v in sd.items() if v.is_floating_point()}
        else:
            for k in avg:
                avg[k] += sd[k].double()
    n = len(ckpt_paths)
    out_sd = {k: (avg[k] / n).to(v.dtype) if k in avg else v for k, v in first.items()}
    out = os.path.join(output_dir, out_name)
    torch.save({"state_dict": out_sd, "averaged_from": ckpt_paths}, out)
    logging.info("averaged %d checkpoints -> %s", n, out)
    return out
