"""Training CLI of the port (counterpart of ``funasr_tpu/bin/train.py``; FunASR
``funasr/bin/train.py``), hydra-style ``++key=value`` overrides without hydra.

Usage (``funasr-tpu-torch-train`` is the console script of this module):
    python -m funasr_tpu_torch.bin.train ++model=<model dir> \\
        ++train_data_set_list=train.jsonl ++valid_data_set_list=val.jsonl \\
        ++dataset_conf.batch_size=6000 ++dataset_conf.batch_type=token \\
        ++optim_conf.lr=0.0002 ++train_conf.max_epoch=50 ++output_dir=exp1 [++device=cpu]

SenseVoice-Small's recipe adds ``++dataset=SenseVoiceDataset`` (or a ``dataset`` key in the
model dir's config.yaml) over the jsonl of ``bin/data_tools sensevoice2jsonl``; every ported
ASR model but the LLM family trains this way. The streaming Paraformer's recipe
(``paraformer_streaming/finetune.sh``) is Paraformer's flags on a ``ParaformerStreaming``
dir whose ``encoder_conf`` holds the training chunk keys (``chunk_size``, ``stride``,
``pad_left``, the look-back factors): each step draws one chunk config and trains under
its overlap-chunk masks, and the averaged checkpoint streams through ``AutoModel``'s
``generate(cache=..., chunk_size=[0, 10, 5])``.

The model is built as ``AutoModel`` builds it (the dir's config.yaml, tokenizer,
frontend, ``model.pt`` as the starting weights, else seeded ones), on ``++device``
(cuda by default; cuda without a GPU raises), in fp32. The output dir gets the model
dir's ``config.yaml`` (file paths made absolute), the trainer's checkpoints and
``train.log.jsonl``, and with ``++train_conf.avg_nbest_model=n`` ``model.pt.avg``:
``AutoModel(model=<output dir>, init_param=<output dir>/model.pt.avg)`` decodes with it.
"""

from __future__ import annotations

import logging
import os
import sys

import yaml

from funasr_tpu_torch.bin._overrides import parse_overrides


def write_output_config(model_path: str, output_dir: str) -> str:
    """The model dir's config.yaml into ``output_dir``, file paths made absolute, so
    that ``AutoModel(model=output_dir)`` builds the same model."""
    from funasr_tpu_torch.download.download_model_from_hub import _rewrite_paths
    with open(os.path.join(model_path, "config.yaml"), encoding="utf-8") as f:
        cfg = yaml.safe_load(f) or {}
    _rewrite_paths(cfg, model_path)
    out = os.path.join(output_dir, "config.yaml")
    if os.path.abspath(out) != os.path.abspath(os.path.join(model_path, "config.yaml")):
        with open(out, "w", encoding="utf-8") as f:
            yaml.safe_dump(cfg, f, allow_unicode=True)
    return out


def main(**kwargs):
    from funasr_tpu_torch.auto.auto_model import AutoModel
    from funasr_tpu_torch.optimizers import build_optimizer
    from funasr_tpu_torch.register import tables
    from funasr_tpu_torch.schedulers import build_scheduler
    from funasr_tpu_torch.train_utils.average_nbest_models import average_checkpoints
    from funasr_tpu_torch.train_utils.trainer import Trainer

    if kwargs.pop("distributed", False):
        raise SystemExit("++distributed=true: the port trains on one device; DDP / FSDP is "
                         "ROADMAP item 21")
    if kwargs.get("bf16") or kwargs.get("fp16") or kwargs.get("quant"):
        raise NotImplementedError("the port trains in fp32; bf16 training (its backward "
                                  "kernels) is ROADMAP item 20b, quantization is inference's")
    kwargs.setdefault("device", "cuda")
    model, kwargs = AutoModel.build_model(**kwargs)
    output_dir = kwargs.get("output_dir", "exp")
    os.makedirs(output_dir, exist_ok=True)
    if kwargs.get("model_path"):
        write_output_config(kwargs["model_path"], output_dir)

    dl_kwargs = {k: v for k, v in kwargs.items() if k not in ("frontend", "tokenizer")}
    dl = tables.dataloader_classes[kwargs.get("dataloader", "DataloaderMapStyle")](
        frontend=kwargs.get("frontend"), tokenizer=kwargs.get("tokenizer"), **dl_kwargs)

    optimizer = build_optimizer(model.parameters(), kwargs.get("optim", "adam"),
                                kwargs.get("optim_conf", {}))
    scheduler = (build_scheduler(optimizer, kwargs["scheduler"], kwargs.get("scheduler_conf"))
                 if kwargs.get("scheduler") else None)
    train_conf = dict(kwargs.get("train_conf", {}))
    trainer = Trainer(model, optimizer, scheduler, frontend=kwargs.get("frontend"),
                      output_dir=output_dir, sharding=kwargs.get("sharding", "dp"),
                      seed=int(kwargs.get("seed", 0)), **train_conf)
    trainer.run(dl.train, dl.valid)
    trainer.close()

    avg_n = train_conf.get("avg_nbest_model", 0)
    if avg_n:
        try:
            average_checkpoints(output_dir, avg_n, avg_keep_nbest_models_type=train_conf.get(
                "avg_keep_nbest_models_type", "acc"))
        except FileNotFoundError as e:
            logging.warning("checkpoint averaging skipped: %s", e)
    return model


def main_cli():
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    cfg = parse_overrides(sys.argv[1:])
    if "model" not in cfg:
        raise SystemExit("pass ++model=<model dir>")
    main(**cfg)


if __name__ == "__main__":
    main_cli()
