"""Trainer of the port: one device, checkpoint / resume, n-best tracking (counterpart of
``funasr_tpu/train_utils/trainer.py``; FunASR ``funasr/train_utils/trainer.py:39-785``).

A step: the batch's waveforms go to the model's device, the frontend runs there (dither
from the step's generator, ``trainer.py:104-108``), ``model(...)`` gives (loss, stats,
weight), or ``model.forward_batch(...)`` for a batch with ``input_ids`` (the LLM-ASR
family's OpenAI-format batches, as the JAX trainer dispatches), ``loss.backward()``;
every parameter without a gradient gets zeros (optax's gradient tree holds every leaf, so
decay and moments cover it too); the gradients' global L2 norm g, scaled by min(1, clip /
(g + 1e-6)), and all set to zero when g is not finite,
the update still taken (``trainer.py:126-141``); ``accum_grad`` k averages k gradients as
``optax.MultiSteps`` does (running mean, ``acc + (g - acc) / (i + 1)``) and applies them
once, the scheduler stepping with the applied updates. Random draws (dither, SpecAug,
dropout, the glancing sampler) come from a generator on the device seeded from (seed,
step), as the JAX trainer folds the step into its key, so a resumed run draws what an
uninterrupted one would.

Logged every ``log_interval`` steps to ``train.log.jsonl`` (and TensorBoard when
``torch.utils.tensorboard`` imports): the step's 0-d stats, ``grad_norm``, ``lr``, the
host seconds of data loading and of the steps since the last line, ``time`` (seconds
since the trainer was made; the lines' differences are whole steps, device work
included, since reading the stats waits for it), each kernel wrapper's launches since
the last line (``launches``) and, on CUDA, the peak device memory (MiB); with
``log_kernel_shapes``, also those launches by the shapes and strides they ran at, with the
first such launch's per-row lengths (``kernel_shapes``, ``cuda_lib.take_launch_shapes``).
Validation (``eval()`` mode: no dropout, no SpecAug, no dither; the sampler still runs, as
in the JAX package) at each epoch's end and with each mid-epoch checkpoint, logged as a
``{"validate": averages, "launches", ...}`` line; checkpoints every
``save_checkpoint_interval`` steps and at each epoch's end are ``torch.save`` files
``{"state_dict": <FunASR-layout state dict>, "optimizer", "scheduler", "accum", "epoch",
"step", "metric", "metric_name", "epoch_step"}`` (``AutoModel(model=<dir>,
init_param=<file>)`` loads their ``state_dict``); ``model.pt.latest`` names the last, which
n-best pruning never deletes. The metric is the validation's ``avg_keep_nbest_models_type``
stat, or its ``loss`` where the model reports no such stat (SenseVoice, CTC, the aligner),
and pruning ranks by the stat it is: highest first for an accuracy, lowest first for a
loss. (The JAX trainer ranks highest first whenever the type is "acc", so for those
models it keeps the worst checkpoints: ROADMAP section 3.) ``profile_dir``:
``torch.profiler`` over steps [profile_start_step, + profile_steps), a Chrome trace and
``summary.json`` (the window's wall ms, device kernel ms by kernel).

Data parallelism (``parallel/sharding.py``): with a process group up (torchrun and
``++distributed=true``), ``sharding="dp"`` keeps the model whole on each rank and sums
the gradients over the group after the backward; ``sharding="fsdp"`` (the recipes'
default) shards it with FSDP2, over a one-rank group of its own where none is up. Each
rank steps on its block of the global batch's rows (padded by repeating the last row),
the losses' normalizers count over the group, so a step is the step on the global
batch, and the logged stats are the global batch's; each rank's random draws fold its
rank into the seed. Only rank 0 writes the log, the profile and the checkpoints, which
hold whole tensors in the same layout under either mode. "sp" and "pp" (and tensor
parallelism) are ROADMAP item 21b.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

from funasr_tpu_torch.ops import cuda_lib
from funasr_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
from funasr_tpu_torch.ops.fsmn import (depthwise_conv1d, depthwise_conv1d_bwd_input,
                                       depthwise_conv1d_bwd_weight, fsmn_memory,
                                       fsmn_memory_bwd_input, fsmn_memory_bwd_weight)
from funasr_tpu_torch.ops.w8a8 import w8a8_linear
from funasr_tpu_torch.parallel.sharding import ITEM_21B, DataGroup, local
from funasr_tpu_torch.train_utils.train_step import backward, clip_scale, global_norm, scale_

# the kernel wrappers whose launches each log line counts
KERNEL_COUNTERS = {"flash_attention": flash_attention,
                   "flash_attention_bwd": flash_attention_bwd,
                   "fsmn_memory": fsmn_memory, "fsmn_memory_bwd_input": fsmn_memory_bwd_input,
                   "fsmn_memory_bwd_weight": fsmn_memory_bwd_weight, "w8a8_linear": w8a8_linear,
                   "depthwise_conv1d": depthwise_conv1d,
                   "depthwise_conv1d_bwd_input": depthwise_conv1d_bwd_input,
                   "depthwise_conv1d_bwd_weight": depthwise_conv1d_bwd_weight}


RANK_SEED_STRIDE = 0x9E3779B1  # odd: r x it mod 2^32 differs for every rank r < 2^32


def higher_is_better(metric_name: str) -> bool:
    """Whether a validation stat ranks highest first: an accuracy ("acc", "acc_rich")
    does, a loss does not."""
    return metric_name.startswith("acc")


def kernel_launches() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_COUNTERS.items()}


def step_generator(device, seed: int, step: int, rank: int = 0) -> torch.Generator:
    """The step's generator (the JAX trainer's ``fold_in(rng, step)``); each rank of a
    data group draws its own (rank 0 as on one device). The rank moves the seed's low 32
    bits, the only ones the CPU generator's Mersenne twister reads."""
    return torch.Generator(device=device).manual_seed(
        seed * 1_000_003 + step + rank * RANK_SEED_STRIDE)


class Trainer:
    def __init__(self, model, optimizer, scheduler=None, frontend=None,
                 output_dir: str = "exp", max_epoch: int = 10, accum_grad: int = 1,
                 clip_grad_norm: float = 5.0, log_interval: int = 50,
                 save_checkpoint_interval: int = 5000,
                 keep_nbest_models: int = 5, avg_keep_nbest_models_type: str = "acc",
                 resume: bool = True, profile_dir: Optional[str] = None,
                 profile_start_step: int = 10, profile_steps: int = 5, sharding: str = "dp",
                 seed: int = 0, use_tensorboard: bool = True, log_kernel_shapes: bool = False,
                 **kwargs):
        if sharding in ("sp", "pp"):
            raise NotImplementedError(
                f"sharding={sharding!r}: sequence and pipeline parallelism need the model "
                f"code to run on time shards or stages ({ITEM_21B})")
        if sharding not in ("dp", "fsdp"):
            raise ValueError(f"sharding must be 'dp', 'fsdp', 'sp' or 'pp', got {sharding!r}")
        self.model = model
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.frontend = frontend
        self.device = next(model.parameters()).device
        self.output_dir = output_dir
        self.max_epoch = max_epoch
        self.accum_grad = accum_grad
        self.clip_grad_norm = clip_grad_norm
        self.log_interval = log_interval
        self.save_checkpoint_interval = save_checkpoint_interval
        self.keep_nbest_models = keep_nbest_models
        self.avg_type = avg_keep_nbest_models_type
        self.resume = resume
        self.profile_dir = profile_dir
        self.profile_start_step = profile_start_step
        self.profile_steps = profile_steps
        self.seed = seed
        self.log_kernel_shapes = log_kernel_shapes
        self.step = 0
        self.start_epoch = 0
        self._resume_skip_batches = 0
        self.best_ckpts: Dict[str, float] = {}
        # a data group over the process group that is up, or fsdp's own one-rank group
        self.data = (DataGroup(sharding, self.device)
                     if sharding == "fsdp" or dist.is_initialized() else None)
        self.rank = 0 if self.data is None else self.data.rank
        if self.data is not None:
            wrap_s = self.data.prepare(model, optimizer)
            logging.info("data group: %s over %d rank(s), group %.1f s, model %.1f s",
                         sharding, self.data.world, self.data.setup_s, wrap_s)
        self.params = [p for p in model.parameters() if p.requires_grad]
        # optax.MultiSteps state: mini-batches accumulated and their running-mean grads
        self._mini_step = 0
        self._acc = None
        os.makedirs(output_dir, exist_ok=True)
        self._tb = self._log_f = None
        if self.rank != 0:
            self.profile_dir = None
        elif use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir=os.path.join(output_dir, "tensorboard"))
            except ImportError:
                pass
        if self.rank == 0:
            self._log_f = open(os.path.join(output_dir, "train.log.jsonl"), "a")
        self._t0 = time.perf_counter()

    # ------------------------------------------------------------------

    def _features(self, batch, generator=None):
        """The batch on the device (this rank's rows of it in a data group): (feats, feat
        lengths, text, text lengths, the OpenAI-format batch's ``input_ids`` /
        ``labels_ids`` / ``fbank_mask`` where it has them); waveforms (B, N) go through the
        frontend there."""
        if self.data is not None:
            batch = self.data.local_rows(batch)
        dev = self.device
        speech = torch.as_tensor(batch["speech"]).to(dev, non_blocking=True)
        lens = torch.as_tensor(batch["speech_lengths"]).to(dev, non_blocking=True)
        text = torch.as_tensor(batch["text"]).to(dev, non_blocking=True).long()
        tlens = torch.as_tensor(batch["text_lengths"]).to(dev, non_blocking=True).long()
        extra = {k: torch.as_tensor(batch[k]).to(dev, non_blocking=True)
                 for k in ("input_ids", "labels_ids", "fbank_mask") if k in batch}
        if self.frontend is not None and speech.dim() == 2:
            speech, lens = self.frontend.forward(speech, lens, generator=generator)
        return speech, lens, text, tlens, extra

    def _loss(self, batch, generator, train=True):
        """The model's (loss, stats, weight) on a batch, dispatched as the JAX trainer's
        ``loss_fn`` (``trainer.py:110-125``): a batch with ``input_ids`` goes to the
        model's ``forward_batch`` where it has one (the LLM-ASR family's OpenAI-format
        batches), any other to ``forward(feats, flens, text, tlens)``. The frontend
        dithers from ``generator`` only when ``train``."""
        feats, flens, text, tlens, extra = self._features(
            batch, generator=generator if train else None)
        with self.data.active() if self.data is not None else contextlib.nullcontext():
            if "input_ids" in batch and hasattr(self.model, "forward_batch"):
                return self.model.forward_batch(
                    {**extra, "speech": feats, "speech_lengths": flens}, generator=generator)
            return self.model(feats, flens, text, tlens, generator=generator)

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        """One mini-batch: loss, backward (the gradients summed over a data group), norm,
        clip / guard, (accumulated) update -> the step's stats (the global batch's)."""
        self.model.train()
        gen = step_generator(self.device, self.seed, self.step, self.rank)
        for p in self.params:
            p.grad = None
        loss, stats, _ = self._loss(batch, gen)
        grads = backward(loss, self.params, self.data)
        gnorm = global_norm(grads, self.data)
        stats = dict(stats) if self.data is None else self.data.sum_stats(stats)
        stats["grad_norm"] = gnorm
        # the host reads the norm: a scale of 0 would leave an inf or NaN gradient NaN
        # (0 x inf), where JAX's where() gives 0, and torch has no multi-tensor where
        if torch.isfinite(gnorm):
            if self.clip_grad_norm:
                scale_(grads, clip_scale(gnorm, self.clip_grad_norm))
        else:
            torch._foreach_zero_([local(g) for g in grads])
        self._apply(grads)
        return stats

    def _apply(self, grads):
        """The optimizer update, every ``accum_grad`` mini-batches on their mean."""
        if self.accum_grad <= 1:
            self.optimizer.step()
            if self.scheduler is not None:
                self.scheduler.step()
            return
        if self._acc is None:
            self._acc = [torch.zeros_like(g) for g in grads]
        n = self._mini_step
        accs, gs = [local(a) for a in self._acc], [local(g) for g in grads]
        for acc, g in zip(accs, gs):
            acc.add_((g - acc) / (n + 1))
        self._mini_step = (n + 1) % self.accum_grad
        if self._mini_step == 0:
            for g, acc in zip(gs, accs):
                g.copy_(acc)
                acc.zero_()
            self.optimizer.step()
            if self.scheduler is not None:
                self.scheduler.step()

    # ------------------------------------------------------------------

    def run(self, dataloader_train, dataloader_val=None):
        if self.resume:
            self.resume_checkpoint()
        for epoch in range(self.start_epoch, self.max_epoch):
            if hasattr(dataloader_train.sampler, "set_epoch"):
                dataloader_train.sampler.set_epoch(epoch)
            self.train_epoch(dataloader_train, dataloader_val, epoch)
            self.save_checkpoint(epoch, **self.validate_epoch(dataloader_val, epoch))
        return self.model

    def _launches_since(self, base):
        """The log line's launches since ``base`` (and, when logged, their shapes)."""
        now = kernel_launches()
        out = {"launches": {k: now[k] - base[k] for k in now}}
        if self.log_kernel_shapes:
            out["kernel_shapes"] = cuda_lib.take_launch_shapes()
        return out

    def _count_from_here(self):
        if self.log_kernel_shapes:
            cuda_lib.record_launch_shapes()
        return kernel_launches()

    def train_epoch(self, loader, val_loader, epoch):
        skip = self._resume_skip_batches
        self._resume_skip_batches = 0
        t_data = t_step = 0.0
        base = self._count_from_here()
        profiler = None
        t0 = time.perf_counter()
        for it, batch in enumerate(loader):
            if it < skip:
                t0 = time.perf_counter()
                continue
            t1 = time.perf_counter()
            t_data += t1 - t0
            if self.profile_dir and profiler is None and self.step == self.profile_start_step:
                profiler = self._start_profile()
            stats = self.train_step(batch)
            self.step += 1
            if profiler is not None and \
                    self.step >= self.profile_start_step + self.profile_steps:
                self._stop_profile(profiler)
                profiler = None
                self.profile_dir = None
            t0 = time.perf_counter()
            t_step += t0 - t1
            if self.step % self.log_interval == 0:
                logs = {k: float(v.detach()) for k, v in stats.items() if v.dim() == 0}
                logs.update(epoch=epoch, step=self.step, data_load=round(t_data, 3),
                            step_time=round(t_step, 3), time=time.perf_counter() - self._t0,
                            lr=self.optimizer.param_groups[0]["lr"],
                            **self._launches_since(base))
                if self.device.type == "cuda":
                    logs["peak_mem_mib"] = torch.cuda.max_memory_allocated(self.device) / 2 ** 20
                base = self._count_from_here()
                t_data = t_step = 0.0
                logging.info("train: %s", logs)
                self._write_log(logs)
                if self._tb is not None:
                    for k, v in logs.items():
                        if isinstance(v, (int, float)) and k not in ("epoch", "step"):
                            self._tb.add_scalar(f"train/{k}", v, self.step)
            if self.save_checkpoint_interval > 0 \
                    and self.step % self.save_checkpoint_interval == 0:
                self.save_checkpoint(epoch, step=self.step, epoch_step=it + 1,
                                     **self.validate_epoch(val_loader, epoch))
                base = self._count_from_here()  # the next line counts its steps' only
        if profiler is not None:
            self._stop_profile(profiler)

    def _write_log(self, line: dict):
        if self._log_f is not None:
            self._log_f.write(json.dumps(line) + "\n")
            self._log_f.flush()

    @torch.no_grad()
    def validate_epoch(self, loader, epoch):
        """The validation's averages (of the global batches' stats in a data group),
        logged -> {"metric": the ``avg_type`` stat, else the loss, "metric_name": which};
        {} without a loader."""
        if loader is None:
            return {}
        self.model.eval()
        base = self._count_from_here()
        tot: Dict[str, float] = {}
        n = 0
        gen = step_generator(self.device, self.seed, 999, self.rank)
        for batch in loader:
            _, stats, _ = self._loss(batch, gen, train=False)
            for k, v in stats.items():
                if v.dim() == 0:
                    tot[k] = tot.get(k, 0.0) + float(v)
            n += 1
        if self.data is not None:
            tot = self.data.sum_floats(tot)
        avg = {k: v / max(n, 1) for k, v in tot.items()}
        logging.info("validate epoch %d: %s", epoch, avg)
        self._write_log({"validate": avg, "epoch": epoch, "step": self.step, "batches": n,
                         **self._launches_since(base)})
        name = self.avg_type if self.avg_type in avg else "loss"
        return {"metric": avg.get(name), "metric_name": name}

    # ------------------------------------------------------------------

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if self.device.type == "cuda" else [])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof = profile(activities=acts)
        prof.__enter__()
        prof.t_start = time.perf_counter()
        return prof

    def _stop_profile(self, prof):
        from torch.autograd import DeviceType
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall_ms = (time.perf_counter() - prof.t_start) * 1e3
        prof.__exit__(None, None, None)
        os.makedirs(self.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.profile_dir, "trace.json"))
        # device kernels only: a record_function range (the optimizer's step) also shows
        # device time, that of the kernels inside it
        by_kernel = {e.key: [e.self_device_time_total / 1e3, e.count]
                     for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)
                     and not e.key.startswith("Optimizer.")}
        summary = {"steps": self.profile_steps, "wall_ms": wall_ms,
                   "device_ms": sum(v[0] for v in by_kernel.values()), "by_kernel": by_kernel}
        with open(os.path.join(self.profile_dir, "summary.json"), "w") as f:
            json.dump(summary, f)
        logging.info("torch.profiler trace written to %s", self.profile_dir)

    # ------------------------------------------------------------------

    def _ckpt_path(self, name):
        return os.path.join(self.output_dir, name)

    def save_checkpoint(self, epoch, step=None, metric=None, epoch_step=None,
                        metric_name=None):
        """``metric_name``: the validation stat ``metric`` is (``avg_type`` if not given),
        which sets the ranking's order. In a data group every rank takes part in gathering
        the whole tensors and rank 0 writes them."""
        t0 = time.perf_counter()
        name = f"model.pt.ep{epoch}" + (f".{step}" if step is not None else "")
        metric_name = metric_name or self.avg_type
        tensors = {"state_dict": self.model.state_dict(),
                   "optimizer": self.optimizer.state_dict(), "acc": self._acc}
        if self.data is not None:
            tensors = self.data.full_state(tensors)
        gather_s = time.perf_counter() - t0
        if self.rank != 0:
            return
        state = {
            "state_dict": tensors["state_dict"],
            "optimizer": tensors["optimizer"],
            "scheduler": None if self.scheduler is None else self.scheduler.state_dict(),
            "accum": {"mini_step": self._mini_step, "acc": tensors["acc"]},
            "epoch": epoch, "step": self.step, "metric": metric, "metric_name": metric_name,
            # batches consumed within this epoch; non-None marks a mid-epoch checkpoint
            "epoch_step": epoch_step,
        }
        torch.save(state, self._ckpt_path(name))
        with open(self._ckpt_path("model.pt.latest"), "w") as f:
            f.write(name)
        if metric is not None:
            # the rank key: lowest first
            metric = float(metric)
            self.best_ckpts[name] = -metric if higher_is_better(metric_name) else metric
            self._prune_nbest()
        logging.info("saved checkpoint %s (metric=%s) in %.1f s (gather %.1f s)", name, metric,
                     time.perf_counter() - t0, gather_s)

    def _prune_nbest(self):
        # never delete the checkpoint model.pt.latest points at: resume reads it
        latest_name = None
        latest = self._ckpt_path("model.pt.latest")
        if os.path.exists(latest):
            with open(latest) as f:
                latest_name = f.read().strip()
        ranked = sorted(self.best_ckpts, key=self.best_ckpts.get)
        for name in ranked[self.keep_nbest_models:]:
            if name == latest_name:
                continue
            path = self._ckpt_path(name)
            if os.path.exists(path):
                os.remove(path)
            del self.best_ckpts[name]

    def resume_checkpoint(self) -> bool:
        """Load the checkpoint ``model.pt.latest`` names, if any: weights, optimizer,
        scheduler and accumulation state, the step, and where in which epoch to go on."""
        latest = self._ckpt_path("model.pt.latest")
        if not os.path.exists(latest):
            return False
        with open(latest) as f:
            name = f.read().strip()
        path = self._ckpt_path(name)
        if not os.path.exists(path):
            return False
        state = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
        if self.data is None:
            self.model.load_state_dict(state["state_dict"])
            self.optimizer.load_state_dict(state["optimizer"])
        else:  # whole tensors, from either mode, into this rank's shards
            self.data.load_model_state(self.model, state["state_dict"])
            self.data.load_optimizer_state(self.optimizer, state["optimizer"])
        if self.scheduler is not None and state.get("scheduler") is not None:
            self.scheduler.load_state_dict(state["scheduler"])
        accum = state.get("accum") or {}
        self._mini_step = accum.get("mini_step", 0)
        acc = accum.get("acc")
        self._acc = None if acc is None else [
            a.to(self.device) if self.data is None else self.data.shard_like(a, p)
            for a, p in zip(acc, self.params)]
        self.step = state["step"]
        epoch_step = state.get("epoch_step")
        if epoch_step:
            self.start_epoch = state["epoch"]
            self._resume_skip_batches = epoch_step
        else:
            self.start_epoch = state["epoch"] + 1
        logging.info("resumed from %s (epoch %d, step %d, epoch_step %s)", name,
                     state["epoch"], self.step, epoch_step)
        return True

    def close(self):
        if self.log_kernel_shapes:
            cuda_lib.stop_recording_launch_shapes()
        if self._log_f is not None:
            self._log_f.close()
        if self._tb is not None:
            self._tb.close()
        if self.data is not None:
            self.data.close()

