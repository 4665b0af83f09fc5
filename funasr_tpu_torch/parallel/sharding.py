"""The data-parallel group a training step runs over (counterpart of
``funasr_tpu/parallel/sharding.py``'s "data" axis; FunASR ``funasr/bin/train.py:80-170``).

The JAX package gets data parallelism from GSPMD: one program over a ("data",) mesh, the
batch's rows sharded over it (``batch_shardings`` :156-161), the gradients summed by XLA,
and under FSDP every tensor of at least 2^16 elements split on its first dim
(``fsdp_param_shardings`` :104-124) with its optimizer moments (``opt_state_shardings``
:126-153). Its step is the step on the global batch: the loss is the mean over all its
rows. Here each rank is a process (torchrun's, or one the trainer makes), and a step
keeps that meaning:

* **Rows.** Every rank builds the global batch the sampler gives at world size 1, pads
  it to a multiple of the world size by repeating its last row (the JAX trainer's
  ``_shard_batch``, ``trainer.py:150-165``) and steps on its own contiguous block of
  rows (``DataGroup.local_rows``). The sampler's own rank split is not used: it hands
  each rank a different batch, which is FunASR's torch semantics, not the JAX step.
* **The loss.** A loss divides a sum over rows by a count over the batch (tokens,
  rows). ``global_count`` sums such a count over the group, so that each rank's loss is
  S_r / D with D the global count, and the sum of the ranks' losses is the global mean
  S / D. The gradients are then *summed* over the group, not averaged: dp all-reduces
  them (``reduce_gradients``), fsdp reduce-scatters them with FSDP2's divide factor set
  to 1. A 0-d stat so computed (a loss, an accuracy, a row count) is likewise the sum of
  the ranks' values (``sum_stats``).
* **dp** keeps the model whole on every rank and all-reduces every gradient after the
  backward, in flat buckets. It is not DDP: ``forward_batch`` (the LLM-ASR family's
  step) bypasses ``DDP.forward``, parameters without a gradient (a CTC head at weight 0)
  would need ``find_unused_parameters``, and DDP's ``module.`` prefix would change the
  checkpoint's keys; an explicit all-reduce after the trainer's zero-fill has none of
  those cases.
* **fsdp** is FSDP2's ``fully_shard``: first every layer (``layer_units``: an element of
  an ``nn.ModuleList`` that defines ``forward`` and holds a parameter of at least
  ``min_size`` elements, so each SAN-M encoder and decoder layer, each Qwen layer), then
  the root, which holds the rest. Each parameter, and so each Adam moment, is a DTensor
  holding 1/n of its rows on each rank; in forward FSDP2 gives the modules plain
  unsharded tensors, so the flash and FSMN kernels launch as they do without it (a
  DTensor reaching a kernel wrapper raises). ``forward_batch`` is registered with
  ``register_fsdp_forward_method``. A step syncs every micro-batch, with
  ``accum_grad`` too: the JAX step clips and guards each micro-batch's global gradient
  before ``optax.MultiSteps`` averages them, which a deferred sync would not.
* **Checkpoints** hold whole tensors in FunASR's layout under either mode: the model's
  state dict and ``optimizer.state_dict()`` (int-keyed, as on one device) gathered on
  rank 0 (``full_state``), and loaded back as each rank's shard (``load_model_state``,
  ``load_optimizer_state``): a dp checkpoint resumes under fsdp and the other way round.

The group comes from torchrun's environment (``init_from_env``, ``++distributed=true``),
or, where there is none and the trainer runs fsdp, is a one-rank group the trainer makes
itself (``DataGroup(owns_group)``) over an in-process store: NCCL on CUDA, gloo on the
CPU. ``tp``, ``sp`` and ``pp`` are ROADMAP item 21b.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import sys
import time
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
MODES = ("dp", "fsdp")
FSDP_MIN_SIZE = 2 ** 16  # elements of a tensor sharded over "data" (fsdp_param_shardings)
BUCKET_BYTES = 32 << 20  # gradient bytes one dp all-reduce carries
ITEM_21B = "ROADMAP item 21b"

# (group, device) of the data group a loss is being computed over, else None
_ACTIVE = contextvars.ContextVar("funasr_tpu_torch_data_group", default=None)


def backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_from_env(device_type: str) -> torch.device:
    """``++distributed=true``: the default process group from torchrun's environment
    (``env://``), NCCL on ``cuda:LOCAL_RANK`` or gloo on the CPU -> this rank's device.
    A missing variable is a ``SystemExit`` that names it."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise SystemExit(
            f"++distributed=true reads torchrun's environment, and {missing[0]} is not set: "
            "launch with torchrun --nproc_per_node=<GPUs> -m funasr_tpu_torch.bin.train ...")
    if device_type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method="env://", device_id=device)
    else:
        device = torch.device("cpu")
        dist.init_process_group("gloo", init_method="env://")
    return device


def local(t):
    """A DTensor's shard on this rank (sharing its storage; no autograd node), any other
    tensor itself. No DTensor exists before its module is imported (1.4 s of import)."""
    dtensor = sys.modules.get("torch.distributed.tensor")
    if dtensor is None or not isinstance(t, dtensor.DTensor):
        return t
    with torch.no_grad():
        return t.to_local()


def global_count(n):
    """A loss normalizer (a count over the batch: tokens, rows) summed over the data group
    the loss is computed in (``DataGroup.active``), without gradient; ``n`` itself
    outside one."""
    active = _ACTIVE.get()
    if active is None:
        return n
    group, device = active
    total = torch.as_tensor(n, device=device).detach().clone()
    dist.all_reduce(total, group=group)
    return total


def layer_units(model: nn.Module, min_size: int = FSDP_MIN_SIZE):
    """The modules FSDP2 shards as units of their own, outermost first: each element of an
    ``nn.ModuleList`` that defines ``forward`` (its callers go through ``__call__``, where
    FSDP2's hooks unshard it) and holds a parameter of at least ``min_size`` elements.
    A unit's own lists stay in it; what no unit holds stays with the root."""
    units = []

    def visit(module):
        for child in module.children():
            if not isinstance(child, nn.ModuleList):
                visit(child)
                continue
            for layer in child:
                if type(layer).forward is not nn.Module.forward and any(
                        p.numel() >= min_size for p in layer.parameters()):
                    units.append(layer)
                else:
                    visit(layer)

    visit(model)
    return units


def pad_rows(v, world: int):
    """``v`` with its last row repeated up to a multiple of ``world`` rows."""
    b = v.shape[0]
    extra = -(-b // world) * world - b
    if not extra:
        return v
    if isinstance(v, np.ndarray):
        return np.concatenate([v, np.repeat(v[-1:], extra, axis=0)])
    return torch.cat([v, v[-1:].expand(extra, *v.shape[1:])])


class DataGroup:
    """The data-parallel group a trainer steps over, in mode "dp" or "fsdp": the default
    process group if one is up, else (fsdp) a one-rank group made here, on ``device``'s
    backend, which ``close`` destroys."""

    def __init__(self, mode: str, device):
        if mode not in MODES:
            raise ValueError(f"data parallelism is 'dp' or 'fsdp', not {mode!r}")
        self.mode = mode
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.owns_group = not dist.is_initialized()
        t0 = time.perf_counter()
        if self.owns_group:
            extra = {"device_id": self.device} if self.device.type == "cuda" else {}
            dist.init_process_group(backend_for(self.device), store=dist.HashStore(),
                                    rank=0, world_size=1, **extra)
        self.group = dist.group.WORLD
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.setup_s = time.perf_counter() - t0

    @property
    def sharded(self) -> bool:
        return self.mode == "fsdp"

    @contextlib.contextmanager
    def active(self):
        """Loss normalizers computed inside count over the group (``global_count``)."""
        token = _ACTIVE.set((self.group, self.device))
        try:
            yield
        finally:
            _ACTIVE.reset(token)

    # ---- the model ------------------------------------------------------------------

    def prepare(self, model: nn.Module, optimizer=None, min_size: int = FSDP_MIN_SIZE):
        """Every rank starts from rank 0's weights (as DDP does); under fsdp the model is
        then sharded (``layer_units``, then the root), and ``optimizer``, which must not
        have stepped, is pointed at the sharded parameters. -> seconds taken."""
        t0 = time.perf_counter()
        if self.world > 1:
            with torch.no_grad():
                for t in model.state_dict().values():
                    dist.broadcast(t, 0, group=self.group)
        if self.sharded:
            self._shard(model, optimizer, min_size)
        return time.perf_counter() - t0

    def _shard(self, model, optimizer, min_size):
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.fsdp import (FSDPModule, fully_shard,
                                            register_fsdp_forward_method)
        if optimizer is not None and optimizer.state:
            raise ValueError("shard the model before its optimizer steps")
        names = {id(p): n for n, p in model.named_parameters()}
        mesh = init_device_mesh(self.device.type, (self.world,), mesh_dim_names=("data",))
        for unit in layer_units(model, min_size):
            fully_shard(unit, mesh=mesh)
        fully_shard(model, mesh=mesh)
        if hasattr(model, "forward_batch"):  # the trainer's entry point besides forward
            register_fsdp_forward_method(model, "forward_batch")
        for m in model.modules():
            if isinstance(m, FSDPModule):  # summed (the losses divide by global counts), as
                m.set_gradient_divide_factor(1.0)  # a plain SUM: gloo has no PREMUL_SUM
                m.set_force_sum_reduction_for_comms(True)
        if optimizer is not None:
            sharded = dict(model.named_parameters())
            for g in optimizer.param_groups:
                g["params"] = [sharded[names[id(p)]] for p in g["params"]]

    # ---- a step ---------------------------------------------------------------------

    def local_rows(self, batch: Dict) -> Dict:
        """This rank's rows of the global batch: each array padded to a multiple of the
        world size by repeating its last row, then the rank's contiguous block."""
        if self.world == 1:
            return batch
        out = dict(batch)
        for k, v in batch.items():
            if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim >= 1:
                v = pad_rows(v, self.world)
                per = v.shape[0] // self.world
                out[k] = v[self.rank * per:(self.rank + 1) * per]
        return out

    def reduce_gradients(self, grads):
        """dp: each gradient summed over the group, in flat buckets of BUCKET_BYTES (fsdp:
        FSDP2 reduce-scattered them in the backward)."""
        if self.sharded:
            return
        bucket, size = [], 0
        for g in grads:
            if bucket and (g.dtype != bucket[0].dtype or size >= BUCKET_BYTES):
                self._all_reduce_flat(bucket)
                bucket, size = [], 0
            bucket.append(g)
            size += g.numel() * g.element_size()
        if bucket:
            self._all_reduce_flat(bucket)

    def _all_reduce_flat(self, tensors):
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.group)
        for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(part.view_as(t))

    def sum_norms(self, norm):
        """fsdp: the global L2 norm from this rank's shards' ``norm`` (the same value on
        every rank); dp: ``norm`` (of whole gradients, the same on every rank)."""
        if not self.sharded:
            return norm
        sq = norm * norm
        dist.all_reduce(sq, group=self.group)
        return sq.sqrt()

    def sum_stats(self, stats: Dict) -> Dict:
        """Every 0-d stat summed over the group, as float32 (see the module's notes)."""
        keys = [k for k, v in stats.items() if torch.is_tensor(v) and v.dim() == 0]
        if not keys:
            return dict(stats)
        vec = torch.stack([stats[k].detach().float().to(self.device) for k in keys])
        dist.all_reduce(vec, group=self.group)
        return dict(stats, **dict(zip(keys, vec.unbind())))

    def sum_floats(self, totals: Dict[str, float]) -> Dict[str, float]:
        """Host floats (a validation's per-stat totals) summed over the group."""
        keys = sorted(totals)
        vec = torch.tensor([totals[k] for k in keys], dtype=torch.float64, device=self.device)
        dist.all_reduce(vec, group=self.group)
        return dict(zip(keys, vec.tolist()))

    # ---- checkpoints ----------------------------------------------------------------

    def full_state(self, obj):
        """``obj`` (nested dicts / lists of tensors) with every DTensor gathered whole, on
        the CPU, on rank 0; None on the other ranks. A collective: every rank calls it
        with the same structure. One rank's shards are whole already: they stay where
        they are (``torch.save`` copies them, as on one device)."""
        from torch.distributed.tensor import DTensor

        def gather(x):
            if isinstance(x, dict):
                return {k: gather(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(gather(v) for v in x)
            if self.world == 1:
                return local(x)
            if isinstance(x, DTensor):
                x = x.full_tensor()
            return x.cpu() if torch.is_tensor(x) and self.rank == 0 else x

        out = gather(obj)
        return out if self.rank == 0 else None

    @staticmethod
    def shard_like(full: torch.Tensor, ref):
        """A whole tensor as ``ref`` holds it: ``ref``'s shard of it for a DTensor ``ref``
        (each rank cuts its own: no communication), else ``full`` on ``ref``'s device."""
        from torch.distributed.tensor import DTensor, distribute_tensor
        if isinstance(ref, DTensor):
            return distribute_tensor(full.to(ref.device, ref.dtype), ref.device_mesh,
                                     ref.placements, src_data_rank=None)
        return full.to(ref.device)

    def load_model_state(self, model: nn.Module, state_dict: Dict):
        """A whole state dict (a checkpoint's, any mode) into the model as it is held."""
        own = model.state_dict()
        model.load_state_dict({k: self.shard_like(v, own[k]) if k in own else v
                               for k, v in state_dict.items()})

    def load_optimizer_state(self, optimizer, state: Dict):
        """A whole ``optimizer.state_dict()`` (a checkpoint's, any mode) into ``optimizer``,
        each moment as its parameter is held."""
        params = [p for g in optimizer.param_groups for p in g["params"]]
        moved = {i: {k: self.shard_like(v, params[i])
                     if torch.is_tensor(v) and v.dim() and v.shape == params[i].shape else v
                     for k, v in s.items()}
                 for i, s in state["state"].items()}
        optimizer.load_state_dict(dict(state, state=moved))

    # ---------------------------------------------------------------------------------

    def barrier(self):
        dist.barrier(group=self.group)

    def close(self):
        """Destroys the group if this object made it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
            self.owns_group = False

