"""A rank of ``tests/test_torch_parallel.py``: joins a gloo group, runs every case of the
spec file the test wrote and saves this rank's results (numpy). No JAX here.

    python tests/torch_parallel_worker.py RANK WORLD INIT_METHOD SPEC OUT

Every tensor a case returns is whole (a DTensor is gathered: every rank gathers in the
same order). A case that raises records its traceback; the others still run, so that
the ranks' collectives stay in step.
"""

import contextlib
import datetime
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from funasr_tpu_torch.parallel.sharding import global_count  # noqa: E402


class MeanStandIn(torch.nn.Module):
    """``test_torch_trainer.py``'s stand-in with its batch mean over the data group:
    loss = sum(50 * mean_b(speech[:, :4]) * w ** 2)."""

    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w.copy()))
        self.unused = torch.nn.Parameter(torch.ones(2))  # no gradient: zeros in JAX

    def forward(self, speech, speech_lengths, text, text_lengths, generator=None):
        mean = speech[:, :4].sum(0) / global_count(speech.shape[0])
        loss = (mean * self.w ** 2).sum() * 50.0
        return loss, {"loss": loss}, speech.shape[0]


class DrawStandIn(MeanStandIn):
    """Records a draw from each step's generator."""

    def forward(self, speech, speech_lengths, text, text_lengths, generator=None):
        self.draws.append(torch.rand(4, generator=generator).numpy())
        return super().forward(speech, speech_lengths, text, text_lengths)


def whole(t):
    from torch.distributed.tensor import DTensor
    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().numpy().copy()


def state(model):
    return {n: whole(p) for n, p in model.named_parameters()}


def grads(model):
    return {n: whole(p.grad) for n, p in model.named_parameters()}


@contextlib.contextmanager
def cif_tie_moved(scale):
    """The training CIF's rescaled alphas times ``scale`` (``test_torch_train_grads.py``'s
    fixture, the port's half)."""
    import funasr_tpu_torch.models.paraformer.cif_predictor as cif_mod
    cif = cif_mod.cif
    cif_mod.cif = lambda h, a, k, thr=1.0: cif(h, a * scale, k, thr)
    try:
        yield
    finally:
        cif_mod.cif = cif


def trainer(model, opt, out, mode, **kw):
    from funasr_tpu_torch.train_utils.trainer import Trainer
    return Trainer(model, opt, output_dir=out, sharding=mode, use_tensorboard=False, **kw)


def optimizer(params, name, lr):
    return (torch.optim.SGD if name == "sgd" else torch.optim.Adam)(params, lr=lr)


def paraformer_run(spec, tmp, mode, batches, opt="sgd", lr=0.1, clip=0.0, accum=1):
    """The Paraformer of the spec through ``Trainer.train_step`` on ``batches``: each
    step's stats, then every gradient (the last applied) and parameter."""
    from funasr_tpu_torch.models.paraformer.model import Paraformer
    model = Paraformer(**spec["para_conf"], generator=torch.Generator().manual_seed(0)).train()
    t = trainer(model, optimizer(model.parameters(), opt, lr), tmp, mode,
                clip_grad_norm=clip, accum_grad=accum)
    with cif_tie_moved(spec["cif_tie_scale"]):
        stats = [{k: float(v) for k, v in t.train_step(spec[b]).items() if v.dim() == 0}
                 for b in batches]
    out = {"stats": stats, "grads": grads(model), "params": state(model)}
    t.close()
    return out


def llm_run(spec, tmp, mode):
    """LLMASR2's ``forward_batch`` through ``Trainer.train_step`` on the collated
    OpenAI-format batch (waveforms: the frontend runs in the step), SGD 0.1, no clip."""
    from funasr_tpu_torch.frontends.wav_frontend import WavFrontend
    from funasr_tpu_torch.register import tables
    model = tables.model_classes["LLMASR2"](**spec["llm_conf"],
                                            generator=torch.Generator().manual_seed(2))
    t = trainer(model, torch.optim.SGD(model.parameters(), lr=0.1), tmp, mode,
                frontend=WavFrontend(**spec["llm_frontend"]), clip_grad_norm=0.0)
    stats = {k: float(v) for k, v in t.train_step(spec["llm_batch"]).items() if v.dim() == 0}
    out = {"stats": stats, "grads": grads(model), "params": state(model)}
    t.close()
    return out


def standin_run(spec, tmp, mode, accum, clip):
    """``test_torch_trainer.py``'s step harness (Adam 0.05, the non-finite batch) with one
    row a rank: w, unused and the gradient norm after each step."""
    model = MeanStandIn(spec["w0"])
    t = trainer(model, torch.optim.Adam(model.parameters(), lr=0.05), tmp, mode,
                clip_grad_norm=clip, accum_grad=accum)
    out = []
    for b in spec["standin_batches"]:
        gnorm = float(t.train_step(b)["grad_norm"])
        p = state(model)
        out.append((p["w"], p["unused"], gnorm))
    t.close()
    return out


def checkpoint_signature(path):
    s = torch.load(path, map_location="cpu", weights_only=True)
    opt = s["optimizer"]
    return {"state_dict": [(k, tuple(v.shape)) for k, v in s["state_dict"].items()],
            "optimizer": [(i, sorted((k, tuple(v.shape)) for k, v in st.items()))
                          for i, st in opt["state"].items()],
            "param_groups": [g["params"] for g in opt["param_groups"]],
            "step": s["step"], "epoch_step": s["epoch_step"]}


def checkpoint_run(spec, tmp):
    """dp and fsdp each: a step, a mid-epoch checkpoint, a second step; then the other
    mode resumed from that checkpoint takes the second step. Adam 1e-3, no clip."""
    from funasr_tpu_torch.models.paraformer.model import Paraformer
    out = {}
    for first, second in (("dp", "fsdp"), ("fsdp", "dp")):
        d = os.path.join(tmp, f"{first}_then_{second}")
        res = {}
        for mode, resume in ((first, False), (second, True)):
            model = Paraformer(**spec["para_conf"],
                               generator=torch.Generator().manual_seed(0)).train()
            t = trainer(model, torch.optim.Adam(model.parameters(), lr=1e-3), d, mode,
                        clip_grad_norm=0.0)
            with cif_tie_moved(spec["cif_tie_scale"]):
                if resume:
                    t.resume_checkpoint()
                    res["resumed_step"] = t.step
                else:
                    t.train_step(spec["even"])
                    t.step = 1
                    t.save_checkpoint(0, step=1, epoch_step=1)
                t.train_step(spec["accum_b"])
            res[mode] = state(model)
            t.close()
        if dist.get_rank() == 0:
            res["checkpoint"] = checkpoint_signature(os.path.join(d, "model.pt.ep0.1"))
        out[f"{first}_then_{second}"] = res
    return out


def validate_run(spec, tmp, mode):
    """A step, a validation (no-grad forwards of the global batches), a step: the
    validation's averages and the weights after."""
    from funasr_tpu_torch.models.paraformer.model import Paraformer
    model = Paraformer(**spec["para_conf"], generator=torch.Generator().manual_seed(0)).train()
    t = trainer(model, torch.optim.Adam(model.parameters(), lr=1e-3), tmp, mode,
                clip_grad_norm=0.0)
    with cif_tie_moved(spec["cif_tie_scale"]):
        t.train_step(spec["even"])
        metric = t.validate_epoch([spec["odd"], spec["accum_a"]], 0)
        t.train_step(spec["accum_b"])
    out = {"metric": metric, "params": state(model)}
    t.close()
    return out


def noise_run(spec, tmp):
    """Two steps of a stand-in that draws from each step's generator."""
    model = DrawStandIn(spec["w0"])
    model.draws = []
    t = trainer(model, torch.optim.SGD(model.parameters(), lr=0.1), tmp, "dp", seed=3)
    for b in spec["standin_batches"][:2]:
        t.train_step(b)
        t.step += 1
    t.close()
    return model.draws


def dtensor_run(spec, tmp):
    """A DTensor at the flash and FSMN wrappers: each raises -> their messages."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    from funasr_tpu_torch.ops.flash_attention import flash_attention
    from funasr_tpu_torch.ops.fsmn import fsmn_memory
    mesh = init_device_mesh("cpu", (dist.get_world_size(),))
    q = torch.randn(2, 2, 8, 16)
    lengths = torch.tensor([8, 5])
    x = torch.randn(2, 8, 16)
    w = torch.randn(16, 1, 11)
    out = []
    for call in (lambda: flash_attention(distribute_tensor(q, mesh, [Shard(0)]), q, q, lengths),
                 lambda: fsmn_memory(x, distribute_tensor(w, mesh, [Shard(0)]), None, 5, 5)):
        try:
            call()
            out.append(None)
        except TypeError as e:
            out.append(str(e))
    return out


def cases(spec):
    yield "noise", noise_run, ()
    yield "dtensor", dtensor_run, ()
    for mode in ("dp", "fsdp"):
        yield f"para_{mode}", paraformer_run, (mode, ["even"])
        yield f"odd_{mode}", paraformer_run, (mode, ["odd"])
        yield f"accum_{mode}", paraformer_run, (mode, ["accum_a", "accum_b"], "sgd", 0.1,
                                                spec["accum_clip"], 2)
        yield f"llm_{mode}", llm_run, (mode,)
        yield f"validate_{mode}", validate_run, (mode,)
        for accum, clip in ((1, 5.0), (3, 5.0)):
            yield f"standin_{mode}_{accum}", standin_run, (mode, accum, clip)
    yield "checkpoint", checkpoint_run, ()


def main(rank, world, init, spec_path, out_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    spec = torch.load(spec_path, weights_only=False)
    tmp = os.path.dirname(out_path)
    results = {}
    try:
        for name, fn, args in cases(spec):
            try:
                results[name] = fn(spec, os.path.join(tmp, name), *args)
            except Exception:
                results[name] = {"error": traceback.format_exc()}
    finally:
        torch.save(results, out_path)
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
