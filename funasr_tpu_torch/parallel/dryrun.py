"""``dryrun_multichip(n)``: one training step of a tiny Paraformer under dp and under fsdp
in n gloo processes on the CPU (the port's counterpart of the dp and FSDP passes of
``__graft_entry__.py::dryrun_multichip``, ``:80-200``).

Each mode builds the same seeded model on every rank, a ``DataGroup`` over the n ranks
(fsdp: every layer a unit at ``min_size`` 256, as the JAX dry run's ``fsdp_param_shardings
(min_size=256)``), and runs ``train_step.make_train_step`` with Adam on a global batch of
2n rows. Checks: a finite loss, the same on every rank and under both modes (the step on
the global batch); under fsdp every parameter and both its Adam moments are DTensors
holding 1/n of their rows on each rank (a dim-0 shard of ``ceil(rows / n)`` rows, as
``torch.chunk`` cuts). Rank 0 returns one line per mode.

    python -m funasr_tpu_torch.parallel.dryrun 2
"""

from __future__ import annotations

import math
import os
import queue
import sys
import tempfile
import traceback
from typing import List

import numpy as np
import torch

TINY = dict(input_size=560, vocab_size=64,
            encoder_conf=dict(output_size=32, attention_heads=4, linear_units=64,
                              num_blocks=2, kernel_size=11, dropout_rate=0.0),
            decoder_conf=dict(attention_heads=4, linear_units=64, num_blocks=2,
                              att_layer_num=2, kernel_size=11, sanm_shfit=0),
            predictor_conf=dict(idim=32, l_order=1, r_order=1, tail_threshold=0.45),
            sos=1, eos=2, predictor_bias=1, sampling_ratio=0.4)
MIN_SIZE = 256
LOSS_RTOL = 1e-5  # the first step's loss, dp against fsdp (fp32, sums in other orders)


def _batch(rows: int, t: int = 32, l: int = 6):
    rng = np.random.default_rng(0)
    return {"speech": torch.from_numpy(rng.standard_normal((rows, t, 560)).astype(np.float32)),
            "speech_lengths": torch.full((rows,), t, dtype=torch.int32),
            "text": torch.from_numpy(rng.integers(3, 64, (rows, l))).long(),
            "text_lengths": torch.full((rows,), l, dtype=torch.int64)}


def _expected_rows(rows: int, n: int, rank: int) -> int:
    per = math.ceil(rows / n)
    return max(0, min(rows, (rank + 1) * per) - rank * per)


def _one_mode(mode: str, n: int, rank: int) -> tuple:
    from torch.distributed.tensor import DTensor

    from funasr_tpu_torch.models.paraformer.model import Paraformer
    from funasr_tpu_torch.parallel.sharding import DataGroup
    from funasr_tpu_torch.train_utils.train_step import make_train_step

    model = Paraformer(**TINY, generator=torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    data = DataGroup(mode, torch.device("cpu"))
    data.prepare(model, opt, min_size=MIN_SIZE)
    step = make_train_step(model, opt, clip_grad_norm=5.0,
                           generator=torch.Generator().manual_seed(1), data=data)
    stats = step(_batch(2 * n))
    loss = float(stats["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"{mode}: non-finite loss {loss}")
    losses = [torch.zeros(()) for _ in range(n)]
    torch.distributed.all_gather(losses, torch.tensor(loss))
    if any(float(x) != loss for x in losses):
        raise AssertionError(f"{mode}: the ranks' losses differ: {losses}")
    sharded = 0
    if mode == "fsdp":
        for name, p in model.named_parameters():
            moments = opt.state[p]
            for what, t in (("param", p), ("exp_avg", moments["exp_avg"]),
                            ("exp_avg_sq", moments["exp_avg_sq"])):
                if not isinstance(t, DTensor):
                    raise AssertionError(f"{name} {what}: not sharded")
                want = _expected_rows(t.shape[0], n, rank)
                if t.to_local().shape[0] != want:
                    raise AssertionError(f"{name} {what}: {t.to_local().shape[0]} of "
                                         f"{t.shape[0]} rows on rank {rank}, not {want}")
                sharded += 1
    return loss, sharded


def _rank_main(rank: int, n: int, init: str, out) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist
    try:
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=n)
        results = {mode: _one_mode(mode, n, rank) for mode in ("dp", "fsdp")}
        (dp_loss, _), (fsdp_loss, sharded) = results["dp"], results["fsdp"]
        if abs(dp_loss - fsdp_loss) > LOSS_RTOL * abs(dp_loss):
            raise AssertionError(f"the first step's loss: dp {dp_loss} against fsdp {fsdp_loss}")
        out.put((rank, [f"dryrun_multichip dp(n={n}): loss={dp_loss:.4f} OK",
                        f"dryrun_multichip fsdp(n={n}): loss={fsdp_loss:.4f} OK ({sharded} "
                        f"parameters and Adam moments each 1/{n} of their rows a rank)"]))
    except BaseException:
        out.put((rank, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def dryrun_multichip(n: int, timeout: float = 300.0) -> List[str]:
    """Spawn ``n`` gloo ranks on the CPU (rendezvous through a file in a temporary
    directory), each waited on for at most ``timeout`` seconds; raises with the first
    failing rank's traceback. -> rank 0's lines, also printed."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        out = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, args=(r, n, f"file://{os.path.join(d, 'rdzv')}",
                                                      out)) for r in range(n)]
        for p in procs:
            p.start()
        results = {}
        try:
            for _ in range(n):
                rank, res = out.get(timeout=timeout)
                results[rank] = res
        except queue.Empty:
            pass
        finally:
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
    errors = {r: res for r, res in results.items() if isinstance(res, str)}
    if errors or len(results) != n:
        rank = min(errors) if errors else None
        raise RuntimeError(f"dryrun_multichip({n}): " + (
            f"rank {rank} failed:\n{errors[rank]}" if errors
            else f"{n - len(results)} rank(s) gave no result in {timeout:g} s"))
    for line in results[0]:
        print(line)
    return results[0]


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
