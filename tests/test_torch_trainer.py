"""The port's training stack against the JAX package's, on the CPU.

* optimizers (adam, adam with weight decay = AdamW, adamw, sgd with and without momentum
  and decay, fairseq_adam) and schedules (warmuplr, noamlr, tri_stage) against optax over
  20 updates: parameters within 1e-6 absolute + 1e-6 relative (fp32, the decoupled
  decay and the Adam step rounded in another order: ~1 ulp a step), lrs within 5e-6
  relative (optax evaluates its schedules in float32);
* the trainer's step against the JAX ``Trainer``'s jitted step on a stand-in model
  (both packages, same loss): clipping by clip / (norm + 1e-6), the non-finite guard
  (zeroed gradients, the update still taken) and ``accum_grad`` against
  ``optax.MultiSteps``, parameters within 1e-6 absolute + 5e-6 relative (lr 0.05 on
  parameters near 1: the updates' rounding feeds back through the gradient); the bare ``make_train_step`` skips a
  non-finite update;
* the dataset copies: samplers (example and token batching, shuffled, two epochs) and
  collated batches equal to the JAX package's; ``scp2jsonl`` writes the same file;
* the trainer on the CPU: the loss falls, a mid-epoch resume ends equal to an
  uninterrupted run, n-best pruning keeps ``model.pt.latest``'s target, averaging;
* ``python -m funasr_tpu_torch.bin.train ++device=cpu`` (the ``funasr-tpu-torch-train``
  console script) end to end after ``bin/data_tools scp2jsonl``, the average decoded by
  ``AutoModel``, and the new modules' import leaving ``jax`` out of ``sys.modules``;
  ``sp``, ``pp`` and ``model_parallel_size`` > 1 raising, naming ROADMAP item 21b.
"""

import json
import os
import subprocess
import sys
import wave

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from torch_parity_util import PIPE_TOKENS, one_torch_thread, write_asr_dir  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAM_ATOL = 1e-6
PARAM_RTOL = 1e-6
STEP_RTOL = 5e-6
LR_RTOL = 5e-6


# --------------------------------------------------------------------------- optimizers

def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}


def _grads(n, seed=1):
    rng = np.random.default_rng(seed)
    return [{"a": rng.standard_normal((3, 4)).astype(np.float32),
             "b": rng.standard_normal(5).astype(np.float32)} for _ in range(n)]


def _run_port(optim, conf, scheduler=None, sched_conf=None, steps=20):
    from funasr_tpu_torch.optimizers import build_optimizer
    from funasr_tpu_torch.schedulers import build_scheduler
    ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in _params().items()}
    opt = build_optimizer(list(ps.values()), optim, conf)
    sch = build_scheduler(opt, scheduler, sched_conf) if scheduler else None
    lrs = []
    for g in _grads(steps):
        lrs.append(opt.param_groups[0]["lr"])
        for k, p in ps.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        if sch is not None:
            sch.step()
    return {k: p.detach().numpy() for k, p in ps.items()}, lrs


def _run_optax(optim, conf, scheduler=None, sched_conf=None, steps=20):
    from funasr_tpu.optimizers import build_optimizer
    from funasr_tpu.schedulers import build_scheduler
    conf = dict(conf)
    schedule = (build_scheduler(scheduler, sched_conf, base_lr=conf.get("lr"))
                if scheduler else None)
    tx = build_optimizer(optim, conf, schedule)
    params = jax.tree_util.tree_map(jnp.asarray, _params())
    state = tx.init(params)
    for g in _grads(steps):
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, updates)
    return jax.tree_util.tree_map(np.asarray, params), schedule


@pytest.mark.parametrize("optim,conf", [
    ("adam", dict(lr=1e-2)), ("adam", dict(lr=1e-2, weight_decay=0.05)),
    ("adamw", dict(lr=1e-2)), ("sgd", dict(lr=0.1)),
    ("sgd", dict(lr=0.1, momentum=0.9, weight_decay=1e-3)),
    ("fairseq_adam", dict(lr=1e-2, adam_b2=0.98, weight_decay=0.01))])
def test_optimizer_matches_optax(optim, conf):
    got, _ = _run_port(optim, conf)
    want, _ = _run_optax(optim, conf)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=PARAM_RTOL, atol=PARAM_ATOL)


@pytest.mark.parametrize("scheduler,sched_conf", [
    ("warmuplr", dict(warmup_steps=8)), ("noamlr", dict(model_size=64, warmup_steps=8)),
    ("tri_stage", dict(phase_ratio=(0.2, 0.3, 0.5), total_steps=20))])
def test_schedule_matches_optax(scheduler, sched_conf):
    conf = dict(lr=1e-2)
    got, lrs = _run_port("adam", conf, scheduler, sched_conf)
    want, schedule = _run_optax("adam", conf, scheduler, sched_conf)
    np.testing.assert_allclose(lrs, [float(schedule(n)) for n in range(20)], rtol=LR_RTOL)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=PARAM_RTOL, atol=PARAM_ATOL)


# --------------------------------------------------------------------------- the step

class PortStandIn(torch.nn.Module):
    """loss = sum(scale * mean_b(speech[:, :4]) * w ** 2) + sum(text_lengths) * 0."""

    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w.copy()))
        self.unused = torch.nn.Parameter(torch.ones(2))  # no gradient: zeros in JAX

    def forward(self, speech, speech_lengths, text, text_lengths, generator=None):
        loss = (speech[:, :4].mean(0) * self.w ** 2).sum() * 50.0
        return loss, {"loss": loss}, speech.shape[0]


class JaxStandIn:
    def forward_jit(self, params, speech, speech_lengths, text, text_lengths, rng):
        loss = jnp.sum(jnp.mean(speech[:, :4], 0) * params["w"] ** 2) * 50.0
        return loss, {"loss": loss}, speech.shape[0]


def _step_batches():
    rng = np.random.default_rng(7)
    out = []
    for i in range(6):
        speech = rng.standard_normal((2, 8)).astype(np.float32)
        if i == 2:
            speech[0, 1] = np.inf  # a non-finite gradient norm
        out.append({"speech": speech, "speech_lengths": np.array([8, 8], np.int32),
                    "text": np.zeros((2, 3), np.int32), "text_lengths": np.array([3, 3], np.int32)})
    return out


@pytest.mark.parametrize("accum_grad,clip", [(1, 5.0), (1, 0.0), (3, 5.0)])
def test_trainer_step_matches_jax_trainer(tmp_path, accum_grad, clip):
    from funasr_tpu.parallel.sharding import make_mesh
    from funasr_tpu.train_utils.trainer import Trainer as JaxTrainer
    from funasr_tpu_torch.train_utils.trainer import Trainer
    w0 = np.array([0.5, -1.0, 2.0, 0.25], np.float32)
    port = PortStandIn(w0)
    opt = torch.optim.Adam(port.parameters(), lr=0.05)
    trainer = Trainer(port, opt, output_dir=str(tmp_path / "port"), accum_grad=accum_grad,
                      clip_grad_norm=clip, use_tensorboard=False)
    jt = JaxTrainer(JaxStandIn(), optax.adam(0.05), output_dir=str(tmp_path / "jax"),
                    accum_grad=accum_grad, clip_grad_norm=clip, mesh=make_mesh(1, model=1),
                    use_tensorboard=False)
    params = {"w": jnp.asarray(w0), "unused": jnp.ones(2)}
    state = jt.tx.init(params)
    for batch in _step_batches():
        stats = trainer.train_step(batch)
        params, state, jstats = jt._step_jit(params, state, batch, jax.random.PRNGKey(0))
        jn, pn = float(jstats["grad_norm"]), float(stats["grad_norm"])
        assert (np.isfinite(jn) == np.isfinite(pn)) and (not np.isfinite(jn)
                                                          or abs(jn - pn) <= 1e-5 * jn)
        np.testing.assert_allclose(port.w.detach().numpy(), np.asarray(params["w"]),
                                   rtol=STEP_RTOL, atol=PARAM_ATOL)
        np.testing.assert_allclose(port.unused.detach().numpy(), np.asarray(params["unused"]),
                                   rtol=STEP_RTOL, atol=PARAM_ATOL)
    trainer.close()


def test_bare_train_step_skips_a_non_finite_update():
    from funasr_tpu_torch.train_utils.train_step import make_train_step
    port = PortStandIn(np.ones(4, np.float32))
    opt = torch.optim.Adam(port.parameters(), lr=0.1)
    step = make_train_step(port, opt, clip_grad_norm=1.0)
    b = {k: torch.from_numpy(v) for k, v in _step_batches()[2].items()}
    before = port.w.detach().clone()
    stats = step(b)
    assert not torch.isfinite(stats["grad_norm"]) and torch.equal(port.w.detach(), before)
    assert not opt.state  # no moments were made
    step({k: torch.from_numpy(v) for k, v in _step_batches()[0].items()})
    assert not torch.equal(port.w.detach(), before)


# --------------------------------------------------------------------------- datasets

def write_wavs(d, n, seed=0, prefix="utt"):
    rng = np.random.default_rng(seed)
    scp, txt = [], []
    for i in range(n):
        m = int(rng.integers(8000, 24000))
        w = (rng.standard_normal(m) * 0.1 * 32767).astype(np.int16)
        path = os.path.join(d, f"{prefix}{i}.wav")
        with wave.open(path, "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(16000)
            f.writeframes(w.tobytes())
        scp.append(f"{prefix}{i} {path}")
        txt.append(f"{prefix}{i} " + "".join(PIPE_TOKENS[3 + int(x)]
                                            for x in rng.integers(0, 40, int(rng.integers(2, 7)))))
    for name, lines in (("wav.scp", scp), ("text.txt", txt)):
        with open(os.path.join(d, f"{prefix}_{name}"), "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
    return os.path.join(d, f"{prefix}_wav.scp"), os.path.join(d, f"{prefix}_text.txt")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("corpus"))
    from funasr_tpu_torch.bin.data_tools import scp2jsonl
    out = {}
    for split, n, seed in (("train", 10, 0), ("val", 3, 1)):
        scp, txt = write_wavs(d, n, seed, split)
        out[split] = os.path.join(d, f"{split}.jsonl")
        scp2jsonl([scp, txt], ["source", "target"], out[split])
    out["dir"] = d
    return out


def test_scp2jsonl_matches_jax(corpus, tmp_path):
    from funasr_tpu.bin.data_tools import scp2jsonl as jax_scp2jsonl
    d = corpus["dir"]
    jax_out = str(tmp_path / "jax.jsonl")
    jax_scp2jsonl([os.path.join(d, "train_wav.scp"), os.path.join(d, "train_text.txt")],
                  ["source", "target"], jax_out)
    with open(jax_out, encoding="utf-8") as a, open(corpus["train"], encoding="utf-8") as b:
        assert a.read() == b.read()


def _datasets(path):
    from funasr_tpu.datasets.audio_datasets.datasets import AudioDataset as JaxDS
    from funasr_tpu.tokenizer.char_tokenizer import CharTokenizer as JaxTok
    from funasr_tpu_torch.datasets.audio_datasets.datasets import AudioDataset
    from funasr_tpu_torch.tokenizer.char_tokenizer import CharTokenizer
    conf = {"path": path}
    return (AudioDataset("IndexDSJsonl", conf, tokenizer=CharTokenizer(token_list=PIPE_TOKENS)),
            JaxDS("IndexDSJsonl", conf, tokenizer=JaxTok(token_list=PIPE_TOKENS)))


@pytest.mark.parametrize("batch_type,batch_size", [("example", 3), ("token", 400)])
def test_sampler_and_collator_match_jax(corpus, batch_type, batch_size):
    from funasr_tpu.datasets.audio_datasets.samplers import BatchSampler as JaxSampler
    from funasr_tpu_torch.datasets.audio_datasets.samplers import BatchSampler
    ds, jds = _datasets(corpus["train"])
    s = BatchSampler(ds, batch_size=batch_size, batch_type=batch_type, shuffle=True, seed=3)
    js = JaxSampler(jds, batch_size=batch_size, batch_type=batch_type, shuffle=True, seed=3)
    for epoch in (0, 1):
        s.set_epoch(epoch)
        js.set_epoch(epoch)
        got, want = [list(map(int, b)) for b in s], [list(map(int, b)) for b in js]
        assert got == want and sum(len(b) for b in got) == 10
    for idx in got:
        a, b = ds.collator([ds[i] for i in idx]), jds.collator([jds[i] for i in idx])
        assert set(a) == set(b)
        for k in a:
            assert (a[k] == b[k]) if k == "keys" else np.array_equal(a[k], b[k])


def _port_model_dir(d, **model_conf):
    write_asr_dir(d)
    cfg = yaml.safe_load(open(os.path.join(d, "config.yaml"), encoding="utf-8"))
    cfg["model_conf"].update(model_conf)
    with open(os.path.join(d, "config.yaml"), "w", encoding="utf-8") as f:
        yaml.safe_dump(cfg, f, allow_unicode=True)
    return d


def _trainer(out, corpus, model_dir, **train_conf):
    from funasr_tpu_torch.auto.auto_model import AutoModel
    from funasr_tpu_torch.datasets.dataloader_entry import DataloaderMapStyle
    from funasr_tpu_torch.optimizers import build_optimizer
    from funasr_tpu_torch.train_utils.trainer import Trainer
    model, kw = AutoModel.build_model(model=model_dir, device="cpu")
    dl = DataloaderMapStyle(frontend=kw["frontend"], tokenizer=kw["tokenizer"],
                            train_data_set_list=corpus["train"],
                            valid_data_set_list=corpus["val"],
                            dataset_conf=dict(batch_size=3, batch_type="example"))
    opt = build_optimizer(model.parameters(), "adam", dict(lr=2e-3))
    conf = dict(log_interval=1, use_tensorboard=False, keep_nbest_models=10)
    conf.update(train_conf)
    return Trainer(model, opt, frontend=kw["frontend"], output_dir=out, **conf), dl


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return _port_model_dir(str(tmp_path_factory.mktemp("asr")), sampling_ratio=0.75,
                           lsm_weight=0.1)


def test_trainer_loss_falls_and_checkpoints_average(corpus, model_dir, tmp_path):
    from funasr_tpu_torch.train_utils.average_nbest_models import average_checkpoints
    out = str(tmp_path / "exp")
    trainer, dl = _trainer(out, corpus, model_dir, max_epoch=4, save_checkpoint_interval=0)
    trainer.run(dl.train, dl.valid)
    trainer.close()
    lines = [json.loads(line) for line in open(os.path.join(out, "train.log.jsonl"))]
    logs = [x for x in lines if "validate" not in x]
    assert sum("validate" in x for x in lines) == 4
    first, last = np.mean([x["loss"] for x in logs[:4]]), np.mean([x["loss"] for x in logs[-4:]])
    assert last < first
    assert all(set(x["launches"]) >= {"flash_attention_bwd", "fsmn_memory_bwd_weight"}
               for x in logs)
    names = sorted(n for n in os.listdir(out) if n.startswith("model.pt.ep"))
    assert names == [f"model.pt.ep{e}" for e in range(4)]
    avg = average_checkpoints(out, 2)
    chosen = torch.load(avg, weights_only=True)["averaged_from"]
    sds = [torch.load(p, weights_only=True)["state_dict"] for p in chosen]
    got = torch.load(avg, weights_only=True)["state_dict"]
    k = "encoder.encoders.0.self_attn.linear_q_k_v.weight"
    torch.testing.assert_close(got[k], (sds[0][k].double() + sds[1][k].double()).div(2).float())


class Interrupted(Exception):
    pass


class StopAfter:
    """A loader that stops the run (raises) after `n` batches of its first epoch."""

    def __init__(self, loader, n):
        self.loader, self.n, self.sampler = loader, n, loader.sampler

    def __iter__(self):
        for i, b in enumerate(self.loader):
            if i == self.n:
                raise Interrupted
            yield b


def test_mid_epoch_resume_equals_an_uninterrupted_run(corpus, model_dir, tmp_path):
    a, dl = _trainer(str(tmp_path / "a"), corpus, model_dir, max_epoch=2,
                     save_checkpoint_interval=2)
    a.run(dl.train, dl.valid)
    b1, dl1 = _trainer(str(tmp_path / "b"), corpus, model_dir, max_epoch=2,
                       save_checkpoint_interval=2)
    with pytest.raises(Interrupted):
        b1.run(StopAfter(dl1.train, 3), dl1.valid)
    with open(tmp_path / "b" / "model.pt.latest") as f:
        assert f.read() == "model.pt.ep0.2"
    b2, dl2 = _trainer(str(tmp_path / "b"), corpus, model_dir, max_epoch=2,
                       save_checkpoint_interval=2)
    torch.nn.init.zeros_(b2.model.decoder.output_layer.weight)  # resume must overwrite it
    b2.run(dl2.train, dl2.valid)
    assert b2.step == a.step
    for (n, p), q in zip(a.model.named_parameters(), b2.model.parameters()):
        assert torch.equal(p, q), n
    for t in (a, b1, b2):
        t.close()


class CountingStandIn(PortStandIn):
    """``PortStandIn`` that counts one FSMN launch a call at its input's shape, with the
    prefix mask of its lengths (the CPU launches no kernel; this stands in for one)."""

    def forward(self, speech, speech_lengths, text, text_lengths, generator=None):
        from funasr_tpu_torch.ops import cuda_lib
        from funasr_tpu_torch.ops.fsmn import fsmn_memory
        mask = torch.arange(speech.shape[1])[None] < speech_lengths[:, None]
        cuda_lib.count_launch(fsmn_memory, (speech[..., None],), (11, 5, 5, False), mask)
        return super().forward(speech, speech_lengths, text, text_lengths, generator)


class ListLoader(list):
    sampler = None


@pytest.mark.parametrize("log_shapes", [True, False])
def test_trainer_logs_the_shapes_its_kernels_launch(tmp_path, log_shapes):
    """With ``log_kernel_shapes`` every step's line and the validation's carry the launches
    by signature (shape and strides of each tensor, the other arguments, the first
    launch's lengths), adding up to the line's ``launches``; recording stops at
    ``close``. Without it the lines carry no shapes and nothing is recorded."""
    from funasr_tpu_torch.ops import cuda_lib
    from funasr_tpu_torch.train_utils.trainer import Trainer
    batches = [dict(b, speech_lengths=np.array([8, 5], np.int32))
               for i, b in enumerate(_step_batches()) if i != 2]
    model = CountingStandIn(np.ones(4, np.float32))
    t = Trainer(model, torch.optim.SGD(model.parameters(), lr=0.01), output_dir=str(tmp_path),
                max_epoch=1, log_interval=1, save_checkpoint_interval=0, resume=False,
                use_tensorboard=False, log_kernel_shapes=log_shapes)
    t.run(ListLoader(batches), ListLoader(batches[:3]))
    t.close()
    assert cuda_lib.launch_shapes is None
    lines = [json.loads(line) for line in open(tmp_path / "train.log.jsonl")]
    assert len(lines) == len(batches) + 1 and "validate" in lines[-1]
    if not log_shapes:
        assert not any("kernel_shapes" in x for x in lines)
        return
    sig = dict(kernel="fsmn_memory", tensors=[[[2, 8, 1], [8, 1, 1]]], args=[11, 5, 5, False],
               lengths=[8, 5])
    for x in lines:
        n = 3 if "validate" in x else 1
        assert x["kernel_shapes"] == [dict(sig, launches=n)]
        assert x["launches"]["fsmn_memory"] == n


def test_pruning_keeps_the_latest_checkpoint(tmp_path):
    from funasr_tpu_torch.train_utils.trainer import Trainer
    model = PortStandIn(np.ones(4, np.float32))
    t = Trainer(model, torch.optim.SGD(model.parameters(), lr=0.1), output_dir=str(tmp_path),
                keep_nbest_models=1, use_tensorboard=False)
    t.save_checkpoint(0, metric=0.9)
    t.save_checkpoint(1, metric=0.2)  # the worst accuracy, but the latest
    t.save_checkpoint(2, metric=0.5)
    left = sorted(n for n in os.listdir(tmp_path) if n.startswith("model.pt.ep"))
    assert left == ["model.pt.ep0", "model.pt.ep2"]  # ep1 pruned once ep2 became latest
    t.save_checkpoint(3, metric=0.1)
    assert os.path.exists(tmp_path / "model.pt.ep3") and os.path.exists(tmp_path / "model.pt.ep0")
    t.close()


@pytest.mark.parametrize("mode", ["sp", "pp", "model_parallel_size=2"])
def test_sharding_other_than_dp_raises(tmp_path, mode):
    """Sequence, pipeline and tensor parallelism wait for ROADMAP item 21b (dp and fsdp:
    ``tests/test_torch_parallel.py``)."""
    from funasr_tpu_torch.bin.train import main
    from funasr_tpu_torch.train_utils.trainer import Trainer
    model = PortStandIn(np.ones(4, np.float32))
    with pytest.raises(NotImplementedError, match="item 21b"):
        if mode.startswith("model_parallel_size"):
            main(model=str(tmp_path), device="cpu", model_parallel_size=2)
        else:
            Trainer(model, torch.optim.SGD(model.parameters(), lr=0.1),
                    output_dir=str(tmp_path), sharding=mode, use_tensorboard=False)


def test_train_cli_cpu_end_to_end(tmp_path):
    """data_tools scp2jsonl, then the train CLI as finetune.sh runs them, ++device=cpu;
    the averaged checkpoint decodes through AutoModel(model=<output dir>)."""
    d = str(tmp_path)
    env = dict(os.environ, PYTHONPATH=REPO)
    jsonl = {}
    for split, n, seed in (("train", 6, 0), ("val", 2, 1)):
        scp, txt = write_wavs(d, n, seed, split)
        jsonl[split] = os.path.join(d, f"{split}.jsonl")
        subprocess.run([sys.executable, "-m", "funasr_tpu_torch.bin.data_tools", "scp2jsonl",
                        f'++scp_file_list=["{scp}","{txt}"]', '++data_type_list=["source","target"]',
                        f"++jsonl_file_out={jsonl[split]}"], check=True, env=env, cwd=d,
                       capture_output=True)
    os.makedirs(os.path.join(d, "model"))
    model = _port_model_dir(os.path.join(d, "model"), sampling_ratio=0.75)
    out = os.path.join(d, "exp")
    run = subprocess.run(
        [sys.executable, "-m", "funasr_tpu_torch.bin.train", f"++model={model}", "++device=cpu",
         f"++train_data_set_list={jsonl['train']}", f"++valid_data_set_list={jsonl['val']}",
         "++dataset_conf.batch_size=600", "++dataset_conf.batch_type=token",
         "++optim_conf.lr=0.0002", "++train_conf.max_epoch=2", "++train_conf.log_interval=1",
         "++train_conf.avg_nbest_model=2", "++train_conf.use_tensorboard=False",
         f"++output_dir={out}"], env=env, cwd=d, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert os.path.exists(os.path.join(out, "model.pt.avg"))
    logs = [json.loads(line) for line in open(os.path.join(out, "train.log.jsonl"))]
    assert logs and all(np.isfinite(x["loss"]) for x in logs if "validate" not in x)
    from funasr_tpu_torch import AutoModel
    am = AutoModel(model=out, init_param=os.path.join(out, "model.pt.avg"), device="cpu")
    res = am.generate(input=[os.path.join(d, "val0.wav")])
    assert res[0]["key"] == "val0" and isinstance(res[0]["text"], str)


NEW_MODULES = [
    "funasr_tpu_torch.bin.train", "funasr_tpu_torch.bin.data_tools",
    "funasr_tpu_torch.train_utils.trainer", "funasr_tpu_torch.train_utils.train_step",
    "funasr_tpu_torch.train_utils.misc", "funasr_tpu_torch.train_utils.average_nbest_models",
    "funasr_tpu_torch.optimizers", "funasr_tpu_torch.schedulers",
    "funasr_tpu_torch.datasets.dataloader_entry",
    "funasr_tpu_torch.datasets.audio_datasets.datasets",
    "funasr_tpu_torch.datasets.audio_datasets.samplers",
    "funasr_tpu_torch.datasets.audio_datasets.index_ds",
    "funasr_tpu_torch.datasets.audio_datasets.preprocessor",
    "funasr_tpu_torch.losses.label_smoothing_loss", "funasr_tpu_torch.losses.ctc",
    "funasr_tpu_torch.losses.cr_ctc", "funasr_tpu_torch.models.specaug.specaug",
    "funasr_tpu_torch.models.normalize.normalize", "funasr_tpu_torch.parallel.sharding",
    "funasr_tpu_torch.parallel.dryrun"]


def test_new_modules_import_without_jax():
    code = ("import importlib, sys\n"
            f"for m in {NEW_MODULES!r}:\n    importlib.import_module(m)\n"
            "from funasr_tpu_torch.register import tables\n"
            "assert 'SpecAugLFR' in tables.specaug_classes and 'adam' in tables.optim_classes\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'funasr_tpu.'))]\n"
            "assert not bad, bad[:5]\n")
    run = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]


# --------------------------------------------------------------------------- the copies

def _tool_pair(name):
    from funasr_tpu.bin import data_tools as jax_tools
    from funasr_tpu_torch.bin import data_tools as port_tools
    return getattr(port_tools, name), getattr(jax_tools, name)


def _read(path):
    with open(path, encoding="utf-8") as f:
        return f.read()


@pytest.mark.parametrize("tool", ["jsonl2scp", "scp2len", "tokenize_text", "vocabulary",
                                  "sensevoice2jsonl"])
def test_data_tools_match_jax(corpus, tmp_path, tool):
    d = corpus["dir"]
    scp, txt = os.path.join(d, "train_wav.scp"), os.path.join(d, "train_text.txt")
    outs = []
    for side, fn in zip(("port", "jax"), _tool_pair(
            "tokenize_text" if tool == "vocabulary" else tool)):
        out = str(tmp_path / f"{side}.out")
        if tool == "jsonl2scp":
            fn(corpus["train"], out, data_type="target")
        elif tool == "scp2len":
            fn(scp, out)
        elif tool == "tokenize_text":
            fn(txt, out, field="2-")
        elif tool == "vocabulary":
            fn(txt, out, field="2-", write_vocabulary=True, vocabulary_size=20,
               add_symbol=["<blank>:0", "<s>:1"])
        else:
            fn([scp, txt], ["source", "target"], out, lid="zh")
        outs.append(_read(out))
    assert outs[0] == outs[1] and outs[0]


def _parse_mvn(path):
    """An am.mvn's (shift, scale) vectors."""
    return [np.array(block.split("]")[0].split(), np.float64)
            for block in _read(path).split("<LearnRateCoef> 0 [")[1:]]


def test_compute_cmvn_matches_jax(corpus, tmp_path):
    """The port's fbank + LFR on the CPU (``device="cpu"``) against the JAX package's: the
    am.mvn shift (the negated mean) within 1e-5 relative, the scale within 1e-3 relative:
    the features agree to ~1e-6, and var = E[x^2] - mean^2 cancels ~2.5 digits (log-mel
    values near 15 with variances near 1)."""
    port, jax_fn = _tool_pair("compute_cmvn")
    port(corpus["train"], str(tmp_path / "port.mvn"), dim=560, device="cpu")
    jax_fn(corpus["train"], str(tmp_path / "jax.mvn"), dim=560)
    (shift, scale), (jshift, jscale) = (_parse_mvn(tmp_path / "port.mvn"),
                                        _parse_mvn(tmp_path / "jax.mvn"))
    np.testing.assert_allclose(shift, jshift, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(scale, jscale, rtol=1e-3)


@pytest.mark.cuda
def test_compute_cmvn_runs_on_the_card_by_default(corpus, tmp_path, monkeypatch):
    """``compute_cmvn`` with no device takes the card (its fbank and LFR launch there) and
    agrees with the CPU run within the tolerances of the JAX comparison above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from funasr_tpu_torch.bin.data_tools import compute_cmvn
    from funasr_tpu_torch.ops import fbank as fbank_mod
    devices = []
    fbank = fbank_mod.fbank

    def spy(waveform, **kwargs):
        devices.append(waveform.device.type)
        return fbank(waveform, **kwargs)

    monkeypatch.setattr(fbank_mod, "fbank", spy)
    compute_cmvn(corpus["train"], str(tmp_path / "card.mvn"), dim=560)
    monkeypatch.setattr(fbank_mod, "fbank", fbank)
    compute_cmvn(corpus["train"], str(tmp_path / "cpu.mvn"), dim=560, device="cpu")
    assert devices and set(devices) == {"cuda"}
    (shift, scale), (cshift, cscale) = (_parse_mvn(tmp_path / "card.mvn"),
                                        _parse_mvn(tmp_path / "cpu.mvn"))
    np.testing.assert_allclose(shift, cshift, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(scale, cscale, rtol=1e-3)


def test_preprocessors_and_rank_split_match_jax(corpus):
    from funasr_tpu.datasets.audio_datasets import index_ds as jax_index
    from funasr_tpu.datasets.audio_datasets import preprocessor as jax_pre
    from funasr_tpu_torch.datasets.audio_datasets import index_ds, preprocessor
    wav = np.random.default_rng(0).standard_normal(16000).astype(np.float32)
    for seed in range(4):
        a = preprocessor.SpeedPerturb()(wav, np.random.default_rng(seed))
        b = jax_pre.SpeedPerturb()(wav, np.random.default_rng(seed))
        assert np.array_equal(a, b)
    text = "你好，世界。Hello, world!"
    assert (preprocessor.TextPreprocessRemovePunctuation()(text)
            == jax_pre.TextPreprocessRemovePunctuation()(text))
    for rank in range(3):
        a = index_ds.IndexDSJsonlRankSplit(corpus["train"], rank=rank, world_size=3)
        b = jax_index.IndexDSJsonlRankSplit(corpus["train"], rank=rank, world_size=3)
        assert a.contents == b.contents


def test_misc_utilities(tmp_path):
    from funasr_tpu_torch.train_utils.misc import (add_gradient_noise, load_pretrained_model,
                                                   model_summary, set_all_random_seed)
    g = set_all_random_seed(3)
    assert torch.equal(torch.rand(2, generator=g), torch.rand(2, generator=torch.Generator()
                                                                 .manual_seed(3)))
    model = PortStandIn(np.ones(4, np.float32))
    assert "TOTAL" in model_summary(model)
    src = PortStandIn(np.full(4, 2.0, np.float32))
    sd = {"old." + k: v for k, v in src.state_dict().items()}
    torch.save({"state_dict": sd}, tmp_path / "ckpt.pt")
    load_pretrained_model(model, str(tmp_path / "ckpt.pt"), scope_map=["old.", ""],
                          excludes=["unused"])
    assert torch.equal(model.w.detach(), torch.full((4,), 2.0))
    assert torch.equal(model.unused.detach(), torch.ones(2))
    model.w.grad = torch.zeros(4)
    add_gradient_noise(model, step=0, eta=1.0, generator=torch.Generator().manual_seed(0))
    assert model.w.grad.abs().sum() > 0
