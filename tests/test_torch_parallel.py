"""Data-parallel training (``funasr_tpu_torch/parallel``) at world size 2 on the CPU (gloo),
against the JAX package's step on the global batch.

Two rank processes (``torch_parallel_worker.py``, rendezvous through a file, spawned once
for the module and overlapped with the JAX oracles) run every case under dp and fsdp:

* a Paraformer (``length_normalized_loss``, ``lsm_weight`` 0.1; layers of 65,536-element
  weights, so fsdp shards each as a unit) on 4 rows whose two halves hold 17 and 7
  tokens: the loss and stats within 1e-5 relative and every gradient within 1e-4 relative
  L2 of ``jax.value_and_grad(forward_jit)`` on the global batch
  (``test_torch_train_grads.py``'s limits and CIF tie), the SGD step's weights with them;
* the odd batch of 3 rows, against JAX on the batch ``_shard_batch`` pads (the last row
  repeated);
* LLMASR2's ``forward_batch`` on a collated ``OpenAIDataset`` batch of 3 (the frontend
  in the step) against ``forward_jit_batch`` on the padded batch's features;
* ``accum_grad`` 2 with clipping that acts: each micro-batch's global gradient clipped by
  its own norm, then averaged (``optax.MultiSteps``);
* ``test_torch_trainer.py``'s step harness (Adam, clipping, a non-finite row on rank 0
  only, ``accum_grad`` 3) against the JAX ``Trainer``'s ``_step_jit``, one row a rank;
* checkpoints: a dp checkpoint resumed under fsdp and an fsdp one under dp give the same
  next step, and both hold the same keys and shapes; a validation between two steps;
* each rank's random draws its own (rank 0's those of one device); a DTensor at a kernel
  wrapper raises.

Then ``dryrun_multichip(2)``, and ``torchrun --nproc_per_node=2 -m
funasr_tpu_torch.bin.train ++device=cpu ++distributed=true ++sharding=fsdp`` on
``test_torch_trainer.py``'s corpus, its average decoding through ``AutoModel``. The card's
case is in ``test_torch_parallel_chip.py``.
"""

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import funasr_tpu.models.paraformer.cif_predictor as jax_cif
from funasr_tpu.convert.torch_to_jax import convert_paraformer, convert_state_dict
from funasr_tpu.models.paraformer.model import Paraformer as JaxParaformer
from funasr_tpu.register import tables as jtables
from funasr_tpu_torch.models.paraformer.model import Paraformer as TorchParaformer
from funasr_tpu_torch.register import tables
from test_torch_train_grads import CIF_TIE_SCALE, GRAD_REL_L2, LOSS_RTOL, batch, train_conf
from test_torch_train_llm import LLMASR_CONF, assert_grads_match, frontends, openai_batch
from test_torch_train_llm import corpus as llm_corpus  # noqa: F401 (a fixture)
from test_torch_trainer import (PARAM_ATOL, STEP_RTOL, JaxStandIn, _port_model_dir,
                                _step_batches, write_wavs)
from torch_parity_util import NANO_FRONTEND, one_torch_thread, to_jax  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
RANKS_TIMEOUT = 240  # seconds the two rank processes may take, all cases
SGD_LR = 0.1
SGD_RTOL, SGD_ATOL = 1e-4, 1e-6  # weights after an SGD step (test_torch_train_llm.py's)
ACCUM_CLIP = 1.0
# d 64 with FFNs of 1,024: every w_1 / w_2 has 65,536 elements, so each encoder and decoder
# layer is an FSDP unit of its own (parallel.sharding.layer_units)
PARA_CONF = dict(train_conf(), encoder_conf=dict(train_conf()["encoder_conf"], output_size=64,
                                                 linear_units=1024),
                 decoder_conf=dict(train_conf()["decoder_conf"], linear_units=1024),
                 predictor_conf=dict(idim=64))


def para_batch(seed, speech_lengths, text_lengths, t=40, l=8, v=41):
    rng = np.random.default_rng(seed)
    b = len(speech_lengths)
    text = np.full((b, l), -1, np.int32)
    for i, n in enumerate(text_lengths):
        text[i, :n] = rng.integers(3, v, n)
    return {"speech": rng.standard_normal((b, t, 80)).astype(np.float32),
            "speech_lengths": np.asarray(speech_lengths, np.int32), "text": text,
            "text_lengths": np.asarray(text_lengths, np.int32)}


def padded(arrays, world=WORLD):
    """The JAX trainer's ``_shard_batch`` padding: the last row repeated to a multiple of
    the data axis."""
    out = {}
    for k, v in arrays.items():
        extra = -(-v.shape[0] // world) * world - v.shape[0]
        out[k] = np.concatenate([v, np.repeat(v[-1:], extra, axis=0)]) if extra else v
    return out


def para_batches():
    speech, slen, text, tlen = batch()
    return {
        # the ranks' halves hold 8 + 7 and 3 + 2 tokens (+ eos each)
        "even": para_batch(1, [40, 36, 25, 18], [8, 7, 3, 2]),
        "odd": {"speech": speech, "speech_lengths": slen, "text": text, "text_lengths": tlen},
        "accum_a": para_batch(2, [40, 31, 22, 40], [5, 8, 2, 6]),
        "accum_b": para_batch(3, [27, 40, 35, 12], [8, 1, 6, 4])}


def spec_for(llm_batch):
    return dict(para_batches(), para_conf=PARA_CONF, cif_tie_scale=CIF_TIE_SCALE,
                accum_clip=ACCUM_CLIP, llm_conf=LLMASR_CONF, llm_batch=llm_batch,
                llm_frontend=dict(NANO_FRONTEND, cmvn_file=None),
                w0=np.array([0.5, -1.0, 2.0, 0.25], np.float32),
                standin_batches=_step_batches())


class Ranks:
    """The two rank processes: started with the module, waited on at the first read."""

    def __init__(self, tmp, spec):
        self.dir = tmp
        spec_path = os.path.join(tmp, "spec.pt")
        torch.save(spec, spec_path)
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        worker = os.path.join(REPO, "tests", "torch_parallel_worker.py")
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        self.outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(WORLD)]
        self.logs = [open(os.path.join(tmp, f"rank{r}.log"), "w") for r in range(WORLD)]
        self.procs = [subprocess.Popen(
            [sys.executable, worker, str(r), str(WORLD), init, spec_path, self.outs[r]],
            env=env, cwd=tmp, stdout=self.logs[r], stderr=subprocess.STDOUT)
            for r in range(WORLD)]
        self.t0 = time.monotonic()
        self._results = None

    def results(self):
        if self._results is None:
            try:
                for p in self.procs:
                    p.wait(timeout=max(1.0, RANKS_TIMEOUT - (time.monotonic() - self.t0)))
            finally:
                self.close()
            tails = [open(f.name).read()[-3000:] for f in self.logs]
            codes = [p.returncode for p in self.procs]
            assert codes == [0] * WORLD, (codes, tails)
            self._results = [torch.load(o, weights_only=False) for o in self.outs]
        return self._results

    def case(self, name):
        res = self.results()
        for r in res:
            assert not (isinstance(r[name], dict) and "error" in r[name]), r[name]["error"]
        return [r[name] for r in res]

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in self.logs:
            f.close()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, llm_corpus):  # noqa: F811
    r = Ranks(str(tmp_path_factory.mktemp("ranks")), spec_for(openai_batch(llm_corpus)))
    yield r
    r.close()


@pytest.fixture(scope="module")
def jax_para():
    """The JAX Paraformer, its weights from the port's seeded model, and the jitted
    value_and_grad of ``forward_jit`` (one shape: every case's batch is 4 x 40 rows)."""
    pt = TorchParaformer(**PARA_CONF, generator=torch.Generator().manual_seed(0))
    jm = JaxParaformer(**PARA_CONF)
    params = to_jax(convert_paraformer(pt.state_dict(), jm))
    sd = {k: v.detach() for k, v in pt.state_dict().items()}
    jax_fn = jax_cif.cif
    jax_cif.cif = lambda h, a, k, thr=1.0: jax_fn(h, a * CIF_TIE_SCALE, k, thr)

    def loss_fn(p, b):
        loss, stats, _ = jm.forward_jit(p, b["speech"], b["speech_lengths"], b["text"],
                                        b["text_lengths"], jax.random.PRNGKey(3))
        return loss, stats

    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    try:
        yield jm, params, sd, lambda b: vg(params, {k: jnp.asarray(v) for k, v in b.items()})
    finally:
        jax_cif.cif = jax_fn


def port_tree(jm, sd, named):
    """A port name -> array dict (gradients or weights) as the JAX tree."""
    return convert_paraformer({k: torch.from_numpy(named[k]) if k in named else v
                               for k, v in sd.items()}, jm)


def leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def leaf(tree, path):
    for k in path:
        tree = tree[k.key] if hasattr(k, "key") else tree[k.idx]
    return np.asarray(tree)


def assert_stats(got, want, keys):
    for k in keys:
        w = float(want[k])
        assert abs(got[k] - w) <= LOSS_RTOL * max(abs(w), 1.0), (k, got[k], w)


def assert_grads(jax_grads, port):
    n = 0
    for path, want in leaves(jax_grads):
        want, got = np.asarray(want), leaf(port, path)
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)
        assert rel <= GRAD_REL_L2, (jax.tree_util.keystr(path), rel)
        n += 1
    assert n > 40


def assert_weights(jax_params, port):
    for path, want in leaves(jax_params):
        np.testing.assert_allclose(leaf(port, path), np.asarray(want), rtol=SGD_RTOL,
                                   atol=SGD_ATOL, err_msg=jax.tree_util.keystr(path))


def norm(tree):
    return float(np.sqrt(sum(float(np.sum(np.square(np.asarray(g)))) for _, g in leaves(tree))))


def sgd(params, grads, lr=SGD_LR):
    return jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)


def check_global_step(ranks, jax_para, case, arrays):
    """One case's ranks against JAX on ``arrays`` (the global batch): the stats (the same
    on both ranks), the gradients and the SGD step's weights."""
    jm, params, sd, vg = jax_para
    (jl, jst), jg = vg(arrays)
    res = ranks.case(case)
    assert res[0]["stats"] == res[1]["stats"]
    st = res[0]["stats"][0]
    assert_stats(st, dict(jst, loss=jl), ("loss", "loss_att", "loss_pre", "acc", "batch_size"))
    assert abs(st["grad_norm"] - norm(jg)) <= LOSS_RTOL * norm(jg)
    assert_grads(jg, port_tree(jm, sd, res[0]["grads"]))
    assert_weights(sgd(params, jg), port_tree(jm, sd, res[0]["params"]))
    for name, w in res[1]["params"].items():
        np.testing.assert_array_equal(w, res[0]["params"][name], err_msg=name)


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
def test_step_matches_jax_global_batch(ranks, jax_para, mode):
    """4 rows, the ranks' halves of 17 and 7 target tokens: the global mean, not the mean
    of the ranks' means."""
    arrays = para_batches()["even"]
    assert arrays["text_lengths"][:2].sum() != arrays["text_lengths"][2:].sum()
    check_global_step(ranks, jax_para, f"para_{mode}", arrays)


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
def test_odd_batch_is_padded_as_shard_batch(ranks, jax_para, mode):
    speech, slen, text, tlen = batch()
    arrays = padded({"speech": speech, "speech_lengths": slen, "text": text,
                     "text_lengths": tlen})
    assert arrays["speech"].shape[0] == 4 and np.array_equal(arrays["text"][3], text[2])
    check_global_step(ranks, jax_para, f"odd_{mode}", arrays)


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
def test_accum_grad_2_clips_each_global_micro_batch(ranks, jax_para, mode):
    jm, params, sd, vg = jax_para
    spec = para_batches()
    micro = [vg(spec[k]) for k in ("accum_a", "accum_b")]
    norms = [norm(g) for _, g in micro]
    assert max(norms) > ACCUM_CLIP  # the clipping acts
    scales = [min(1.0, ACCUM_CLIP / (n + 1e-6)) for n in norms]
    mean = jax.tree_util.tree_map(lambda a, b: (a * scales[0] + b * scales[1]) / 2,
                                  micro[0][1], micro[1][1])
    res = ranks.case(f"accum_{mode}")
    for st, ((jl, _), _), n in zip(res[0]["stats"], micro, norms):
        assert abs(st["loss"] - float(jl)) <= LOSS_RTOL * abs(float(jl))
        assert abs(st["grad_norm"] - n) <= LOSS_RTOL * n
    assert_grads(mean, port_tree(jm, sd, res[0]["grads"]))
    assert_weights(sgd(params, mean), port_tree(jm, sd, res[0]["params"]))


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
def test_llm_forward_batch_matches_jax(ranks, llm_corpus, mode):  # noqa: F811
    """LLMASR2's OpenAI-format batch of 3 rows (padded to 4), the frontend in the step:
    ``forward_batch`` (registered with FSDP2 under fsdp) against ``forward_jit_batch``."""
    arrays = padded({k: v for k, v in openai_batch(llm_corpus).items()
                     if isinstance(v, np.ndarray)})
    pfe, _ = frontends()
    with torch.no_grad():
        feats, flens = pfe.forward(torch.from_numpy(arrays["speech"]),
                                   torch.from_numpy(arrays["speech_lengths"]))
    pt = tables.model_classes["LLMASR2"](**LLMASR_CONF,
                                         generator=torch.Generator().manual_seed(2))
    jm = jtables.model_classes["LLMASR2"](**LLMASR_CONF)
    params = to_jax(convert_state_dict(pt.state_dict(), jm, "FunASRNano"))
    jbatch = {"speech": jnp.asarray(feats.numpy()), "speech_lengths": jnp.asarray(flens.numpy()),
              **{k: jnp.asarray(arrays[k]) for k in ("input_ids", "labels_ids", "fbank_mask")}}

    def loss_fn(p):
        loss, stats, _ = jm.forward_jit_batch(p, jbatch)
        return loss, stats

    (jl, jst), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    res = ranks.case(f"llm_{mode}")
    assert res[0]["stats"] == res[1]["stats"]
    assert_stats(res[0]["stats"], dict(jst, loss=jl), ("loss", "loss_llm", "acc"))
    sd = {k: v.detach() for k, v in pt.state_dict().items()}

    def tree(named):
        return convert_state_dict({k: torch.from_numpy(named[k]) if k in named else v
                                   for k, v in sd.items()}, jm, "FunASRNano")

    assert assert_grads_match(jg, tree(res[0]["grads"])) >= 30
    assert_weights(sgd(params, jg), tree(res[0]["params"]))


@pytest.mark.parametrize("mode,accum_grad", [("dp", 1), ("dp", 3), ("fsdp", 1), ("fsdp", 3)])
def test_adam_steps_match_jax_trainer(ranks, tmp_path, mode, accum_grad):
    """``test_torch_trainer.py``'s harness, one row a rank: clipping by the global norm,
    the non-finite row (rank 0's alone) zeroing both ranks' update, Adam's moments."""
    from funasr_tpu.parallel.sharding import make_mesh
    from funasr_tpu.train_utils.trainer import Trainer as JaxTrainer
    jt = JaxTrainer(JaxStandIn(), optax.adam(0.05), output_dir=str(tmp_path),
                    accum_grad=accum_grad, clip_grad_norm=5.0, mesh=make_mesh(1, model=1),
                    use_tensorboard=False)
    params = {"w": jnp.asarray(np.array([0.5, -1.0, 2.0, 0.25], np.float32)),
              "unused": jnp.ones(2)}
    state = jt.tx.init(params)
    res = ranks.case(f"standin_{mode}_{accum_grad}")
    for i, b in enumerate(_step_batches()):
        params, state, jstats = jt._step_jit(params, state, b, jax.random.PRNGKey(0))
        for r in range(WORLD):
            w, unused, gn = res[r][i]
            jn = float(jstats["grad_norm"])
            assert np.isfinite(jn) == np.isfinite(gn) and (not np.isfinite(jn)
                                                          or abs(jn - gn) <= 1e-5 * jn)
            np.testing.assert_allclose(w, np.asarray(params["w"]), rtol=STEP_RTOL,
                                       atol=PARAM_ATOL)
            np.testing.assert_allclose(unused, np.asarray(params["unused"]), rtol=STEP_RTOL,
                                       atol=PARAM_ATOL)


def test_checkpoints_interchange_between_dp_and_fsdp(ranks):
    """A dp checkpoint resumed under fsdp takes the step dp took after it, and an fsdp one
    under dp the step fsdp took; both files hold the same keys, shapes and optimizer
    layout (FunASR's, whole tensors)."""
    res = ranks.case("checkpoint")
    sigs = [res[0][route]["checkpoint"] for route in ("dp_then_fsdp", "fsdp_then_dp")]
    assert sigs[0] == sigs[1] and sigs[0]["step"] == 1 and sigs[0]["epoch_step"] == 1
    assert sigs[0]["optimizer"] and all(s == sorted([("exp_avg", s[0][1]),
                                                     ("exp_avg_sq", s[0][1]), ("step", ())])
                                        for _, s in sigs[0]["optimizer"])
    for rank in res:
        for first, second in (("dp", "fsdp"), ("fsdp", "dp")):
            route = rank[f"{first}_then_{second}"]
            assert route["resumed_step"] == 1
            for name, w in route[first].items():
                np.testing.assert_array_equal(route[second][name], w, err_msg=name)
        for name, w in rank["dp_then_fsdp"]["dp"].items():
            np.testing.assert_allclose(rank["fsdp_then_dp"]["fsdp"][name], w, rtol=1e-6,
                                       atol=1e-7, err_msg=name)


def test_a_validation_between_steps_changes_nothing(ranks):
    """fsdp's no-grad forwards (a validation) leave the next step as dp's; both ranks
    report the same averages."""
    dp, fsdp = ranks.case("validate_dp"), ranks.case("validate_fsdp")
    assert dp[0]["metric"] == dp[1]["metric"] == fsdp[1]["metric"]
    assert abs(fsdp[0]["metric"]["metric"] - dp[0]["metric"]["metric"]) <= \
        LOSS_RTOL * abs(dp[0]["metric"]["metric"])
    for name, w in dp[0]["params"].items():
        np.testing.assert_allclose(fsdp[0]["params"][name], w, rtol=1e-6, atol=1e-7,
                                   err_msg=name)


def test_each_rank_draws_its_own_noise(ranks):
    from funasr_tpu_torch.train_utils.trainer import step_generator
    draws = ranks.case("noise")
    for step in range(2):
        assert not np.array_equal(draws[0][step], draws[1][step])
        one_device = torch.rand(4, generator=step_generator("cpu", 3, step)).numpy()
        np.testing.assert_array_equal(draws[0][step], one_device)


def test_a_dtensor_at_a_kernel_wrapper_raises(ranks):
    for messages in ranks.case("dtensor"):
        assert len(messages) == 2 and all(m and "DTensor reached" in m for m in messages)


def test_dryrun_multichip_2():
    from funasr_tpu_torch.parallel.dryrun import dryrun_multichip
    lines = dryrun_multichip(2, timeout=120)
    assert len(lines) == 2 and lines[0].startswith("dryrun_multichip dp(n=2)")
    assert "1/2 of their rows" in lines[1]


def test_torchrun_fsdp_cli_cpu(tmp_path):
    """The recipe's flags under torchrun at 2 CPU ranks: one log (rank 0's) of finite
    steps, the average decoding through ``AutoModel``."""
    from funasr_tpu_torch.bin.data_tools import scp2jsonl
    d = str(tmp_path)
    jsonl = {}
    for split, n, seed in (("train", 6, 0), ("val", 2, 1)):
        scp, txt = write_wavs(d, n, seed, split)
        jsonl[split] = os.path.join(d, f"{split}.jsonl")
        scp2jsonl([scp, txt], ["source", "target"], jsonl[split])
    os.makedirs(os.path.join(d, "model"))
    model = _port_model_dir(os.path.join(d, "model"))
    out = os.path.join(d, "exp")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={WORLD}", "-m", "funasr_tpu_torch.bin.train", f"++model={model}",
         "++device=cpu", "++distributed=true", "++sharding=fsdp",
         f"++train_data_set_list={jsonl['train']}", f"++valid_data_set_list={jsonl['val']}",
         "++dataset_conf.batch_size=600", "++dataset_conf.batch_type=token",
         "++optim_conf.lr=0.0002", "++train_conf.max_epoch=1", "++train_conf.log_interval=1",
         "++train_conf.avg_nbest_model=1", "++train_conf.use_tensorboard=False",
         f"++output_dir={out}"], env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        cwd=d, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    assert "process group: 2 rank(s) on gloo" in run.stderr
    logs = [json.loads(line) for line in open(os.path.join(out, "train.log.jsonl"))]
    steps = [x for x in logs if "validate" not in x]
    assert steps and [x["step"] for x in steps] == list(range(1, len(steps) + 1))
    assert all(np.isfinite(x["loss"]) for x in steps)
    from funasr_tpu_torch import AutoModel
    am = AutoModel(model=out, init_param=os.path.join(out, "model.pt.avg"), device="cpu")
    res = am.generate(input=[os.path.join(d, "val0.wav")])
    assert res[0]["key"] == "val0" and isinstance(res[0]["text"], str)
