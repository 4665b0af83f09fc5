"""MossFormer of the PyTorch port against the JAX package (CPU), at a small width (32
channels, 2 blocks, group 16, qk 16, expansion 4, 2 speakers), the same weights in both
packages (the port's seeded init through ``convert_state_dict``; ``params_from_jax``
back). Limits:

* ``separate`` within 2e-4 of max |y| on waves whose frame count S is not a multiple of
  the group (the pad-to-group path and its zeroed padded keys), and on one where it is;
  ``inference`` likewise, directly and through ``AutoModel.generate``;
* ``FFConvM``'s conv on ``fsmn_memory_ref`` at k 17, pads 8 / 8 against the JAX
  package's ``_dwconv_apply`` plus the residual within 1e-6 of max |y|, and its three
  calls a block at C = expansion x d, qk and d (a recording ``fsmn_memory``);
* the SI-SNR PIT loss within 1e-5 relative and every gradient within 1e-4 relative L2
  of ``jax.jit(jax.value_and_grad(forward_jit))``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import funasr_tpu  # noqa: F401 (fills the JAX tables)
from funasr_tpu.convert.torch_to_jax import convert_state_dict
from funasr_tpu.models.mossformer import model as jmoss
from funasr_tpu.register import tables as jtables
from funasr_tpu_torch import AutoModel, tables
from funasr_tpu_torch.convert import params_from_jax
from funasr_tpu_torch.models.mossformer import model as pmoss
from funasr_tpu_torch.ops.fsmn import fsmn_memory_ref
from torch_parity_util import _write_config, t, to_jax
from torch_parity_util import one_torch_thread  # noqa: F401 (autouse)

CONF = dict(in_channels=32, out_channels=32, num_blocks=2, group_size=16, query_key_dim=16,
            expansion_factor=4.0, num_spks=2)
TOL = 2e-4
LOSS_RTOL, GRAD_REL_L2 = 1e-5, 1e-4


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.max(np.abs(got - want)) <= tol * max(np.max(np.abs(want)), 1e-30)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def pair():
    pt = tables.model_classes["MossFormer"](**CONF, generator=torch.Generator().manual_seed(0))
    jm = jtables.model_classes["MossFormer"](**CONF)
    tree = jax.tree_util.tree_map(np.asarray, convert_state_dict(pt.state_dict(), jm,
                                                                 "MossFormer"))
    return pt.eval(), jm, tree


def mixtures(seed=1, b=2, n=1200):
    return (np.random.default_rng(seed).standard_normal((b, n)) * 0.1).astype(np.float32)


def test_state_dict_round_trip(pair):
    pt, _, tree = pair
    back = params_from_jax(tree, pt)
    for name, tensor in pt.state_dict().items():
        assert torch.equal(back[name], tensor), name


@pytest.mark.parametrize("n", [1200, 1032], ids=["S149", "S128"])
def test_separate_matches_jax(pair, n):
    pt, jm, tree = pair
    wav = mixtures(n=n)
    s = (n - 16) // 8 + 1
    assert (s % CONF["group_size"] != 0) == (n == 1200)
    with torch.inference_mode():
        got = pt.separate(t(wav))
    want = jax.jit(jm.separate)(to_jax(tree), jnp.asarray(wav))
    for g, w in zip(got, want):
        close(g.numpy(), w)


def test_ffconvm_conv_is_fsmn_memory_at_k17(pair):
    rng = np.random.default_rng(2)
    h = rng.standard_normal((2, 45, 24)).astype(np.float32)
    w = (rng.uniform(-1, 1, (17, 24)) / np.sqrt(17)).astype(np.float32)  # JAX (K, C)
    want = jnp.asarray(h) + jmoss._dwconv_apply({"w": jnp.asarray(w)}, jnp.asarray(h), 17)
    got = fsmn_memory_ref(t(h), torch.from_numpy(w.T.copy())[:, None, :], None, 8, 8)
    close(got.numpy(), want, 1e-6)
    pt = pair[0]
    calls = []
    original = pmoss.fsmn_memory
    def recording(x, w, m, left, right):
        calls.append((x.shape[-1], w.shape[-1], m, left, right))
        return original(x, w, m, left, right)

    pmoss.fsmn_memory = recording
    try:
        with torch.inference_mode():
            pt.separate(t(mixtures(n=400)))
    finally:
        pmoss.fsmn_memory = original
    d, qk = CONF["out_channels"], CONF["query_key_dim"]
    assert calls == [(4 * d, 17, None, 8, 8), (qk, 17, None, 8, 8),
                     (d, 17, None, 8, 8)] * CONF["num_blocks"]


def test_loss_and_grads_match_jax(pair):
    pt, jm, tree = pair
    rng = np.random.default_rng(3)
    src = (rng.standard_normal((2, 2, 1000)) * 0.1).astype(np.float32)
    mix = src.sum(1)

    def loss_fn(p):
        loss, stats, _ = jm.forward_jit(p, jnp.asarray(mix), None, jnp.asarray(src))
        return loss, stats

    (_, jstats), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(to_jax(tree))
    pt.train()
    pt.zero_grad()
    loss, stats, weight = pt(t(mix), None, t(src))
    loss.backward()
    pt.eval()
    assert weight == 2 and set(stats) == set(jstats)
    for k, v in jstats.items():
        assert abs(float(stats[k].detach()) - float(v)) <= LOSS_RTOL * abs(float(v)), k
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jg), pt)
    for n, p in pt.named_parameters():
        assert rel_l2(p.grad.numpy(), want[n].numpy()) <= GRAD_REL_L2, n


def test_inference_and_automodel_match_jax(pair, tmp_path):
    pt, jm, tree = pair
    wavs = [mixtures(4, 1, 1500)[0], mixtures(5, 1, 900)[0]]
    want, _ = jm.inference(to_jax(tree), wavs, key=["a", "b"])
    got, _ = pt.inference(wavs, key=["a", "b"])
    d = str(tmp_path)
    torch.save(pt.state_dict(), os.path.join(d, "model.pt"))
    _write_config(d, dict(model="MossFormer", model_conf=CONF))
    res = AutoModel(model=d, device="cpu", log_level="WARNING").generate(input=wavs,
                                                                         batch_size=2)
    assert [r["key"] for r in got] == ["a", "b"] and len(res) == 2
    for rows in (got, res):
        for r, w in zip(rows, want):
            assert len(r["value"]) == 2
            for g_, w_ in zip(r["value"], w["value"]):
                close(g_, w_)
