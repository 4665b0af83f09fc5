"""EEND-OLA of the PyTorch port against the JAX package (CPU), at a small width (2 layers
of 32 units x 4 heads, FFN 64, up to 8 speakers, the mel23 input of 345), the same
weights in both packages (the port's seeded init through ``convert_state_dict``;
``params_from_jax`` back). Limits:

* the encoder's output and the attractor / existence probabilities within 2e-4 of max
  |y|, a row of length 0 among them (it averages V in both: the kernel's -1e30 and the
  JAX package's -1e9 give one softmax);
* ``estimate_sequential``'s decisions equal, with the speaker count found and given;
  ``inference`` segments (ms) equal, directly and through ``AutoModel.generate`` on a
  model dir whose frontend is ``WavFrontendMel23``;
* ``forward``'s loss and its three stats within 1e-5 relative, every gradient within
  1e-4 relative L2 of ``jax.jit(jax.value_and_grad(forward_jit))`` (the key projections'
  biases, whose gradient is 0 in exact arithmetic (a softmax is shift-invariant), held
  under 1e-6 of the global gradient norm in both);
* the power-set tables and the segment builder as copies of the JAX functions, and an
  OOV frame carrying the previous decision as in the JAX package.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import funasr_tpu  # noqa: F401 (fills the JAX tables)
from funasr_tpu.convert.torch_to_jax import convert_state_dict
from funasr_tpu.frontends.mel23 import WavFrontendMel23 as JaxMel23
from funasr_tpu.models.eend import model as jeend
from funasr_tpu.register import tables as jtables
from funasr_tpu_torch import AutoModel, tables
from funasr_tpu_torch.convert import params_from_jax
from funasr_tpu_torch.models.eend import model as peend
from torch_parity_util import _write_config, t, to_jax
from torch_parity_util import one_torch_thread  # noqa: F401 (autouse)

CONF = dict(input_size=345, n_units=32, max_n_speaker=8,
            encoder_conf=dict(n_layers=2, e_units=64, h=4))
FRONTEND = dict(fs=8000, frame_length=200, frame_shift=80, lfr_m=7, lfr_n=10)
TOL = 2e-4
LOSS_RTOL, GRAD_REL_L2, ZERO_SHARE = 1e-5, 1e-4, 1e-6


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.max(np.abs(got - want)) <= tol * max(np.max(np.abs(want)), 1e-30)


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def pair():
    pt = tables.model_classes["EENDOLA"](**CONF, generator=torch.Generator().manual_seed(0))
    jm = jtables.model_classes["EENDOLA"](**CONF)
    tree = jax.tree_util.tree_map(np.asarray, convert_state_dict(pt.state_dict(), jm,
                                                                 "DiarEENDOLA"))
    return pt.eval(), jm, tree


def feats(seed=1, b=3, t=40):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, t, 345)).astype(np.float32)


def test_state_dict_round_trip(pair):
    pt, _, tree = pair
    back = params_from_jax(tree, pt)
    for name, tensor in pt.state_dict().items():
        assert torch.equal(back[name], tensor), name


def test_encoder_and_attractors_match_jax_with_a_zero_length_row(pair):
    pt, jm, tree = pair
    x, lens = feats(), np.asarray([40, 23, 0], np.int32)
    with torch.inference_mode():
        emb, _ = pt.enc(t(x), t(lens))
        probs, exist, _ = pt.activities(t(x), t(lens))
    p = to_jax(tree)
    want_emb, _ = jax.jit(jm.encoder.__call__)(p["encoder"], jnp.asarray(x), jnp.asarray(lens))
    want_probs, want_exist, _ = jax.jit(jm.activities)(p, jnp.asarray(x), jnp.asarray(lens))
    close(emb.numpy(), want_emb)
    close(emb[2].numpy(), np.asarray(want_emb)[2])  # the length-0 row on its own
    close(probs.numpy(), want_probs)
    close(exist.numpy(), want_exist)
    with torch.inference_mode():  # no lengths: every key valid
        close(pt.enc(t(x))[0].numpy(), jm.encoder(p["encoder"], jnp.asarray(x))[0])


@pytest.mark.parametrize("n_speakers", [None, 3])
def test_estimate_sequential_decisions_equal(pair, n_speakers):
    pt, jm, tree = pair
    x, lens = feats(2), np.asarray([40, 31, 12], np.int32)
    got = pt.estimate_sequential(t(x), t(lens), n_speakers=n_speakers)
    want = jm.estimate_sequential(to_jax(tree), jnp.asarray(x), jnp.asarray(lens),
                                  n_speakers=n_speakers)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_oov_frames_carry_the_previous_decision_as_jax(pair):
    """With the OOV label's bias raised, some frames' power-set argmax is OOV: each takes
    the frame before it (frame 0 label 0) in both packages."""
    pt, jm, tree = pair
    oov = pt.mapping_dict["oov"]
    x, lens = feats(6), np.asarray([40, 33, 20], np.int32)
    with torch.inference_mode():
        emb, _ = pt.enc(t(x), t(lens))
        att, _ = pt._attractors(emb, pt.max_n_speaker)
        logits = torch.cat(pt.power_logits(emb, att, lens.tolist(), [3, 3, 3]))
    top2 = logits.topk(2, dim=-1).values
    lift = float((top2[:, 0] - logits[:, oov]).median())  # about half the frames go OOV
    pt2 = copy.deepcopy(pt)
    with torch.no_grad():
        pt2.output_layer.bias[oov] += lift
    tree2 = copy.deepcopy(tree)
    tree2["output_layer"]["b"][oov] += lift
    with torch.inference_mode():
        emb2, _ = pt2.enc(t(x), t(lens))
        preds = torch.cat(pt2.power_logits(emb2, att, lens.tolist(), [3, 3, 3])).argmax(-1)
    assert 0 < int((preds == oov).sum()) < len(preds)
    got = pt2.estimate_sequential(t(x), t(lens), n_speakers=3)
    want = jm.estimate_sequential(to_jax(tree2), jnp.asarray(x), jnp.asarray(lens),
                                  n_speakers=3)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def mel_waves(seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in (48000, 36000)]


def test_inference_segments_equal(pair, tmp_path):
    pt, jm, tree = pair
    wavs = mel_waves()
    fe, jfe = tables.frontend_classes["WavFrontendMel23"](**FRONTEND), JaxMel23(**FRONTEND)
    got, _ = pt.inference(wavs, key=["a", "b"], frontend=fe, fs=8000)
    want, _ = jm.inference(to_jax(tree), wavs, key=["a", "b"], frontend=jfe, fs=8000)
    assert got == want
    assert any(r["value"] for r in want)  # the seeded model finds segments
    d = str(tmp_path)
    torch.save(pt.state_dict(), os.path.join(d, "model.pt"))
    _write_config(d, dict(model="EENDOLA", model_conf={k: v for k, v in CONF.items()
                                                       if k != "encoder_conf"},
                          encoder="EENDOLATransformerEncoder",
                          encoder_conf=CONF["encoder_conf"], frontend="WavFrontendMel23",
                          frontend_conf=FRONTEND))
    am = AutoModel(model=d, device="cpu", log_level="WARNING")
    res = am.generate(input=wavs, batch_size=2, fs=8000)
    assert [r["value"] for r in res] == [r["value"] for r in want]
    assert [r["n_speakers"] for r in res] == [r["n_speakers"] for r in want]


def test_loss_stats_and_grads_match_jax(pair):
    pt, jm, tree = pair
    rng = np.random.default_rng(4)
    x, lens = feats(5, b=2, t=30), np.asarray([30, 22], np.int32)
    labels = (rng.random((2, 30, 3)) > 0.6).astype(np.float32)
    labels[1, :, 2] = 0.0  # a speaker silent throughout

    def loss_fn(p):
        loss, stats, _ = jm.forward_jit(p, jnp.asarray(x), jnp.asarray(lens),
                                        jnp.asarray(labels), None)
        return loss, stats

    (jl, jstats), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(to_jax(tree))
    pt.train()
    pt.zero_grad()
    loss, stats, weight = pt(t(x), t(lens), t(labels))
    loss.backward()
    pt.eval()
    assert weight == 2 and set(stats) == set(jstats)
    for k, v in jstats.items():
        got = float(stats[k].detach())
        assert abs(got - float(v)) <= LOSS_RTOL * max(abs(float(v)), 1e-6), k
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jg), pt)
    floor = ZERO_SHARE * np.sqrt(sum(float((w ** 2).sum()) for w in want.values()))
    for n, p in pt.named_parameters():
        if "linearK.bias" in n:
            assert max(np.linalg.norm(p.grad.numpy()), np.linalg.norm(want[n])) <= floor, n
        else:
            assert rel_l2(p.grad.numpy(), want[n].numpy()) <= GRAD_REL_L2, n


def test_power_tables_and_oov_carry_are_the_jax_ones():
    for s, o in ((8, 3), (4, 2)):
        got, want = peend.generate_mapping_dict(s, o), jeend.generate_mapping_dict(s, o)
        assert got == want
        assert np.array_equal(peend.powerlabel_table(got, s), jeend.powerlabel_table(want, s))
        assert np.array_equal(peend.label_to_bits_table(got, s),
                              jeend.label_to_bits_table(want, s))
    act = np.zeros((6, 2), np.float32)
    act[1:3, 0] = act[2:, 1] = 1
    assert peend.activity_segments(act, 100) == [[0, 100, 300], [1, 200, 600]]
