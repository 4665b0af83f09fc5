"""data2vec of the PyTorch port against the JAX package (CPU), at a small width (a 2-layer
conv extractor of 16 channels, 2 layers of 16 x 2 heads, FFN 32, a positional conv of k
4 in 2 groups, the top 2 layers averaged), the same weights in both packages (the port's
seeded init through ``convert_state_dict``; ``params_from_jax`` back). Limits:

* ``extract_features`` in both ``extractor_mode``s within 2e-4 of max |y|, an odd frame
  count padded to ``required_seq_len_multiple`` among them;
* the pretraining loss and its stats (``target_var``, ``pred_var``, ``ema_decay``,
  ``masked_frames``) within 1e-5 relative with a fixed ``mask_indices``, each target-norm
  option and ``loss_beta`` on in one of three cases; every student gradient within 1e-4
  relative L2 of ``jax.jit(jax.value_and_grad(forward_jit))``, none reaching the teacher
  (the key projections' biases, 0 in exact arithmetic, under 1e-6 of the global norm in
  both);
* ``ema_update`` (the annealed decay, ``pos_conv`` copied through) within 1e-6 relative
  L2 of the JAX package's;
* the weight-norm positional conv: JAX's folded w -> (g, v) -> w within 1e-6, and the
  port's g v / ||v|| equal to ``convert_data2vec``'s fold within 1e-6;
* the port's span sampler by its statistics: the masked share within 4 standard errors of
  1 - (1 - p / L)^L and of the JAX sampler's own share, nothing past a row's length,
  every masked run at least L frames long away from the row's edges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import funasr_tpu  # noqa: F401 (fills the JAX tables)
from funasr_tpu.convert.torch_to_jax import convert_state_dict
from funasr_tpu.register import tables as jtables
from funasr_tpu_torch import tables
from funasr_tpu_torch.convert import params_from_jax
from torch_parity_util import t, to_jax
from torch_parity_util import one_torch_thread  # noqa: F401 (autouse)

ENC = dict(conv_feature_layers="[(16,10,5)] + [(16,3,2)]", encoder_layers=2,
           encoder_embed_dim=16, encoder_ffn_embed_dim=32, encoder_attention_heads=2,
           conv_pos=4, conv_pos_groups=2, average_top_k_layers=2)
TOL = 2e-4
LOSS_RTOL, GRAD_REL_L2, ZERO_SHARE = 1e-5, 1e-4, 1e-6


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.max(np.abs(got - want)) <= tol * max(np.max(np.abs(want)), 1e-30)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def build(seed=0, **enc):
    conf = dict(encoder_conf=dict(ENC, **enc))
    pt = tables.model_classes["data2vec"](**conf, generator=torch.Generator().manual_seed(seed))
    jm = jtables.model_classes["Data2VecPretrainModel"](**conf)
    tree = jax.tree_util.tree_map(np.asarray, convert_state_dict(pt.state_dict(), jm,
                                                                 "Data2VecPretrainModel"))
    return pt.eval(), jm, tree


@pytest.fixture(scope="module")
def pair():
    return build()


def waves(seed=1, lengths=(4000, 3115)):
    rng = np.random.default_rng(seed)
    out = np.zeros((len(lengths), max(lengths)), np.float32)
    for i, n in enumerate(lengths):
        out[i, :n] = rng.standard_normal(n) * 0.1
    return out, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("mode", ["default", "layer_norm"])
def test_features_match_jax(mode):
    pt, jm, tree = build(1, extractor_mode=mode)
    for lengths in ((4000, 3115), (3990,)):  # 399 frames: the odd count is padded
        wav, lens = waves(2, lengths)
        with torch.inference_mode():
            got, glens = pt.extract_features(t(wav), t(lens))
        want, wlens = jm.extract_features(to_jax(tree), jnp.asarray(wav), jnp.asarray(lens))
        assert np.array_equal(glens.numpy(), wlens)
        close(got.numpy(), want)
    back = params_from_jax(tree, pt)
    for name, tensor in pt.state_dict().items():
        if "pos_conv" not in name:
            assert torch.equal(back[name], tensor), name


# each target-norm option on in one case (a JAX compile a case: ~9 s on one core)
@pytest.mark.parametrize("opts", [
    dict(), dict(instance_norm_target_layer=True, layer_norm_targets=True, loss_beta=0.25),
    dict(layer_norm_target_layer=True, instance_norm_targets=True)],
    ids=["plain", "in_layer_ln_targets_beta", "ln_layer_in_targets"])
def test_loss_stats_and_grads_match_jax(opts):
    pt, jm, tree = build(2, ema_decay=0.99, ema_end_decay=0.999, ema_anneal_end_step=10,
                         **opts)
    wav, lens = waves(3)
    n_frames = int(pt.encoder.feat_extract_output_length(torch.tensor(4000)))
    mask = np.random.default_rng(4).random((2, n_frames)) < 0.4
    mask[1, int(pt.encoder.feat_extract_output_length(torch.tensor(3115))):] = False

    def loss_fn(p):
        loss, stats, _ = jm.forward_jit(p, jnp.asarray(wav), jnp.asarray(lens),
                                        mask_indices=jnp.asarray(mask), num_updates=3)
        return loss, stats

    (_, jstats), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(to_jax(tree))
    pt.train()
    pt.zero_grad()
    loss, stats, size = pt(t(wav), t(lens), mask_indices=t(mask), num_updates=3)
    loss.backward()
    pt.eval()
    assert set(stats) == set(jstats) and float(size) == mask.sum()
    for k, v in jstats.items():
        got = float(stats[k])
        assert abs(got - float(v)) <= LOSS_RTOL * max(abs(float(v)), 1e-6), k
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jg), pt)
    floor = ZERO_SHARE * np.sqrt(sum(float((w ** 2).sum()) for w in want.values()))
    for n, p in pt.named_parameters():
        if n.startswith("ema."):
            assert p.grad is None and not p.requires_grad
            assert np.abs(want[n].numpy()).max() == 0  # stop_gradient in JAX
        elif n.endswith("weight_g") or n.endswith("weight_v"):
            continue  # JAX's gradient is the folded w's: held below through the fold
        elif n.endswith("k_proj.bias"):  # 0 in exact arithmetic: a softmax is shift-invariant
            assert max(np.linalg.norm(p.grad.numpy()), np.linalg.norm(want[n])) <= floor, n
        else:
            assert rel_l2(p.grad.numpy(), want[n].numpy()) <= GRAD_REL_L2, n
    # the positional conv's gradient through the fold: d/dw mapped onto (g, v) by autograd
    conv = pt.encoder.encoder.pos_conv[0]
    w = conv.weight()
    gw = np.asarray(jg["student"]["encoder"]["pos_conv"]["w"]).transpose(2, 1, 0)
    gg, gv = torch.autograd.grad(w, (conv.weight_g, conv.weight_v),
                                 torch.from_numpy(gw.copy()))
    assert rel_l2(conv.weight_g.grad.numpy(), gg.numpy()) <= GRAD_REL_L2
    assert rel_l2(conv.weight_v.grad.numpy(), gv.numpy()) <= GRAD_REL_L2


def test_ema_update_matches_jax(pair):
    pt, jm, tree = build(3, ema_decay=0.9, ema_end_decay=0.99, ema_anneal_end_step=100)
    with torch.no_grad():  # a student that has moved away from its teacher
        for p in pt.encoder.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=torch.Generator().manual_seed(5)))
    tree = jax.tree_util.tree_map(np.asarray, convert_state_dict(pt.state_dict(), jm,
                                                                 "Data2VecPretrainModel"))
    tree["ema"] = jax.tree_util.tree_map(np.asarray, params_from_jax_teacher(pt))
    new = jax.tree_util.tree_map(np.asarray, jm.ema_update(to_jax(tree), num_updates=40))
    pt.ema_update(num_updates=40)
    want = params_from_jax(new, pt)
    for name, tensor in pt.state_dict().items():
        if name.startswith("ema.") and "pos_conv" not in name:
            assert rel_l2(tensor.numpy(), want[name].numpy()) <= 1e-6, name
    ema_w = pt.ema.pos_conv[0].weight().detach().numpy()
    assert rel_l2(ema_w, pt.encoder.encoder.pos_conv[0].weight().detach().numpy()) == 0


def params_from_jax_teacher(pt):
    """The port's current teacher as a JAX ``ema`` tree (the folded positional conv)."""
    sd = {"encoder.encoder." + k: v for k, v in pt.ema.state_dict().items()}
    d = {k: v for k, v in pt.state_dict().items() if k.startswith("encoder.")
         and not k.startswith("encoder.encoder.")}
    d.update(sd)
    jm = jtables.model_classes["Data2VecPretrainModel"](encoder_conf=ENC)
    return convert_state_dict(d, jm, "Data2VecPretrainModel")["student"]["encoder"]


def test_weight_norm_round_trip(pair):
    pt, jm, tree = pair
    jtree = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init_params)(jax.random.PRNGKey(7)))
    pt2 = build(4)[0]
    pt2.load_state_dict(params_from_jax(jtree, pt2))
    got = pt2.encoder.encoder.pos_conv[0].weight().detach().numpy().transpose(2, 1, 0)
    assert rel_l2(got, jtree["student"]["encoder"]["pos_conv"]["w"]) <= 1e-6
    fold = tree["student"]["encoder"]["pos_conv"]["w"]
    mine = pt.encoder.encoder.pos_conv[0].weight().detach().numpy().transpose(2, 1, 0)
    assert rel_l2(mine, fold) <= 1e-6
    # a FunASR checkpoint has no teacher: loading one copies the student's transformer
    sd = {k: v for k, v in pt.state_dict().items() if not k.startswith("ema.")}
    pt2.load_state_dict(sd)
    for name, tensor in pt2.ema.state_dict().items():
        assert torch.equal(tensor, pt.encoder.encoder.state_dict()[name]), name


def test_span_sampler_statistics(pair):
    pt, jm, _ = pair
    enc = pt.encoder
    b, t_len, p, span = 64, 400, enc.mask_prob, enc.mask_length
    lengths = torch.tensor([t_len - 3 * i for i in range(b)])
    g = torch.Generator().manual_seed(8)
    masks = torch.stack([enc.sample_mask(g, b, t_len) for _ in range(8)])
    share, want = masks.float().mean().item(), 1 - (1 - p / span) ** span
    jshare = float(np.mean([np.asarray(jm.encoder.sample_mask(jax.random.PRNGKey(i), b,
                                                              t_len)).mean()
                            for i in range(8)]))
    # a frame's mask is a function of span consecutive starts: about t_len / span
    # independent runs a row
    se = np.sqrt(want * (1 - want) / (masks.numel() / span))
    assert abs(share - want) <= 4 * se and abs(share - jshare) <= 6 * se
    cut = enc.sample_mask(g, b, t_len, lengths)
    assert not (cut & ~(torch.arange(t_len)[None] < lengths[:, None])).any()
    for row in masks.reshape(-1, t_len)[:64]:
        edges = torch.diff(torch.nn.functional.pad(row.int(), (1, 1))).nonzero()[:, 0]
        runs = (edges[1::2] - edges[0::2]).tolist()
        inner = [r for r, s0 in zip(runs, edges[0::2].tolist()) if 0 < s0 and s0 + r < t_len]
        assert all(r >= span for r in inner)
