"""The depthwise conv's backward in the PyTorch port (``ops/fsmn.py``): the plain versions
of its input gradient (``depthwise_conv1d_bwd_input_ref``: the forward's plain version on
dout, taps reversed, pads swapped, times the input mask) and of its weight and bias
gradients (``depthwise_conv1d_bwd_weight_ref``: the explicit sums in tap order) against
autograd through ``depthwise_conv1d_ref`` and against ``jax.grad`` of the JAX package's
``depthwise_conv1d_apply``, at each (k, left) of the slice: the Conformer's k 15 / 7, the
chunk conformer's causal k 15 / 14, the E-Branchformer's merge conv k 3 / 1 and the cgMLP
gate's k 31 / 15, masked and not, with a bias and without. The CUDA kernels' walk and plan
are emulated on the CPU (``_depthwise_dw_like_the_kernel``, ``depthwise_dw_plan``); the
kernels themselves run in ``test_torch_depthwise_chip.py`` on the card. Limits: dx within
1e-6 of max |dx| (the same products summed in another order), dw and db within 1e-5
relative L2 (fp32 sums over B T rows in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funasr_tpu.core import layers as jlayers
from funasr_tpu_torch.ops.fsmn import (DEPTHWISE_DW_VEC, depthwise_conv1d,
                                       depthwise_conv1d_bwd_input_ref,
                                       depthwise_conv1d_bwd_weight_ref, depthwise_conv1d_ref,
                                       depthwise_dw_plan)

SIGNATURES = [(15, 7), (15, 14), (3, 1), (31, 15)]
DX_TOL = 1e-6
DW_REL_L2 = 1e-5


def rel_l2(got, want):
    return ((got - want).norm() / want.norm()).item()


def inputs(k, masked, bias, seed=0, b=3, t=37, c=12):
    rng = np.random.default_rng(seed + k)
    x, dout = (torch.from_numpy(rng.standard_normal((b, t, c), dtype=np.float32))
               for _ in range(2))
    w = torch.from_numpy(rng.uniform(-0.5, 0.5, (c, 1, k)).astype(np.float32))
    bv = torch.from_numpy(rng.standard_normal(c).astype(np.float32)) if bias else None
    mask = (torch.arange(t)[None] < torch.tensor([t, 25, 6])[:, None]) if masked else None
    return x, dout, w, bv, mask


def autograd_grads(x, dout, w, bv, mask, left, right):
    leaves = [x.clone().requires_grad_(), w.clone().requires_grad_()]
    if bv is not None:
        leaves.append(bv.clone().requires_grad_())
    out = depthwise_conv1d_ref(leaves[0], leaves[1], leaves[2] if bv is not None else None,
                               mask, left, right)
    grads = torch.autograd.grad(out, leaves, dout)
    return grads[0], grads[1].reshape(w.shape[0], -1), grads[2] if bv is not None else None


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("k,left", SIGNATURES)
def test_plain_versions_match_autograd(k, left, masked, bias):
    x, dout, w, bv, mask = inputs(k, masked, bias)
    right = k - 1 - left
    want_dx, want_dw, want_db = autograd_grads(x, dout, w, bv, mask, left, right)
    dx = depthwise_conv1d_bwd_input_ref(dout, w, mask, left, right)
    dw, db = depthwise_conv1d_bwd_weight_ref(x, dout, mask, left, right)
    assert (dx - want_dx).abs().max() <= DX_TOL * want_dx.abs().max()
    assert rel_l2(dw, want_dw) <= DW_REL_L2
    if bias:
        assert rel_l2(db, want_db) <= DW_REL_L2
    if masked:  # no gradient reaches a masked input row
        assert not dx[2, 6:].any()


@pytest.mark.parametrize("k,left", SIGNATURES)
def test_wrapper_gradients_on_the_cpu_match_jax(k, left):
    """``depthwise_conv1d`` on CPU tensors (autograd through the plain version) against
    ``jax.grad`` of ``depthwise_conv1d_apply`` over the masked input."""
    x, dout, w, bv, mask = inputs(k, True, True, seed=1)
    right = k - 1 - left
    xs, ws, bs = (a.clone().requires_grad_() for a in (x, w, bv))
    depthwise_conv1d(xs, ws, bs, mask, left, right).backward(dout)
    m = jnp.asarray(mask.numpy())[..., None]

    def f(xj, wj, bj):
        y = jlayers.depthwise_conv1d_apply({"w": wj, "b": bj}, xj * m, left_pad=left,
                                           right_pad=right)
        return jnp.sum(y * jnp.asarray(dout.numpy()))

    gx, gw, gb = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x.numpy()),
                                                jnp.asarray(w[:, 0].T.numpy()),
                                                jnp.asarray(bv.numpy()))
    np.testing.assert_allclose(xs.grad.numpy(), np.asarray(gx), atol=DX_TOL * 10)
    assert rel_l2(ws.grad[:, 0], torch.from_numpy(np.asarray(gw).T.copy())) <= DW_REL_L2
    assert rel_l2(bs.grad, torch.from_numpy(np.array(gb))) <= DW_REL_L2


def _depthwise_dw_like_the_kernel(x, dout, mask, left, right, rows):
    """``csrc/fsmn.cu``'s vector weight-gradient kernel in its plain mode, in fp32: blocks
    of 4 chunks of ``rows`` flat (b, t) rows; a chunk's walk loads x row c0 - left + i at
    step i into slot i % k and, from step k - 1 on, adds g row r (never masked) times the
    window (tap j: slot (i + 1 + j) % k), skipping taps whose x row is masked or outside
    r's utterance, and g row r itself to the bias row; the chunks' sums added in order
    into a block's partial, the partials in block order -> ((C, k), (C,))."""
    b, t, c = x.shape
    k = left + right + 1
    n = b * t
    xf, gf = x.reshape(n, c), dout.reshape(n, c)
    valid = torch.ones(n, dtype=torch.bool) if mask is None else mask.reshape(n)
    blocks = []
    for r_0 in range(0, n, 4 * rows):
        r_1 = min(r_0 + 4 * rows, n)
        sums = []
        for c0 in range(r_0, r_0 + 4 * rows, rows):
            c1 = min(c0 + rows, r_1)
            acc = torch.zeros(k + 1, c)
            window = [torch.zeros(c) for _ in range(k)]
            for i in range(c1 - c0 + k - 1 if c1 > c0 else 0):
                f = c0 - left + i
                window[i % k] = xf[f] if 0 <= f < n else torch.zeros(c)
                if i < k - 1:
                    continue
                r = c0 + i - (k - 1)
                for j in range(k):
                    if 0 <= r % t + j - left < t and valid[r + j - left]:
                        acc[j] += gf[r] * window[(i + 1 + j) % k]
                acc[k] += gf[r]
            sums.append(acc)
        blocks.append(((sums[0] + sums[1]) + sums[2]) + sums[3])
    total = blocks[0]
    for part in blocks[1:]:
        total = total + part
    return total[:k].T, total[k]


@pytest.mark.parametrize("k,left,rows,masked", [
    (15, 7, 7, True),    # chunks ending inside utterances and across a boundary
    (15, 14, 4, True),   # the causal conv: every tap at or before its row
    (3, 1, 16, False),   # a chunk across two boundaries
    (31, 15, 5, True),   # the window longer than an utterance's tail
])
def test_kernel_walk_matches_plain_version(k, left, rows, masked):
    x, dout, _, _, mask = inputs(k, masked, False, seed=2, t=20, c=8)
    right = k - 1 - left
    want_dw, want_db = depthwise_conv1d_bwd_weight_ref(x, dout, mask, left, right)
    dw, db = _depthwise_dw_like_the_kernel(x, dout, mask, left, right, rows)
    assert rel_l2(dw, want_dw) <= DW_REL_L2 / 10
    assert rel_l2(db, want_db) <= DW_REL_L2 / 10


@pytest.mark.parametrize("b,t,c,k,left,plan", [
    # the Conformer recipe's batch (16 x 374, C 256): 4 channels a thread, 2 groups
    (16, 374, 256, 15, 7, (4, 12, (125, 16, 256))),
    (16, 374, 256, 15, 14, (4, 12, (125, 16, 256))),
    # the E-Branchformer's merge conv (C 512) and cgMLP gate (C 1,024, 2 a thread)
    (16, 374, 512, 3, 1, (4, 16, (94, 4, 512))),
    (16, 374, 1024, 31, 15, (2, 16, (94, 32, 1024))),
    # any other (k, left), or C the vectors do not tile: the generic kernel
    (16, 374, 256, 15, 0, (0, 374, (16, 16, 256))),
    (16, 374, 250, 15, 7, (0, 374, (16, 16, 250))),
])
def test_depthwise_dw_plan(b, t, c, k, left, plan):
    got = depthwise_dw_plan(b, t, c, k, left, 132)
    assert got == plan
    if got[0]:
        assert (k, left) in DEPTHWISE_DW_VEC and c % got[0] == 0
        assert got[2][0] == -(-(-(-(b * t) // got[1])) // 4)  # blocks of 4 chunks


def test_aed_train_sites_and_dw_work():
    """chip_smoke's phase 21 sites (12 forward + 12 dx + 12 dw a Conformer step, twice
    that for the E-Branchformer's two convs a block; forwards only a validation batch) and
    the weight gradient's bytes (x and dout once, the mask, dw and db) and flops."""
    import chip_smoke
    step, val = chip_smoke.aed_train_sites(12)
    assert step == dict.fromkeys(chip_smoke.DEPTHWISE_SIGNATURES, 12)
    assert val == dict(step, depthwise_conv1d_bwd_input=0, depthwise_conv1d_bwd_weight=0)
    assert chip_smoke.aed_train_sites(2, convs=2)[0]["depthwise_conv1d_bwd_weight"] == 4
    assert chip_smoke.sites_met({"a": 1, "b": 0}, {"a": 1})
    assert not chip_smoke.sites_met({"a": 1, "b": 2}, {"a": 1})
    n_bytes, n_ops = chip_smoke.depthwise_dw_work(16, 374, 256, 15, True)
    assert n_bytes == 4 * (2 * 16 * 374 * 256 + 256 * 15 + 256) + 16 * 374
    assert n_ops == 31 * 16 * 374 * 256


def test_kernels_line_carries_the_depthwise_backward_entries():
    """Phase 21 adds two kernels, the depthwise conv's backward, each with every key of
    the line at the recipe's signature, and its figures under ``aed_training`` in
    ``depthwise_conv1d``."""
    import chip_smoke
    base = dict(shape=(16, 374, 256), max_abs_err=0.0, ms=1.0, call_ms=2.0, plain_ms=3.0,
                library_ms=4.0, bound_ms=0.5, bound_by="bytes", pads=(7, 7))
    row = dict(base, launches=48)  # phase 21's rows carry their signature's launches
    record = {(name, torch.bfloat16): base for name in chip_smoke.LIBRARY_CALLS}
    call = {"flash_attention": 50, "fsmn_memory": 66, "w8a8_linear": 0}
    aed = dict(launches={"conformer": {"depthwise_conv1d": 48}}, rows={"m": base},
               main_label="m", profile={"depthwise": {}}, w8a8_rows={})
    step, _ = chip_smoke.aed_train_sites(12)
    rows = {name: {"16x374x256_k15_pads7-7": row} for name in chip_smoke.DEPTHWISE_SIGNATURES[1:]}
    fig = dict(recipe=dict(launches={k: 96 if k == "depthwise_conv1d" else 48 for k in step},
                           launches_per_step=step),
               transducer=dict(launches=dict.fromkeys(step, 60)),
               cuda_vs_cpu={"Conformer": dict(launches=dict.fromkeys(step, 2))},
               rows=rows, forward_rows={"4x300x256_k15_pads14-0_masked": row},
               main={name: "16x374x256_k15_pads7-7" for name in rows})
    fig["launches"] = {k: fig["recipe"]["launches"][k] for k in step}
    kernels = {k["name"]: k for k in chip_smoke.kernels_line(
        record, call, {"w8a8_linear": 282}, call, aed=aed, aed_training=fig)["kernels"]}
    for name in chip_smoke.DEPTHWISE_SIGNATURES[1:]:
        entry = kernels[name]
        assert {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms"} <= set(entry)
        assert entry["route"] == "cuda" and entry["launches"] == 48
        assert entry["replaces"] == "benchmarks/bench_pallas_dwconv.py:21"
        assert entry["aed_training"]["rows"] == rows[name]
    dw = kernels["depthwise_conv1d"]["aed_training"]
    assert dw["launches"] == 96 and dw["transducer_launches"] == 60
    assert set(dw["rows"]) == {"4x300x256_k15_pads14-0_masked"}


def test_relu_crossings_are_held_to_the_call_rms():
    """chip_smoke's shared ReLU pieces: the recording pass is ReLU's FFN bit for bit; a
    replay on a perturbed input counts the pre-activations that crossed 0 and the largest
    of them over the call's RMS, which ``aed_step_cuda_vs_cpu`` holds to RELU_CROSS_REL."""
    import chip_smoke
    from funasr_tpu_torch.core.layers import PositionwiseFeedForward

    g = torch.Generator().manual_seed(0)
    ff = PositionwiseFeedForward(8, 64)
    with torch.no_grad():
        for p in ff.parameters():
            p.copy_(torch.randn(p.shape, generator=g) / 8 ** 0.5)
    x = torch.randn(3, 5, 8, generator=g)
    want = ff(x)
    masks = chip_smoke.Masks()
    with chip_smoke.shared_relu_masks(masks, record=True):
        assert torch.equal(ff(x), want)
    with chip_smoke.shared_relu_masks(masks, record=False):
        assert torch.equal(ff(x), want)
    assert len(masks) == 1 and masks.crossed == 0 and masks.worst == 0.0
    # a small perturbation crosses only pre-activations near 0
    with chip_smoke.shared_relu_masks(masks, record=False):
        ff(x + 0.05 * torch.randn(x.shape, generator=g))
    assert masks.crossed > 0 and 0 < masks.worst < 0.2
    # another input's signs: crossings far from 0, over the gate
    crossed = masks.crossed
    with chip_smoke.shared_relu_masks(masks, record=False):
        ff(-x)
    assert masks.crossed > crossed + 50 and masks.worst > 1.0 > chip_smoke.RELU_CROSS_REL
    assert ff.forward.__func__ is PositionwiseFeedForward.forward  # restored
