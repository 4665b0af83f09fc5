"""The port's training loss and gradients against the JAX package's.

* ``Paraformer.forward`` (loss, stats) and every parameter's gradient against
  ``jax.value_and_grad(forward_jit)`` on the same weights (``convert_paraformer``) and
  inputs: dropout 0, SpecAug off; without the glancing sampler, with it (JAX's uniform
  draws fed to the port), with CTC at ``ctc_weight`` 0.3 and with ``predictor_bias`` 2.
  Limits: the loss within 1e-5 relative, each gradient within 1e-4 relative L2 (fp32 on
  the CPU in both; sums in other orders).
* The training CIF fires a row's last token where the alphas, rescaled to sum to the
  target count, reach it exactly: a tie that rounding decides, in another order in each
  framework (6.9999995 against 7.0). The parity cases scale the rescaled alphas by
  1 + 1e-5 in both packages alike, so that both fire it;
  ``test_cif_training_fire_tie_is_the_last_token_only`` shows what differs without that.
* ``FlashAttentionFn`` and ``FsmnMemoryFn`` by ``torch.autograd.gradcheck`` in float64
  (the CPU path: autograd through the plain versions), a length-0 row, and the identity
  the CUDA backward uses: the FSMN input gradient is the forward with reversed taps and
  swapped pads.
* On the card (``cuda``): the backward kernels against autograd through the plain
  versions, bit-equal across two runs.
* ``chip_smoke.py``'s phase 16 plan: a training step's launch sites, the flash
  backward's work, the kernels line's training entries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import funasr_tpu.models.paraformer.cif_predictor as jax_cif
import funasr_tpu_torch.models.paraformer.cif_predictor as port_cif
from funasr_tpu.convert.torch_to_jax import convert_paraformer
from funasr_tpu.models.paraformer.model import Paraformer as JaxParaformer
from funasr_tpu_torch.models.paraformer.model import Paraformer as TorchParaformer
from funasr_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref
from funasr_tpu_torch.ops.fsmn import fsmn_memory, fsmn_memory_ref
from torch_parity_util import one_torch_thread, to_jax  # noqa: F401

V = 41
B, T, L = 3, 40, 8
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
CIF_TIE_SCALE = 1 + 1e-5


def train_conf(sampling_ratio=0.0, ctc_weight=0.0, predictor_bias=1):
    return dict(
        input_size=80, vocab_size=V,
        encoder_conf=dict(output_size=32, attention_heads=4, linear_units=48, num_blocks=2,
                          dropout_rate=0.0),
        decoder_conf=dict(attention_heads=4, linear_units=48, num_blocks=2, att_layer_num=2,
                          sanm_shfit=0),
        predictor_conf=dict(idim=32), sos=1, eos=2, predictor_bias=predictor_bias,
        lsm_weight=0.1, sampling_ratio=sampling_ratio, length_normalized_loss=True,
        ctc_weight=ctc_weight)


def batch(seed=0):
    rng = np.random.default_rng(seed)
    speech = rng.standard_normal((B, T, 80)).astype(np.float32)
    speech_lengths = np.array([40, 33, 21], np.int32)
    text_lengths = np.array([6, 8, 3], np.int32)
    text = np.full((B, L), -1, np.int32)
    for i in range(B):
        text[i, :text_lengths[i]] = rng.integers(3, V, text_lengths[i])
    return speech, speech_lengths, text, text_lengths


@pytest.fixture
def cif_tie_moved(monkeypatch):
    """Both packages' training CIF with the rescaled alphas scaled by CIF_TIE_SCALE."""
    jax_fn, port_fn = jax_cif.cif, port_cif.cif
    monkeypatch.setattr(jax_cif, "cif", lambda h, a, k, thr=1.0: jax_fn(h, a * CIF_TIE_SCALE,
                                                                          k, thr))
    monkeypatch.setattr(port_cif, "cif", lambda h, a, k, thr=1.0: port_fn(h, a * CIF_TIE_SCALE,
                                                                            k, thr))


def run_both(conf, seed=0):
    pt = TorchParaformer(**conf, generator=torch.Generator().manual_seed(seed)).train()
    jm = JaxParaformer(**conf)
    params = to_jax(convert_paraformer(pt.state_dict(), jm))
    speech, slen, text, tlen = batch(seed)
    key = jax.random.PRNGKey(seed + 3)
    _, k_smp = jax.random.split(key)
    l_out = L + conf["predictor_bias"]
    uniform = np.asarray(jax.random.uniform(k_smp, (B, l_out)))

    def loss_fn(p):
        loss, stats, _ = jm.forward_jit(p, jnp.asarray(speech), jnp.asarray(slen),
                                        jnp.asarray(text), jnp.asarray(tlen), key)
        return loss, stats

    (jax_loss, jax_stats), jax_grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    loss, stats, weight = pt(torch.from_numpy(speech), torch.from_numpy(slen),
                             torch.from_numpy(text).long(), torch.from_numpy(tlen).long(),
                             sampler_uniform=torch.from_numpy(uniform.copy()))
    loss.backward()
    # a parameter the loss does not reach (the sampler's embedding without the sampler)
    # has no grad here and a zero one in JAX's tree
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in pt.named_parameters()}
    port_grads = convert_paraformer({k: grads.get(k, v) for k, v in pt.state_dict().items()},
                                    jm)
    return (float(jax_loss), jax_stats, jax_grads), (loss.item(), stats, weight, port_grads)


def leaf(tree, path):
    for k in path:
        tree = tree[k.key] if hasattr(k, "key") else tree[k.idx]
    return np.asarray(tree)


@pytest.mark.parametrize("sampling_ratio,ctc_weight,predictor_bias", [
    (0.0, 0.0, 1), (0.75, 0.0, 1), (0.75, 0.3, 1), (0.0, 0.0, 2)],
    ids=["cif", "sampler", "sampler_ctc", "bias2"])
def test_paraformer_loss_and_grads_match_jax(cif_tie_moved, sampling_ratio, ctc_weight,
                                             predictor_bias):
    conf = train_conf(sampling_ratio, ctc_weight, predictor_bias)
    (jl, jst, jg), (pl, pst, weight, pg) = run_both(conf)
    assert abs(pl - jl) <= LOSS_RTOL * abs(jl)
    for k in ("loss_att", "loss_pre", "acc", "loss") + (("loss_ctc",) if ctc_weight else ()):
        assert abs(float(pst[k]) - float(jst[k])) <= LOSS_RTOL * max(abs(float(jst[k])), 1.0), k
    assert int(weight) == int(batch()[3].sum()) + B * predictor_bias
    n = 0
    for path, want in jax.tree_util.tree_leaves_with_path(jg):
        want, got = np.asarray(want), leaf(pg, path)
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)
        assert rel <= GRAD_REL_L2, (jax.tree_util.keystr(path), rel)
        n += 1
    assert n > 40


def test_cif_training_fire_tie_is_the_last_token_only():
    """Unpatched, the two packages' training CIF may disagree on a row's last fire (the
    tie at the exact target count), and on nothing else."""
    conf = train_conf()
    pt = TorchParaformer(**conf, generator=torch.Generator().manual_seed(0)).eval()
    jm = JaxParaformer(**conf)
    params = to_jax(convert_paraformer(pt.state_dict(), jm))
    speech, slen, text, tlen = batch()
    tgt = tlen + 1
    with torch.no_grad():
        enc, enc_len = pt.encode(torch.from_numpy(speech), torch.from_numpy(slen))
        mask = torch.arange(T)[None] < enc_len[:, None]
        emb, _, alphas, _ = pt.predictor(enc, mask, L + 1,
                                         target_length=torch.from_numpy(tgt))
    jenc, jlen = jm.encode(params, jnp.asarray(speech), jnp.asarray(slen))
    jmask = jnp.arange(T)[None] < jlen[:, None]
    jemb, _, jalphas, _ = jm.predictor(params["predictor"], jenc, jmask, L + 1,
                                       target_length=jnp.asarray(tgt))
    np.testing.assert_allclose(alphas.numpy(), np.asarray(jalphas), rtol=1e-4, atol=1e-6)
    for i, n in enumerate(tgt):
        np.testing.assert_allclose(emb[i, :n - 1].numpy(), np.asarray(jemb)[i, :n - 1],
                                   rtol=1e-4, atol=1e-5)
        last_port = np.abs(emb[i, n - 1].numpy()).max() > 0
        last_jax = np.abs(np.asarray(jemb)[i, n - 1]).max() > 0
        if last_port and last_jax:
            np.testing.assert_allclose(emb[i, n - 1].numpy(), np.asarray(jemb)[i, n - 1],
                                       rtol=1e-4, atol=1e-5)


def _qkv(b, h, t, d, seed, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, h, t, d, generator=g, dtype=dtype).requires_grad_()
            for _ in range(3)]


@pytest.mark.parametrize("mode,vad_pos", [("none", None), ("causal", None),
                                          ("corner", [3, 9])])
def test_flash_attention_fn_gradcheck(mode, vad_pos):
    q, k, v = _qkv(2, 2, 6, 8, seed=1)
    lens = torch.tensor([6, 4])
    vp = None if vad_pos is None else torch.tensor(vad_pos)
    assert torch.autograd.gradcheck(
        lambda q, k, v: flash_attention(q, k, v, lens, mode, vp), (q, k, v))
    out = flash_attention(q, k, v, lens, mode, vp)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"


def test_flash_attention_length_zero_row():
    """A row of length 0 averages V over its Tk keys: V's gradient is dO / Tk summed over
    the query rows, Q and K get zero, as autograd through the plain version gives."""
    q, k, v = _qkv(2, 2, 5, 8, seed=2)
    lens = torch.tensor([5, 0])
    dout = torch.randn(2, 2, 5, 8, dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    flash_attention(q, k, v, lens).backward(dout)
    assert q.grad[1].abs().max() == 0 and k.grad[1].abs().max() == 0
    want = dout[1].sum(dim=1, keepdim=True).expand(-1, 5, -1) / 5
    torch.testing.assert_close(v.grad[1], want, atol=1e-12, rtol=0)
    q2, k2, v2 = (x.detach().requires_grad_() for x in (q, k, v))
    flash_attention_ref(q2, k2, v2, lens).backward(dout)
    for a, b in ((q.grad, q2.grad), (k.grad, k2.grad), (v.grad, v2.grad)):
        torch.testing.assert_close(a, b, atol=1e-12, rtol=0)


@pytest.mark.parametrize("pads,masked", [((5, 5), True), ((10, 0), False), ((2, 4), True)])
def test_fsmn_memory_fn_gradcheck(pads, masked):
    g = torch.Generator().manual_seed(4)
    left, right = pads
    x = torch.randn(2, 9, 4, generator=g, dtype=torch.float64).requires_grad_()
    w = torch.randn(4, 1, left + right + 1, generator=g, dtype=torch.float64).requires_grad_()
    mask = (torch.arange(9)[None] < torch.tensor([9, 6])[:, None]) if masked else None
    assert torch.autograd.gradcheck(lambda x, w: fsmn_memory(x, w, mask, left, right), (x, w))
    assert type(fsmn_memory(x, w, mask, left, right).grad_fn).__name__ == "FsmnMemoryFnBackward"


@pytest.mark.parametrize("pads", [(5, 5), (10, 0), (3, 7), (0, 0)])
def test_fsmn_input_grad_is_the_forward_with_reversed_taps(pads):
    """dx = fsmn_memory_ref(dout, w.flip(-1), mask, right, left): the identity the CUDA
    backward uses to run the forward kernel for the input gradient (fp32, 1e-6)."""
    g = torch.Generator().manual_seed(5)
    left, right = pads
    x = torch.randn(3, 20, 16, generator=g).requires_grad_()
    w = torch.randn(16, 1, left + right + 1, generator=g)
    mask = torch.arange(20)[None] < torch.tensor([20, 13, 0])[:, None]
    dout = torch.randn(3, 20, 16, generator=g)
    dx, = torch.autograd.grad(fsmn_memory_ref(x, w, mask, left, right), x, dout)
    torch.testing.assert_close(fsmn_memory_ref(dout, w.flip(-1), mask, right, left), dx,
                               atol=1e-6, rtol=1e-6)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    return torch.device("cuda")


RECIPE_LENS = [179, 177, 175, 173, 174]  # the recipe's first batch: (5, 190) frames


@pytest.mark.cuda
@pytest.mark.parametrize("shape,lens,mode,vad_pos", [
    # the recipe's encoder signatures, (5, 190) in each mode
    ((5, 4, 190, 190, 128), RECIPE_LENS, "none", None),
    ((5, 4, 190, 190, 128), RECIPE_LENS, "causal", None),
    ((5, 4, 190, 190, 128), RECIPE_LENS, "corner", [63] * 5),
    ((4, 4, 237, 237, 128), [237, 230, 200, 190], "none", None),
    ((3, 4, 296, 296, 128), [296, 250, 281], "none", None),
    # a length-0 row, ragged last tiles, narrow heads, Tq < Tk
    ((5, 4, 256, 256, 128), [256, 200, 131, 0, 64], "none", None),
    ((2, 8, 64, 64, 32), [64, 50], "causal", None),
    ((2, 8, 70, 70, 32), [0, 50], "corner", [1, 30]),
    ((1, 4, 15, 55, 128), [55], "none", None),
    ((2, 4, 40, 100, 128), [100, 63], "causal", None),
    ((3, 4, 100, 100, 72), [100, 1, 37], "none", None)])
def test_flash_backward_kernel_matches_plain_on_card(cuda_device, shape, lens, mode, vad_pos):
    """dq, dk, dv within 1e-5 relative L2 of autograd through the plain version (3xTF32
    against cuBLAS sums), bit-equal across two runs; the forward's (m, l) instantiation
    gives the forward's output bit for bit, and the backward without them (the forward
    run again) the same gradients."""
    from funasr_tpu_torch.ops.flash_attention import (flash_attention_bwd, flash_attention_bwd_ref,
                                                      flash_attention_with_stats)
    b, h, t, tk, d = shape
    g = torch.Generator().manual_seed(7)
    q = torch.randn(b, h, t, d, generator=g).to(cuda_device)
    k, v = (torch.randn(b, h, tk, d, generator=g).to(cuda_device) for _ in range(2))
    ln = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    vp = None if vad_pos is None else torch.tensor(vad_pos, dtype=torch.int32,
                                                   device=cuda_device)
    out, stats = flash_attention_with_stats(q, k, v, ln, mode, vp)
    assert torch.equal(out, flash_attention(q, k, v, ln, mode, vp))
    dout = torch.randn(out.shape, generator=g).to(cuda_device)
    got = flash_attention_bwd(q, k, v, out, dout, ln, mode, vp, stats=stats)
    again = flash_attention_bwd(q, k, v, out, dout, ln, mode, vp, stats=stats)
    alone = flash_attention_bwd(q, k, v, out, dout, ln, mode, vp)
    want = flash_attention_bwd_ref(q, k, v, dout, ln, mode, vp)
    for a, a2, a3, w in zip(got, again, alone, want):
        assert torch.equal(a, a2) and torch.equal(a, a3)
        assert ((a - w).norm() / w.norm()).item() < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape,pads,layout", [
    # the recipe's encoder (v slice of q|k|v) and decoder (contiguous) signatures
    ((5, 190, 512), (5, 5), "qkv"), ((4, 237, 512), (5, 5), "qkv"),
    ((3, 296, 512), (5, 5), "qkv"), ((5, 49, 512), (5, 5), "dense"),
    ((5, 256, 512), (5, 5), "qkv"),
    # chunks across batch boundaries at every row count, a mask with holes
    ((7, 13, 512), (5, 5), "holes"), ((2, 3, 384), (5, 5), "dense"),
    # the generic kernel: other pads, an odd C
    ((1, 25, 512), (10, 0), "dense"), ((4, 60, 512), (10, 10), "qkv"),
    ((2, 50, 510), (5, 5), "dense")])
def test_fsmn_backward_kernels_match_plain_on_card(cuda_device, shape, pads, layout):
    """dx and dw within 1e-5 relative L2 of autograd through the plain version, dw
    bit-equal across two runs (dx: the forward kernel, which needs C % 4 == 0)."""
    from funasr_tpu_torch.ops.fsmn import (fsmn_memory_bwd_input, fsmn_memory_bwd_ref,
                                           fsmn_memory_bwd_weight)
    b, t, c = shape
    left, right = pads
    g = torch.Generator().manual_seed(8)
    if layout == "qkv":
        x = torch.randn(b, t, 3 * c, generator=g).to(cuda_device)[..., 2 * c:]
    else:
        x = torch.randn(b, t, c, generator=g).to(cuda_device)
    w = (torch.rand(c, 1, left + right + 1, generator=g) - 0.5).to(cuda_device)
    if layout == "holes":
        mask = (torch.rand(b, t, generator=g) > 0.3).to(cuda_device)
    else:
        mask = torch.arange(t, device=cuda_device)[None] < torch.tensor(
            [max(t - 7 * i, 0) for i in range(b)], device=cuda_device)[:, None]
    dout = torch.randn(b, t, c, generator=g).to(cuda_device)
    dw = fsmn_memory_bwd_weight(x, dout, mask, left, right)
    assert torch.equal(dw, fsmn_memory_bwd_weight(x, dout, mask, left, right))
    want_dx, want_dw = fsmn_memory_bwd_ref(x, w, mask, left, right, dout)
    assert ((dw.reshape(want_dw.shape) - want_dw).norm() / want_dw.norm()).item() < 1e-5
    if c % 4 == 0:
        dx = fsmn_memory_bwd_input(dout, w, mask, left, right)
        assert ((dx - want_dx).norm() / want_dx.norm()).item() < 1e-5


def test_train_sites_and_backward_work():
    """chip_smoke's phase-16 launch sites (a Paraformer-large step: 50 flash and its
    backward, 82 FSMN with the sampler's pass, 66 FSMN input and weight gradients) and the
    flash backward's bytes and flops (10 D a query row and key it sees)."""
    import chip_smoke
    step, val = chip_smoke.train_sites(50, 16)
    assert step == {"flash_attention": 50, "flash_attention_bwd": 50, "fsmn_memory": 82,
                    "fsmn_memory_bwd_input": 66, "fsmn_memory_bwd_weight": 66,
                    "w8a8_linear": 0}
    assert val["flash_attention_bwd"] == 0 and val["fsmn_memory"] == 82
    n_bytes, n_ops = chip_smoke.flash_bwd_work(2, 4, 10, 10, 128, [[10] * 10, [6] * 10])
    assert n_ops == 10 * 4 * 128 * (100 + 60)
    assert n_bytes == 4 * 2 * 4 * 128 * 80 + 8


def test_kernels_line_carries_training_entries():
    """Phase 16 adds each forward kernel's recipe launches under ``training`` and three
    kernels of their own, the backward launches, each with every key of the line; each
    kernel carries its rows at the recipe's launched shapes under ``recipe_rows``."""
    import chip_smoke
    row = dict(shape=(1, 2), max_abs_err=0.0, ms=1.0, call_ms=2.0, plain_ms=3.0,
               library_ms=4.0, bound_ms=0.5, bound_by="bytes")
    record = {(name, torch.bfloat16): row for name in chip_smoke.LIBRARY_CALLS}
    call = {"flash_attention": 50, "fsmn_memory": 66, "w8a8_linear": 0}
    step, _ = chip_smoke.train_sites(50, 16)
    rows = {("flash_attention_bwd", m): dict(row, mode=m) for m in ("none", "causal", "corner")}
    rows.update({("fsmn_memory_bwd_input",): row, ("fsmn_memory_bwd_weight",): row})
    recipe_rows = {name: {"5x190x512_k11": dict(row, launches=8)}
                   for name in ("fsmn_memory", "fsmn_memory_bwd_input", "fsmn_memory_bwd_weight")}
    recipe_rows.update({name: {"5x4x190x128": dict(row, launches=8)}
                        for name in ("flash_attention", "flash_attention_bwd")})
    training = dict(rows=rows, launches={k: 8 * v for k, v in step.items()},
                    launches_per_step=step, recipe_rows=recipe_rows)
    kernels = {k["name"]: k for k in chip_smoke.kernels_line(
        record, call, {"w8a8_linear": 282}, call, training=training)["kernels"]}
    assert kernels["fsmn_memory"]["training"] == dict(
        launches=656, launches_per_step=82, recipe_rows=recipe_rows["fsmn_memory"])
    assert kernels["w8a8_linear"]["training"]["recipe_rows"] == {}
    for name in ("flash_attention_bwd", "fsmn_memory_bwd_input", "fsmn_memory_bwd_weight"):
        entry = kernels[name]
        assert {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms"} <= set(entry)
        assert entry["route"] == "cuda" and entry["launches"] == 8 * step[name]
        assert entry["recipe_rows"] == recipe_rows[name]
    assert set(kernels["flash_attention_bwd"]["rows"]) == {"none", "causal", "corner"}
    assert kernels["flash_attention_bwd"]["replaces"] == "funasr_tpu/ops/flash_attention.py:63"
    assert "training" not in chip_smoke.kernels_line(record, call, {"w8a8_linear": 282},
                                                     call)["kernels"][0]


def _signature(kernel, tensors, args, launches, lengths):
    return dict(kernel=kernel, tensors=tensors, args=args, launches=launches, lengths=lengths)


def test_recipe_launch_shapes_add_up_to_the_launches():
    """chip_smoke's union of the trainer's ``kernel_shapes`` over log lines: one entry per
    signature with its launches summed and its first lengths; a line whose signatures do
    not add up to its launches raises."""
    import chip_smoke
    enc = [[[2, 40, 512], [61440, 1536, 1]]]
    dec = [[[2, 9, 512], [4608, 512, 1]]]
    lines = [dict(step=1, launches={"fsmn_memory": 3, "w8a8_linear": 0}, kernel_shapes=[
                 _signature("fsmn_memory", enc, [11, 5, 5, False], 2, [40, 31]),
                 _signature("fsmn_memory", dec, [11, 5, 5, False], 1, [9, 4])]),
             dict(step=2, launches={"fsmn_memory": 2, "w8a8_linear": 0}, kernel_shapes=[
                 _signature("fsmn_memory", enc, [11, 5, 5, False], 2, [40, 12])])]
    shapes = chip_smoke.recipe_launch_shapes(lines)
    key = ("fsmn_memory", (((2, 40, 512), (61440, 1536, 1)),), (11, 5, 5, False))
    assert len(shapes) == 2 and shapes[key] == dict(launches=4, lengths=[40, 31])
    assert sorted(map(chip_smoke.recipe_label, shapes)) == ["2x40x512_k11", "2x9x512_k11"]
    lines[1]["launches"]["fsmn_memory"] = 3
    with pytest.raises(AssertionError, match="add up"):
        chip_smoke.recipe_launch_shapes(lines)


@pytest.mark.cuda
def test_recipe_kernel_rows_on_card(cuda_device):
    """chip_smoke's rows at recorded signatures of all five training kernels (the flash
    head views of a fused q|k|v, the FSMN's v slice and contiguous decoder input), each
    within its tolerance, the backward ones bit-equal."""
    import chip_smoke
    from funasr_tpu_torch.ops import cuda_lib
    b, t, h, d, c, ln = 3, 70, 4, 128, 512, [70, 51, 9]
    qkv = torch.randn(b, t, 3, h, d, device=cuda_device)
    q, k, v = (qkv[:, :, i].transpose(1, 2).requires_grad_() for i in range(3))
    x = torch.randn(b, t, 3 * c, device=cuda_device)[..., 2 * c:].requires_grad_()
    w = (torch.rand(c, 1, 11, device=cuda_device) - 0.5).requires_grad_()
    lens = torch.tensor(ln, dtype=torch.int32, device=cuda_device)
    mask = torch.arange(t, device=cuda_device)[None] < lens[:, None]
    cuda_lib.record_launch_shapes()
    try:
        out = flash_attention(q, k, v, lens)
        mem = fsmn_memory(x, w, mask, 5, 5)
        (out.sum() + mem.square().sum()).backward()
        lines = [dict(step=1, launches={}, kernel_shapes=cuda_lib.take_launch_shapes())]
    finally:
        cuda_lib.stop_recording_launch_shapes()
    shapes = chip_smoke.recipe_launch_shapes(lines)
    assert {key[0] for key in shapes} == {"flash_attention", "flash_attention_bwd", "fsmn_memory",
                                          "fsmn_memory_bwd_input", "fsmn_memory_bwd_weight"}
    rows = chip_smoke.recipe_kernel_rows(cuda_device, shapes)
    assert rows["fsmn_memory"]["3x70x512_k11"]["lengths"] == ln
    assert all(r.get("deterministic", True) for by in rows.values() for r in by.values())


def test_run_step_ms_leaves_out_the_epoch_boundary():
    """``chip_smoke.py --recipe-ab``'s ms a step: consecutive log lines of one epoch only
    (the epoch's end carries its validation and checkpoint)."""
    import chip_smoke
    steps = [dict(epoch=0, time=1.0), dict(epoch=0, time=1.2), dict(epoch=0, time=1.5),
             dict(epoch=1, time=9.0), dict(epoch=1, time=9.25)]
    assert chip_smoke.run_step_ms(steps) == pytest.approx([200.0, 300.0, 250.0])
