"""``chip_smoke.py``'s phase 17 plan (its launch sites, its gradient rule, its configs, its
entries in the kernels line) and, on the card (``cuda``), the training kernels at
CT-Transformer's widths: the flash backward at head dim 32 and the FSMN gradients at
width 256 against autograd through their plain versions. No JAX here: the card's tests
compare with the plain PyTorch versions.
"""

import pytest
import torch

from funasr_tpu_torch.register import tables


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 17 plan
# ---------------------------------------------------------------------------

def test_phase17_sites():
    """A full-width SenseVoice step launches each of the five kernels once a block (70);
    a validation batch only the forwards. The losses of (c) at 4 + 2 blocks: BiCif and
    SeACo encode twice with gradients, Paraformer-v2 has no sampler pass."""
    import chip_smoke
    step, val = chip_smoke.sv_train_sites(70)
    assert set(step.values()) == {70, 0} and step["w8a8_linear"] == 0
    assert val == dict(step, flash_attention_bwd=0, fsmn_memory_bwd_input=0,
                       fsmn_memory_bwd_weight=0)
    sites = {name: chip_smoke.family_train_sites(name, 4, 2)
             for name in ("CTC", "ParaformerV2", "EParaformer", "BiCifParaformer",
                          "ContextualParaformer")}
    assert sites["CTC"] == chip_smoke.sv_train_sites(4)[0]
    assert sites["ParaformerV2"] == dict(sites["CTC"], fsmn_memory=6, fsmn_memory_bwd_input=6,
                                         fsmn_memory_bwd_weight=6)
    assert sites["EParaformer"] == sites["ContextualParaformer"] == \
        chip_smoke.train_sites(4, 2)[0]
    assert sites["BiCifParaformer"] == dict(
        flash_attention=8, flash_attention_bwd=8, fsmn_memory=12, fsmn_memory_bwd_input=10,
        fsmn_memory_bwd_weight=10, w8a8_linear=0)
    assert chip_smoke.family_train_sites("SeacoParaformer", 4, 2) == sites["BiCifParaformer"]


def test_phase17_gradient_rule_holds_zero_gradients_to_a_floor():
    import chip_smoke
    cpu = {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([1e-9, 0.0]), "c": None}
    gpu = {"a": torch.tensor([3.0, 4.0004]), "b": torch.tensor([0.0, 2e-9]), "c": None}
    worst, name, bad = chip_smoke.grad_rel_errors(cpu, gpu)
    assert name == "a" and worst == pytest.approx(8e-5, rel=1e-3) and bad == []
    gpu["b"] = torch.tensor([0.0, 1e-3])
    assert chip_smoke.grad_rel_errors(cpu, gpu)[2] == ["b"]
    gpu["c"] = torch.ones(1)
    assert "c" in chip_smoke.grad_rel_errors(cpu, gpu)[2]


def test_phase17_confs_build_the_nine_models():
    """(c)'s nine configs are the port's classes at PROD_CONF width, 4 + 2 blocks (the
    names the loop builds; here only checked, not built)."""
    import chip_smoke
    confs = chip_smoke.family_train_confs()
    assert list(confs) == ["SenseVoiceSmall", "CTC", "ParaformerV2", "EParaformer",
                           "BiCifParaformer", "SeacoParaformer", "ContextualParaformer",
                           "MonotonicAligner", "CTTransformer"]
    assert all(name in tables.model_classes for name in confs)
    assert confs["SenseVoiceSmall"]["encoder_conf"]["output_size"] == 512
    assert confs["CTTransformer"]["encoder_conf"]["attention_heads"] == 8
    assert "predictor_bias" not in confs["EParaformer"]  # E-Paraformer's own 2


def test_kernels_line_carries_phase17_entries():
    """Each of the five training kernels carries phase 17's launches, its rows at the
    SenseVoice recipe's and CT-Transformer's signatures and its launches in each loss's
    CUDA step, under ``training_family``."""
    import chip_smoke
    row = dict(shape=(1, 2), max_abs_err=0.0, ms=1.0, call_ms=2.0, plain_ms=3.0,
               library_ms=4.0, bound_ms=0.5, bound_by="bytes")
    record = {(name, torch.bfloat16): row for name in chip_smoke.LIBRARY_CALLS}
    call = {"flash_attention": 50, "fsmn_memory": 66, "w8a8_linear": 0}
    step, _ = chip_smoke.train_sites(50, 16)
    rows = {("flash_attention_bwd", m): dict(row, mode=m) for m in ("none", "causal", "corner")}
    rows.update({("fsmn_memory_bwd_input",): row, ("fsmn_memory_bwd_weight",): row})
    training = dict(rows=rows, launches={k: 8 * v for k, v in step.items()},
                    launches_per_step=step, recipe_rows={k: {} for k in step})
    sv_step, _ = chip_smoke.sv_train_sites(70)
    family = dict(launches={k: 4 * v for k, v in sv_step.items()}, launches_per_step=sv_step,
                  recipe_rows={"flash_attention_bwd": {"5x4x194x128": dict(row, launches=280)}},
                  ct_rows={"flash_attention_bwd": {"16x8x100x32": dict(row, launches=4)}},
                  cuda_vs_cpu={"CTC": dict(launches=chip_smoke.sv_train_sites(4)[0])})
    kernels = {k["name"]: k for k in chip_smoke.kernels_line(
        record, call, {"w8a8_linear": 282}, call, training=training,
        training_family=family)["kernels"]}
    assert set(kernels) == {"flash_attention", "fsmn_memory", "w8a8_linear",
                            "flash_attention_bwd", "fsmn_memory_bwd_input",
                            "fsmn_memory_bwd_weight"}
    entry = kernels["flash_attention_bwd"]["training_family"]
    assert entry == dict(launches=280, launches_per_step=70,
                         recipe_rows=family["recipe_rows"]["flash_attention_bwd"],
                         ct_rows=family["ct_rows"]["flash_attention_bwd"],
                         cuda_vs_cpu_launches={"CTC": 4})
    assert kernels["w8a8_linear"]["training_family"]["launches"] == 0
    assert kernels["fsmn_memory"]["training_family"]["ct_rows"] == {}


# ---------------------------------------------------------------------------
# on the card: the backward kernels at CT-Transformer's widths
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,lens", [
    ((16, 8, 100, 32), [100, 97, 60, 33, 81, 100, 45, 70, 99, 34, 88, 51, 66, 100, 39, 72]),
    ((4, 8, 64, 32), [64, 0, 1, 57]), ((2, 8, 200, 32), [200, 131])])
def test_flash_backward_at_head_dim_32_on_card(cuda_device, shape, lens):
    """CT-Transformer's heads (D = 32, the kernel's shared-memory tiles zero above it) as
    the fused projection gives them: dq, dk, dv within 1e-5 relative L2 of autograd
    through the plain version, bit-equal across two runs."""
    from funasr_tpu_torch.ops.flash_attention import (flash_attention_bwd, flash_attention_bwd_ref,
                                                      flash_attention_with_stats)
    b, h, t, d = shape
    g = torch.Generator().manual_seed(32)
    qkv = torch.randn(b, t, 3, h, d, generator=g).to(cuda_device)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    ln = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    out, stats = flash_attention_with_stats(q, k, v, ln)
    dout = torch.randn(out.shape, generator=g).to(cuda_device)
    got = flash_attention_bwd(q, k, v, out, dout, ln, stats=stats)
    again = flash_attention_bwd(q, k, v, out, dout, ln, stats=stats)
    want = flash_attention_bwd_ref(q, k, v, dout, ln)
    for a, a2, w in zip(got, again, want):
        assert torch.equal(a, a2)
        assert ((a - w).norm() / w.norm()).item() < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape,layout", [((16, 100, 256), "qkv"), ((16, 100, 256), "dense"),
                                          ((3, 37, 256), "qkv")])
def test_fsmn_backward_at_width_256_on_card(cuda_device, shape, layout):
    """CT-Transformer's FSMN (C = 256, k 11, pads 5 / 5): dx and dw within 1e-5 relative
    L2 of autograd through the plain version, dw bit-equal across two runs."""
    from funasr_tpu_torch.ops.fsmn import (fsmn_memory_bwd_input, fsmn_memory_bwd_ref,
                                           fsmn_memory_bwd_weight)
    b, t, c = shape
    g = torch.Generator().manual_seed(256)
    x = (torch.randn(b, t, 3 * c, generator=g).to(cuda_device)[..., 2 * c:] if layout == "qkv"
         else torch.randn(b, t, c, generator=g).to(cuda_device))
    w = (torch.rand(c, 1, 11, generator=g) - 0.5).to(cuda_device)
    mask = torch.arange(t, device=cuda_device)[None] < torch.tensor(
        [max(t - 9 * i, 1) for i in range(b)], device=cuda_device)[:, None]
    dout = torch.randn(b, t, c, generator=g).to(cuda_device)
    dw = fsmn_memory_bwd_weight(x, dout, mask, 5, 5)
    assert torch.equal(dw, fsmn_memory_bwd_weight(x, dout, mask, 5, 5))
    want_dx, want_dw = fsmn_memory_bwd_ref(x, w, mask, 5, 5, dout)
    assert ((dw.reshape(want_dw.shape) - want_dw).norm() / want_dw.norm()).item() < 1e-5
    dx = fsmn_memory_bwd_input(dout, w, mask, 5, 5)
    assert ((dx - want_dx).norm() / want_dx.norm()).item() < 1e-5
