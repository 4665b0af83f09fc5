"""The FSMN kernel's plain depthwise mode (``ops/fsmn.py::depthwise_conv1d``) against its
plain PyTorch version on the card, at the AED path's shapes: the Conformer's convolution
module (C 256, k 15, pads 7 / 7, bias, no mask), the Branchformer's cgMLP gate (C 1,024,
k 31, pads 15 / 15, bias, input masked) and the E-Branchformer's merge conv (C 512, k 3,
pads 1 / 1), fp32 and bf16, on the specialised and the generic instantiations: bit-equal
(the kernel rounds each product and sum as the plain version's separate multiply and add
do). Also: one launch counted a call, and the CPU wrapper taking the plain version. The
backward on the card, fp32, at every instantiation of the slice (k 15 / left 7 and 14,
k 3 / 1, k 31 / 15, and the generic kernel at k 15 / 0): dx bit-equal to
``depthwise_conv1d_bwd_input_ref``, dw and db within 1e-5 relative L2 of
``depthwise_conv1d_bwd_weight_ref`` and bit-equal across two runs, each counted once a
call; autograd through ``depthwise_conv1d`` launching the three kernels; a bf16 backward
raising ``NotImplementedError``. No JAX here.
"""

import pytest
import torch

from funasr_tpu_torch.ops.fsmn import (depthwise_conv1d, depthwise_conv1d_bwd_input,
                                       depthwise_conv1d_bwd_input_ref,
                                       depthwise_conv1d_bwd_weight,
                                       depthwise_conv1d_bwd_weight_ref, depthwise_conv1d_ref)

SHAPES = [(4, 199, 256, 15, False), (4, 199, 1024, 31, True), (4, 199, 512, 3, False),
          (1, 7, 256, 15, True)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    return torch.device("cuda")


def _inputs(dev, b, t, c, k, masked, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, t, c, device=dev, generator=g).to(dtype)
    w = torch.randn(c, 1, k, device=dev, generator=g).to(dtype)
    bias = torch.randn(c, device=dev, generator=g).to(dtype)
    lens = torch.tensor([t, t - 3, t // 2, 1][:b], device=dev)
    mask = (torch.arange(t, device=dev)[None] < lens[:, None]) if masked else None
    return x, w, bias, mask


@pytest.mark.cuda
@pytest.mark.parametrize("generic", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_mode_bit_equal_to_plain_version(cuda_device, shape, dtype, generic):
    b, t, c, k, masked = shape
    x, w, bias, mask = _inputs(cuda_device, b, t, c, k, masked, dtype)
    pad = (k - 1) // 2
    with torch.inference_mode():
        before = depthwise_conv1d.launches
        got = depthwise_conv1d(x, w, bias, mask, pad, k - 1 - pad, generic=generic)
        assert depthwise_conv1d.launches == before + 1
        want = depthwise_conv1d_ref(x, w, bias, mask, pad, k - 1 - pad)
        assert torch.equal(got, want)
        nob = depthwise_conv1d(x, w, None, mask, pad, k - 1 - pad, generic=generic)
        assert torch.equal(nob, depthwise_conv1d_ref(x, w, None, mask, pad, k - 1 - pad))


# (B, T, C, k, left, masked): the Conformer's, the chunk conformer's causal conv and its
# dx's (0 / 14 is the forward of k 15 / 14's input gradient), the merge conv's, the cgMLP
# gate's, and a (k, left) without an instantiation of its own (the generic kernels)
BWD_SHAPES = [(4, 199, 256, 15, 7, False), (4, 199, 256, 15, 14, True),
              (4, 199, 512, 3, 1, False), (4, 199, 1024, 31, 15, True),
              (3, 61, 256, 15, 0, True), (1, 7, 256, 15, 7, True)]
DW_REL_L2 = 1e-5


def _rel(a, b):
    return ((a - b).norm() / b.norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_backward_kernels_match_plain_versions(cuda_device, shape):
    b, t, c, k, left, masked = shape
    right = k - 1 - left
    x, w, _, mask = _inputs(cuda_device, b, t, c, k, masked, torch.float32)
    dout = torch.randn(b, t, c, device=cuda_device, generator=torch.Generator(
        device=cuda_device).manual_seed(1))
    n_dx, n_dw = depthwise_conv1d_bwd_input.launches, depthwise_conv1d_bwd_weight.launches
    dx = depthwise_conv1d_bwd_input(dout, w, mask, left, right)
    dw, db = depthwise_conv1d_bwd_weight(x, dout, mask, left, right)
    dw2, db2 = depthwise_conv1d_bwd_weight(x, dout, mask, left, right)
    assert depthwise_conv1d_bwd_input.launches == n_dx + 1
    assert depthwise_conv1d_bwd_weight.launches == n_dw + 2
    assert torch.equal(dx, depthwise_conv1d_bwd_input_ref(dout, w, mask, left, right))
    want_dw, want_db = depthwise_conv1d_bwd_weight_ref(x, dout, mask, left, right)
    assert _rel(dw, want_dw) <= DW_REL_L2 and _rel(db, want_db) <= DW_REL_L2
    assert torch.equal(dw, dw2) and torch.equal(db, db2)


@pytest.mark.cuda
def test_autograd_on_the_card_launches_the_three_kernels(cuda_device):
    x, w, bias, mask = _inputs(cuda_device, 2, 50, 256, 15, True, torch.float32)
    x, w, bias = (a.clone().requires_grad_() for a in (x, w, bias))
    before = [f.launches for f in (depthwise_conv1d, depthwise_conv1d_bwd_input,
                                   depthwise_conv1d_bwd_weight)]
    depthwise_conv1d(x, w, bias, mask, 14, 0).square().sum().backward()
    after = [f.launches for f in (depthwise_conv1d, depthwise_conv1d_bwd_input,
                                  depthwise_conv1d_bwd_weight)]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    xr, wr, br = (a.detach().cpu().requires_grad_() for a in (x, w, bias))
    depthwise_conv1d_ref(xr, wr, br, mask.cpu(), 14, 0).square().sum().backward()
    for got, want in ((x.grad, xr.grad), (w.grad, wr.grad), (bias.grad, br.grad)):
        assert _rel(got.cpu(), want) <= 1e-5


@pytest.mark.cuda
def test_bf16_backward_raises(cuda_device):
    x, w, bias, _ = _inputs(cuda_device, 1, 8, 256, 15, False, torch.bfloat16)
    out = depthwise_conv1d(x.requires_grad_(), w, bias, None, 7, 7)
    with pytest.raises(NotImplementedError, match="ROADMAP item 20b"):
        out.float().sum().backward()


def test_cpu_wrapper_takes_the_plain_version():
    x, w, bias, mask = _inputs(torch.device("cpu"), 2, 20, 8, 3, True, torch.float32)
    before = depthwise_conv1d.launches
    got = depthwise_conv1d(x, w, bias, mask, 1, 1)
    assert depthwise_conv1d.launches == before
    assert torch.equal(got, depthwise_conv1d_ref(x, w, bias, mask, 1, 1))
