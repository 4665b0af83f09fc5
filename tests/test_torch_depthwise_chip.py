"""The FSMN kernel's plain depthwise mode (``ops/fsmn.py::depthwise_conv1d``) against its
plain PyTorch version on the card, at the AED path's shapes: the Conformer's convolution
module (C 256, k 15, pads 7 / 7, bias, no mask), the Branchformer's cgMLP gate (C 1,024,
k 31, pads 15 / 15, bias, input masked) and the E-Branchformer's merge conv (C 512, k 3,
pads 1 / 1), fp32 and bf16, on the specialised and the generic instantiations: bit-equal
(the kernel rounds each product and sum as the plain version's separate multiply and add
do). Also: one launch counted a call, the backward refused on the card, and the CPU
wrapper taking the plain version. No JAX here.
"""

import pytest
import torch

from funasr_tpu_torch.ops.fsmn import depthwise_conv1d, depthwise_conv1d_ref

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


@pytest.mark.cuda
def test_plain_mode_refuses_training_on_the_card(cuda_device):
    x, w, bias, _ = _inputs(cuda_device, 1, 8, 256, 15, False, torch.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP item 22"):
        depthwise_conv1d(x.requires_grad_(), w, bias, None, 7, 7)


def test_cpu_wrapper_takes_the_plain_version():
    x, w, bias, mask = _inputs(torch.device("cpu"), 2, 20, 8, 3, True, torch.float32)
    before = depthwise_conv1d.launches
    got = depthwise_conv1d(x, w, bias, mask, 1, 1)
    assert depthwise_conv1d.launches == before
    assert torch.equal(got, depthwise_conv1d_ref(x, w, bias, mask, 1, 1))
