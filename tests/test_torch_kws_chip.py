"""The lookahead FSMN on the card (no JAX): the FSMN kernel at the keyword spotters' k 12 /
left 9 (the forward: ``[conv_left | conv_right]``, pads (9, 2)) and k 12 / left 2 (its input
gradient's instantiation), fp32 and bf16, specialised and generic, against
``fsmn_memory_ref`` (max abs error within 1e-5 fp32, 2e-2 bf16, and the two instantiations
within the same); the vector weight-gradient kernel at (12, 9) within 1e-5 relative L2 of
autograd through the plain version and bit-equal across two runs; ``FSMNBlock`` (lorder 10,
rorder 2, C 128) on the card, offline and with a cache, one fused launch a call, within
1e-6 relative L2 of the CPU block (JAX's order: the left memory, then the lookahead), and
its backward (one dx and one dw launch) within 1e-5 relative L2 of the CPU's gradients,
``conv_right``'s included. Each test is ``cuda``-marked and skips without a card.
"""

import copy

import pytest
import torch

from funasr_tpu_torch.models.fsmn_vad_streaming.encoder import FSMNBlock
from funasr_tpu_torch.ops.fsmn import (fsmn_memory, fsmn_memory_bwd_input,
                                       fsmn_memory_bwd_ref, fsmn_memory_bwd_weight,
                                       fsmn_memory_ref)

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
SHAPES = [(1, 601, 128), (4, 1775, 128), (2, 7, 128), (3, 150, 256)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    return torch.device("cuda")


def rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("left,right", [(9, 2), (2, 9)])
@pytest.mark.parametrize("shape", SHAPES)
def test_k12_instantiations_match_the_plain_version(cuda_device, shape, left, right, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(*shape, generator=g, device=cuda_device).to(dtype)
    w = (torch.rand(shape[2], 1, 12, generator=g, device=cuda_device) - 0.5).to(dtype)
    with torch.inference_mode():
        before = fsmn_memory.launches
        got = fsmn_memory(x, w, None, left, right)
        generic = fsmn_memory(x, w, None, left, right, generic=True)
        assert fsmn_memory.launches == before + 2
        want = fsmn_memory_ref(x, w, None, left, right)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert (got.float() - generic.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES[:3])
def test_lookahead_backward_kernels(cuda_device, shape):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x, dout = (torch.randn(*shape, generator=g, device=cuda_device) for _ in range(2))
    w = torch.rand(shape[2], 1, 12, generator=g, device=cuda_device) - 0.5
    want_dx, want_dw = fsmn_memory_bwd_ref(x, w, None, 9, 2, dout)
    n_in, n_w = fsmn_memory_bwd_input.launches, fsmn_memory_bwd_weight.launches
    dx = fsmn_memory_bwd_input(dout, w, None, 9, 2)
    dw, dw2 = (fsmn_memory_bwd_weight(x, dout, None, 9, 2) for _ in range(2))
    assert fsmn_memory_bwd_input.launches == n_in + 1
    assert fsmn_memory_bwd_weight.launches == n_w + 2
    assert rel_l2(dx, want_dx) <= 1e-5
    assert rel_l2(dw, want_dw.reshape(shape[2], 12)) <= 1e-5
    assert torch.equal(dw, dw2)


@pytest.mark.cuda
def test_fsmn_block_fused_on_the_card(cuda_device):
    torch.manual_seed(2)
    block = FSMNBlock(128, 10, 2)
    with torch.no_grad():
        block.conv_left.weight.uniform_(-0.5, 0.5)
        block.conv_right.weight.uniform_(-0.5, 0.5)
    h, cache = torch.randn(2, 150, 128), torch.randn(2, 9, 128)
    gpu = copy.deepcopy(block).to(cuda_device)
    with torch.no_grad():
        before = fsmn_memory.launches
        got = [gpu(h.to(cuda_device))[0], gpu(h.to(cuda_device), cache.to(cuda_device))[0]]
        assert fsmn_memory.launches == before + 2
        want = [block(h)[0], block(h, cache)[0]]
    for a, b in zip(got, want):
        assert rel_l2(a.cpu(), b) <= 1e-6

    # the backward: one dx and one dw launch; conv_left / conv_right split by autograd
    dout = torch.randn(2, 150, 128)
    hg = h.clone().requires_grad_()
    block(hg)[0].backward(dout)
    hc = h.to(cuda_device).requires_grad_()
    n_in, n_w = fsmn_memory_bwd_input.launches, fsmn_memory_bwd_weight.launches
    gpu(hc)[0].backward(dout.to(cuda_device))
    assert fsmn_memory_bwd_input.launches == n_in + 1
    assert fsmn_memory_bwd_weight.launches == n_w + 1
    assert rel_l2(hc.grad.cpu(), hg.grad) <= 1e-5
    for name in ("conv_left", "conv_right"):
        want_g = getattr(block, name).weight.grad
        assert rel_l2(getattr(gpu, name).weight.grad.cpu(), want_g) <= 1e-5, name
