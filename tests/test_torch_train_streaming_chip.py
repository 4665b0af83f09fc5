"""The flash kernels' chunk mode (streaming training) on the card, against the plain
version, and ``chip_smoke.py`` phase 18's helpers. No JAX: the card's machine runs these
with the port alone (``python -m pytest tests/test_torch_*.py -m cuda``)."""

import numpy as np
import pytest
import torch

from funasr_tpu_torch.models.scama.chunk_utils import OverlapChunk
from funasr_tpu_torch.ops.flash_attention import (chunk_mask, flash_attention,
                                                  flash_attention_bwd, flash_attention_bwd_ref,
                                                  flash_attention_ref)

FWD_REL_L2 = 1e-5  # fp32 (3xTF32 products, other sum orders) against the plain version
BWD_REL_L2 = 1e-5


def chunk_case(ind, lengths, look_back=4, d=128, h=4, seed=0):
    """q, k, v (B, H, Tc, d) over the recipe's config ``ind`` ([12, 15] / [8, 10]), the
    chunked lengths and the predicate's integers."""
    oc = OverlapChunk(chunk_size=(12, 15), stride=(8, 10), pad_left=(0, 0),
                      encoder_att_look_back_factor=(look_back, look_back), shfit_fsmn=5)
    masks = oc.gen_chunk_mask(np.asarray(lengths), ind)
    tc = masks["mask_shfit_chunk"].shape[0]
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(len(lengths), h, tc, d, generator=g) for _ in range(3))
    lc = torch.from_numpy(np.asarray(masks["x_len_chunk"]).astype(np.int32))
    return q, k, v, lc, oc.attention_chunk(ind)


def test_chunk_case_has_dead_rows_and_holes():
    q, k, v, lc, chunk = chunk_case(0, (190, 150, 61))
    live = chunk_mask(lc, q.shape[2], q.shape[2], chunk)
    assert (~live.any(-1)).any()                       # FSMN shift rows
    first = live[0, chunk[0] + chunk[1]]               # chunk 1's first frame row
    assert first[chunk[1]] and not first[chunk[1] + chunk[2]]  # a look-back hole


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chunk mode's kernels)")
    return torch.device("cuda")


def rel(a, b):
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(0, 4), (1, 4), (0, 0), (1, 1), (0, 1_000_000)])
def test_chunk_mode_kernels_match_plain_on_cuda(cuda_dev, case):
    """Forward and backward kernels in chunk mode at (3, 4, Tc, 128) fp32 against the plain
    version on the same inputs, q | k | v as strided head views of one projection: the
    forward within FWD_REL_L2, fully masked rows exactly 0 in the output and in dq, the
    backward within BWD_REL_L2 and bit-equal across two runs."""
    ind, look_back = case
    q, k, v, lc, chunk = chunk_case(ind, (190, 150, 61), look_back)
    b, h, t, d = q.shape
    qkv = torch.stack([x.transpose(1, 2) for x in (q, k, v)], 2).to(cuda_dev)  # (B,T,3,H,D)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    lc = lc.to(cuda_dev)
    out = flash_attention(q, k, v, lc, "chunk", chunk=chunk)
    torch.cuda.synchronize()
    ref = flash_attention_ref(q, k, v, lc, "chunk", chunk=chunk)
    assert rel(out, ref) <= FWD_REL_L2
    dead = ~chunk_mask(lc, t, t, chunk).any(-1)
    assert (out.permute(0, 2, 1, 3)[dead] == 0).all()
    dout = torch.randn(out.shape, device=cuda_dev)
    got = flash_attention_bwd(q, k, v, out, dout, lc, "chunk", chunk=chunk)
    again = flash_attention_bwd(q, k, v, out, dout, lc, "chunk", chunk=chunk)
    torch.cuda.synchronize()
    want = flash_attention_bwd_ref(q, k, v, dout, lc, "chunk", chunk=chunk)
    for a, a2, w in zip(got, again, want):
        assert rel(a, w) <= BWD_REL_L2
        assert torch.equal(a, a2)
    assert (got[0].permute(0, 2, 1, 3)[dead] == 0).all()


@pytest.mark.cuda
def test_chunk_mode_autograd_on_cuda(cuda_dev):
    """Through ``FlashAttentionFn`` (the forward's (m, l), then the backward kernel): the
    gradients equal autograd through the plain version."""
    q, k, v, lc, chunk = chunk_case(1, (120, 97), d=64, h=2)
    q, k, v = (x.to(cuda_dev).requires_grad_() for x in (q, k, v))
    lc = lc.to(cuda_dev)
    out = flash_attention(q, k, v, lc, "chunk", chunk=chunk)
    dout = torch.randn(out.shape, device=cuda_dev)
    got = torch.autograd.grad(out, (q, k, v), dout)
    want = flash_attention_bwd_ref(q, k, v, dout, lc, "chunk", chunk=chunk)
    for a, w in zip(got, want):
        assert rel(a, w) <= BWD_REL_L2


@pytest.mark.cuda
def test_chunk_mode_refuses_bf16_on_cuda(cuda_dev):
    q, k, v, lc, chunk = chunk_case(0, (40,), d=64, h=2)
    q, k, v = (x.to(cuda_dev, torch.bfloat16) for x in (q, k, v))
    with pytest.raises(NotImplementedError, match="fp32"):
        flash_attention(q, k, v, lc.to(cuda_dev), "chunk", chunk=chunk)


def test_phase18_reads_the_chunk_configs_and_holed_masks_of_a_log():
    """chip_smoke's phase 18 helpers on trainer log lines: the chunk configs a step drew
    (from its flash launches' arguments), the union of signatures keeping a holed mask's
    runs, and the rows' labels."""
    import chip_smoke
    flash = dict(kernel="flash_attention", tensors=[[[2, 4, 402, 128], [1, 1, 1, 1]]] * 3,
                 args=["chunk", 17, 5, 8, 4], launches=50, lengths=[380, 300])
    fsmn = dict(kernel="fsmn_memory", tensors=[[[2, 402, 512], [1, 1, 1]]],
                args=[11, 5, 5, False], launches=50, lengths=[15, 12],
                mask_runs=[[[5, 20]], [[5, 17]]])
    dec = dict(kernel="fsmn_memory", tensors=[[[2, 49, 512], [1, 1, 1]]],
               args=[11, 10, 0, False], launches=32, lengths=[49, 40])
    assert chip_smoke.chunk_configs([flash, fsmn]) == ({(17, 5, 8, 4)}, True)
    assert chip_smoke.chunk_configs([dict(flash, args=["none"])]) == (set(), False)
    lines = [dict(step=1, launches={"flash_attention": 50, "fsmn_memory": 82},
                  kernel_shapes=[flash, fsmn, dec])]
    shapes = chip_smoke.recipe_launch_shapes(lines)
    labels = {chip_smoke.recipe_label(k): v for k, v in shapes.items()}
    assert set(labels) == {"2x4x402x128_chunk17-5-8-4", "2x402x512_k11",
                           "2x49x512_k11_pads10-0"}
    assert labels["2x402x512_k11"]["mask_runs"] == [[[5, 20]], [[5, 17]]]
    assert "mask_runs" not in labels["2x49x512_k11_pads10-0"]


def test_chunk_library_mask_gives_every_row_a_key():
    """The library call's mask in chunk mode: the predicate, with key 0 live on the rows
    it leaves empty (SDPA would give them NaN); the bound counts the predicate's scores."""
    import chip_smoke
    q, _, _, lc, chunk = chunk_case(1, (40, 23), d=8, h=1)
    t = q.shape[2]
    live = chunk_mask(lc, t, t, chunk)
    lib = chip_smoke.chunk_library_mask(lc, t, chunk)
    assert lib.any(-1).all() and torch.equal(lib[live.any(-1)], live[live.any(-1)])
    n_bytes, n_ops, n_live = chip_smoke.chunk_flash_work(2, 1, t, 8, lc, chunk)
    assert n_live == int(live.sum()) and n_ops == 4 * 8 * n_live
