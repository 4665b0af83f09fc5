"""The kernels of the diarization / SSL / separation slice on the card (no JAX): the FSMN
kernel at MossFormer's k 17 / left 8 (``FFConvM``'s h + dwconv(h), no mask) at the
separation's three widths, fp32 and bf16, against ``fsmn_memory_ref`` and the generic
instantiation (max abs error within 1e-5 fp32, 2e-2 bf16); its input gradient (the same
instantiation: (17, 8) maps onto itself) and the vector weight-gradient kernel at (17, 8)
within 1e-5 relative L2 of autograd through the plain version, dw bit-equal across two
runs; the flash kernel at D 64 in mode "none" at data2vec's (B, 12, T, 64) and EEND's
(B, 4, T, 64), forward within 1e-4 max abs of ``flash_attention_ref`` (valid rows) and
the backward within 1e-5 relative L2 of autograd through it, bit-equal across two runs;
a CTC model whose frontend is ``S3prlFrontend`` (CTC's ``inference`` takes host numpy)
through ``AutoModel(device="cuda").generate``: one flash launch a data2vec layer besides
the encoder's own. Each test is ``cuda``-marked and skips without a card; on the card: ``python -m pytest
tests/test_torch_longtail2_chip.py -m cuda --noconftest``.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from funasr_tpu_torch.ops.flash_attention import (flash_attention, flash_attention_bwd,
                                                  flash_attention_bwd_ref,
                                                  flash_attention_ref,
                                                  flash_attention_with_stats)
from funasr_tpu_torch.ops.fsmn import (dw_plan, fsmn_memory, fsmn_memory_bwd_input,
                                       fsmn_memory_bwd_ref, fsmn_memory_bwd_weight,
                                       fsmn_memory_ref)

FSMN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# MossFormer's FFConvM convs at the published widths (C = 2,048, 128, 512) over a 4 s
# mixture at 8 kHz (S = 3,999 frames), and a short batch of 2
FSMN_SHAPES = [(1, 3999, 2048), (1, 3999, 128), (1, 3999, 512), (2, 250, 512)]
# data2vec's 12 x 64 heads over 6 s (299 frames) and EEND's 4 x 64 over 60 frames
FLASH_SHAPES = [((2, 12, 299, 64), [299, 170]), ((2, 4, 60, 64), [60, 41]),
                ((1, 12, 300, 64), [299])]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    return torch.device("cuda")


def rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FSMN_SHAPES)
def test_k17_forward_matches_the_plain_version(cuda_device, shape, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(*shape, generator=g, device=cuda_device).to(dtype)
    w = ((torch.rand(shape[2], 1, 17, generator=g, device=cuda_device) * 2 - 1)
         / 17 ** 0.5).to(dtype)
    with torch.inference_mode():
        before = fsmn_memory.launches
        got = fsmn_memory(x, w, None, 8, 8)
        generic = fsmn_memory(x, w, None, 8, 8, generic=True)
        assert fsmn_memory.launches == before + 2
        want = fsmn_memory_ref(x, w, None, 8, 8)
    assert (got.float() - want.float()).abs().max().item() <= FSMN_TOL[dtype]
    assert (got.float() - generic.float()).abs().max().item() <= FSMN_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FSMN_SHAPES)
def test_k17_backward_kernels(cuda_device, shape):
    b, t, c = shape
    assert dw_plan(b, t, c, 17, 8, 132)[0]  # the vector weight-gradient kernel
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x, dout = (torch.randn(*shape, generator=g, device=cuda_device) for _ in range(2))
    w = (torch.rand(c, 1, 17, generator=g, device=cuda_device) * 2 - 1) / 17 ** 0.5
    want_dx, want_dw = fsmn_memory_bwd_ref(x, w, None, 8, 8, dout)
    n_in, n_w = fsmn_memory_bwd_input.launches, fsmn_memory_bwd_weight.launches
    dx = fsmn_memory_bwd_input(dout, w, None, 8, 8)
    dw, dw2 = (fsmn_memory_bwd_weight(x, dout, None, 8, 8) for _ in range(2))
    assert fsmn_memory_bwd_input.launches == n_in + 1
    assert fsmn_memory_bwd_weight.launches == n_w + 2
    assert rel_l2(dx, want_dx) <= 1e-5
    assert rel_l2(dw, want_dw.reshape(c, 17)) <= 1e-5
    assert torch.equal(dw, dw2)


def _heads(shape, g, dev):
    """q, k, v as (B, H, T, D) head views of one (B, T, 3, H, D) projection."""
    b, h, t, d = shape
    qkv = torch.randn(b, t, 3, h, d, generator=g, device=dev)
    return (qkv[:, :, i].transpose(1, 2) for i in range(3))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,lens", FLASH_SHAPES, ids=["d2v", "eend", "d2v_pad"])
def test_flash_d64_forward_and_backward(cuda_device, shape, lens):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v = _heads(shape, g, cuda_device)
    ln = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    with torch.inference_mode():
        out = flash_attention(q, k, v, ln)
        want = flash_attention_ref(q, k, v, ln)
    for i, n in enumerate(lens):
        assert (out[i, :, :n] - want[i, :, :n]).abs().max().item() <= 1e-4
    with torch.no_grad():
        out, stats = flash_attention_with_stats(q, k, v, ln)
    dout = torch.randn(out.shape, generator=g, device=cuda_device)
    got = flash_attention_bwd(q, k, v, out, dout, ln, stats=stats)
    again = flash_attention_bwd(q, k, v, out, dout, ln, stats=stats)
    ref = flash_attention_bwd_ref(q, k, v, dout, ln)
    for a, a2, r in zip(got, again, ref):
        assert rel_l2(a, r) <= 1e-5
        assert torch.equal(a, a2)


@pytest.mark.cuda
def test_ctc_with_the_s3prl_frontend_runs_the_trunk_on_the_card(cuda_device, tmp_path):
    from funasr_tpu_torch import AutoModel, tables
    from funasr_tpu_torch.models.sanm.attention import MultiHeadedAttentionSANM

    d2v = dict(encoder_conf=dict(conv_feature_layers="[(64,10,5)] + [(64,3,2)]",
                                 encoder_layers=2, encoder_embed_dim=128,
                                 encoder_ffn_embed_dim=256, encoder_attention_heads=2,
                                 average_top_k_layers=2))
    tokens = ["<blank>", "<s>", "</s>"] + [chr(0x4E00 + i) for i in range(12)] + ["<unk>"]
    enc = dict(output_size=64, attention_heads=4, linear_units=96, num_blocks=2)
    model = tables.model_classes["CTC"](input_size=128, vocab_size=len(tokens),
                                        encoder_conf=enc,
                                        generator=torch.Generator().manual_seed(7))
    torch.save(model.state_dict(), os.path.join(tmp_path, "model.pt"))
    with open(os.path.join(tmp_path, "tokens.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(tokens) + "\n")
    with open(os.path.join(tmp_path, "config.yaml"), "w", encoding="utf-8") as f:
        yaml.safe_dump(dict(
            model="CTC", encoder="SANMEncoder", encoder_conf=enc, frontend="S3prlFrontend",
            frontend_conf=dict(fs=16000, frontend_conf=dict(upstream="data2vec",
                                                            upstream_conf=d2v, seed=3)),
            tokenizer="CharTokenizer",
            tokenizer_conf=dict(token_list="tokens.txt", unk_symbol="<unk>")), f)
    am = AutoModel(model=str(tmp_path), device="cuda", log_level="WARNING")
    wav = (np.random.default_rng(0).standard_normal(16000) * 0.1).astype(np.float32)
    before = flash_attention.launches
    res = am.generate(input=[wav])
    sites = sum(isinstance(m, MultiHeadedAttentionSANM) for m in am.model.modules())
    assert flash_attention.launches - before == 2 + sites
    assert am.kwargs["frontend"].upstream.device.type == "cuda" and "text" in res[0]
