"""``chip_smoke.py``'s data-parallel parts (phase 16 (b) and (c), phase 19's torchrun run)
and, on the card (``cuda``), a Paraformer step under fsdp and dp over a one-rank NCCL
group against the plain step. No JAX here: the card's machine runs these with the port
alone (``python -m pytest tests/test_torch_*.py -m cuda``).
"""

import copy
import logging

import numpy as np
import pytest
import torch

from funasr_tpu_torch.register import tables

# a Paraformer whose attention the kernels take on the card (head dim 32), each encoder
# and decoder layer an FSDP unit (w_1 / w_2 of 128 x 512 = 65,536 elements)
SMALL = dict(input_size=560, vocab_size=300, encoder_conf=dict(
    output_size=128, attention_heads=4, linear_units=512, num_blocks=3, dropout_rate=0.0),
    decoder_conf=dict(attention_heads=4, linear_units=512, num_blocks=2, att_layer_num=2),
    predictor_conf=dict(idim=128), sos=1, eos=2, predictor_bias=1, lsm_weight=0.1,
    sampling_ratio=0.75, length_normalized_loss=True)


def test_recipes_run_their_default_fsdp():
    """Phase 16 (c) resumes the dp run under fsdp; phase 19 runs Fun-ASR-Nano's recipe with
    its default fsdp under torchrun on one rank; ``--sharding-ab`` times dp against it."""
    import chip_smoke
    assert "++sharding=fsdp" in chip_smoke.TRAIN_RESUMED
    assert not any(a.startswith("++sharding") for a in chip_smoke.TRAIN_FIRST)
    assert {"++sharding=fsdp", "++distributed=true"} <= set(chip_smoke.NANO_TRAIN_RUN)
    assert chip_smoke.NANO_TORCHRUN == ["torch.distributed.run", "--standalone",
                                        "--nproc_per_node=1", "-m"]
    # --sharding-ab profiles the sixth step, which its ms a step leave out
    assert "++train_conf.profile_start_step=5" in chip_smoke.SHARDING_AB_RUN


def test_data_group_seconds_reads_the_trainer_log(tmp_path, caplog):
    """An fsdp trainer on the CPU (its own one-rank gloo group) logs the group's and the
    sharding's seconds and each checkpoint's gather, which ``data_group_seconds`` reads
    beside ``bin/train``'s process-group line."""
    import chip_smoke
    from funasr_tpu_torch.train_utils.trainer import Trainer
    model = tables.model_classes["Paraformer"](**SMALL)
    with caplog.at_level(logging.INFO):
        t = Trainer(model, torch.optim.Adam(model.parameters(), lr=1e-3),
                    output_dir=str(tmp_path), sharding="fsdp", use_tensorboard=False)
        t.save_checkpoint(0, step=3)
        t.save_checkpoint(0)
        t.close()
    text = caplog.text + "\nINFO process group: 1 rank(s) on nccl, up in 2.5 s\n"
    got = chip_smoke.data_group_seconds(text)
    assert got["group"] == 2.5 and got["wrap"] >= 0
    assert list(got["gather"]) == ["model.pt.ep0.3", "model.pt.ep0"]
    assert list(chip_smoke.checkpoint_seconds(text)) == list(got["gather"])
    assert not torch.distributed.is_initialized()  # close() destroyed the trainer's group


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fsdp_and_dp_steps_on_one_nccl_rank_equal_the_plain_step(cuda_device):
    """Phase 16 (b)'s check at a small config: the step under dp and under fsdp (one NCCL
    rank in this process) against the plain step on the card, the same launches."""
    import chip_smoke
    from funasr_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from funasr_tpu_torch.ops.fsmn import (fsmn_memory, fsmn_memory_bwd_input,
                                           fsmn_memory_bwd_weight)
    from funasr_tpu_torch.ops.w8a8 import w8a8_linear
    counters = (flash_attention, fsmn_memory, w8a8_linear, flash_attention_bwd,
                fsmn_memory_bwd_input, fsmn_memory_bwd_weight)
    model = tables.model_classes["Paraformer"](
        **SMALL, generator=torch.Generator().manual_seed(4)).to(cuda_device).train()
    pristine = copy.deepcopy(model)
    rng = np.random.default_rng(4)
    tl = torch.tensor([12, 7])
    text = torch.full((2, 12), -1, dtype=torch.long)
    for i, n in enumerate(tl.tolist()):
        text[i, :n] = torch.from_numpy(rng.integers(3, 299, n))
    inputs = tuple(x.to(cuda_device) for x in (
        torch.from_numpy(rng.standard_normal((2, 90, 560)).astype(np.float32)),
        torch.tensor([90, 61]), text, tl,
        torch.from_numpy(rng.random((2, 13), dtype=np.float32))))
    for c in counters:
        c.launches = 0
    with chip_smoke.cif_tie_moved():
        loss, _, _ = model(*inputs[:4], sampler_uniform=inputs[4])
    loss.backward()
    sites = {c.__name__: c.launches for c in counters}
    assert sites == chip_smoke.train_sites(3, 2)[0]
    grads = {n: p.grad for n, p in model.named_parameters()}
    got = chip_smoke.train_data_parallel(cuda_device, counters, pristine, inputs, loss.item(),
                                         grads, sites)
    assert {"dp", "fsdp"} <= set(got) and not torch.distributed.is_initialized()
