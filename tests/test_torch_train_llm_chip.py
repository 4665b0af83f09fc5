"""``chip_smoke.py``'s phase 19 plan (its launch sites, its configs, the checkpoint helpers,
its entries in the kernels line, the recipe's model dir and OpenAI batch) and, on the
card (``cuda``), a Fun-ASR-Nano training step through the flash and FSMN kernels against
the CPU. No JAX here: the card's machine runs these with the port alone
(``python -m pytest tests/test_torch_*.py -m cuda``).
"""

import copy
import logging
import os

import numpy as np
import pytest
import torch

from funasr_tpu_torch.register import tables

# a Fun-ASR-Nano whose encoder the kernels take on the card (head dim 32, 128 channels)
SMALL = dict(input_size=560, audio_encoder="SANMEncoder",
             audio_encoder_conf=dict(output_size=128, attention_heads=4, linear_units=192,
                                     num_blocks=3, kernel_size=11, sanm_shfit=0,
                                     dropout_rate=0.0),
             audio_adaptor="Linear",
             audio_adaptor_conf=dict(downsample_rate=2, encoder_dim=128, llm_dim=128,
                                     ffn_dim=128),
             llm_conf=dict(vocab_size=1000, hidden_size=128, intermediate_size=256,
                           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                           head_dim=32, qk_norm=True, tie_word_embeddings=True))


def test_phase19_sites_and_confs():
    """A full-width Fun-ASR-Nano step launches each of the five kernels once an encoder
    block (50), a validation batch only the forwards; (c)'s models keep NANO_FULL's widths
    and Qwen3-0.6B's vocabulary at 4 encoder blocks and 2 Qwen3 layers."""
    import chip_smoke
    step, val = chip_smoke.sv_train_sites(chip_smoke.NANO_ENCODER["num_blocks"])
    assert set(step.values()) == {50, 0} and step["w8a8_linear"] == 0
    assert val == dict(step, flash_attention_bwd=0, fsmn_memory_bwd_input=0,
                       fsmn_memory_bwd_weight=0)
    confs = chip_smoke.llm_train_confs()
    assert list(confs) == ["FunASRNano", "FunASRNano_ctc", "LLMASR2_batch", "Whisper"]
    assert all(name in tables.model_classes for name, _ in confs.values())
    nano = confs["FunASRNano"][1]
    assert nano["audio_encoder_conf"]["num_blocks"] == 4
    assert nano["audio_encoder_conf"]["output_size"] == 512
    assert nano["llm_conf"]["num_hidden_layers"] == 2
    assert nano["llm_conf"]["vocab_size"] == 151936 and nano["llm_conf"]["hidden_size"] == 1024
    assert confs["FunASRNano_ctc"][1]["ctc_weight"] > 0
    assert confs["FunASRNano_ctc"][1]["ctc_decoder"] == "Transformer"
    assert confs["Whisper"][1] == dict(encoder_layers=2, decoder_layers=2)
    assert {"++sharding=fsdp", "++distributed=true"} <= set(chip_smoke.NANO_TRAIN_RUN)
    assert "++train_conf.avg_nbest_model=5" in chip_smoke.NANO_TRAIN_RUN


def test_trainer_checkpoint_seconds_and_weights_reached(tmp_path, caplog):
    """The trainer logs each checkpoint's seconds, which ``checkpoint_seconds`` reads; the
    Adam moments in a checkpoint name every parameter no gradient reached (of a
    linear_q_k_v weight, its q / k rows)."""
    import chip_smoke
    from funasr_tpu_torch.train_utils.trainer import Trainer
    model = tables.model_classes["FunASRNano"](**SMALL, generator=torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    qkv = model.audio_encoder.encoders[0].self_attn.linear_q_k_v.weight
    qkv.grad[: 2 * qkv.shape[0] // 3] = 0  # q / k rows never reached, v rows were
    model.audio_adaptor.linear2.bias.grad.zero_()
    opt.step()
    trainer = Trainer(model, opt, output_dir=str(tmp_path), use_tensorboard=False)
    with caplog.at_level(logging.INFO):
        trainer.save_checkpoint(0, step=3, metric=0.5, metric_name="acc")
        trainer.save_checkpoint(0, metric=0.6, metric_name="acc")
    trainer.close()
    secs = chip_smoke.checkpoint_seconds(caplog.text)
    assert list(secs) == ["model.pt.ep0.3", "model.pt.ep0"] and all(s >= 0 for s in secs.values())
    names, zero = chip_smoke.nano_weights_reached(str(tmp_path / "model.pt.ep0.3"))
    assert len(names) == len(list(model.parameters()))
    assert zero == ["audio_encoder.encoders.0.self_attn.linear_q_k_v.weight",
                    "audio_adaptor.linear2.bias"]


def test_phase19_model_dir_and_openai_batch(tmp_path):
    """The recipe's dir (``write_nano_train_dir``, here at a small config on the CPU) names a
    ``CharTokenizer`` over the given tokens, which a ``bin/train`` process can build; the
    OpenAI batch of (c) holds one audio span a row, its slots those of the adaptor."""
    import chip_smoke
    from funasr_tpu_torch.auto.auto_model import AutoModel
    tokens = ["<blank>", "<s>", "</s>"] + [chr(0x4E00 + i) for i in range(40)] + ["<unk>"]
    d = str(tmp_path / "nano")
    os.makedirs(d)
    chip_smoke.write_nano_train_dir(d, torch.device("cpu"), tokens, conf=SMALL)
    model, kw = AutoModel.build_model(model=d, device="cpu", init_param=os.path.join(d, "model.pt"))
    assert type(model).__name__ == "FunASRNano"
    assert type(kw["tokenizer"]).__name__ == "CharTokenizer"
    assert kw["tokenizer"].encode(tokens[3] + tokens[4]) == [3, 4]
    batch = chip_smoke.openai_train_batch(str(tmp_path), np.random.default_rng(0))
    assert set(batch) == {"speech", "speech_lengths", "input_ids", "labels_ids", "fbank_mask"}
    slots = batch["fbank_mask"].sum(1).long()
    frames = batch["speech_lengths"].long()
    # the dataset sizes a span from its samples (encoder rate 1, adaptor 2), the frontend
    # counts its frames with the window's edges: within one slot of each other
    assert ((slots - ((frames - 1) // 2 + 1)).abs() <= 1).all()
    assert torch.equal((batch["labels_ids"] != -100).sum(1),
                       torch.tensor(chip_smoke.LLM_TRAIN_TEXT) + 1)  # the text, <|im_end|>


def test_kernels_line_carries_phase19_entries():
    """Every kernel, W8A8 at 0 launches included, carries phase 19's launches, its rows at
    the recipe's signatures and its launches in each model's CUDA step, under
    ``llm_training``."""
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
    nano_step, _ = chip_smoke.sv_train_sites(50)
    llm = dict(launches={k: 6 * v for k, v in nano_step.items()}, launches_per_step=nano_step,
               recipe_rows={"fsmn_memory_bwd_weight": {"5x190x512_k11": dict(row, launches=50)}},
               cuda_vs_cpu={"FunASRNano": dict(launches=chip_smoke.sv_train_sites(4)[0]),
                            "Whisper": dict(launches=dict.fromkeys(nano_step, 0))},
               decode_launches=dict(nano_step, flash_attention_bwd=0, fsmn_memory_bwd_input=0,
                                    fsmn_memory_bwd_weight=0))
    kernels = {k["name"]: k for k in chip_smoke.kernels_line(
        record, call, {"w8a8_linear": 282}, call, training=training,
        llm_training=llm)["kernels"]}
    assert kernels["fsmn_memory_bwd_weight"]["llm_training"] == dict(
        launches=300, launches_per_step=50,
        recipe_rows=llm["recipe_rows"]["fsmn_memory_bwd_weight"],
        cuda_vs_cpu_launches={"FunASRNano": 4, "Whisper": 0}, decode_launches=0)
    assert kernels["w8a8_linear"]["llm_training"]["launches"] == 0
    assert kernels["flash_attention"]["llm_training"]["decode_launches"] == 50


# ---------------------------------------------------------------------------
# on the card: a Fun-ASR-Nano step through the kernels
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("ctc_weight", [0.0, 0.3])
def test_nano_training_step_on_card_matches_cpu(cuda_device, ctc_weight):
    """``FunASRNano.forward`` + backward on the card (the encoder's 3 attentions and FSMN
    memories on the flash and FSMN kernels, forward and backward) against its copy on the
    CPU: the loss within 1e-5 relative, every gradient within 1e-4 relative L2, the
    launches one of each kernel a block."""
    import chip_smoke
    from funasr_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from funasr_tpu_torch.ops.fsmn import (fsmn_memory, fsmn_memory_bwd_input,
                                           fsmn_memory_bwd_weight)
    from funasr_tpu_torch.ops.w8a8 import w8a8_linear
    conf = dict(SMALL)
    if ctc_weight:
        conf.update(ctc_decoder="Linear", ctc_weight=ctc_weight, ctc_conf=dict(ctc_vocab_size=60),
                    ctc_decoder_conf=dict(downsample_rate=1, encoder_dim=128, llm_dim=128,
                                          ffn_dim=128))
    cpu = tables.model_classes["FunASRNano"](**conf, generator=torch.Generator().manual_seed(1))
    gpu = copy.deepcopy(cpu).to(cuda_device)
    rng = np.random.default_rng(1)
    feats = torch.from_numpy(rng.standard_normal((3, 90, 560)).astype(np.float32))
    flens = torch.tensor([90, 71, 40])
    tlens = torch.tensor([12, 9, 5])
    text = torch.full((3, 12), -1, dtype=torch.long)
    for i, n in enumerate(tlens.tolist()):
        text[i, :n] = torch.from_numpy(rng.integers(3, 60, n))
    counters = (flash_attention, fsmn_memory, w8a8_linear, flash_attention_bwd,
                fsmn_memory_bwd_input, fsmn_memory_bwd_weight)
    out = {}
    for label, model in (("cpu", cpu), ("cuda", gpu)):
        d = next(model.parameters()).device
        for c in counters:
            c.launches = 0
        loss, _, _ = model.train()(feats.to(d), flens.to(d), text.to(d), tlens.to(d))
        loss.backward()
        out[label] = (loss.item(), {n: p.grad for n, p in model.named_parameters()},
                      {c.__name__: c.launches for c in counters})
    (cl, cg, _), (gl, gg, launches) = out["cpu"], out["cuda"]
    assert abs(gl - cl) <= 1e-5 * abs(cl)
    worst, name, bad = chip_smoke.grad_rel_errors(cg, gg)
    assert worst <= 1e-4 and not bad, (name, worst, bad)
    assert launches == chip_smoke.sv_train_sites(3)[0]
