"""Training Fun-ASR-Nano, the LLM-ASR family and Whisper in the port, against the JAX
package's (CPU, fp32).

* ``FunASRNano.forward`` (loss, stats, weight) and every parameter's gradient against
  ``jax.jit(jax.value_and_grad(forward_jit))`` on the same weights (the port's state dict
  through ``convert_state_dict``): the Linear adaptor at ``ctc_weight`` 0, the Transformer
  adaptor with a Transformer ``ctc_decoder`` at 0.3. The loss and stats within 1e-5
  relative, each gradient leaf within 1e-4 relative L2; a leaf whose gradient is zero in
  exact arithmetic (an attention's key bias) stays under 1e-6 of the global norm in both.
* ``LLMASR2.forward_batch`` against ``forward_jit_batch`` on a collated
  ``OpenAIDataset`` batch (the same features), and one ``Trainer`` step on that batch
  against the JAX ``Trainer``'s ``_step_jit`` (SGD, the frontend inside the step).
* The copied datasets and prompt helpers equal to their originals: ``LLMDataset``,
  ``LLMVicunaDataset``, ``LLMQwenAudioDataset``, ``OpenAIDataset`` items and batches,
  ``detect_language``, ``MultiContextPrompt(New)`` under one seed, ``OpenAIIndexDSJsonl``.
* ``models/lora/layers.py`` against the JAX functions (and against ``peft``, where it
  imports); ``params_from_jax`` of LoRA leaves.
* The LoRA-load repair: a peft-layout Fun-ASR-Nano checkpoint loads through
  ``load_pretrained`` to the JAX converter's merged weights and logits, and a port
  ``generate`` gives the JAX package's ids.
* ``WhisperModel.forward`` at a tiny config; ``bin/train`` refusing a Whisper model.
* ``bin/train ++device=cpu`` on a small Fun-ASR-Nano dir under ``++sharding=dp`` and the
  recipe's ``fsdp`` (the same logs and weights), its averaged checkpoint generating
  through ``AutoModel``; the import boundary.

``chip_smoke.py``'s phase 19 and the card's tests are in ``test_torch_train_llm_chip.py``.
"""

import json
import os
import random
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from funasr_tpu.convert.torch_to_jax import convert_state_dict
from funasr_tpu.register import tables as jtables
from funasr_tpu_torch.register import tables
from torch_parity_util import (NANO_CONF, NANO_FRONTEND, one_torch_thread,  # noqa: F401
                               to_jax, wav_bytes, write_hf_tokenizer, write_nano_dir)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
ZERO_SHARE = 1e-6
MERGE_TOL = 2e-4

# chip_smoke.py's NANO_SMALL: 2 encoder blocks at d 64, a 2-layer Qwen3 at d 128, GQA 4 / 2
ENC = dict(output_size=64, attention_heads=4, linear_units=96, num_blocks=2, kernel_size=11,
           sanm_shfit=0, dropout_rate=0.0)
LLM = dict(vocab_size=1000, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, head_dim=32, qk_norm=True,
           tie_word_embeddings=True, rope_theta=1000000.0, rms_norm_eps=1e-6)
ADAPTORS = {
    "Linear": dict(downsample_rate=2, encoder_dim=64, llm_dim=128, ffn_dim=128),
    "Transformer": dict(downsample_rate=2, encoder_dim=64, llm_dim=128, ffn_dim=128,
                        n_layer=1, attention_heads=4)}
CTC_DECODER = dict(ctc_decoder="Transformer",
                   ctc_decoder_conf=dict(downsample_rate=1, encoder_dim=64, llm_dim=64,
                                         ffn_dim=96, n_layer=1, attention_heads=4),
                   ctc_conf=dict(ctc_vocab_size=50))
B, T, L = 3, 40, 9


def nano_conf(adaptor, ctc_weight, input_size=560):
    conf = dict(input_size=input_size, audio_encoder="SANMEncoder", audio_encoder_conf=ENC,
                audio_adaptor=adaptor, audio_adaptor_conf=ADAPTORS[adaptor], llm_conf=LLM)
    if ctc_weight:
        conf.update(CTC_DECODER, ctc_weight=ctc_weight)
    return conf


def leaf(tree, path):
    for k in path:
        tree = tree[k.key] if hasattr(k, "key") else tree[k.idx]
    return np.asarray(tree)


def port_grads(pt):
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in pt.named_parameters()}
    return {k: grads.get(k, v) for k, v in pt.state_dict().items()}


def assert_grads_match(jax_grads, port_tree):
    """Each leaf within GRAD_REL_L2 relative L2; a leaf under ZERO_SHARE of the global
    norm in JAX (zero in exact arithmetic) under it in the port too. Returns the count."""
    leaves = jax.tree_util.tree_leaves_with_path(jax_grads)
    floor = ZERO_SHARE * np.sqrt(sum(float(np.sum(np.square(w))) for _, w in leaves))
    for path, want in leaves:
        want, got = np.asarray(want), leaf(port_tree, path)
        if np.linalg.norm(want) <= floor:
            assert np.linalg.norm(got) <= floor, (jax.tree_util.keystr(path), floor)
            continue
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= GRAD_REL_L2, (jax.tree_util.keystr(path), rel)
    return len(leaves)


def assert_stats_match(pst, jst):
    assert set(pst) == set(jst)
    for k, want in jst.items():
        want, got = float(want), float(pst[k].detach())
        assert abs(got - want) <= LOSS_RTOL * max(abs(want), 1.0), (k, got, want)


def pair(name, conf, seed=0):
    pt = tables.model_classes[name](**conf, generator=torch.Generator().manual_seed(seed))
    jm = jtables.model_classes[name](**conf)
    return pt.train(), jm, to_jax(convert_state_dict(pt.state_dict(), jm, "FunASRNano"))


# ---------------------------------------------------------------------------
# Fun-ASR-Nano's loss
# ---------------------------------------------------------------------------

def nano_batch(seed=0):
    rng = np.random.default_rng(seed)
    speech = rng.standard_normal((B, T, 560)).astype(np.float32)
    slen = np.array([40, 33, 21], np.int32)
    tlen = np.array([6, 9, 3], np.int32)
    text = np.full((B, L), -1, np.int32)
    for i in range(B):
        text[i, :tlen[i]] = rng.integers(3, 50, tlen[i])
    text[1, 4] = -1  # an id < 0 inside a row's length: masked by text >= 0
    text[0, 2] = 60  # an id past the CTC head's 50 (an LLM token id): zeros in one_hot
    return speech, slen, text, tlen


@pytest.mark.parametrize("adaptor,ctc_weight", [("Linear", 0.0), ("Transformer", 0.3)])
def test_nano_loss_stats_and_grads_match_jax(adaptor, ctc_weight):
    pt, jm, params = pair("FunASRNano", nano_conf(adaptor, ctc_weight))
    speech, slen, text, tlen = nano_batch()

    def loss_fn(p):
        loss, stats, weight = jm.forward_jit(p, jnp.asarray(speech), jnp.asarray(slen),
                                             jnp.asarray(text), jnp.asarray(tlen))
        return loss, (stats, weight)

    (jl, (jst, jw)), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    loss, stats, weight = pt(torch.from_numpy(speech), torch.from_numpy(slen),
                             torch.from_numpy(text).long(), torch.from_numpy(tlen).long())
    loss.backward()
    assert np.isfinite(loss.item()) and abs(loss.item() - float(jl)) <= LOSS_RTOL * abs(float(jl))
    assert_stats_match(stats, jst)
    assert ("loss_ctc" in stats) == (ctc_weight > 0) and int(weight) == int(jw) == B
    assert assert_grads_match(jg, convert_state_dict(port_grads(pt), jm, "FunASRNano")) >= 40
    # every weight is reached: the tied token table by the lookups and the head together
    emb = pt.llm.model.embed_tokens.weight.grad
    assert emb is not None and emb.abs().sum() > 0
    assert all(p.grad is not None for p in pt.parameters())


def test_hidden_embeds_equals_the_cache_path():
    """The training path (no cache) gives the cache path's logits exactly."""
    from funasr_tpu_torch.models.llm.qwen import QwenConfig, QwenLM
    cfg = QwenConfig(**LLM)
    lm = QwenLM(cfg, generator=torch.Generator().manual_seed(3))
    x = torch.randn(2, 11, cfg.hidden_size, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        got = lm.forward_embeds(x)
        kv = lm.init_kv_cache(2, 11, dtype=torch.float32)
        want, _ = lm.forward(x, torch.arange(11)[None].expand(2, 11), kv,
                             torch.zeros(2, dtype=torch.long), torch.full((2,), 11))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the OpenAI-format data and the LLM-ASR batch loss
# ---------------------------------------------------------------------------

class ByteTokenizer:
    """ids 1..95 from bytes; id 0 is the audio slot (``tests/test_llm_asr_multiturn.py``)."""

    def encode(self, text):
        return [1 + ((b - 32) % 95) for b in text.encode()][:512]

    def decode(self, ids):
        return "".join(chr(32 + ((i - 1) % 95)) for i in ids if i > 0)


LLMASR_CONF = dict(input_size=560, audio_encoder="SANMEncoder",
                   audio_encoder_conf=dict(ENC, output_size=32, linear_units=48),
                   audio_adaptor="Linear",
                   audio_adaptor_conf=dict(downsample_rate=2, encoder_dim=32, llm_dim=48,
                                           ffn_dim=48),
                   llm_conf=dict(LLM, vocab_size=128, hidden_size=48, intermediate_size=96,
                                 head_dim=12))
DS_CONF = dict(audio_encoder_downsample_rate=1, audio_adaptor_downsample_rate=2)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """4 wavs of 0.5-1.1 s; an OpenAI-format jsonl (system / user / assistant turns, one
    of two turns) and a plain one with prompts."""
    root = tmp_path_factory.mktemp("llm_corpus")
    rng = np.random.default_rng(17)
    rows, plain = [], []
    for i in range(4):
        path = str(root / f"a{i}.wav")
        n = int(16000 * (0.5 + 0.2 * i))
        with open(path, "wb") as f:
            f.write(wav_bytes(0.2 * rng.standard_normal(n)))
        turns = 2 if i == 1 else 1
        rows.append({"system": ["You transcribe."] * turns,
                     "user": [f"Say <|startofspeech|>!{path}<|endofspeech|> now"] * turns,
                     "assistant": [f"hello {i}", f"again {i}"][:turns], "source": path,
                     "target": f"hello {i}", "source_len": n, "target_len": 7,
                     "key": f"u{i}"})
        plain.append({"source": path, "target": f"text {i}", "source_len": n,
                      "target_len": 6, "key": f"p{i}", "prompt": f"Transcribe #{i}."})
    paths = {}
    for name, lines in (("openai", rows), ("plain", plain)):
        paths[name] = str(root / f"{name}.jsonl")
        with open(paths[name], "w", encoding="utf-8") as f:
            f.write("\n".join(json.dumps(r) for r in lines) + "\n")
    return paths


def frontends():
    from funasr_tpu.frontends.wav_frontend import WavFrontend as JaxFrontend
    from funasr_tpu_torch.frontends.wav_frontend import WavFrontend
    conf = dict(NANO_FRONTEND, cmvn_file=None)
    return WavFrontend(**conf), JaxFrontend(**conf)


def dataset_pair(name, path, **kwargs):
    import funasr_tpu  # noqa: F401 (registers the JAX datasets)
    pfe, jfe = frontends()
    tok = ByteTokenizer()
    make = {}
    for side, tabs, fe in (("port", tables, pfe), ("jax", jtables, jfe)):
        make[side] = tabs.dataset_classes[name](index_ds="IndexDSJsonl",
                                                index_ds_conf={"path": path}, tokenizer=tok,
                                                frontend=fe, **kwargs)
    return make["port"], make["jax"]


def assert_items_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("name,data,kwargs", [
    ("OpenAIDataset", "openai", DS_CONF), ("OpenAIDatasetMultiTurn", "openai", {}),
    ("LLMDataset", "plain", {}), ("LLMVicunaDataset", "plain", {}),
    ("LLMQwenAudioDataset", "plain", {})])
def test_dataset_items_and_batches_equal_jax(corpus, name, data, kwargs):
    port, ref = dataset_pair(name, corpus[data], **kwargs)
    assert len(port) == len(ref) == 4
    items = [port[i] for i in range(4)]
    for i, item in enumerate(items):
        assert_items_equal(item, ref[i])
    assert_items_equal(port.collator(items), ref.collator([ref[i] for i in range(4)]))


def test_parity_aliases_bind_the_llm_datasets():
    ds = tables.dataset_classes
    for alias, target in (("AudioLLMDataset", "LLMDataset"), ("AudioLLMARDataset", "LLMDataset"),
                          ("AudioLLMNARDataset", "LLMDataset"),
                          ("AudioLLMQwenAudioDataset", "LLMQwenAudioDataset"),
                          ("AudioLLMVicunaDataset", "LLMVicunaDataset")):
        assert ds[alias] is ds[target]
    assert ds["KwsMTDataset"] is ds["KWSDataset"]  # the keyword spotters' dataset
    assert set(tables.prompt_classes) >= {"MultiContextPrompt", "MultiContextPromptNew"}
    assert "OpenAIIndexDSJsonl" in tables.index_ds_classes


def openai_batch(corpus):
    port, _ = dataset_pair("OpenAIDataset", corpus["openai"], **DS_CONF)
    return port.collator([port[i] for i in range(3)])


def test_llm_asr_batch_loss_and_grads_match_jax(corpus):
    batch = openai_batch(corpus)
    pfe, _ = frontends()
    with torch.no_grad():
        feats, flens = pfe.forward(torch.from_numpy(batch["speech"]),
                                   torch.from_numpy(batch["speech_lengths"]))
    pt = tables.model_classes["LLMASR2"](**LLMASR_CONF,
                                         generator=torch.Generator().manual_seed(2)).train()
    jm = jtables.model_classes["LLMASR2"](**LLMASR_CONF)
    params = to_jax(convert_state_dict(pt.state_dict(), jm, "FunASRNano"))
    jbatch = {"speech": jnp.asarray(feats.numpy()), "speech_lengths": jnp.asarray(flens.numpy()),
              **{k: jnp.asarray(batch[k]) for k in ("input_ids", "labels_ids", "fbank_mask")}}

    def loss_fn(p):
        loss, stats, weight = jm.forward_jit_batch(p, jbatch)
        return loss, (stats, weight)

    (jl, (jst, jw)), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tbatch = {"speech": feats, "speech_lengths": flens,
              **{k: torch.from_numpy(batch[k]) for k in ("input_ids", "labels_ids", "fbank_mask")}}
    loss, stats, weight = pt.forward_batch(tbatch)
    loss.backward()
    assert abs(loss.item() - float(jl)) <= LOSS_RTOL * abs(float(jl))
    assert_stats_match(stats, jst)
    assert int(weight) == int(jw) == 3
    assert assert_grads_match(jg, convert_state_dict(port_grads(pt), jm, "FunASRNano")) >= 30
    with pytest.raises(ValueError, match="fbank features"):
        pt.forward_batch({**tbatch, "speech": torch.from_numpy(batch["speech"])})


def test_splice_audio_embeds_matches_jax():
    pt = tables.model_classes["LLMASR"](**LLMASR_CONF)
    jm = jtables.model_classes["LLMASR"](**LLMASR_CONF)
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((2, 9, 5)).astype(np.float32)
    audio = rng.standard_normal((2, 4, 5)).astype(np.float32)
    mask = np.zeros((2, 9), np.float32)
    mask[0, 2:6], mask[1, 1:8] = 1, 1  # row 1: more slots than audio rows (clipped)
    got = pt.splice_audio_embeds(torch.from_numpy(emb), torch.from_numpy(audio), None,
                                 torch.from_numpy(mask))
    want = jm.splice_audio_embeds(jnp.asarray(emb), jnp.asarray(audio), None, jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_trainer_step_on_an_openai_batch_matches_jax_trainer(corpus, tmp_path):
    """The port's ``Trainer.train_step`` on a collated OpenAI-format batch (waveforms:
    the frontend runs in the step; ``forward_batch`` by dispatch) against the JAX
    trainer's ``_step_jit``: the loss, the gradient norm and every weight after the SGD
    update."""
    from funasr_tpu.parallel.sharding import make_mesh
    from funasr_tpu.train_utils.trainer import Trainer as JaxTrainer
    from funasr_tpu_torch.train_utils.trainer import Trainer

    batch = openai_batch(corpus)
    pfe, jfe = frontends()
    pt = tables.model_classes["LLMASR2"](**LLMASR_CONF,
                                         generator=torch.Generator().manual_seed(4))
    jm = jtables.model_classes["LLMASR2"](**LLMASR_CONF)
    params = to_jax(convert_state_dict(pt.state_dict(), jm, "FunASRNano"))
    trainer = Trainer(pt, torch.optim.SGD(pt.parameters(), lr=0.1), frontend=pfe,
                      output_dir=str(tmp_path / "port"), clip_grad_norm=5.0,
                      use_tensorboard=False)
    jt = JaxTrainer(jm, optax.sgd(0.1), frontend=jfe, output_dir=str(tmp_path / "jax"),
                    clip_grad_norm=5.0, mesh=make_mesh(1, model=1), use_tensorboard=False)
    arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    new, _, jstats = jt._step_jit(params, jt.tx.init(params), arrays, jax.random.PRNGKey(0))
    stats = trainer.train_step(batch)
    trainer.close()
    for k in ("loss", "acc", "grad_norm"):
        got, want = float(stats[k].detach()), float(jstats[k])
        assert abs(got - want) <= 1e-4 * max(abs(want), 1.0), (k, got, want)
    got = convert_state_dict({k: v.detach() for k, v in pt.state_dict().items()}, jm,
                             "FunASRNano")
    for path, want in jax.tree_util.tree_leaves_with_path(new):
        np.testing.assert_allclose(leaf(got, path), np.asarray(want), rtol=1e-4, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# the prompt helpers
# ---------------------------------------------------------------------------

def test_detect_language_and_index_equal_jax(corpus, tmp_path):
    from funasr_tpu.datasets import fun_asr_datasets as jfa
    from funasr_tpu_torch.datasets import fun_asr_datasets as pfa
    for text in ("语音转写", "hello world", "", ["你好", "world"], "abc 中文字符很多"):
        assert pfa.detect_language(text) == jfa.detect_language(text)
    path = tmp_path / "msgs.jsonl"
    rows = [{"messages": [{"role": "user", "content": [{"audio": "/x/a.wav"}, "hi"]},
                          {"role": "assistant", "content": "你好"}], "key": "k0"},
            {"conversation": [{"role": "assistant", "content": "x"}], "source": "/y.wav",
             "source_len": 9},
            {"source": "/z.wav", "target": "z", "target_len": 3}]
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n", encoding="utf-8")
    got, want = pfa.OpenAIIndexDSJsonl(str(path)), jfa.OpenAIIndexDSJsonl(str(path))
    assert len(got) == len(want) == 3 and got.contents == want.contents


@pytest.mark.parametrize("name", ["MultiContextPrompt", "MultiContextPromptNew"])
def test_multicontext_prompts_equal_jax_under_one_seed(name, tmp_path):
    from funasr_tpu.datasets import fun_asr_datasets as jfa
    from funasr_tpu_torch.datasets import fun_asr_datasets as pfa
    zh, en = tmp_path / "zh.txt", tmp_path / "en.txt"
    zh.write_text("\n".join(f"热词{i}" for i in range(40)), encoding="utf-8")
    en.write_text("\n".join(f"word{i}" for i in range(40)), encoding="utf-8")
    conf = dict(chinese_hotwords_list=str(zh), english_hotwords_list=str(en),
                max_neg_hotwords_num=6, min_neg_hotwords_num=1)
    items = [{"hist_context": "上一句", "one_pass_result": "一遍",
              "hotwords": "阿里, 通义"},
             {"asr_hotwords": ["alpha", "beta"], "hotwords": "ignored"},
             {"one_pass_result": "only"}, {}]
    out = {}
    for side, mod in (("port", pfa), ("jax", jfa)):
        prompt = getattr(mod, name)(**conf)
        np.random.seed(5)
        random.seed(5)
        out[side] = [prompt.get_prompt(it, lang) for it in items for lang in ("zh", "en")]
        out[side] += [prompt.get_inference_prompt(it, lang) for it in items
                      for lang in ("zh", "en")]
    assert out["port"] == out["jax"]
    assert any("word" in p for p in out["port"])  # negatives were drawn


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------

def jax_path(name):
    """A port linear's name as the JAX tree's path to its dict."""
    if name.startswith("llm."):
        name = name.replace("model.layers.", "layers.").replace("self_attn.", "")
    return name.replace("encoders0.0.", "encoders0.").replace(".", "/")


def test_lora_functions_match_jax():
    from funasr_tpu.models.lora import layers as jl
    from funasr_tpu_torch.convert import params_from_jax
    from funasr_tpu_torch.models.lora import layers as pl

    pt = tables.model_classes["FunASRNano"](**nano_conf("Linear", 0.0),
                                            generator=torch.Generator().manual_seed(6))
    jm = jtables.model_classes["FunASRNano"](**nano_conf("Linear", 0.0))
    params = convert_state_dict(pt.state_dict(), jm, "FunASRNano")
    targets = ("linear_q_k_v", "q_proj", "o_proj")
    names = pl.inject_lora(pt, torch.Generator().manual_seed(7), targets, r=4)
    jparams = jl.inject_lora(to_jax(params), jax.random.PRNGKey(0), targets, r=4)
    jpaths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path[:-1])
              for path, _ in jax.tree_util.tree_leaves_with_path(jparams)
              if getattr(path[-1], "key", None) == "lora_a"]
    # the JAX walk passes over a scanned stack's 3-d weights (the encoder's blocks after
    # the first); the port has no stacks and gives every matched linear its factors
    assert len(jpaths) == 1 + 2 * 2 and len(names) == 2 + 2 * 2
    assert {jax_path(n) for n in names if ".encoders." not in n} == set(jpaths)
    for n in names:
        if ".encoders." in n:  # the linears the JAX walk passed over: no JAX factors to load
            del pt.get_submodule(n).lora_A, pt.get_submodule(n).lora_B
    lin = pt.audio_encoder.encoders0[0].self_attn.linear_q_k_v
    assert lin.lora_A.shape == (4, 560) and lin.lora_B.abs().sum() == 0
    assert abs(lin.lora_A.std().item() - 0.25) < 0.05  # normal / r
    # the same factors in both packages: the JAX tree's, with lora_b made nonzero
    jparams = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.3 if getattr(p[-1], "key", None) == "lora_b" else v, jparams)
    npt = jax.tree_util.tree_map(np.asarray, jparams)
    pt.load_state_dict(params_from_jax(npt, pt))
    jlin = jparams["audio_encoder"]["encoders0"]["self_attn"]["linear_q_k_v"]
    x = np.random.default_rng(8).standard_normal((2, 5, 560)).astype(np.float32)
    got = pl.lora_linear_apply(lin, torch.from_numpy(x), r=4, alpha=16)
    want = jl.lora_linear_apply({k: jlin[k] for k in ("w", "b")}, jlin, jnp.asarray(x), r=4,
                                alpha=16)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    # the trainable set: the LoRA factors and the names holding "norm"
    trainable = pl.lora_param_filter(pt, extra_trainable=("norm",))
    jmask = jl.lora_param_filter(jparams["llm"], extra_trainable=("norm",))
    n_jax = sum(jax.tree_util.tree_leaves(jmask))
    llm_trainable = [n for n in trainable if n.startswith("llm.")]
    assert len(llm_trainable) == n_jax == 2 * 2 * 2 + 2 * 4 + 1
    assert all(p.requires_grad == (n in trainable) for n, p in pt.named_parameters())
    # merging
    pl.merge_lora(pt, r=4, alpha=16)
    merged = jl.merge_lora(jparams, r=4, alpha=16)
    assert not any("lora" in n for n, _ in pt.named_parameters())
    np.testing.assert_allclose(pt.llm.model.layers[1].self_attn.o_proj.weight.detach().numpy(),
                               np.asarray(merged["llm"]["layers"][1]["o_proj"]["w"]).T,
                               atol=1e-5, rtol=1e-5)


def test_lora_matches_peft():
    """``peft``'s LoRA (where it imports) as a third oracle: the same factors give the same
    forward and the same merged weight."""
    peft = pytest.importorskip("peft")
    from funasr_tpu_torch.models.lora import layers as pl
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(12, 10))
    ref = peft.get_peft_model(torch.nn.Sequential(torch.nn.Linear(12, 10)),
                              peft.LoraConfig(r=4, lora_alpha=16, target_modules=["0"]))
    ref.base_model.model[0].base_layer.load_state_dict(net[0].state_dict())
    pl.inject_lora(net, torch.Generator().manual_seed(1), targets=("0",), r=4)
    with torch.no_grad():
        net[0].lora_B.normal_()
        ref.base_model.model[0].lora_A["default"].weight.copy_(net[0].lora_A)
        ref.base_model.model[0].lora_B["default"].weight.copy_(net[0].lora_B)
    x = torch.randn(3, 12)
    torch.testing.assert_close(pl.lora_linear_apply(net[0], x, r=4, alpha=16), ref(x))
    pl.merge_lora(net, r=4, alpha=16)
    torch.testing.assert_close(net[0].weight, ref.merge_and_unload()[0].weight)


def peft_state_dict(model, seed=0, r=4):
    """``model``'s state dict in peft's layout for its LLM: ``llm.base_model.model.``
    before every LLM key, q / k / v / o under ``.base_layer.`` with random nonzero
    ``lora_A.default`` / ``lora_B.default`` beside them."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in model.state_dict().items():
        if not k.startswith("llm."):
            sd[k] = v
            continue
        k = "llm.base_model.model." + k[len("llm."):]
        if any(f"self_attn.{p}_proj.weight" in k for p in "qkvo"):
            base = k[: -len(".weight")]
            sd[base + ".base_layer.weight"] = v
            sd[base + ".lora_A.default.weight"] = 0.05 * torch.randn(r, v.shape[1], generator=g)
            sd[base + ".lora_B.default.weight"] = 0.05 * torch.randn(v.shape[0], r, generator=g)
        else:
            sd[k] = v
    return sd


def test_peft_checkpoint_loads_merged_as_in_jax(tmp_path):
    """The repaired fault: a LoRA-fine-tuned Fun-ASR-Nano ``model.pt`` (peft layout) loads
    in the port (it raised ``KeyError``): the weights the JAX converter merges, within
    MERGE_TOL, the same teacher-forced logits, and ``AutoModel.generate`` gives the JAX
    ``AutoModel``'s ids."""
    from funasr_tpu.auto import auto_model as jauto
    from funasr_tpu_torch import AutoModel
    from funasr_tpu_torch.models.fun_asr_nano.model import FunASRNano
    from funasr_tpu_torch.utils.load_utils import load_pretrained
    from torch_parity_util import speech

    tok = write_hf_tokenizer(tmp_path / "tok")
    os.makedirs(tmp_path / "nano")
    d, model = write_nano_dir(tmp_path / "nano", tok)
    sd = peft_state_dict(model)
    torch.save(sd, os.path.join(d, "model.pt"))
    jm = jtables.model_classes["FunASRNano"](**NANO_CONF)
    params = convert_state_dict(sd, jm, "FunASRNano")
    pt = FunASRNano(**NANO_CONF).eval()
    with pytest.raises(KeyError):  # the loader without the model's name merges nothing
        load_pretrained(FunASRNano(**NANO_CONF), os.path.join(d, "model.pt"))
    load_pretrained(pt, os.path.join(d, "model.pt"), "FunASRNano")
    for i, layer in enumerate(pt.llm.model.layers):
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            want = np.asarray(params["llm"]["layers"][i][name]["w"]).T
            np.testing.assert_allclose(getattr(layer.self_attn, name).weight.detach().numpy(),
                                       want, atol=MERGE_TOL, rtol=0)
            assert np.abs(want - model.state_dict()[
                f"llm.model.layers.{i}.self_attn.{name}.weight"].numpy()).max() > 1e-3
    x = np.random.default_rng(9).standard_normal((2, 13, NANO_CONF["llm_conf"]["hidden_size"]))
    x = x.astype(np.float32)
    with torch.no_grad():
        got = pt.llm.forward_embeds(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jm.llm.forward_embeds)(to_jax(params["llm"]), jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=MERGE_TOL, rtol=0)
    wave = speech(1.5, [(0.2, 1.2, 260.0)], seed=3)
    call = dict(max_new_tokens=8, num_slots=2)
    kw = dict(model=d, device="cpu", log_level="WARNING", disable_pbar=True)
    res = AutoModel(**kw).generate(input=[wave], **call)
    ref = jauto.AutoModel(**kw).generate(input=[wave], **call)
    assert res[0]["text"] == ref[0]["text"] and len(res[0]["text"]) > 0


# ---------------------------------------------------------------------------
# Whisper's loss
# ---------------------------------------------------------------------------

WHISPER_TINY = dict(whisper_size="whisper-tiny", d_model=64, encoder_layers=1,
                    decoder_layers=1, encoder_attention_heads=4, decoder_attention_heads=4,
                    encoder_ffn_dim=96, decoder_ffn_dim=96, num_mel_bins=16, vocab_size=300,
                    max_source_positions=40, max_target_positions=16)


def test_whisper_loss_and_grads_match_jax():
    from funasr_tpu.models.whisper import model as jwhisper
    pt = tables.model_classes["whisper-tiny"](
        **{k: v for k, v in WHISPER_TINY.items() if k != "whisper_size"},
        generator=torch.Generator().manual_seed(5)).train()
    jm = jwhisper.WhisperModel(**WHISPER_TINY)
    params = to_jax(convert_state_dict(pt.state_dict(), jm, "Whisper-tiny"))
    rng = np.random.default_rng(5)
    mel = rng.standard_normal((2, 60, 16)).astype(np.float32)
    mlen = np.array([60, 44], np.int32)
    tlen = np.array([9, 5], np.int32)
    text = np.full((2, 10), -1, np.int32)
    for i in range(2):
        text[i, :tlen[i]] = rng.integers(0, 300, tlen[i])

    def loss_fn(p):
        loss, stats, weight = jm.forward_jit(p, jnp.asarray(mel), jnp.asarray(mlen),
                                             jnp.asarray(text), jnp.asarray(tlen), None)
        return loss, (stats, weight)

    (jl, (jst, jw)), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    loss, stats, weight = pt(torch.from_numpy(mel), torch.from_numpy(mlen),
                             torch.from_numpy(text).long(), torch.from_numpy(tlen).long())
    loss.backward()
    assert abs(loss.item() - float(jl)) <= LOSS_RTOL * abs(float(jl))
    assert_stats_match(stats, jst)
    assert int(weight) == int(jw) == 2
    assert pt.model.encoder.embed_positions.weight.grad is None  # fixed sinusoids, as in JAX
    assert assert_grads_match(jg, convert_state_dict(port_grads(pt), jm, "Whisper-tiny")) >= 20


def test_bin_train_refuses_whisper(tmp_path):
    from funasr_tpu_torch.bin.train import main
    with pytest.raises(NotImplementedError, match="WhisperFrontend has no batched forward"):
        main(model="whisper-tiny", model_conf={}, frontend="WhisperFrontend",
             frontend_conf=dict(n_mels=80), device="cpu", encoder_layers=1,
             decoder_layers=1, output_dir=str(tmp_path / "exp"))


def test_every_llm_model_trains():
    """No ``forward`` of the family raises: FunASRNano's and Whisper's are the losses, every
    LLMASR name inherits ``forward_batch``, GLMASR (bound since its TransformerEncoder was
    ported) included."""
    from funasr_tpu_torch.models.fun_asr_nano.model import FunASRNano
    names = [n for n, c in tables.model_classes.items()
             if isinstance(c, type) and issubclass(c, FunASRNano)]
    assert len(names) >= 13 and "GLMASR" in names
    for n in names:
        assert callable(getattr(tables.model_classes[n], "forward_batch", None)) \
            or n == "FunASRNano", n


# ---------------------------------------------------------------------------
# the recipe on the CPU, and the import boundary
# ---------------------------------------------------------------------------

def test_nano_recipe_cpu_end_to_end(tmp_path):
    """``data_tools scp2jsonl`` and ``bin/train`` as ``fun_asr_nano/finetune.sh`` runs
    them (``++device=cpu``) on a small Fun-ASR-Nano dir, under ``++sharding=dp`` and under
    the recipe's default ``fsdp`` (a one-rank group of the trainer's own, no torchrun),
    both at once: the same logs and averaged weights; the average generates through
    ``AutoModel(model=<output dir>)``."""
    import yaml
    d = str(tmp_path)
    env = dict(os.environ, PYTHONPATH=REPO)
    os.makedirs(tmp_path / "nano")
    md, _ = write_nano_dir(tmp_path / "nano", tmp_path)
    # a character tokenizer over the LLM's 160 ids: no transformers in the subprocess
    tokens = ["<blank>", "<s>", "</s>"] + [chr(ord("一") + i) for i in range(156)] + ["<unk>"]
    (tmp_path / "nano" / "tokens.txt").write_text("\n".join(tokens) + "\n", encoding="utf-8")
    cfg = yaml.safe_load((tmp_path / "nano" / "config.yaml").read_text(encoding="utf-8"))
    cfg.update(tokenizer="CharTokenizer", tokenizer_conf=dict(token_list="tokens.txt"))
    (tmp_path / "nano" / "config.yaml").write_text(yaml.safe_dump(cfg, allow_unicode=True),
                                                   encoding="utf-8")
    rng = np.random.default_rng(12)
    jsonl = {}
    for split, n in (("train", 4), ("val", 2)):
        scp, txt = [], []
        for i in range(n):
            path = os.path.join(d, f"{split}{i}.wav")
            with open(path, "wb") as f:
                f.write(wav_bytes(0.2 * rng.standard_normal(int(16000 * (0.8 + 0.2 * i)))))
            scp.append(f"{split}{i} {path}")
            txt.append(f"{split}{i} " + "".join(chr(ord("一") + int(j))
                                                for j in rng.integers(0, 100, 3 + i)))
        for kind, lines in (("wav.scp", scp), ("text.txt", txt)):
            with open(os.path.join(d, f"{split}_{kind}"), "w", encoding="utf-8") as f:
                f.write("\n".join(lines) + "\n")
        jsonl[split] = os.path.join(d, f"{split}.jsonl")
        subprocess.run([sys.executable, "-m", "funasr_tpu_torch.bin.data_tools", "scp2jsonl",
                        f'++scp_file_list=["{d}/{split}_wav.scp","{d}/{split}_text.txt"]',
                        '++data_type_list=["source","target"]', f"++jsonl_file_out={jsonl[split]}"],
                       check=True, env=env, cwd=d, capture_output=True)
    outs = {mode: os.path.join(d, f"exp_{mode}") for mode in ("dp", "fsdp")}
    runs = {mode: subprocess.Popen(
        [sys.executable, "-m", "funasr_tpu_torch.bin.train", f"++model={md}", "++device=cpu",
         f"++train_data_set_list={jsonl['train']}", f"++valid_data_set_list={jsonl['val']}",
         f"++sharding={mode}", "++dataset_conf.batch_size=300",
         "++dataset_conf.batch_type=token", "++optim_conf.lr=0.0002",
         "++train_conf.max_epoch=2", "++train_conf.log_interval=1",
         "++train_conf.keep_nbest_models=10", "++train_conf.avg_nbest_model=5",
         "++train_conf.use_tensorboard=False", f"++output_dir={out}"],
        env=dict(env, OMP_NUM_THREADS="1"), cwd=d, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True) for mode, out in outs.items()}
    for mode, run in runs.items():
        _, err = run.communicate(timeout=300)
        assert run.returncode == 0, (mode, err[-3000:])
    logs = {mode: [json.loads(line) for line in open(os.path.join(out, "train.log.jsonl"))]
            for mode, out in outs.items()}
    drop = ("time", "data_load", "step_time")  # host clocks
    assert [{k: v for k, v in x.items() if k not in drop} for x in logs["fsdp"]] == \
        [{k: v for k, v in x.items() if k not in drop} for x in logs["dp"]]
    avg = {mode: torch.load(os.path.join(out, "model.pt.avg"), map_location="cpu",
                            weights_only=True)["state_dict"] for mode, out in outs.items()}
    assert list(avg["fsdp"]) == list(avg["dp"])
    for k, v in avg["dp"].items():
        assert torch.equal(avg["fsdp"][k], v), k
    out, logs = outs["fsdp"], logs["fsdp"]
    steps = [x for x in logs if "validate" not in x]
    assert len(steps) >= 4 and all(np.isfinite([x["loss"], x["acc"], x["loss_ctc"]]).all()
                                   for x in steps)
    assert [x["validate"]["acc"] for x in logs if "validate" in x]
    from funasr_tpu_torch import AutoModel
    am = AutoModel(model=out, init_param=os.path.join(out, "model.pt.avg"), device="cpu",
                   log_level="WARNING", disable_pbar=True)
    res = am.generate(input=[os.path.join(d, "val0.wav")], max_new_tokens=6, num_slots=2)
    assert res[0]["key"] == "val0" and isinstance(res[0]["text"], str)


def test_openai_recipe_cpu_end_to_end(corpus, tmp_path):
    """The LLM-ASR family's recipe: ``bin/train ++dataset=OpenAIDataset`` (in-process,
    ``++device=cpu``) on a small LLMASR2 dir over the OpenAI-format jsonl; every batch goes
    to ``forward_batch`` (its stats: ``loss_llm``, no CTC), checkpoints rank by ``acc``."""
    import yaml
    from funasr_tpu_torch.bin.train import main
    d = tmp_path / "llmasr"
    os.makedirs(d)
    tokens = ["<blank>", "<s>", "</s>"] + [chr(c) for c in range(32, 127)] + ["<unk>"]
    (d / "tokens.txt").write_text("\n".join(tokens) + "\n", encoding="utf-8")
    (d / "config.yaml").write_text(yaml.safe_dump(dict(
        model="LLMASR2", **{k: v for k, v in LLMASR_CONF.items() if k != "input_size"},
        frontend="WavFrontend", frontend_conf=dict(NANO_FRONTEND, cmvn_file=None),
        tokenizer="CharTokenizer", tokenizer_conf=dict(token_list="tokens.txt"))),
        encoding="utf-8")
    out = str(tmp_path / "exp")
    main(model=str(d), device="cpu", dataset="OpenAIDataset",
         dataset_conf=dict(batch_size=2, batch_type="example", **DS_CONF),
         train_data_set_list=corpus["openai"], valid_data_set_list=corpus["openai"],
         train_conf=dict(max_epoch=1, log_interval=1, use_tensorboard=False,
                         avg_nbest_model=1), output_dir=out)
    logs = [json.loads(line) for line in open(os.path.join(out, "train.log.jsonl"))]
    steps = [x for x in logs if "validate" not in x]
    assert len(steps) == 2 and all(np.isfinite(x["loss"]) and "loss_llm" in x for x in steps)
    assert "acc" in logs[-1]["validate"] and os.path.exists(os.path.join(out, "model.pt.avg"))


NEW_MODULES = ["funasr_tpu_torch.datasets.fun_asr_datasets",
               "funasr_tpu_torch.datasets.specialized_datasets",
               "funasr_tpu_torch.models.lora.layers", "funasr_tpu_torch.models.llm_asr.model",
               "funasr_tpu_torch.models.whisper.model", "funasr_tpu_torch.utils.load_utils",
               "funasr_tpu_torch.train_utils.trainer", "funasr_tpu_torch.bin.train",
               "funasr_tpu_torch.parallel.sharding", "funasr_tpu_torch.parallel.dryrun"]


def test_new_modules_import_without_jax():
    code = ("import importlib, sys\n"
            f"for m in {NEW_MODULES!r}:\n    importlib.import_module(m)\n"
            "from funasr_tpu_torch.register import tables\n"
            "assert 'OpenAIDataset' in tables.dataset_classes\n"
            "bad = [m for m in sys.modules\n"
            "       if m == 'jax' or m.startswith(('jax.', 'funasr_tpu.'))]\n"
            "assert not bad, bad[:5]\n")
    run = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
