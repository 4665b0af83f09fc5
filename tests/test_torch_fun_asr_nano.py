"""Fun-ASR-Nano of the port against the JAX package's (CPU), the LLM slice end to end.

The model (``tests/torch_parity_util.py::NANO_CONF``: ``tests/test_fun_asr_nano_r2.py``'s
2-block SAN-M encoder at d 32 and 2-layer Qwen3 at d 48, a Linear adaptor, a CTC branch
over 40 ids) is a seeded port model; the JAX package converts its ``state_dict()`` with
``convert_state_dict(..., "FunASRNano")``. The tokenizer is a character-level Hugging Face
tokenizer built with ``tokenizers`` in a temporary directory. Held:

* the audio path (encoder + adaptor, the rows the LLM takes) within 2e-4, and the
  on-device prompt splice equal to ``_assemble_prompts_jit``;
* the copied host code (``get_prompt``, ``build_chatml_ids``) and
  ``HuggingfaceTokenizer`` equal to the originals;
* ``AutoModel(model=dir, device="cpu").generate`` and ``AutoModelVLLM.generate`` /
  ``streaming_generate`` against the JAX ones: texts, ``ctc_text``, ``ctc_timestamps`` and
  ``timestamps`` equal. Both engines run the LLM in bf16 (the engines' default cache
  dtype); the texts here agree token for token;
* the sampled path (``temperature`` > 0, the prefix cache) reproducible, hotword prompts,
  ``bf16=True`` and ``quant="int8"`` / ``"w8a8"`` runs; under W8A8 an untied LLM head
  stays weight-only, as the JAX quantizer leaves it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funasr_tpu.auto import auto_model as jauto
from funasr_tpu.auto import auto_model_vllm as jvllm
from funasr_tpu.convert.torch_to_jax import convert_state_dict
from funasr_tpu.models.fun_asr_nano import model as jnano
from funasr_tpu.tokenizer.char_tokenizer import CharTokenizer as JaxCharTokenizer
from funasr_tpu_torch import AutoModel
from funasr_tpu_torch.auto import auto_model_vllm as tvllm
from funasr_tpu_torch.models.fun_asr_nano.model import FunASRNano, assemble_prompts
from funasr_tpu_torch.tokenizer.char_tokenizer import CharTokenizer
from torch_parity_util import (CTC_TOKENS, NANO_CONF, one_torch_thread, speech,  # noqa: F401
                               to_jax, write_hf_tokenizer, write_nano_dir)

AUDIO_TOL = 2e-4
CALL = dict(max_new_tokens=12, num_slots=4)


@pytest.fixture(scope="module")
def nano_dir(tmp_path_factory):
    tok = write_hf_tokenizer(tmp_path_factory.mktemp("tok"))
    d, model = write_nano_dir(tmp_path_factory.mktemp("nano"), tok)
    return d, model, tok


@pytest.fixture(scope="module")
def jax_pair(nano_dir):
    _, model, _ = nano_dir
    jm = jnano.FunASRNano(**NANO_CONF)
    return model, jm, to_jax(convert_state_dict(model.state_dict(), jm, "FunASRNano"))


def waves():
    return [speech(2.0, [(0.2, 1.7, 220.0)], seed=1), speech(1.3, [(0.1, 1.1, 330.0)], seed=2)]


def test_audio_path_matches_jax(jax_pair):
    pt, jm, jp = jax_pair
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, 30, 560)).astype(np.float32)
    lens = np.asarray([30, 22], np.int32)
    with torch.no_grad():
        got, got_lens = pt.encode_audio(torch.from_numpy(feats), torch.from_numpy(lens))
    want, want_lens = jm.encode_audio(jp, jnp.asarray(feats), jnp.asarray(lens))
    assert got.shape == (2, 15, 48)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=AUDIO_TOL, rtol=0)


def test_assemble_prompts_matches_jax():
    rng = np.random.default_rng(1)
    prefix, suffix = (rng.standard_normal((n, 8)).astype(np.float32) for n in (5, 3))
    audio = rng.standard_normal((3, 7, 8)).astype(np.float32)
    lens = np.asarray([7, 2, 0])
    got = assemble_prompts(torch.from_numpy(prefix), torch.from_numpy(audio),
                           torch.from_numpy(lens), torch.from_numpy(suffix))
    want, want_lens = jnano._assemble_prompts_jit(jnp.asarray(prefix), jnp.asarray(audio),
                                                  jnp.asarray(lens), jnp.asarray(suffix))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(want_lens), 5 + lens + 3)


def test_prompt_host_code_matches_jax(jax_pair, nano_dir):
    from funasr_tpu.tokenizer.hf_tokenizer import HuggingfaceTokenizer as JaxHF
    from funasr_tpu_torch.tokenizer.hf_tokenizer import HuggingfaceTokenizer

    pt, jm, _ = jax_pair
    tok, jtok = HuggingfaceTokenizer(init_param_path=nano_dir[2]), JaxHF(init_param_path=nano_dir[2])
    for hw, lang, itn in ((None, None, True), (["阿里", "通义"], "英文", False), ([], "中文", True)):
        assert pt.get_prompt(hw, lang, itn) == jm.get_prompt(hw, lang, itn)
        prompt = pt.get_prompt(hw, lang, itn)
        for prev in ("", "语音"):
            assert pt.build_chatml_ids(tok, prompt, prev) == jm.build_chatml_ids(jtok, prompt,
                                                                                 prev)
    ids = tok.encode("<|im_start|>user\n语音转写：<|im_end|>")
    assert ids == jtok.encode("<|im_start|>user\n语音转写：<|im_end|>")
    assert tok.decode(ids) == jtok.decode(ids) and tok.ids2tokens(ids) == jtok.ids2tokens(ids)
    assert tok.get_vocab_size() == jtok.get_vocab_size() == 160
    assert tok.text2tokens("语音") == jtok.text2tokens("语音")
    assert FunASRNano.eos_ids(tok, {}) == (1, 2)


@pytest.fixture(scope="module")
def automodels(nano_dir):
    kw = dict(model=nano_dir[0], device="cpu", log_level="WARNING", disable_pbar=True)
    return AutoModel(**kw), jauto.AutoModel(**kw)


def assert_results_equal(got, want, skip=()):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in set(g) - set(skip):
            assert g[k] == w[k], (k, g[k], w[k])


def test_automodel_generate_matches_jax(automodels):
    port, ref = automodels
    call = dict(CALL, key=["a", "b"])
    got = port.generate(input=waves(), ctc_tokenizer=CharTokenizer(token_list=CTC_TOKENS),
                        batch_size=2, **call)
    want = ref.generate(input=waves(), ctc_tokenizer=JaxCharTokenizer(token_list=CTC_TOKENS),
                        batch_size=2, **call)
    assert_results_equal(got, want)
    assert all(r["text"] and r["ctc_text"] for r in got)
    assert any(r["ctc_timestamps"] for r in got), got
    print("texts:", [r["text"] for r in got], "ctc:", [r["ctc_text"] for r in got])


def test_automodel_vllm_matches_jax(nano_dir, automodels):
    kw = dict(model=nano_dir[0], device="cpu", log_level="WARNING", max_num_seqs=4)
    port = tvllm.AutoModelVLLM(**kw)
    ref = jvllm.AutoModelVLLM(**kw)
    got = port.generate(waves(), max_new_tokens=8)
    assert_results_equal(got, ref.generate(waves(), max_new_tokens=8), skip=("key",))
    # the same texts as AutoModel's
    assert [r["text"] for r in got] == [r["text"] for r in automodels[0].generate(
        input=waves(), batch_size=2, max_new_tokens=8, num_slots=4)]
    wav = waves()[0]
    got = list(port.streaming_generate(wav, chunk_ms=720, rollback_chars=2, max_new_tokens=6))
    want = list(ref.streaming_generate(wav, chunk_ms=720, rollback_chars=2, max_new_tokens=6))
    assert got == want and got[-1]["is_final"] and len(got) == 3
    with pytest.raises(NotImplementedError, match="item 21"):
        tvllm.AutoModelVLLM(**kw, tensor_parallel_size=2)
    for name in ("FunASRNano", "LLMASR", "QwenAudio"):
        assert tvllm.check_vllm_applicable(name) == jvllm.check_vllm_applicable(name)
    for name in ("Paraformer", "SenseVoiceSmall", "Qwen3ASR"):
        with pytest.raises(ValueError, match="cannot use the batched-LLM path"):
            tvllm.check_vllm_applicable(name)


def test_sampled_path_and_hotwords(automodels):
    """temperature > 0: per-utterance host prompts through the prefix cache, reproducible
    for a seed; a hotword prompt changes the prompt rows."""
    port = automodels[0]
    port.model._engine = None
    run = [port.generate(input=waves(), batch_size=2, temperature=0.8, **CALL)
           for _ in range(2)]
    assert [r["text"] for r in run[0]] == [r["text"] for r in run[1]]
    engine = port.model._engine
    assert engine.n_prefix_hits >= 1 and len(engine.prefix_cache) == 1
    hot = port.generate(input=waves()[:1], hotword="阿里 通义", **CALL)
    assert len(hot) == 1 and isinstance(hot[0]["text"], str)


@pytest.mark.parametrize("extra", [dict(bf16=True), dict(quant="int8"), dict(quant="w8a8")],
                         ids=["bf16", "int8", "w8a8"])
def test_automodel_settings_run(nano_dir, extra):
    am = AutoModel(model=nano_dir[0], device="cpu", log_level="WARNING", **extra)
    res = am.generate(input=waves(), batch_size=2, **CALL)
    assert len(res) == 2 and all(isinstance(r["text"], str) for r in res)


def test_w8a8_keeps_an_untied_llm_head_weight_only():
    """Under W8A8 every LLM and encoder linear of >= 256 rows and columns is W8A8 but the
    vocab head, which stays weight-only; the JAX quantizer gives the same layout."""
    from funasr_tpu.ops.quant import quantize_params_int8 as jquant
    from funasr_tpu_torch.ops.quant import Int8Linear, quantize_params_int8

    conf = dict(NANO_CONF, llm_conf=dict(NANO_CONF["llm_conf"], hidden_size=256,
                                         intermediate_size=256, num_attention_heads=4,
                                         head_dim=64, vocab_size=300,
                                         tie_word_embeddings=False),
                audio_adaptor_conf=dict(NANO_CONF["audio_adaptor_conf"], llm_dim=256))
    pt = FunASRNano(**conf, generator=torch.Generator().manual_seed(0))
    jm = jnano.FunASRNano(**conf)
    jp = jquant(convert_state_dict(pt.state_dict(), jm, "FunASRNano"), mode="w8a8")
    quantize_params_int8(pt, mode="w8a8")
    assert pt.llm.lm_head.key == "w_q" and "w_q" in jp["llm"]["lm_head"]
    layer = pt.llm.model.layers[0]
    for name in ("q_proj", "o_proj"):
        mod = getattr(layer.self_attn, name)
        assert isinstance(mod, Int8Linear) and mod.key == "w_q8"
        assert "w_q8" in jp["llm"]["layers"][0][name]
        np.testing.assert_array_equal(mod.w_q8.numpy().T,
                                      np.asarray(jp["llm"]["layers"][0][name]["w_q8"]))
    assert isinstance(pt.llm.model.embed_tokens, torch.nn.Embedding)


@pytest.mark.parametrize("name,conf", [
    ("Transformer", dict(downsample_rate=2, encoder_dim=32, llm_dim=48, ffn_dim=64, n_layer=2,
                         attention_heads=4)),
    ("QFormer", dict(encoder_dim=32, llm_dim=48, query_tokens=6, n_layer=2,
                     attention_heads=4, ffn_dim=64))])
def test_adaptors_match_jax(name, conf):
    """The Transformer and QFormer adaptors against JAX's, on the JAX package's seeded
    params brought over by ``params_from_jax`` (its converter reads no QFormer); then a
    whole FunASRNano with the Transformer adaptor, both ways."""
    from funasr_tpu.register import tables as jtables
    from funasr_tpu_torch import tables
    from funasr_tpu_torch.convert import params_from_jax

    jad = jtables.adaptor_classes[name](**conf)
    jp = jad.init(jax.random.PRNGKey(0))
    pt = tables.adaptor_classes[name](**conf).eval()
    nano = FunASRNano(**dict(NANO_CONF, audio_adaptor=name, audio_adaptor_conf=conf))
    tree = {"audio_encoder": {}, "audio_adaptor": jax.tree_util.tree_map(np.asarray, jp)}
    sd = {k[len("audio_adaptor."):]: v for k, v in _adaptor_sd(tree, nano).items()}
    pt.load_state_dict(sd)
    x = np.random.default_rng(4).standard_normal((2, 12, 32)).astype(np.float32)
    lens = np.asarray([12, 7], np.int32)
    with torch.no_grad():
        got, got_lens = pt(torch.from_numpy(x), torch.from_numpy(lens))
    want, want_lens = jad(jp, jnp.asarray(x), jnp.asarray(lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=AUDIO_TOL, rtol=0)
    if name == "Transformer":  # the JAX converter reads its blocks: the round trip
        nano = FunASRNano(**dict(NANO_CONF, audio_adaptor=name, audio_adaptor_conf=conf),
                          generator=torch.Generator().manual_seed(2))
        jm = jnano.FunASRNano(**dict(NANO_CONF, audio_adaptor=name, audio_adaptor_conf=conf))
        back = params_from_jax(convert_state_dict(nano.state_dict(), jm, "FunASRNano"), nano)
        for k, v in nano.state_dict().items():
            torch.testing.assert_close(back[k], v, atol=0, rtol=0)


def _adaptor_sd(tree, model):
    """The ``audio_adaptor.*`` tensors that ``params_from_jax`` gives for ``tree``."""
    from funasr_tpu_torch import convert

    out = {}
    convert._adaptor(tree["audio_adaptor"], "audio_adaptor.", model.state_dict(), out)
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}
