"""The LLM-ASR family of the port against the JAX package's (CPU): the multiturn
OpenAI-message layout and messages-mode inference of ``tests/test_llm_asr_multiturn.py``
(its inference cases), on the same config (``LLMASR2``: a 2-block SAN-M encoder at d 24,
a 2-layer Qwen3 at d 32, 80-mel frames without LFR) and its byte tokenizer. The weights
are a seeded port model's, converted for JAX with ``convert_state_dict(..., "LLMASR")``.

Held: ``data_template`` and ``data_load_speech`` equal (ids, labels, masks, features);
generated texts, teacher-forcing loss (within 2e-4) and predictions; ``LLMASRNAR``'s texts;
``QwenAudio``'s ChatML prompt ids; the class names registered as in JAX, ``GLMASR``
included.
"""

import wave

import numpy as np
import pytest
import torch

from funasr_tpu.convert.torch_to_jax import convert_state_dict
from funasr_tpu.frontends.wav_frontend import WavFrontend as JaxWavFrontend
from funasr_tpu.register import tables as jtables
from funasr_tpu_torch import AutoModel, tables
from funasr_tpu_torch.frontends.wav_frontend import WavFrontend
from torch_parity_util import one_torch_thread, to_jax  # noqa: F401

LLM_CONF = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, vocab_size=96, head_dim=8,
                rms_norm_eps=1e-6, rope_theta=10000.0, tie_word_embeddings=False,
                qkv_bias=False, qk_norm=True)
ENC_CONF = dict(output_size=24, attention_heads=2, linear_units=48, num_blocks=2,
                kernel_size=5, dropout_rate=0.0)
CONF = dict(input_size=80, audio_encoder="SANMEncoder", audio_encoder_conf=ENC_CONF,
            audio_adaptor="Linear",
            audio_adaptor_conf=dict(downsample_rate=2, encoder_dim=24, llm_dim=32, ffn_dim=48),
            llm_conf=LLM_CONF)
FRONTEND = dict(fs=16000, lfr_m=1, lfr_n=1, n_mels=80, dither=0.0)


class ByteTokenizer:
    """``tests/test_llm_asr_multiturn.py``'s: bytes -> ids shifted by 1; id 0 is the
    audio slot."""

    def encode(self, text):
        return [1 + ((b - 32) % 95) for b in text.encode()][:512]

    def decode(self, ids):
        return "".join(chr(32 + ((i - 1) % 95)) for i in ids if i > 0)


@pytest.fixture(scope="module")
def wav_path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("llmwav") / "a.wav")
    sig = (np.random.default_rng(7).standard_normal(6400) * 0.1 * 32767).astype(np.int16)
    with wave.open(p, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(sig.tobytes())
    return p


def messages(wav_path):
    return [{"role": "system", "content": "You transcribe."},
            {"role": "user",
             "content": f"Transcribe: <|startofspeech|>!{wav_path}<|endofspeech|>"},
            {"role": "assistant", "content": "hello world"}]


def build(name="LLMASR2", conf=CONF, seed=0):
    pt = tables.model_classes[name](**conf, generator=torch.Generator().manual_seed(seed)).eval()
    with torch.no_grad():  # token rows of std 0.1, so that the ids vary step to step
        pt.llm.model.embed_tokens.weight.mul_(5.0)
    jm = jtables.model_classes[name](**conf)
    return pt, jm, to_jax(convert_state_dict(pt.state_dict(), jm, "LLMASR"))


@pytest.fixture(scope="module")
def pair():
    return build()


def test_data_template_and_layout_match_jax(pair, wav_path):
    pt, jm, _ = pair
    msgs = messages(wav_path)
    contents = pt.data_template(msgs)
    assert contents == jm.data_template(msgs) and pt.data_template(contents) == contents
    two_turns = msgs + [{"role": "user", "content": "again"},
                        {"role": "assistant", "content": "ok"}]
    assert pt.data_template(two_turns) == jm.data_template(two_turns)
    tok = ByteTokenizer()
    meta_t, meta_j = {}, {}
    got = pt.data_load_speech(contents, tok, WavFrontend(**FRONTEND), meta_t)
    want = jm.data_load_speech(contents, tok, JaxWavFrontend(**FRONTEND), meta_j)
    assert got.keys() == want.keys()
    for k in got:
        if k == "speech":
            # the fbank's tolerance (tests/test_torch_frontend.py::FEAT_ATOL)
            np.testing.assert_allclose(got[k], want[k], atol=1e-3, rtol=0)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert meta_t == meta_j and int(got["fake_token_len"][0]) == pt.audio_token_len(
        int(got["speech_lengths"][0]))
    n_src = len(got["source_ids"])
    assert np.all(got["labels_ids"][:n_src] == -100)
    assert tok.decode(list(got["labels_ids"][n_src:])).startswith("hello world")


def test_messages_inference_and_teacher_forcing_match_jax(pair, wav_path):
    pt, jm, jp = pair
    kw = dict(tokenizer=ByteTokenizer(), max_new_tokens=6, key=["m"])
    got, meta = pt.inference([messages(wav_path)], frontend=WavFrontend(**FRONTEND), **kw)
    want, jmeta = jm.inference(jp, [messages(wav_path)], frontend=JaxWavFrontend(**FRONTEND),
                               **kw)
    assert got == want and got[0]["label"] == "hello world" and got[0]["text"]
    assert meta == jmeta and meta["batch_data_time"] > 0
    print("messages text:", repr(got[0]["text"]))
    for flag in ("teacher_forcing", "tearchforing"):
        kw = {flag: True, "tokenizer": ByteTokenizer()}
        got, _ = pt.inference([messages(wav_path)], frontend=WavFrontend(**FRONTEND), **kw)
        want, _ = jm.inference(jp, [messages(wav_path)], frontend=JaxWavFrontend(**FRONTEND),
                               **kw)
        assert abs(got[0]["loss"] - want[0]["loss"]) < 2e-4 and np.isfinite(got[0]["loss"])
        assert got[0]["text"] == want[0]["text"] and got[0]["label"] == want[0]["label"]


def test_nar_and_qwen_audio_match_jax():
    pt, jm, jp = build("LLMASRNAR", seed=3)
    wavs = [np.random.default_rng(i).standard_normal(n).astype(np.float32) * 0.1
            for i, n in enumerate((6400, 4000))]
    kw = dict(tokenizer=ByteTokenizer(), key=["a", "b"])
    got, _ = pt.inference(wavs, frontend=WavFrontend(**FRONTEND), **kw)
    want, _ = jm.inference(jp, wavs, frontend=JaxWavFrontend(**FRONTEND), **kw)
    assert got == want and all(r["text"] for r in got)
    qa, jqa, _ = build("QwenAudio", seed=4)
    tok = ByteTokenizer()
    assert qa.build_chatml_ids(tok, qa.get_prompt(["x"], "en"), "y") == jqa.build_chatml_ids(
        tok, jqa.get_prompt(["x"], "en"), "y")


def test_family_names_and_glmasr_unbound(tmp_path):
    # GLMASR is bound since its TransformerEncoder was ported: every name, GLMASR
    # included, is registered in both packages, and an unknown name still raises
    for name in ("LLMASR", "LLMASR2", "LLMASR3", "LLMASR4", "LLMASRNAR", "LLMASRNARPrompt",
                 "Qwen3ASR", "QwenAudio", "QwenAudioChat", "QwenAudioWarp", "MinMo",
                 "FunASRNano", "GLMASR"):
        assert name in tables.model_classes and name in jtables.model_classes, name
    with pytest.raises(RuntimeError, match="not ported"):
        AutoModel(model="GLMASRX", model_conf={}, device="cpu")


def test_extra_tokenizers_match_jax(tmp_path, monkeypatch):
    """The copied ``extra_tokenizers``: word, phoneme (lexicon + per-character fallback)
    and id conversion equal to the originals; ``WhisperTokenizer`` over a local Hugging
    Face directory equal, and gated on ``tiktoken`` as in JAX; the text cleaners."""
    from funasr_tpu.tokenizer import extra_tokenizers as jx
    from funasr_tpu_torch.tokenizer import extra_tokenizers as tx
    from torch_parity_util import write_hf_tokenizer

    tokens = ["<blank>", "<unk>", "hello", "world", "h", "ə", "l", "oʊ", "x", "y"]
    lex = tmp_path / "lexicon.txt"
    lex.write_text("hello h ə l oʊ\nworld w ɜ l d\n", encoding="utf-8")
    line = "Hello xy world"
    for cls, kw in ((tx.WordTokenizer, {}), (tx.WordTokenizer, {"delimiter": ","}),
                    (tx.PhonemeTokenizer, {"lexicon_file": str(lex)})):
        jcls = getattr(jx, cls.__name__)
        a, b = cls(token_list=tokens, **kw), jcls(token_list=tokens, **kw)
        assert a.text2tokens(line) == b.text2tokens(line)
        assert a.encode(line) == b.encode(line) and a.decode([2, 3]) == b.decode([2, 3])
    conv, jconv = tx.TokenIDConverter(tokens), jx.TokenIDConverter(tokens)
    assert conv.tokens2ids(["x", "zz"]) == jconv.tokens2ids(["x", "zz"]) == [8, 1]
    assert conv.ids2tokens([2, 9]) == jconv.ids2tokens([2, 9])
    assert conv.get_num_vocabulary_size() == jconv.get_num_vocabulary_size() == 10
    for text in ("  a  b ", "<|en|> Hello [noise]  World "):
        assert tx.basic_cleaner(text) == jx.basic_cleaner(text)
        assert tx.whisper_basic_cleaner(text) == jx.whisper_basic_cleaner(text)
    hf = write_hf_tokenizer(tmp_path / "hf")
    a, b = tx.WhisperTokenizer(hf_tokenizer_path=hf), jx.WhisperTokenizer(hf_tokenizer_path=hf)
    ids = a.encode("语音转写")
    assert ids == b.encode("语音转写") and a.decode(ids) == b.decode(ids) == "语音转写"
    assert a.ids2tokens(ids) == b.ids2tokens(ids) and a.get_vocab_size() == b.get_vocab_size()
    assert tables.tokenizer_classes["SenseVoiceTokenizer"] is tx.WhisperTokenizer
    monkeypatch.setitem(__import__("sys").modules, "tiktoken", None)
    for cls in (tx.WhisperTokenizer, jx.WhisperTokenizer):
        with pytest.raises(ImportError, match="tiktoken"):
            cls()
