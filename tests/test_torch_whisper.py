"""Whisper of the port against the JAX package's (CPU, fp32).

The model is whisper-tiny (d 384, 6 heads, 80 mels, vocab 51,865) cut to 2 + 2 layers,
seeded in the port; the JAX package converts its ``state_dict()`` (Hugging Face names)
with ``convert_state_dict(..., "Whisper-tiny")``. Held:

* the log-mel of ``WhisperFrontend`` within 2e-4 of JAX's (the slaney filters equal);
* encoder output and teacher-forced decoder logits within 2e-4;
* the cached greedy decode equal to the prefix-recompute oracle, in the port
  (``tests/test_whisper_parity.py:66-89``'s case) and against JAX's cached decode;
* ``inference`` texts equal to JAX's; ``params_from_jax`` the way back, exact; every
  size registered under the JAX package's names; a Hugging Face checkpoint's extra
  tensors (the tied ``proj_out``) dropped on load;
* the whisper-tower encoders (``OpenAIWhisperEncoderWarp``, ``QwenAudioEncoder``) inside
  an ``LLMASR`` / ``QwenAudio`` against JAX, ragged lengths masked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funasr_tpu.convert.torch_to_jax import convert_state_dict
from funasr_tpu.frontends import whisper_frontend as jfe
from funasr_tpu.models.whisper import model as jwhisper
from funasr_tpu_torch import tables
from funasr_tpu_torch.convert import params_from_jax
from funasr_tpu_torch.frontends import whisper_frontend as tfe
from torch_parity_util import one_torch_thread, to_jax  # noqa: F401

TOL = 2e-4
TINY = dict(whisper_size="whisper-tiny", encoder_layers=2, decoder_layers=2)


@pytest.fixture(scope="module")
def pair():
    pt = tables.model_classes["whisper-tiny"](
        encoder_layers=2, decoder_layers=2, generator=torch.Generator().manual_seed(0)).eval()
    jm = jwhisper.WhisperModel(**TINY)
    return pt, jm, to_jax(convert_state_dict(pt.state_dict(), jm, "Whisper-tiny"))


def test_log_mel_matches_jax():
    for n_mels in (80, 128):
        np.testing.assert_array_equal(tfe.slaney_mel_filters(n_mels),
                                      jfe.slaney_mel_filters(n_mels))
    wavs = [np.random.default_rng(i).standard_normal(n).astype(np.float32) * 0.1
            for i, n in enumerate((16000, 23456))]
    wavs.append((wavs[0] * 32767).astype(np.int16))  # PCM16 is scaled as in JAX
    port = tfe.WhisperFrontend(n_mels=80, pad_samples=48000)
    ref = jfe.WhisperFrontend(n_mels=80, pad_samples=48000)
    got, lens = port.extract(wavs)
    from funasr_tpu.utils.load_utils import extract_fbank
    want, want_lens = extract_fbank(wavs, frontend=ref)
    assert got.shape == (3, 300, 80)
    np.testing.assert_array_equal(lens, want_lens)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    one = port.log_mel(torch.from_numpy(wavs[1]))
    np.testing.assert_allclose(one.numpy(), np.asarray(ref.log_mel(jnp.asarray(wavs[1]))),
                               atol=TOL, rtol=0)


def test_encoder_and_logits_match_jax(pair):
    pt, jm, jp = pair
    rng = np.random.default_rng(1)
    mel = rng.standard_normal((2, 120, 80)).astype(np.float32)
    tokens = rng.integers(0, 51865, (2, 7))
    with torch.no_grad():
        enc, enc_lens = pt.encode(torch.from_numpy(mel), torch.tensor([120, 90]))
        logits = pt.decode_logits(torch.from_numpy(tokens), enc)
    j_enc, j_lens = jm.encode(jp, jnp.asarray(mel), jnp.asarray([120, 90]))
    assert enc.shape == (2, 60, 384) and enc_lens.tolist() == [60, 45]
    np.testing.assert_allclose(enc.numpy(), np.asarray(j_enc), atol=TOL, rtol=0)
    want = np.asarray(jax.jit(jm.decode_logits)(jp, jnp.asarray(tokens), j_enc))
    assert logits.shape == (2, 7, 51865)
    np.testing.assert_allclose(logits.numpy(), want, atol=TOL, rtol=0)


def test_cached_greedy_matches_the_prefix_oracle_and_jax(pair):
    """``tests/test_whisper_parity.py``'s small model: cached = prefix oracle over three
    batches with early EOT; then at whisper-tiny width the port's cached decode against
    JAX's."""
    m = tables.model_classes["whisper-tiny"](
        vocab_size=64, d_model=32, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4, encoder_ffn_dim=64,
        decoder_ffn_dim=64, max_source_positions=100, max_target_positions=64,
        num_mel_bins=16, generator=torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(0)
    for _ in range(3):
        with torch.no_grad():
            enc, _ = m.encode(torch.from_numpy(rng.standard_normal((2, 40, 16)).astype(
                np.float32)))
        cached = m.greedy_decode(enc, [1, 2], eot_id=3, max_new=8)
        assert cached == m.greedy_decode_prefix(enc, [1, 2], eot_id=3, max_new=8)
        assert all(len(c) <= 8 for c in cached)
    pt, jm, jp = pair
    mel = rng.standard_normal((2, 80, 80)).astype(np.float32)
    with torch.no_grad():
        enc, _ = pt.encode(torch.from_numpy(mel))
    got = pt.greedy_decode(enc, [50258, 50259], eot_id=50257, max_new=6)
    want = jm.greedy_decode(jp, jm.encode(jp, jnp.asarray(mel))[0], [50258, 50259],
                            eot_id=50257, max_new=6)
    assert got == want and all(len(g) == 6 for g in got), (got, want)


def test_inference_matches_jax(pair):
    pt, jm, jp = pair

    class Tok:
        sot_sequence = (50258, 50259, 50359)

        def decode(self, ids):
            return " ".join(str(i) for i in ids)

    wavs = [np.random.default_rng(3).standard_normal(8000).astype(np.float32) * 0.1]
    kw = dict(tokenizer=Tok(), max_new_tokens=4, key=["k"])
    got, meta = pt.inference(wavs, frontend=tfe.WhisperFrontend(pad_samples=16000), **kw)
    want, _ = jm.inference(jp, wavs, frontend=jfe.WhisperFrontend(pad_samples=16000), **kw)
    assert got == want and meta["batch_data_time"] == 0.5


def test_params_from_jax_and_names(pair):
    pt, jm, jp = pair
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), pt)
    for name, value in pt.state_dict().items():
        torch.testing.assert_close(sd[name], value, atol=0, rtol=0)
    for name in ("whisper-tiny", "whisper-base", "whisper-small", "whisper-medium",
                 "whisper-large-v2", "whisper-large-v3", "Whisper-large-v3",
                 "Whisper-large-v2", "OpenAIWhisperModel", "WhisperWarp"):
        assert name in tables.model_classes and name in jwhisper.tables.model_classes
    extra = dict(pt.state_dict(), **{"proj_out.weight": pt.model.decoder.embed_tokens.weight})
    pt.load_state_dict(extra)  # Hugging Face's tied head is dropped


@pytest.mark.parametrize("name,encoder,conf", [
    ("LLMASR", "OpenAIWhisperEncoderWarp",
     dict(whisper_model="tiny", n_layer=2)),
    ("QwenAudio", "QwenAudioEncoder",
     dict(n_mels=80, n_state=64, n_head=4, n_layer=2, output_dim=48))])
def test_whisper_tower_encoders_match_jax(name, encoder, conf):
    from funasr_tpu.models.llm_asr import model as jllm  # noqa: F401 (registers)
    from funasr_tpu.register import tables as jtables

    llm = dict(hidden_size=48, intermediate_size=96, num_hidden_layers=1,
               num_attention_heads=4, num_key_value_heads=2, vocab_size=96, head_dim=12,
               qk_norm=True)
    enc_dim = 384 if encoder == "OpenAIWhisperEncoderWarp" else 48
    mconf = dict(input_size=80, audio_encoder=encoder, audio_encoder_conf=conf,
                 audio_adaptor="Linear",
                 audio_adaptor_conf=dict(downsample_rate=2, encoder_dim=enc_dim, llm_dim=48,
                                         ffn_dim=64), llm_conf=llm)
    pt = tables.model_classes[name](**mconf, generator=torch.Generator().manual_seed(1)).eval()
    jm = jtables.model_classes[name](**mconf)
    jp = to_jax(convert_state_dict(pt.state_dict(), jm, "LLMASR"))
    mel = np.random.default_rng(2).standard_normal((2, 60, 80)).astype(np.float32)
    lens = np.asarray([60, 41])
    with torch.no_grad():
        got, got_lens = pt.encode_audio(torch.from_numpy(mel), torch.from_numpy(lens))
    want, want_lens = jm.encode_audio(jp, jnp.asarray(mel), jnp.asarray(lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), pt)
    assert set(sd) == set(pt.state_dict())
