"""Frontend parity of the PyTorch port against the JAX package (CPU).

fbank, LFR, CMVN, WavFrontend (float and int16 PCM), the bucketing helpers, the
tokenizer copy and the text join. Tolerance: log-mel features within 1e-3 abs (both are
fp32 pipelines; the DFT and mel products sum in different orders); everything else is
exact.
"""

import wave

import jax.numpy as jnp
import numpy as np
import pytest

from funasr_tpu.frontends.wav_frontend import WavFrontend as JaxWavFrontend
from funasr_tpu.ops import fbank as jfb
from funasr_tpu.ops import lfr as jlfr
from funasr_tpu.tokenizer.char_tokenizer import CharTokenizer as JaxCharTokenizer
from funasr_tpu.utils import bucket as jbucket
from funasr_tpu.utils import postprocess_utils as jpost
from funasr_tpu.utils.load_utils import load_audio as jax_load_audio
from funasr_tpu_torch.frontends.wav_frontend import WavFrontend
from funasr_tpu_torch.ops import fbank as tfb
from funasr_tpu_torch.ops import lfr as tlfr
from funasr_tpu_torch.tokenizer.char_tokenizer import CharTokenizer
from funasr_tpu_torch.utils import bucket as tbucket
from funasr_tpu_torch.utils import postprocess_utils as tpost
from funasr_tpu_torch.utils.load_utils import load_audio
from torch_parity_util import TOKENS, t

FEAT_ATOL = 1e-3  # log-mel, fp32 both sides


def test_fbank_matches_jax(rng):
    wave_ = (rng.standard_normal(16000) * 1000).astype(np.float32)
    want = np.asarray(jfb.fbank(jnp.asarray(wave_)))
    got = tfb.fbank(t(wave_)).numpy()
    assert got.shape == want.shape == (98, 80)
    np.testing.assert_allclose(got, want, atol=FEAT_ATOL, rtol=0)
    np.testing.assert_array_equal(tfb.kaldi_mel_banks(80, 512, 16000.0),
                                  jfb.kaldi_mel_banks(80, 512, 16000.0))


def test_fbank_batch_matches_jax(rng):
    waves = (rng.standard_normal((3, 8000)) * 3000).astype(np.float32)
    lens = np.asarray([8000, 5000, 300], np.int32)
    want, want_l = jfb.fbank_batch(jnp.asarray(waves), jnp.asarray(lens))
    got, got_l = tfb.fbank_batch(t(waves), t(lens))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FEAT_ATOL, rtol=0)


def test_lfr_cmvn_match_jax(rng, tmp_path):
    feats = rng.standard_normal((3, 50, 80)).astype(np.float32)
    lens = np.asarray([50, 31, 1], np.int32)
    want, want_l = jlfr.apply_lfr_batch(jnp.asarray(feats), jnp.asarray(lens), 7, 6)
    got, got_l = tlfr.apply_lfr_batch(t(feats), t(lens), 7, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))

    means = rng.standard_normal(560).astype(np.float32)
    istd = rng.random(560).astype(np.float32)
    mvn = tmp_path / "am.mvn"
    mvn.write_text(
        "<Nnet>\n<Splice> 560 560\n<AddShift> 560 560\n<LearnRateCoef> 0 [ "
        + " ".join(map(repr, means.tolist())) + " ]\n<Rescale> 560 560\n<LearnRateCoef> 0 [ "
        + " ".join(map(repr, istd.tolist())) + " ]\n</Nnet>\n")
    cmvn = tlfr.load_cmvn(str(mvn))
    np.testing.assert_array_equal(cmvn, jlfr.load_cmvn(str(mvn)))
    x = rng.standard_normal((2, 5, 560)).astype(np.float32)
    np.testing.assert_array_equal(
        tlfr.apply_cmvn(t(x), t(cmvn[0]), t(cmvn[1])).numpy(),
        np.asarray(jlfr.apply_cmvn(jnp.asarray(x), cmvn[0], cmvn[1])))


@pytest.mark.parametrize("pcm16", [False, True])
def test_wav_frontend_matches_jax(rng, pcm16):
    lens = [16000, 23456, 7001]
    if pcm16:
        waves = [(rng.standard_normal(n) * 0.1 * 32767).astype(np.int16) for n in lens]
    else:
        waves = [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in lens]
    conf = dict(fs=16000, n_mels=80, lfr_m=7, lfr_n=6, dither=0.0)
    jfe, tfe = JaxWavFrontend(**conf), WavFrontend(**conf)
    want, want_l = jfe.extract(waves)
    got, got_l = tfe.extract(waves)
    np.testing.assert_array_equal(got_l, want_l)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=FEAT_ATOL, rtol=0)
    # the device path keeps the waveform bucket's frame count, as the JAX path does
    dev_feats, dev_l = tfe.extract(waves, device="cpu")
    jdev_feats, _ = jfe.extract(waves, device=True)
    assert tuple(dev_feats.shape) == tuple(jdev_feats.shape)
    np.testing.assert_array_equal(dev_l.numpy(), want_l)


def test_pcm16_bit_identical_to_float(rng):
    pcm = (rng.standard_normal(12345) * 0.1 * 32767).astype(np.int16)
    fe = WavFrontend(fs=16000, n_mels=80, lfr_m=7, lfr_n=6)
    a, _ = fe.extract([pcm])
    b, _ = fe.extract([pcm.astype(np.float32) / 32768.0])
    np.testing.assert_array_equal(a, b)


def test_load_wav_matches_jax(rng, tmp_path):
    pcm = (rng.standard_normal(8000) * 0.1 * 32767).astype(np.int16)
    path = tmp_path / "x.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    np.testing.assert_array_equal(load_audio(str(path)), jax_load_audio(str(path)))
    assert load_audio(pcm).dtype == np.int16


def test_bucketing_matches_jax(rng):
    for n in (1, 15, 16, 17, 4000, 240000, 277760, 1120000):
        for kw in ({}, dict(minimum=4000, multiple=160)):
            assert tbucket.bucket_length(n, **kw) == jbucket.bucket_length(n, **kw)
    for n in range(1, 70):
        assert tbucket.bucket_batch(n) == jbucket.bucket_batch(n)
        assert tbucket.bucket_frames(n * 37) == jbucket.bucket_frames(n * 37)
    # 15 s of audio: 277,760 samples -> 289 LFR frames -> encoder T 384 (the path's shape)
    assert tbucket.bucket_length(240000, minimum=4000, multiple=160) == 277760
    sp = rng.standard_normal((3, 50, 4)).astype(np.float32)
    ln = np.asarray([50, 40, 30], np.int32)
    want = jbucket.pad_feats_bucketed(sp, ln)
    got = tbucket.pad_feats_bucketed(t(sp), t(ln))
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert got[2] == want[2] == 3
    # the extra batch row replicates row 0
    np.testing.assert_array_equal(got[0][3].numpy(), got[0][0].numpy())


def test_tokenizer_and_text_join_match_jax():
    tok, jtok = CharTokenizer(token_list=TOKENS), JaxCharTokenizer(token_list=TOKENS)
    line = "一丁 七<unk>万丈"
    assert tok.text2tokens(line) == jtok.text2tokens(line)
    assert tok.encode(line) == jtok.encode(line)
    assert tok.decode([3, 4, 40, 5]) == jtok.decode([3, 4, 40, 5])
    for words in (["一", "丁", "<s>", "七"], ["hel@@", "lo", "world"],
                  ["i", "b", "m", "一", "ok"], ["a@@", "b", "二", "</s>", "c"], []):
        assert tpost.sentence_postprocess(words) == jpost.sentence_postprocess(words)
