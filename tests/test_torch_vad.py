"""FSMN-VAD of the PyTorch port against the JAX package (CPU).

``WavFrontendOnline`` features offline and in chunks, the ``FSMN`` scoring encoder at
fsmn-vad's published width (with and without the chunk cache, and the lookahead branch),
``FsmnVADStreaming.inference`` segments on a crafted energy detector, and the copied
host helpers (``vad_utils``, ``timestamp_tools``, ``load_utils``). Weights cross with the
JAX package's ``convert_fsmn_vad`` and the port's ``params_from_jax``.

Tolerances: features 1e-3 abs (as ``tests/test_torch_frontend.py``; the DFT and mel
products sum in another order); VAD scores 1e-5 abs (fp32 softmax outputs); segments
exact to the millisecond.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funasr_tpu.convert.torch_to_jax import convert_fsmn_vad
from funasr_tpu.frontends.wav_frontend import WavFrontendOnline as JaxWavFrontendOnline
from funasr_tpu.models.fsmn_vad_streaming.model import FsmnVADStreaming as JaxVAD
from funasr_tpu.utils import load_utils as jload
from funasr_tpu.utils import timestamp_tools as jts
from funasr_tpu.utils import vad_utils as jvad
from funasr_tpu_torch.convert import params_from_jax
from funasr_tpu_torch.frontends.wav_frontend import WavFrontendOnline
from funasr_tpu_torch.models.fsmn_vad_streaming.model import FsmnVADStreaming
from funasr_tpu_torch.utils import load_utils as tload
from funasr_tpu_torch.utils import timestamp_tools as tts
from funasr_tpu_torch.utils import vad_utils as tvad
from pipeline_parity_util import multi_segment_wav
from torch_parity_util import VAD_CONF, VAD_FRONTEND, craft_energy_vad, t

FEAT_ATOL = 1e-3
SCORE_ATOL = 1e-5


def _pair(conf=VAD_CONF, seed=0, crafted=False):
    """(port VAD, JAX VAD, JAX params) with the same weights."""
    port = FsmnVADStreaming(encoder_conf=conf, generator=torch.Generator().manual_seed(seed))
    if crafted:
        craft_energy_vad(port, seed)
    ref = JaxVAD(encoder_conf=conf)
    return port.eval(), ref, jax.tree_util.tree_map(
        jnp.asarray, convert_fsmn_vad(port.state_dict(), ref))


def _stream(fe, wav, n_chunks):
    cache, out = {}, []
    for i, chunk in enumerate(np.array_split(wav, n_chunks)):
        feats, lens = fe.forward_streaming([chunk], cache=cache, is_final=i == n_chunks - 1)
        assert feats.shape[1] == lens[0]
        out.append(feats[0])
    return np.concatenate(out)


@pytest.mark.parametrize("n_chunks", [1, 5])
def test_wav_frontend_online_matches_jax(rng, n_chunks):
    wav = (rng.standard_normal(23457) * 0.1).astype(np.float32)
    got = _stream(WavFrontendOnline(**VAD_FRONTEND), wav, n_chunks)
    want = _stream(JaxWavFrontendOnline(**VAD_FRONTEND), wav, n_chunks)
    assert got.shape == want.shape and got.shape[1] == 400
    np.testing.assert_allclose(got, want, atol=FEAT_ATOL, rtol=0)


def test_fsmn_encoder_matches_jax_with_and_without_cache(rng):
    port, ref, params = _pair()
    x = rng.standard_normal((1, 137, 400)).astype(np.float32)
    want = np.asarray(ref.encoder(params["encoder"], jnp.asarray(x)))
    with torch.no_grad():
        got = port.encoder(t(x)).numpy()
    assert got.shape == (1, 137, 248)
    np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=0)

    # two chunks through the cache: the second chunk's memory reads the first's tail
    jcache, tcache = {}, {}
    for part in (x[:, :60], x[:, 60:]):
        want = np.asarray(ref.encoder(params["encoder"], jnp.asarray(part), cache=jcache))
        with torch.no_grad():
            got = port.encoder(t(part), cache=tcache).numpy()
        np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=0)
    for i in range(VAD_CONF["fsmn_layers"]):
        key = f"cache_layer_{i}"
        assert tuple(tcache[key].shape) == (1, 19, 128)
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]),
                                   atol=SCORE_ATOL, rtol=0)


def test_fsmn_lookahead_branch_matches_jax(rng):
    conf = dict(VAD_CONF, linear_dim=64, proj_dim=32, lorder=5, rorder=3,
                output_affine_dim=40, output_dim=16)
    port, ref, params = _pair(conf, seed=3)
    x = rng.standard_normal((2, 41, 400)).astype(np.float32)
    want = np.asarray(ref.encoder(params["encoder"], jnp.asarray(x)))
    with torch.no_grad():
        got = port.encoder(t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=0)


def test_params_from_jax_loads_jax_vad_params(rng):
    """JAX-initialised params -> the port's state dict (memory taps (k, C) -> (C, 1, k, 1))
    -> the same scores."""
    ref = JaxVAD(encoder_conf=VAD_CONF)
    params = ref.init_params(jax.random.PRNGKey(4))
    port = FsmnVADStreaming(encoder_conf=VAD_CONF)
    port.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), port))
    x = rng.standard_normal((1, 50, 400)).astype(np.float32)
    want = np.asarray(ref.encoder(params["encoder"], jnp.asarray(x)))
    with torch.no_grad():
        got = port.encoder(t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=0)


@pytest.mark.parametrize("pcm16,fixed_silence", [(False, True), (True, True), (False, False)])
def test_vad_segments_match_jax(pcm16, fixed_silence):
    """The crafted energy detector over tone bursts, equal to the ms: with a fixed 800 ms
    end silence every burst is a segment; the default dynamic schedule (1850 ms at the
    start of a chunk) joins bursts ~1 s apart."""
    port, ref, params = _pair(crafted=True)
    wav = multi_segment_wav()
    if pcm16:
        wav = np.clip(wav * 32768, -32768, 32767).astype(np.int16)
    kw = dict(max_end_silence_time=800) if fixed_silence else {}
    got, _ = port.inference([wav], key=["utt"], frontend=WavFrontendOnline(**VAD_FRONTEND),
                            **kw)
    want, _ = ref.inference(params, [wav], key=["utt"],
                            frontend=JaxWavFrontendOnline(**VAD_FRONTEND), **kw)
    assert got == want
    assert got[0]["key"] == "utt" and len(got[0]["value"]) == (4 if fixed_silence else 1)


def test_vad_utils_copies_match(rng):
    segs = [[0, 1200], [1500, 4000], [4100, 9000], [9300, 9800], [12000, 30000]]
    for max_len in (1000, 5000, 15000, 60000):
        assert tvad.merge_vad(segs, max_len) == jvad.merge_vad(segs, max_len)
    assert tvad.merge_vad(segs[:1]) == jvad.merge_vad(segs[:1])
    speech = rng.standard_normal(200000).astype(np.float32)
    pairs = [(s, i) for i, s in enumerate(segs)]
    got, got_l = tvad.slice_padding_audio_samples(speech, len(speech), pairs)
    want, want_l = jvad.slice_padding_audio_samples(speech, len(speech), pairs)
    assert got_l == want_l
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    feats = rng.standard_normal((3000, 8)).astype(np.float32)
    for a, b in zip(tvad.slice_padding_fbank(feats, 3000, pairs),
                    jvad.slice_padding_fbank(feats, 3000, pairs)):
        np.testing.assert_array_equal(a, b)


def test_timestamp_tools_copies_match(rng):
    alphas = rng.random(120).astype(np.float32) * 0.4
    peaks = jts.cif_wo_hidden_np(alphas, 1.0 - 1e-4)
    np.testing.assert_array_equal(tts.cif_wo_hidden_np(alphas, 1.0 - 1e-4), peaks)
    chars = list("一丁七万丈三上下不与丐丑")
    for args in ((alphas, peaks, chars), (alphas, peaks, chars + ["</s>"], 500.0)):
        assert tts.ts_prediction_lfr6_standard(*args) == jts.ts_prediction_lfr6_standard(*args)
    ts = [[i * 100, i * 100 + 80] for i in range(9)]
    text = "一 丁 七 hello world 万 丈 三 上"
    punc = np.asarray([1, 2, 1, 1, 3, 1, 1, 4, 3])
    for fn in ("timestamp_sentence", "timestamp_sentence_en"):
        for raw in (False, True):
            assert getattr(tts, fn)(punc, ts, text, raw) == getattr(jts, fn)(punc, ts, text, raw)
    assert tts.timestamp_sentence(None, ts, text) == jts.timestamp_sentence(None, ts, text)
    assert tts.timestamp_sentence(punc, [], text) == jts.timestamp_sentence(punc, [], text) == []


def test_load_utils_copies_match(rng):
    pcm = (rng.standard_normal(1000) * 3000).astype(np.int16)
    flt = rng.standard_normal(1000).astype(np.float32) * 0.1
    for wav in (pcm, flt):
        for name in ("as_unit_f32", "as_pcm16_f32"):
            got, want = getattr(tload, name)(wav), getattr(jload, name)(wav)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    from funasr_tpu.tokenizer.char_tokenizer import CharTokenizer as JaxTok
    from funasr_tpu_torch.tokenizer.char_tokenizer import CharTokenizer
    tokens = ["<blank>", "<s>", "</s>", "一", "丁", "<unk>"]
    for tok, jtok in ((None, None),
                      (CharTokenizer(token_list=tokens), JaxTok(token_list=tokens))):
        got = tload.load_audio_text_image_video(["一丁七", "丁"], data_type="text", tokenizer=tok)
        want = jload.load_audio_text_image_video(["一丁七", "丁"], data_type="text",
                                                 tokenizer=jtok)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert tload.load_audio_text_image_video("一丁", data_type="text") == ["一丁"]
