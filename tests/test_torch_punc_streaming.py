"""Realtime punctuation and the dynamic streaming VAD of the PyTorch port against the
JAX package (CPU).

* ``SANMVadEncoder`` (causal layers, the "VAD corner" last layer, the FSMN on the pad
  mask) within 2e-4 of the JAX encoder, B = 2 with ragged lengths, for vad positions 0,
  1, mid-sequence and past T;
* ``CTTransformerStreaming`` over the demo's ``|``-separated pieces with the cache
  carried: texts, ``punc_array`` and the carried ``pre_text`` equal after every piece,
  directly and through ``AutoModel`` over a written model dir (ct-punc's encoder cut to
  3 blocks of 64, the demo's characters as the vocabulary);
* ``DynamicStreamingVAD`` over the crafted energy VAD, fed 60 ms at a time and in
  uneven feeds, with the default and a tight silence schedule: the events equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funasr_tpu.auto import auto_model as jauto
from funasr_tpu.convert.torch_to_jax import convert_ct_transformer, convert_fsmn_vad
from funasr_tpu.frontends.wav_frontend import WavFrontendOnline as JaxFrontendOnline
from funasr_tpu.models.ct_transformer_streaming.model import CTTransformerStreaming as JaxPunc
from funasr_tpu.models.fsmn_vad_streaming.dynamic_vad import DynamicStreamingVAD as JaxDynamic
from funasr_tpu.models.fsmn_vad_streaming.model import FsmnVADStreaming as JaxVAD
from funasr_tpu.tokenizer.char_tokenizer import CharTokenizer as JaxCharTokenizer
from funasr_tpu_torch import AutoModel
from funasr_tpu_torch.convert import params_from_jax
from funasr_tpu_torch.frontends.wav_frontend import WavFrontendOnline
from funasr_tpu_torch.models.ct_transformer_streaming.model import CTTransformerStreaming
from funasr_tpu_torch.models.fsmn_vad_streaming.dynamic_vad import DynamicStreamingVAD
from funasr_tpu_torch.models.fsmn_vad_streaming.model import FsmnVADStreaming
from funasr_tpu_torch.tokenizer.char_tokenizer import CharTokenizer
from pipeline_parity_util import multi_segment_wav
from torch_parity_util import (PUNC_DEMO, PUNC_DEMO_TOKENS, PUNC_RT_ENC, PUNC_RT_MODEL_CONF,  # noqa: F401
                               VAD_CONF, VAD_FRONTEND, craft_energy_vad, one_torch_thread,
                               t, write_punc_realtime_dir)

ATOL = 2e-4
CONF = dict(encoder_conf=PUNC_RT_ENC, vocab_size=len(PUNC_DEMO_TOKENS), **PUNC_RT_MODEL_CONF)


@pytest.fixture(scope="module")
def pair():
    port = CTTransformerStreaming(**CONF, generator=torch.Generator().manual_seed(2)).eval()
    ref = JaxPunc(**CONF)
    params = jax.tree_util.tree_map(jnp.asarray, convert_ct_transformer(port.state_dict(), ref))
    return port, ref, params


def test_params_from_jax_round_trips_the_realtime_model(pair):
    port, _, params = pair
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, params), port)
    for name, value in port.state_dict().items():
        assert torch.equal(sd[name], value), name


@pytest.mark.parametrize("vad_pos", [(0, 0), (1, 1), (9, 5), (40, 24), (23, 11)])
def test_vad_encoder_matches_jax(pair, rng, vad_pos):
    """B = 2, T = 24 with lengths 24 and 17: vad positions 0 and 1 (no corner), mid,
    past T and at / past a row's length."""
    port, ref, params = pair
    x = rng.standard_normal((2, 24, 64)).astype(np.float32)
    lens = np.asarray([24, 17], np.int32)
    vp = np.asarray(vad_pos, np.int32)
    want, _ = ref.encoder(params["encoder"], jnp.asarray(x), jnp.asarray(lens),
                          vad_indexes=jnp.asarray(vp))
    with torch.no_grad():
        got, _ = port.encoder(t(x), t(lens), t(vp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("vad_pos", [0, 3, 12, 30])
def test_window_logits_match_jax(pair, rng, vad_pos):
    port, ref, params = pair
    ids = rng.integers(3, len(PUNC_DEMO_TOKENS), size=21).astype(np.int32)
    np.testing.assert_allclose(port.window_logits(ids, vad_pos),
                               np.asarray(ref._window_logits(params, ids, vad_pos)),
                               atol=ATOL, rtol=0)


def _demo_pieces(repeat=1):
    return PUNC_DEMO.split("|") * repeat


def test_demo_pieces_match_jax(pair):
    """The demo loop, twice over (so the carried pre-text grows past 20 words and the
    windows split), the cache carried between calls."""
    port, ref, params = pair
    jtok, ptok = JaxCharTokenizer(token_list=PUNC_DEMO_TOKENS), CharTokenizer(
        token_list=PUNC_DEMO_TOKENS)
    jcache, pcache = {}, {}
    for piece in _demo_pieces(2):
        want, _ = ref.inference(params, piece, tokenizer=jtok, cache=jcache)
        got, _ = port.inference(piece, tokenizer=ptok, cache=pcache)
        assert got[0]["text"] == want[0]["text"]
        np.testing.assert_array_equal(got[0]["punc_array"], np.asarray(want[0]["punc_array"]))
        assert pcache["pre_text"] == jcache["pre_text"]


def test_automodel_realtime_punctuation_matches_jax(tmp_path):
    d = write_punc_realtime_dir(tmp_path)
    kw = dict(model=d, device="cpu", log_level="WARNING")
    port, ref = AutoModel(**kw), jauto.AutoModel(**kw)
    jcache, pcache = {}, {}
    for piece in _demo_pieces():
        got = port.generate(input=piece, cache=pcache, disable_pbar=True)
        want = ref.generate(input=piece, cache=jcache, disable_pbar=True)
        assert [r["text"] for r in got] == [r["text"] for r in want]
        assert pcache["pre_text"] == jcache["pre_text"]


@pytest.fixture(scope="module")
def vad_pair():
    port = craft_energy_vad(FsmnVADStreaming(encoder_conf=VAD_CONF,
                                             generator=torch.Generator().manual_seed(0)), 0)
    ref = JaxVAD(encoder_conf=VAD_CONF)
    params = jax.tree_util.tree_map(jnp.asarray, convert_fsmn_vad(port.state_dict(), ref))
    return port.eval(), ref, params


# the default schedule (2 s of end silence for short utterances: the bursts ~1 s apart
# join) and a tight one (800 ms, then 300 ms once 2 s of speech has accumulated)
TIGHT = [(2000, 800), (float("inf"), 300)]


@pytest.mark.parametrize("feeds,schedule,endpoints", [("60ms", None, 1), ("60ms", TIGHT, 4),
                                                      ("uneven", TIGHT, 4)])
def test_dynamic_vad_events_match_jax(vad_pair, feeds, schedule, endpoints):
    port, ref, params = vad_pair
    wav = multi_segment_wav()
    if feeds == "60ms":
        sizes = [960] * (len(wav) // 960 + 1)
    else:
        sizes = list(np.random.default_rng(3).integers(300, 9000, size=len(wav) // 300))
    bounds = np.cumsum([0] + sizes)
    pieces = [wav[a:b] for a, b in zip(bounds[:-1], bounds[1:]) if a < len(wav)]
    got_vad = DynamicStreamingVAD(port, frontend=WavFrontendOnline(**VAD_FRONTEND),
                                  silence_schedule=schedule)
    want_vad = JaxDynamic(ref, params, frontend=JaxFrontendOnline(**VAD_FRONTEND),
                          silence_schedule=schedule)
    got, want = [], []
    for i, piece in enumerate(pieces):
        final = i == len(pieces) - 1
        got += got_vad.feed(piece, is_final=final)
        want += want_vad.feed(piece, is_final=final)
    assert got == want
    assert len([e for e in got if e[1] != -1]) == endpoints
