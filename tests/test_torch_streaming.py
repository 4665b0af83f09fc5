"""Streaming Paraformer of the PyTorch port against the JAX package (CPU).

A small ParaformerStreaming (2 chunk-encoder blocks of 32, decoder 2 + 1 blocks with
``sanm_shfit`` 5, vocab 64) with the same weights in both packages (``convert_paraformer``
one way, ``params_from_jax`` the other), driven 600 ms at a time (``chunk_size [0, 10,
5]``) at encoder / decoder look-back (0, 0), (4, 1) and (-1, 1):

* ``SANMEncoderChunkOpt.forward_chunk`` per chunk within 2e-4, tail chunk included, and
  its K/V caches;
* the streaming CIF's sequential scan on alphas whose running sums land on integers
  exactly, and on 1 ulp either side of them: fire counts exact; the predictor's
  ``forward_chunk`` (stride mask, the tail frame) against JAX's;
* ``ParaformerSANMDecoder.forward_chunk`` logits within 2e-4 with ``n`` valid rows of a
  padded bucket, and its FSMN / cross-attention caches;
* ``generate_chunk``'s token ids per chunk equal, and whole streams (a final remainder
  under 960 samples, the tail chunk, and over it; a second utterance after the reset);
* ``AutoModel``'s demo loop over a written model dir, texts equal to the JAX
  ``AutoModel``'s, with the caller's cache carried across ``generate`` calls;
* ``extract_fbank`` with a streaming cache at lfr 7/6 in 1 and 5 pieces.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funasr_tpu.auto import auto_model as jauto
from funasr_tpu.convert.torch_to_jax import convert_paraformer
from funasr_tpu.frontends.wav_frontend import WavFrontendOnline as JaxFrontendOnline
from funasr_tpu.models.paraformer_streaming.model import ParaformerStreaming as JaxStreaming
from funasr_tpu.ops.cif import cif_scan_step as jax_cif_scan_step
from funasr_tpu.tokenizer.char_tokenizer import CharTokenizer as JaxCharTokenizer
from funasr_tpu.utils import load_utils as jload
from funasr_tpu_torch import AutoModel
from funasr_tpu_torch.convert import params_from_jax
from funasr_tpu_torch.frontends.wav_frontend import WavFrontendOnline
from funasr_tpu_torch.models.paraformer_streaming.model import ParaformerStreaming
from funasr_tpu_torch.ops.cif import cif_scan
from funasr_tpu_torch.tokenizer.char_tokenizer import CharTokenizer
from funasr_tpu_torch.utils import load_utils as tload
from torch_parity_util import (PIPE_TOKENS, STREAM_CONF, STREAM_FRONTEND, one_torch_thread,  # noqa: F401
                               t, to_jax, write_streaming_dir)

ATOL = 2e-4
LOOK_BACKS = [(0, 0), (4, 1), (-1, 1)]
CHUNK = [0, 10, 5]
STRIDE = 9600  # samples a chunk: chunk_size[1] x 960


@pytest.fixture(scope="module")
def pair():
    port = ParaformerStreaming(**STREAM_CONF, generator=torch.Generator().manual_seed(0)).eval()
    ref = JaxStreaming(**STREAM_CONF)
    params = to_jax(convert_paraformer(port.state_dict(), ref))
    ref.params_ref = params
    return port, ref, params


def _kw(look_back):
    return dict(chunk_size=list(CHUNK), encoder_chunk_look_back=look_back[0],
                decoder_chunk_look_back=look_back[1])


def _speech(seconds, seed=0):
    return (np.random.default_rng(seed).standard_normal(int(seconds)) * 0.1).astype(np.float32)


def test_params_from_jax_round_trips_the_streaming_model(pair):
    port, ref, params = pair
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, params), port)
    for name, value in port.state_dict().items():
        assert torch.equal(sd[name], value), name


@pytest.mark.parametrize("look_back", LOOK_BACKS)
def test_chunk_encoder_matches_jax(pair, rng, look_back):
    """Five chunks of 10 feature rows (the carry makes them 15), then the tail chunk,
    which re-runs the 5 carried rows."""
    port, ref, params = pair
    enc = port.encoder
    jcache = dict(start_idx=0, chunk_size=list(CHUNK), encoder_chunk_look_back=look_back[0],
                  feats=jnp.zeros((1, 5, 560), jnp.float32), tail_chunk=False)
    pcache = dict(start_idx=0, chunk_size=list(CHUNK), encoder_chunk_look_back=look_back[0],
                  feats=torch.zeros(1, 5, 560), tail_chunk=False)
    for i in range(6):
        x = rng.standard_normal((1, 10, 560)).astype(np.float32)
        if i == 5:
            jcache["tail_chunk"] = pcache["tail_chunk"] = True
            x = np.asarray(jcache["feats"])
        want, _ = ref.encoder.forward_chunk(params["encoder"], jnp.asarray(x),
                                            jnp.asarray([x.shape[1]]), jcache)
        with torch.no_grad():
            got = enc.forward_chunk(t(x), pcache)
        assert got.shape == want.shape == (1, 15 if i < 5 else 5, 32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
        np.testing.assert_allclose(pcache["feats"].numpy(), np.asarray(jcache["feats"]),
                                   atol=1e-5, rtol=0)
    if look_back[0] == 0:
        assert pcache["opt"] == [None, None]
        return
    want_k = [np.asarray(jcache["opt0"]["k"])] + list(np.asarray(jcache["opt"]["k"]))
    assert pcache["opt"][0]["k"].shape[2] == (40 if look_back[0] == 4 else 50)
    for got_kv, want in zip(pcache["opt"], want_k):
        np.testing.assert_allclose(got_kv["k"].numpy(), want, atol=ATOL, rtol=0)


def _near_integer_alphas():
    """(B = 3, T = 12) alphas whose running sums (after a carried integrate of 0 or 0.5)
    land on integers exactly (row 0), 1 ulp below one (row 1: the fire moves) and 1 ulp
    above (row 2)."""
    base = np.asarray([0.5, 0.25, 0.25, 0.125, 0.375, 0.5, 0.75, 0.25, 0.0, 1.0, 0.5, 0.5],
                      np.float32)
    rows = [base, base.copy(), base.copy()]
    rows[1][2] = 0.25 - 2.0 ** -24  # 0.75 + this = 1 - 2^-24, the float below 1.0
    rows[2][2] = 0.25 + 2.0 ** -23  # 0.75 + this = 1 + 2^-23, the float above it
    return np.stack(rows)


@pytest.mark.parametrize("integrate0", [0.0, 0.5])
def test_cif_scan_fires_match_jax_at_integer_sums(rng, integrate0):
    alphas = _near_integer_alphas()
    hidden = rng.standard_normal((3, 12, 16)).astype(np.float32)
    integ = np.full((3,), integrate0, np.float32)
    frame = rng.standard_normal((3, 16)).astype(np.float32)
    (ji, jf), (jfire, jframes) = jax.lax.scan(
        jax_cif_scan_step, (jnp.asarray(integ), jnp.asarray(frame)),
        (jnp.asarray(alphas.T), jnp.asarray(hidden.transpose(1, 0, 2))))
    pi, pf, pfire, pframes = cif_scan(t(hidden), t(alphas), t(integ), t(frame))
    np.testing.assert_array_equal(pfire.numpy(), np.asarray(jfire).T)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pframes.numpy(), np.asarray(jframes).transpose(1, 0, 2),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(pf.numpy(), np.asarray(jf), atol=1e-5, rtol=0)
    fire = pfire.numpy()
    assert not np.array_equal(fire[0], fire[1])  # 1 ulp short of an integer moves a fire


@pytest.mark.parametrize("is_final", [False, True])
def test_cif_predictor_forward_chunk_matches_jax(pair, rng, is_final):
    port, ref, params = pair
    hidden = rng.standard_normal((1, 15, 32)).astype(np.float32)
    state = {"integrate": np.asarray([0.6], np.float32),
             "frame": rng.standard_normal((1, 32)).astype(np.float32)}
    want, jn, jstate = ref.predictor.forward_chunk(
        params["predictor"], jnp.asarray(hidden), {k: jnp.asarray(v) for k, v in state.items()},
        16, is_final, tuple(CHUNK))
    with torch.no_grad():
        got, pn, pstate = port.predictor.forward_chunk(
            t(hidden), {k: t(v) for k, v in state.items()}, 16, is_final, tuple(CHUNK))
    assert got.shape == want.shape == (1, 16 if is_final else 15, 32)
    assert pn.tolist() == np.asarray(jn).tolist()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    for k in state:
        np.testing.assert_allclose(pstate[k].numpy(), np.asarray(jstate[k]), atol=ATOL, rtol=0)


@pytest.mark.parametrize("look_back", [0, 1, 2])
def test_decoder_forward_chunk_matches_jax(pair, rng, look_back):
    """Three chunks with n = 3, 0 and 15 valid rows of a 15-row bucket (16 in the last)."""
    port, ref, params = pair
    jcache = dict(chunk_size=list(CHUNK), decoder_chunk_look_back=look_back)
    pcache = dict(chunk_size=list(CHUNK), decoder_chunk_look_back=look_back)
    for n, tmax in ((3, 15), (0, 15), (15, 16)):
        memory = rng.standard_normal((1, 15, 32)).astype(np.float32)
        tgt = rng.standard_normal((1, tmax, 32)).astype(np.float32)
        tgt[:, n:] = 0.0
        want = ref.decoder.forward_chunk(params["decoder"], jnp.asarray(memory),
                                         jnp.asarray(tgt), jcache, n)
        with torch.no_grad():
            got = port.decoder.forward_chunk(t(memory), t(tgt), torch.tensor(n, dtype=torch.int32),
                                             pcache)
        np.testing.assert_allclose(got[:, :n].numpy(), np.asarray(want)[:, :n], atol=ATOL,
                                   rtol=0)
        for got_c, want_c in zip(pcache["decode_fsmn"], np.asarray(jcache["decode_fsmn"])):
            np.testing.assert_allclose(got_c.numpy(), want_c, atol=ATOL, rtol=0)
    if look_back:
        for got_c, want_c in zip(pcache["opt"], np.asarray(jcache["opt"]["k"])):
            np.testing.assert_allclose(got_c["k"].numpy(), want_c, atol=ATOL, rtol=0)


@pytest.mark.parametrize("look_back", LOOK_BACKS)
def test_generate_chunk_token_ids_match_jax(pair, look_back):
    """Six 600 ms chunks through both packages' frontends and ``generate_chunk`` (no
    tokenizer: the ids), the last one final."""
    port, ref, _ = pair
    kw = _kw(look_back)
    jcache, pcache = ref.init_cache({}, **kw), port.init_cache({}, **kw)
    jfe, pfe = JaxFrontendOnline(**STREAM_FRONTEND), WavFrontendOnline(**STREAM_FRONTEND)
    wav = _speech(6 * STRIDE, seed=1)
    fired = 0
    for i in range(6):
        final = i == 5
        chunk = wav[i * STRIDE:(i + 1) * STRIDE]
        jfeats, _ = jload.extract_fbank([chunk], frontend=jfe, cache=jcache["frontend"],
                                        is_final=final)
        pfeats, _ = tload.extract_fbank([chunk], frontend=pfe, cache=pcache["frontend"],
                                        is_final=final)
        np.testing.assert_allclose(pfeats, np.asarray(jfeats), atol=1e-3, rtol=1e-5)
        want = ref.generate_chunk(jfeats, None, cache=jcache, is_final=final, **kw)
        got = port.generate_chunk(pfeats, None, cache=pcache, is_final=final, **kw)
        assert got == want, f"chunk {i}"
        fired += len(got)
    assert fired > 0


@pytest.mark.parametrize("look_back", LOOK_BACKS)
def test_streams_match_jax(pair, look_back):
    """Three streams through ``inference`` 600 ms a call: a final remainder of 500
    samples (under 960: the tail chunk re-runs the carry), one of 3,000 (a chunk of its
    own), and after the reset a second utterance whose last call carries 1.4 chunks."""
    port, ref, params = pair
    kw = _kw(look_back)
    jfe, pfe = JaxFrontendOnline(**STREAM_FRONTEND), WavFrontendOnline(**STREAM_FRONTEND)
    jtok, ptok = JaxCharTokenizer(token_list=PIPE_TOKENS), CharTokenizer(token_list=PIPE_TOKENS)
    jcache, pcache = {}, {}
    for seed, n in ((2, 3 * STRIDE + 500), (3, 3 * STRIDE + 3000), (4, 2 * STRIDE + 4000)):
        wav = _speech(n, seed)
        calls = [wav[i:i + STRIDE] for i in range(0, n - STRIDE // 2, STRIDE)]
        if seed == 4:
            calls = [wav[:STRIDE], wav[STRIDE:]]  # 1.4 chunks: one kept as prev_samples
        for j, piece in enumerate(calls):
            final = j == len(calls) - 1
            want, _ = ref.inference(params, piece, key=["s"], tokenizer=jtok, frontend=jfe,
                                    cache=jcache, is_final=final, **kw)
            got, _ = port.inference(piece, key=["s"], tokenizer=ptok, frontend=pfe,
                                    cache=pcache, is_final=final, **kw)
            assert got == want, (seed, j)
        assert pcache["encoder"]["start_idx"] == 0  # reset after the final call


def test_int16_stream_equals_float_stream(pair):
    """The port scales int16 PCM to [-1, 1) before its stride loop (as load_audio's other
    outputs are), so an int16 stream decodes as its float twin."""
    port, _, _ = pair
    wav = _speech(2 * STRIDE + 2000, seed=5)
    pcm = np.clip(np.round(wav * 32768), -32768, 32767).astype(np.int16)
    tok = CharTokenizer(token_list=PIPE_TOKENS)
    texts = []
    for audio in (pcm.astype(np.float32) / 32768.0, pcm):
        res, _ = port.inference(audio, key=["s"], tokenizer=tok,
                                frontend=WavFrontendOnline(**STREAM_FRONTEND), cache={},
                                is_final=True, **_kw((4, 1)))
        texts.append(res[0]["text"])
    assert texts[0] == texts[1]


def test_whole_array_streams_internally(pair):
    """One call with the whole array and is_final=True runs every chunk (JAX
    ``model.py:316-378``) and equals the chunked calls' joined text."""
    port, ref, params = pair
    kw = _kw((4, 1))
    wav = _speech(4 * STRIDE + 1200, seed=6)
    tok = CharTokenizer(token_list=PIPE_TOKENS)
    got, _ = port.inference(wav, key=["s"], tokenizer=tok,
                            frontend=WavFrontendOnline(**STREAM_FRONTEND), cache={},
                            is_final=True, **kw)
    want, _ = ref.inference(params, wav, key=["s"],
                            tokenizer=JaxCharTokenizer(token_list=PIPE_TOKENS),
                            frontend=JaxFrontendOnline(**STREAM_FRONTEND), cache={},
                            is_final=True, **kw)
    assert got == want


@pytest.fixture(scope="module")
def streaming_dir(tmp_path_factory):
    return write_streaming_dir(tmp_path_factory.mktemp("paraformer_streaming"))


def test_automodel_demo_loop_matches_jax(streaming_dir):
    """The demo (``paraformer_streaming/demo.py:21-40``): 600 ms per ``generate`` with the
    caller's cache, which AutoModel carries (``kwargs.pop("cache")`` then ``deep_update``)
    into ``inference``: the same dict object is the one that fills and is reset."""
    kw = dict(model=streaming_dir, device="cpu", log_level="WARNING")
    port, ref = AutoModel(**kw), jauto.AutoModel(**kw)
    wav = _speech(3 * STRIDE + 2500, seed=7)
    calls = [wav[i:i + STRIDE] for i in range(0, len(wav), STRIDE)]
    jcache, pcache = {}, {}
    for j, piece in enumerate(calls):
        final = j == len(calls) - 1
        got = port.generate(input=piece, cache=pcache, is_final=final, **_kw((4, 1)))
        want = ref.generate(input=piece, cache=jcache, is_final=final, **_kw((4, 1)))
        assert [r["text"] for r in got] == [r["text"] for r in want]
        if j == 0:
            assert pcache["encoder"]["start_idx"] > 0 and pcache["prev_samples"].size == 0
            enc_cache = pcache["encoder"]
        elif not final:
            assert pcache["encoder"] is enc_cache  # the same cache, filled again
    assert pcache["encoder"]["start_idx"] == 0  # reset by the final call


@pytest.mark.parametrize("pieces", [1, 5])
@pytest.mark.parametrize("pcm16", [False, True])
def test_extract_fbank_streaming_matches_jax(rng, pieces, pcm16):
    wav = (rng.standard_normal(23457) * 0.1).astype(np.float32)
    if pcm16:
        wav = np.clip(np.round(wav * 32768), -32768, 32767).astype(np.int16)
    jfe, pfe = JaxFrontendOnline(**STREAM_FRONTEND), WavFrontendOnline(**STREAM_FRONTEND)
    jcache, pcache, got, want = {}, {}, [], []
    for i, chunk in enumerate(np.array_split(wav, pieces)):
        final = i == pieces - 1
        w, wl = jload.extract_fbank([chunk], frontend=jfe, cache=jcache, is_final=final)
        g, gl = tload.extract_fbank([chunk], frontend=pfe, cache=pcache, is_final=final)
        assert gl.tolist() == np.asarray(wl).tolist()
        got.append(g[0])
        want.append(np.asarray(w)[0])
    got, want = np.concatenate(got), np.concatenate(want)
    assert got.shape == want.shape and got.shape[1] == 560 and got.shape[0] > 0
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-5)
