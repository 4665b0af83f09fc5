"""Paraformer parity of the PyTorch port against the JAX package (CPU, small config).

Both packages run the same weights (the port's seeded init, converted by the JAX
package's ``convert_paraformer``) on the same numpy inputs. Tolerances: encoder, CIF
predictor and decoder outputs within 2e-4 in fp32 (the ROADMAP budget); token ids and
CIF token counts exactly equal end to end, including alphas whose running sums land
exactly on integers.
"""

import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funasr_tpu.frontends.wav_frontend import WavFrontend as JaxWavFrontend
from funasr_tpu.ops.cif import cif as jax_cif
from funasr_tpu.tokenizer.char_tokenizer import CharTokenizer as JaxCharTokenizer
from funasr_tpu_torch.core.layers import embedding
from funasr_tpu_torch.frontends.wav_frontend import WavFrontend
from funasr_tpu_torch.ops.cif import cif
from funasr_tpu_torch.tokenizer.char_tokenizer import CharTokenizer
from torch_parity_util import TOKENS, build_pair, t

TOL = 2e-4


@pytest.fixture(scope="module")
def pair():
    return build_pair(seed=0)


def _feats(rng, b, n, lens):
    x = rng.standard_normal((b, n, 560)).astype(np.float32)
    return x, np.asarray(lens, np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=0)


@torch.inference_mode()
def test_encoder_predictor_decoder_match_jax(rng, pair):
    pt, jm, params = pair
    x, lens = _feats(rng, 3, 70, [70, 52, 9])
    enc, enc_l = pt.encode(t(x), t(lens))
    jenc, _ = jm.encode(params, jnp.asarray(x), jnp.asarray(lens))
    _close(enc.numpy(), jenc)

    # the predictor and decoder each take the same (JAX) encoder output on both sides
    jenc_np = np.asarray(jenc)
    emb, tok_num, alphas, fires = pt.calc_predictor(t(jenc_np), t(lens), 40)
    jemb, jtok_num, jalphas, jfires = jm.calc_predictor(params, jenc, jnp.asarray(lens), 40)
    _close(alphas.numpy(), jalphas)
    _close(tok_num.numpy(), jtok_num)
    _close(emb.numpy(), jemb)
    _close(fires.numpy(), jfires)

    ys_lens = np.asarray([13, 7, 2], np.int32)
    ys = np.asarray(jemb)[:, :13]
    logits, _ = pt.decoder(t(jenc_np), t(lens), t(ys), t(ys_lens))
    jlogits, _ = jm.decoder(params["decoder"], jenc, jnp.asarray(lens), jnp.asarray(ys),
                            jnp.asarray(ys_lens))
    _close(logits.numpy(), jlogits)

    ids = np.asarray([[3, 0, 40], [1, 2, 7]])
    _close(embedding(t(ids), pt.decoder.embed[0].weight).numpy(),
           jm.decoder.embed(params["decoder"], jnp.asarray(ids)), 0)


@pytest.mark.parametrize("pattern", ["half", "quarter", "one", "random"])
def test_cif_fires_match_jax(rng, pattern):
    b, n, d = 2, 37, 8
    hidden = rng.standard_normal((b, n, d)).astype(np.float32)
    alphas = {"half": np.full((b, n), 0.5), "quarter": np.full((b, n), 0.25),
              "one": np.ones((b, n)), "random": rng.random((b, n))}[pattern]
    alphas = alphas.astype(np.float32)
    alphas[1, 30:] = 0.0  # a padded tail
    frames, fires = cif(t(hidden), t(alphas), 40)
    jframes, jfires = jax_cif(jnp.asarray(hidden), jnp.asarray(alphas), 40)
    np.testing.assert_array_equal(fires.numpy() >= 1.0, np.asarray(jfires) >= 1.0)
    _close(fires.numpy(), jfires, 1e-5)
    _close(frames.numpy(), jframes, 1e-5)


def _set_alpha(model, bias):
    """Constant alphas: sigmoid(30) == 1.0 and sigmoid(0) == 0.5 exactly in fp32, so
    every running sum of alphas lands exactly on an integer or half-integer."""
    with torch.no_grad():
        model.predictor.cif_output.weight.zero_()
        model.predictor.cif_output.bias.fill_(bias)


@pytest.mark.parametrize("alpha_bias", [None, 0.0, 30.0])
def test_infer_bucketed_token_ids_match_jax(rng, pair, alpha_bias):
    pt, jm, params = pair
    if alpha_bias is not None:
        pt, jm, params = build_pair(seed=0)
        _set_alpha(pt, alpha_bias)
        params["predictor"]["cif_output"]["b"] = jnp.full((1,), alpha_bias, jnp.float32)
        params["predictor"]["cif_output"]["w"] = jnp.zeros_like(
            params["predictor"]["cif_output"]["w"])
    x, lens = _feats(rng, 3, 100, [100, 61, 24])
    got = pt.infer_bucketed(x, lens)
    want = jm.infer_bucketed(params, x, lens)
    yseq, tok_lens = got[0], got[1]
    np.testing.assert_array_equal(tok_lens, want[1])
    for i in range(3):
        np.testing.assert_array_equal(yseq[i, : tok_lens[i]], want[0][i, : tok_lens[i]])
    _close(got[3], want[3])  # alphas
    if alpha_bias == 30.0:
        # one token per frame: row 0's 100 tokens exceed the T=128 bucket's 80-token
        # budget, so both packages re-decoded at the full budget
        np.testing.assert_array_equal(tok_lens, lens)
        assert yseq.shape[1] == 129


def test_inference_text_matches_jax(tmp_path, pair):
    pt, jm, params = pair
    rng = np.random.default_rng(7)
    pcm = [(rng.standard_normal(n) * 0.1 * 32767).astype(np.int16) for n in (16000, 27000)]
    path = tmp_path / "a.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm[0].tobytes())
    conf = dict(fs=16000, n_mels=80, lfr_m=7, lfr_n=6, dither=0.0)
    tok, jtok = CharTokenizer(token_list=TOKENS), JaxCharTokenizer(token_list=TOKENS)
    for data in (pcm, [p.astype(np.float32) / 32768.0 for p in pcm], [str(path), pcm[1]]):
        got, meta = pt.inference(data, tokenizer=tok, frontend=WavFrontend(**conf))
        want, jmeta = jm.inference(params, data, tokenizer=jtok,
                                   frontend=JaxWavFrontend(**conf))
        assert [r["text"] for r in got] == [r["text"] for r in want]
        assert all(r["text"] for r in got)
        assert meta["batch_data_time"] == jmeta["batch_data_time"]
    got, _ = pt.inference(pcm, key=["a", "b"], frontend=WavFrontend(**conf))
    want, _ = jm.inference(params, pcm, key=["a", "b"], frontend=JaxWavFrontend(**conf))
    assert got == want  # no tokenizer: {"key", "token_int"}


def test_bf16_decode_runs_and_stays_close(pair):
    """The serving dtype on CPU: bf16 weights and activations give finite logits close
    to fp32 (the card's run of this is in chip_smoke.py)."""
    from funasr_tpu_torch.core.module import cast_floats
    pt, _, _ = pair
    rng = np.random.default_rng(3)
    x, lens = _feats(rng, 2, 60, [60, 41])
    ref = pt.infer_bucketed(x, lens)
    bf = cast_floats(build_pair(seed=0)[0], torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    got = bf.infer_bucketed(x, lens)
    assert np.isfinite(got[2]).all()
    _close(got[3], ref[3], 0.05)  # alphas through 2 bf16 encoder blocks
