"""MFCCA of the PyTorch port against the JAX package (CPU), at a small width (d 32, 4
heads, FFN 64, 2 blocks, conv kernel 31, legacy rel-pos; a 2-block Transformer decoder;
CTC at 0.3; seeded batch-norm statistics). The same weights in both packages: the port's
seeded init through ``convert_state_dict``; ``params_from_jax`` back. Limits:

* the encoder's fused output within 2e-4 of max |y| with 1, 2 and 3 channels (tiled to 8
  for the fusion convs: 8 of 1, 4 of 2, 3 of 3 cut to 8), ragged lengths;
* the legacy rel-pos pieces: ``legacy_rel_shift`` equal to JAX's, ``legacy_rel_pe``
  within 3e-5 (sin / cos of fp32 arguments near 5,000 rad);
* ``forward`` (2 channels) loss and stats within 1e-5 relative, every gradient within
  1e-4 relative L2 of ``jax.jit(jax.value_and_grad(forward_jit))``;
* ``inference`` (beam 4, one channel) texts equal to the JAX model's, the head sharpened
  x10 and eos pushed down (else random weights end every beam at once or tie).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import funasr_tpu  # noqa: F401 (fills the JAX tables)
from funasr_tpu.convert.torch_to_jax import convert_state_dict
from funasr_tpu.frontends.wav_frontend import WavFrontend as JaxWavFrontend
from funasr_tpu.models.mfcca import encoder as jenc
from funasr_tpu.register import tables as jtables
from funasr_tpu_torch import tables
from funasr_tpu_torch.convert import params_from_jax
from funasr_tpu_torch.frontends.wav_frontend import WavFrontend
from funasr_tpu_torch.models.mfcca import encoder as penc
from funasr_tpu_torch.tokenizer.char_tokenizer import CharTokenizer
from test_torch_scama import check_loss_stats_grads
from torch_parity_util import seed_batchnorm, t, to_jax
from torch_parity_util import one_torch_thread  # noqa: F401 (autouse)

TOKENS = ["<blank>", "<s>", "</s>"] + [chr(ord("a") + i) for i in range(20)] + ["<unk>"]
V = len(TOKENS)
CONF = dict(input_size=80, vocab_size=V, ctc_weight=0.3, sos=1, eos=2,
            encoder_conf=dict(output_size=32, attention_heads=4, linear_units=64,
                              num_blocks=2),
            decoder_conf=dict(attention_heads=4, linear_units=64, num_blocks=2))
FRONTEND = dict(fs=16000, window="hamming", n_mels=80, frame_length=25, frame_shift=10,
                lfr_m=1, lfr_n=1, dither=0.0)
TOL = 2e-4


def close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)
    assert err <= tol, err


@pytest.fixture(scope="module")
def pair():
    pt = tables.model_classes["MFCCA"](**CONF, generator=torch.Generator().manual_seed(0))
    seed_batchnorm(pt, 0)
    with torch.no_grad():
        pt.decoder.output_layer.weight.mul_(10.0)
        pt.decoder.output_layer.bias[2] -= 30.0
    jm = jtables.model_classes["MFCCA"](**CONF)
    tree = jax.tree_util.tree_map(np.asarray, convert_state_dict(pt.state_dict(), jm, "MFCCA"))
    return pt.eval(), jm, tree


def test_params_round_trip(pair):
    pt, _, tree = pair
    back = params_from_jax(tree, pt)
    want = pt.state_dict()
    assert set(back) == set(want)
    for name, w in want.items():
        assert torch.equal(back[name], w), name


def test_legacy_relative_position_pieces_match_jax():
    # sin / cos at fp32 arguments near 5,000 rad: XLA's and torch's differ in the last bits
    np.testing.assert_allclose(penc.legacy_rel_pe(23, 32).numpy(),
                               np.asarray(jenc.legacy_rel_pe(23, 32)), atol=3e-5, rtol=0)
    x = np.random.default_rng(0).standard_normal((2, 3, 7, 7)).astype(np.float32)
    np.testing.assert_array_equal(penc.legacy_rel_shift(t(x)).numpy(),
                                  np.asarray(jenc._legacy_rel_shift(jnp.asarray(x))))


@pytest.mark.parametrize("channels", [1, 2, 3])
def test_encoder_matches_jax(pair, channels):
    pt, jm, tree = pair
    rng = np.random.default_rng(channels)
    x = rng.standard_normal((2, channels, 61, 80)).astype(np.float32)
    lens = np.asarray([61, 40], np.int32)
    with torch.no_grad():
        got, got_lens = pt.encode(t(x), t(lens))
    want, want_lens = jax.jit(lambda p, a, b: jm.encode(p, a, b))(to_jax(tree), jnp.asarray(x),
                                                                  jnp.asarray(lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    close(got.numpy(), np.asarray(want), TOL)


def test_loss_stats_and_grads_match_jax(pair):
    pt, jm, tree = pair
    rng = np.random.default_rng(5)
    speech = rng.standard_normal((2, 2, 50, 80)).astype(np.float32)
    slen = np.asarray([50, 37], np.int32)
    tlen = np.asarray([4, 3], np.int32)
    text = np.full((2, 4), -1, np.int32)
    for i in range(2):
        text[i, :tlen[i]] = rng.integers(3, V, tlen[i])
    check_loss_stats_grads(pt, jm, tree, speech, slen, text, tlen)


def test_inference_texts_match_jax(pair):
    pt, jm, tree = pair
    rng = np.random.default_rng(3)
    wavs = [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in (9600, 7200)]
    tok = CharTokenizer(token_list=TOKENS)
    got, _ = pt.inference(wavs, key=["a", "b"], tokenizer=tok, frontend=WavFrontend(**FRONTEND),
                          beam_size=4)
    # the search calls the scorer once a step; eager, each call retraces the layer scan
    jm.decoder.score_step = jax.jit(jm.decoder.score_step)
    want, _ = jm.inference(to_jax(tree), wavs, key=["a", "b"], tokenizer=tok,
                           frontend=JaxWavFrontend(**FRONTEND), beam_size=4)
    assert got == want and all(r["text"] for r in got)
