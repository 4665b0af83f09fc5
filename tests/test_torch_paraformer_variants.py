"""Paraformer variants of the PyTorch port against the JAX package (CPU): the V1 CIF
predictor (``CifPredictor``: a depthwise alpha conv with a bias and a residual) and the SAN
decoder (``ParaformerSANDecoder``: plain multi-head self- and cross-attention).

Weights go JAX ``init_params`` -> ``params_from_jax`` -> port (the JAX package's
``convert_paraformer`` reads every CIF conv as a full conv, so it cannot take V1's
depthwise weight; ROADMAP section 3). Alphas within 1e-5, decoder logits within 2e-4, and
token ids of a whole ``inference`` equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funasr_tpu.frontends.wav_frontend import WavFrontend as JaxWavFrontend
from funasr_tpu.models.paraformer.model import Paraformer as JaxParaformer
from funasr_tpu_torch.convert import params_from_jax
from funasr_tpu_torch.frontends.wav_frontend import WavFrontend
from funasr_tpu_torch.models.paraformer.model import Paraformer
from pipeline_parity_util import multi_segment_wav
from torch_parity_util import SMALL_CONF, t
from torch_parity_util import one_torch_thread  # noqa: F401 (autouse)

FRONTEND = dict(fs=16000, n_mels=80, lfr_m=7, lfr_n=6, dither=0.0)


def _from_jax(conf, seed):
    jm = JaxParaformer(**conf)
    params = jm.init_params(jax.random.PRNGKey(seed))
    pt = Paraformer(**conf).eval()
    pt.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), pt))
    return pt, jm, params


@pytest.mark.parametrize("l_order,r_order", [(1, 1), (2, 0)])
def test_cif_predictor_v1_alphas_match_jax(l_order, r_order):
    conf = dict(SMALL_CONF, predictor="CifPredictor",
                predictor_conf=dict(idim=64, l_order=l_order, r_order=r_order,
                                    tail_threshold=0.45))
    pt, jm, params = _from_jax(conf, seed=1)
    assert tuple(pt.predictor.cif_conv1d.weight.shape) == (64, 1, l_order + r_order + 1)
    rng = np.random.default_rng(2)
    hidden = rng.standard_normal((3, 40, 64)).astype(np.float32)
    mask = np.arange(40)[None] < np.asarray([40, 22, 5])[:, None]
    with torch.inference_mode():
        got = pt.predictor.alphas(t(hidden), t(mask))
        emb, tn, _, _ = pt.predictor(t(hidden), t(mask), 24)
    want = jm.predictor.alphas(params["predictor"], jnp.asarray(hidden), jnp.asarray(mask))
    jemb, jtn, _, _ = jm.predictor(params["predictor"], jnp.asarray(hidden), jnp.asarray(mask), 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jtn))
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), atol=1e-4, rtol=0)


SAN_CONF = dict(SMALL_CONF, decoder="ParaformerSANDecoder",
                decoder_conf=dict(attention_heads=4, linear_units=96, num_blocks=2))


def test_san_decoder_matches_jax():
    pt, jm, params = _from_jax(SAN_CONF, seed=3)
    assert type(pt.decoder).__name__ == "ParaformerSANDecoder" and len(pt.decoder.decoders) == 2
    rng = np.random.default_rng(4)
    enc = rng.standard_normal((2, 40, 64)).astype(np.float32)
    emb = rng.standard_normal((2, 12, 64)).astype(np.float32)
    elens, ylens = np.asarray([40, 23], np.int32), np.asarray([12, 7], np.int32)
    with torch.inference_mode():
        got, _ = pt.decoder(t(enc), t(elens), t(emb), t(ylens))
    want, _ = jm.decoder(params["decoder"], jnp.asarray(enc), jnp.asarray(elens),
                         jnp.asarray(emb), jnp.asarray(ylens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)


@pytest.mark.parametrize("conf", [
    dict(SMALL_CONF, predictor="CifPredictor"),
    SAN_CONF,
], ids=["cif_v1", "san_decoder"])
def test_inference_token_ids_match_jax(conf):
    pt, jm, params = _from_jax(conf, seed=5)
    waves = [multi_segment_wav(s, seed=i + 3) for i, s in enumerate((1.1, 4.2))]
    got, _ = pt.inference(waves, frontend=WavFrontend(**FRONTEND))
    want, _ = jm.inference(params, waves, frontend=JaxWavFrontend(**FRONTEND))
    assert got == want and all(r["token_int"] for r in got)
