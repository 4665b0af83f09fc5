"""BiCifParaformer and timestamps of the PyTorch port against the JAX package (CPU).

* ``CifPredictorV3.get_upsample_timestamp`` at idim 32 for ``cnn`` / ``cnn_blstm`` with
  ``use_cif1_cnn`` on and off, weights both ways (port -> JAX through
  ``convert_paraformer``, JAX -> port through ``params_from_jax``): ``us_alphas`` within
  1e-5 and the fire positions (``us_peaks >= 1 - 1e-4``, ``ts_prediction``'s rule)
  equal, on inputs whose running sums are checked to sit more than 1e-5 away from
  integers (fp32 summation orders differ by ~1e-6 there);
* ``BiCifParaformer.inference`` on ``SMALL_CONF`` with the published V3 head:
  token ids and ms timestamps equal to JAX's, on a batch whose rows alone would bucket
  to another T; the encoder output at the padded positions (which the BLSTM reads)
  within 2e-4;
* the plain Paraformer's ``pred_timestamp=True``, which copies the JAX package's
  argument order (peaks in the alphas slot, ROADMAP section 3);
* ``AutoModel.generate(batch_size=1)`` over 3 inputs on a BiCif directory: the
  double-buffered loop keeps the timestamps and equals JAX's
  ``BiCifParaformer.inference``; the JAX ``AutoModel`` loses them there.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funasr_tpu.auto import auto_model as jauto
from funasr_tpu.convert.torch_to_jax import convert_paraformer
from funasr_tpu.frontends.wav_frontend import WavFrontend as JaxWavFrontend
from funasr_tpu.models.bicif_paraformer.model import BiCifParaformer as JaxBiCif
from funasr_tpu.tokenizer.char_tokenizer import CharTokenizer as JaxCharTokenizer
from funasr_tpu_torch import AutoModel
from funasr_tpu_torch.auto.auto_model import dispatch_pair
from funasr_tpu_torch.convert import params_from_jax
from funasr_tpu_torch.frontends.wav_frontend import WavFrontend
from funasr_tpu_torch.models.bicif_paraformer.model import BiCifParaformer
from funasr_tpu_torch.models.paraformer.model import Paraformer
from funasr_tpu_torch.tokenizer.char_tokenizer import CharTokenizer
from funasr_tpu_torch.utils.bucket import pad_feats_bucketed
from pipeline_parity_util import multi_segment_wav
from torch_parity_util import (BICIF_PREDICTOR, PIPE_ASR_CONF, PIPE_TOKENS, SMALL_CONF,
                               TOKENS, build_pair, shape_only_init, t, to_jax,
                               write_bicif_dir)
from torch_parity_util import one_torch_thread  # noqa: F401 (autouse)

FRONTEND = dict(fs=16000, n_mels=80, lfr_m=7, lfr_n=6, dither=0.0)
D32 = dict(input_size=560, vocab_size=len(TOKENS),
           encoder_conf=dict(output_size=32, attention_heads=4, linear_units=64, num_blocks=2,
                             kernel_size=11, sanm_shfit=0),
           decoder_conf=dict(attention_heads=4, linear_units=64, num_blocks=2, att_layer_num=2,
                             kernel_size=11, sanm_shfit=0),
           sos=1, eos=2, predictor_bias=1)


def _v3_conf(upsample_type, use_cif1_cnn):
    return dict(D32, predictor_conf=dict(idim=32, l_order=1, r_order=1, tail_threshold=0.45,
                                         smooth_factor2=0.25, noise_threshold2=0.01,
                                         upsample_times=3, upsample_type=upsample_type,
                                         use_cif1_cnn=use_cif1_cnn))


def _tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _margin(us_alphas, thr=1.0 - 1e-4):
    """Least distance of the running sums of alphas / thr to an integer, per row."""
    csum = np.cumsum(np.asarray(us_alphas, np.float64) / thr, axis=-1)
    return np.abs(csum - np.round(csum)).min()


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
@pytest.mark.parametrize("upsample_type,use_cif1_cnn",
                         [("cnn", True), ("cnn", False), ("cnn_blstm", True),
                          ("cnn_blstm", False)])
def test_cif_predictor_v3_matches_jax(upsample_type, use_cif1_cnn, direction):
    conf = _v3_conf(upsample_type, use_cif1_cnn)
    jm = JaxBiCif(**conf)
    if direction == "port_to_jax":
        pt = BiCifParaformer(**conf, generator=torch.Generator().manual_seed(1)).eval()
        params = to_jax(convert_paraformer(pt.state_dict(), jm))
    else:
        params = jm.init_params(jax.random.PRNGKey(1))
        pt = BiCifParaformer(**conf).eval()
        pt.load_state_dict(params_from_jax(_tree(params), pt))
    rng = np.random.default_rng(4)
    hidden = rng.standard_normal((3, 40, 32)).astype(np.float32)
    lens = np.asarray([40, 26, 9])
    mask = np.arange(40)[None] < lens[:, None]
    token_num = np.asarray([9.0, 6.0, 2.0], np.float32)
    with torch.inference_mode():
        got = pt.predictor.get_upsample_timestamp(t(hidden), t(mask), t(token_num))
    want = jm.predictor.get_upsample_timestamp(params["predictor"], jnp.asarray(hidden),
                                               jnp.asarray(mask), jnp.asarray(token_num))
    ds_alphas, ds_peak, us_alphas, us_peaks = (x.numpy() for x in got)
    assert us_alphas.shape == (3, 120) and ds_alphas.shape == (3, 40)
    np.testing.assert_allclose(us_alphas, want[2], atol=1e-5, rtol=0)
    np.testing.assert_allclose(ds_alphas, want[0], atol=1e-5, rtol=0)
    # no running sum within rounding of an integer: fp32 sums of 120 alphas differ by
    # ~1e-6 between summation orders
    assert _margin(want[2]) > 1e-5
    np.testing.assert_array_equal(us_peaks >= 1 - 1e-4, np.asarray(want[3]) >= 1 - 1e-4)
    np.testing.assert_array_equal(ds_peak >= 1 - 1e-4, np.asarray(want[1]) >= 1 - 1e-4)
    np.testing.assert_allclose(us_alphas.sum(-1), token_num, rtol=1e-5)  # rescaled


@pytest.fixture(scope="module")
def bicif_pair():
    """SMALL_CONF (2 + 2 blocks, d 64) with the published V3 head."""
    conf = dict(SMALL_CONF, predictor_conf=dict(BICIF_PREDICTOR, idim=64))
    pt = BiCifParaformer(**conf, generator=torch.Generator().manual_seed(0)).eval()
    jm = JaxBiCif(**conf)
    return pt, jm, to_jax(convert_paraformer(pt.state_dict(), jm))


def test_encoder_output_at_padded_positions_matches_jax(bicif_pair):
    """The BLSTM reads every frame of the bucket, so the padding must agree too."""
    pt, jm, params = bicif_pair
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 70, 560)).astype(np.float32)
    lens = np.asarray([70, 33, 12], np.int32)
    sp, ln, _ = pad_feats_bucketed(t(x), t(lens))
    with torch.inference_mode():
        enc, _ = pt.encode(sp, ln)
    jenc, _ = jm.encode(params, jnp.asarray(sp.numpy()), jnp.asarray(ln.numpy()))
    assert enc.shape[1] == 128
    np.testing.assert_allclose(enc.numpy()[:, 33:], np.asarray(jenc)[:, 33:], atol=2e-4, rtol=0)
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), atol=2e-4, rtol=0)


def test_bicif_inference_ids_and_timestamps_match_jax(bicif_pair):
    """Three rows of 1.1, 4.2 and 9 s: the short ones bucket to T = 256 with the long one
    (128 alone), and B to 4 (a replicated padding row)."""
    pt, jm, params = bicif_pair
    waves = [multi_segment_wav(s, seed=i + 3) for i, s in enumerate((1.1, 4.2, 9.0))]
    tok, jtok = CharTokenizer(token_list=TOKENS), JaxCharTokenizer(token_list=TOKENS)
    got, meta = pt.inference(waves, tokenizer=tok, frontend=WavFrontend(**FRONTEND),
                             begin_time=250)
    want, jmeta = jm.inference(params, waves, tokenizer=jtok,
                               frontend=JaxWavFrontend(**FRONTEND), begin_time=250)
    assert got == want
    assert all(r["timestamp"] and len(r["timestamp"]) == len(r["text"].split()) for r in got)
    assert meta["batch_data_time"] == jmeta["batch_data_time"]
    ids, _ = pt.inference(waves, frontend=WavFrontend(**FRONTEND))
    jids, _ = jm.inference(params, waves, frontend=JaxWavFrontend(**FRONTEND))
    assert ids == jids  # no tokenizer: token ids


def test_paraformer_pred_timestamp_matches_jax():
    pt, jm, params = build_pair(seed=0)
    rng = np.random.default_rng(7)
    pcm = [(rng.standard_normal(n) * 0.1 * 32767).astype(np.int16) for n in (16000, 27000)]
    tok, jtok = CharTokenizer(token_list=TOKENS), JaxCharTokenizer(token_list=TOKENS)
    got, _ = pt.inference(pcm, tokenizer=tok, frontend=WavFrontend(**FRONTEND),
                          pred_timestamp=True)
    want, _ = jm.inference(params, pcm, tokenizer=jtok, frontend=JaxWavFrontend(**FRONTEND),
                           pred_timestamp=True)
    assert got == want
    assert all(r["timestamp"] for r in got)
    plain, _ = pt.inference(pcm, tokenizer=tok, frontend=WavFrontend(**FRONTEND))
    assert all("timestamp" not in r for r in plain)


def test_automodel_keeps_bicif_timestamps_in_the_double_buffered_loop(tmp_path):
    d = write_bicif_dir(tmp_path)
    port = AutoModel(model=d, device="cpu", log_level="WARNING")
    fetched = []
    fetch = port.model.inference_fetch
    port.model.inference_fetch = lambda h: fetched.append(h["b"]) or fetch(h)
    waves = [multi_segment_wav(s, seed=i) for i, s in enumerate((2.0, 3.0, 4.0))]
    got = port.generate(input=waves, batch_size=1, key=["a", "b", "c"])
    assert fetched == [1, 1, 1]  # through the dispatch / fetch pair

    conf = dict(PIPE_ASR_CONF, predictor_conf=BICIF_PREDICTOR)
    jm = JaxBiCif(**conf)
    params = to_jax(convert_paraformer(torch.load(os.path.join(d, "model.pt")), jm))
    jtok = JaxCharTokenizer(token_list=PIPE_TOKENS)
    want = [jm.inference(params, [w], key=[k], tokenizer=jtok,
                         frontend=JaxWavFrontend(**FRONTEND))[0][0]
            for w, k in zip(waves, "abc")]
    assert got == want and all(r["timestamp"] for r in got)
    # the reference fault the port does not copy: the JAX AutoModel pipelines BiCif
    # through Paraformer's pair and drops its timestamps
    with shape_only_init():
        ref = jauto.AutoModel(model=d, device="cpu", log_level="WARNING")
    lost = ref.generate(input=waves, batch_size=1, key=["a", "b", "c"])
    assert [r["text"] for r in lost] != [] and all("timestamp" not in r for r in lost)


def test_dispatch_pair_belongs_to_the_class_that_defines_inference():
    class OwnInference(Paraformer):
        def inference(self, *args, **kwargs):
            return [], {}

    model = BiCifParaformer(**_v3_conf("cnn", True))
    pair = dispatch_pair(model)
    assert pair is not None and pair[0].__self__ is model
    assert dispatch_pair(Paraformer(**_v3_conf("cnn", True) | dict(
        predictor_conf=dict(idim=32)))) is not None
    assert dispatch_pair(OwnInference(**_v3_conf("cnn", True) | dict(
        predictor_conf=dict(idim=32)))) is None
    assert dispatch_pair(object()) is None
