"""The Conformer and Branchformer families of the PyTorch port against the JAX package
(CPU), small configs (2 blocks, d 32), the same weights in both packages. Tolerances:

* the plain depthwise conv (``ops/fsmn.py::depthwise_conv1d_ref``, the CPU side of the
  FSMN kernel's plain mode) bit-equal to ``core/layers.py::depthwise_conv1d_apply`` run
  eagerly (each tap a separate multiply and add) at k 3, 15 and 31, with and without
  bias and input mask;
* the Conformer, Branchformer and E-Branchformer encoders within 2e-4 of max |y| on a
  padded batch of unequal lengths (the Conformer's convolution module masks nothing, so
  the padded rows differ from a lone utterance's: both packages alike), seeded batch
  norm statistics;
* ``AutoModel(model=<Conformer dir>).generate(input=..., beam_size=5)`` texts equal to
  the JAX ``AutoModel``'s;
* Paraformer over ``ConformerEncoder`` (the AISHELL paraformer_conformer recipe's model,
  ``ParaformerSANDecoder`` + ``CifPredictor``): the JAX init through ``params_from_jax``,
  ids equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funasr_tpu.auto import auto_model as jauto
from funasr_tpu.convert.torch_to_jax import convert_state_dict
from funasr_tpu.core import layers as jlayers
from funasr_tpu.register import tables as jtables
from funasr_tpu_torch import AutoModel, tables
from funasr_tpu_torch.convert import params_from_jax
from funasr_tpu_torch.ops.fsmn import depthwise_conv1d, depthwise_conv1d_ref
from torch_parity_util import (_write_config, _write_tokens, one_torch_thread,  # noqa: F401
                               seed_batchnorm, t, to_jax)

import funasr_tpu.models.conformer.model  # noqa: F401,E402 (registers Conformer in JAX)

TOKENS = ["<blank>", "<s>", "</s>"] + [chr(ord("a") + i) for i in range(20)] + ["<unk>"]
DEC = dict(attention_heads=4, linear_units=64, num_blocks=2)
ENCODERS = {
    "Conformer": dict(output_size=32, attention_heads=4, linear_units=64, num_blocks=2,
                      cnn_module_kernel=15),
    "Branchformer": dict(output_size=32, attention_heads=4, cgmlp_linear_units=64,
                         cgmlp_conv_kernel=31, num_blocks=2),
    "EBranchformer": dict(output_size=32, attention_heads=4, cgmlp_linear_units=64,
                          cgmlp_conv_kernel=31, num_blocks=2, linear_units=48, ffn_units=48),
}
FRONTEND = dict(fs=16000, window="hamming", n_mels=80, frame_length=25, frame_shift=10,
                lfr_m=1, lfr_n=1, dither=0.0)
MODEL_TOL = 2e-4


def close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)
    assert err <= tol, err


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("k", [3, 15, 31])
def test_plain_depthwise_reference_equals_jax(rng, k, masked, bias):
    b, tt, c = 3, 45, 24
    x = rng.standard_normal((b, tt, c)).astype(np.float32)
    w = rng.standard_normal((k, c)).astype(np.float32)
    bv = rng.standard_normal(c).astype(np.float32)
    lens = np.asarray([45, 30, 7])
    mask = np.arange(tt)[None] < lens[:, None]
    pad = (k - 1) // 2
    got = depthwise_conv1d_ref(t(x), t(w.T[:, None, :]), t(bv) if bias else None,
                               t(mask) if masked else None, pad, k - 1 - pad)
    # through the wrapper too: a CPU tensor takes the plain version
    again = depthwise_conv1d(t(x), t(w.T[:, None, :]), t(bv) if bias else None,
                             t(mask) if masked else None, pad, k - 1 - pad)
    jx = x * mask[..., None] if masked else x
    p = {"w": jnp.asarray(w), **({"b": jnp.asarray(bv)} if bias else {})}
    want = jlayers.depthwise_conv1d_apply(p, jnp.asarray(jx), left_pad=pad,
                                          right_pad=k - 1 - pad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def build(name, seed=0, input_size=80):
    conf = dict(input_size=input_size, vocab_size=len(TOKENS), ctc_weight=0.3,
                encoder_conf=ENCODERS[name], decoder_conf=DEC, sos=1, eos=2)
    pt = tables.model_classes[name](**conf, generator=torch.Generator().manual_seed(seed))
    seed_batchnorm(pt, seed).eval()
    jm = jtables.model_classes[name](**conf)
    return pt, jm, to_jax(convert_state_dict(pt.state_dict(), jm, name)), conf


@pytest.mark.parametrize("name", list(ENCODERS))
def test_encoder_padded_batch_matches_jax(name):
    pt, jm, jp, _ = build(name)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 120, 80)).astype(np.float32)
    lens = np.asarray([120, 83, 57], np.int32)
    with torch.no_grad():
        got, glens = pt.encode(t(x), t(lens))
        alone, _ = pt.encode(t(x[1:2, :83]), t(lens[1:2]))
    want, wlens = jax.jit(lambda p, a, b: jm.encode(p, a, b))(jp, jnp.asarray(x),
                                                             jnp.asarray(lens))
    np.testing.assert_array_equal(glens.numpy(), np.asarray(wlens))
    for i, n in enumerate(np.asarray(wlens)):
        close(got[i, :n].numpy(), np.asarray(want)[i, :n], MODEL_TOL)
    if name == "Conformer":  # the unmasked depthwise conv: padding reaches valid frames
        n = alone.shape[1]
        assert not torch.allclose(got[1, :n], alone[0, :n], atol=1e-4)


def write_conformer_dir(d, seed=0):
    pt, _, _, conf = build("Conformer", seed)
    with torch.no_grad():
        # a sharper head: the seeded small decoder's logits are nearly flat, and the
        # frontends' last-bit differences would reorder near-tied beams
        pt.decoder.output_layer.weight.mul_(10.0)
        pt.decoder.output_layer.bias[2] -= 30.0  # eos unlikely: beams would end at once
    torch.save(pt.state_dict(), os.path.join(d, "model.pt"))
    _write_tokens(d, TOKENS)
    return _write_config(d, dict(
        model="Conformer", model_conf=dict(ctc_weight=0.3, sos=1, eos=2),
        encoder="ConformerEncoder", encoder_conf=conf["encoder_conf"],
        decoder="TransformerDecoder", decoder_conf=DEC,
        frontend="WavFrontend", frontend_conf=FRONTEND,
        tokenizer="CharTokenizer", tokenizer_conf=dict(token_list="tokens.txt",
                                                       unk_symbol="<unk>")))


def test_automodel_generate_texts_match_jax(tmp_path):
    d = write_conformer_dir(str(tmp_path))
    rng = np.random.default_rng(3)
    wavs = [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in (9600, 6400)]
    got = AutoModel(model=d, device="cpu").generate(input=wavs, beam_size=5)
    jam = jauto.AutoModel(model=d)
    # the search calls the scorer once a step; eager, each call retraces the layer scan
    jam.model.decoder.score_step = jax.jit(jam.model.decoder.score_step)
    want = jam.generate(input=wavs, beam_size=5)
    assert [r["text"] for r in got] == [r["text"] for r in want]
    assert all(r["text"] for r in got), got


PARA_CONF = dict(input_size=80, vocab_size=len(TOKENS), encoder="ConformerEncoder",
                 encoder_conf=ENCODERS["Conformer"], decoder="ParaformerSANDecoder",
                 decoder_conf=DEC, predictor="CifPredictor",
                 predictor_conf=dict(idim=32, threshold=1.0, l_order=1, r_order=1,
                                     tail_threshold=0.45),
                 sos=1, eos=2, predictor_bias=1, ctc_weight=0.3)


def test_paraformer_over_conformer_ids_match_jax():
    jm = jtables.model_classes["Paraformer"](**PARA_CONF)
    tree = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.PRNGKey(2)))
    rng = np.random.default_rng(4)
    norm = tree["encoder"]["encoders"]["conv_module"]["norm"]
    norm["mean"] = rng.normal(0, 0.1, norm["mean"].shape).astype(np.float32)
    norm["var"] = rng.uniform(0.5, 1.5, norm["var"].shape).astype(np.float32)
    pt = tables.model_classes["Paraformer"](**PARA_CONF).eval()
    pt.load_state_dict(params_from_jax(tree, pt))
    x = rng.standard_normal((3, 200, 80)).astype(np.float32)
    lens = np.asarray([200, 150, 96], np.int32)
    got = pt.infer_bucketed(x, lens)
    want = jm.infer_bucketed(to_jax(tree), x, lens)
    np.testing.assert_array_equal(got[1], want[1])
    for i, n in enumerate(want[1]):
        np.testing.assert_array_equal(got[0][i, :n], want[0][i, :n])
    assert want[1].min() > 0
