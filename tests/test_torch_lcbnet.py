"""LCB-Net of the PyTorch port against the JAX package (CPU): a small Conformer AED
(2 blocks, d 32, seeded batch-norm statistics) with its text encoder (2 blocks),
fusion block and bias predictor (k 7, pads 3 / 3), vocab 24, the same weights in both
packages (the port's seeded init through ``convert_state_dict``; ``params_from_jax``
takes it back). Limits:

* ``fuse_ocr`` (the fused encoder output) and ``bias_scores`` (the depthwise conv at k 7 /
  left 3 with a bias, ``ops/fsmn.py::depthwise_conv1d_ref`` on the CPU) within 2e-4 of
  max |y| on a batch of 2 with ragged audio;
* ``forward`` (``Transformer.forward``) loss and stats within 1e-5 relative, every
  gradient within 1e-4 relative L2 of ``jax.jit(jax.value_and_grad(forward_jit))``
  (the bias stack, which the loss does not read, has none);
* ``AutoModel(model=<LCBNet dir>).generate(input=..., ocr_text=..., beam_size=5)`` texts
  equal to the JAX ``AutoModel``'s, with the OCR context (fused into the memory) and
  without it.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import funasr_tpu.models.lcbnet.model  # noqa: F401 (registers LCBNet in JAX)
from funasr_tpu.auto import auto_model as jauto
from funasr_tpu.convert.torch_to_jax import convert_state_dict
from funasr_tpu.register import tables as jtables
from funasr_tpu_torch import AutoModel, tables
from funasr_tpu_torch.convert import params_from_jax
from test_torch_scama import check_loss_stats_grads
from torch_parity_util import (_write_config, _write_tokens, seed_batchnorm,
                               shape_only_init, t, to_jax)
from torch_parity_util import one_torch_thread  # noqa: F401 (autouse)

TOKENS = ["<blank>", "<s>", "</s>"] + [chr(ord("a") + i) for i in range(20)] + ["<unk>"]
V = len(TOKENS)
CONF = dict(input_size=80, vocab_size=V, ctc_weight=0.3, sos=1, eos=2,
            encoder_conf=dict(output_size=32, attention_heads=4, linear_units=64,
                              num_blocks=2, cnn_module_kernel=15),
            decoder_conf=dict(attention_heads=4, linear_units=64, num_blocks=2),
            text_encoder_conf=dict(linear_units=48, num_blocks=2),
            fusion_encoder_conf=dict(linear_units=48),
            bias_predictor_conf=dict(linear_units=48))
FRONTEND = dict(fs=16000, window="hamming", n_mels=80, frame_length=25, frame_shift=10,
                lfr_m=1, lfr_n=1, dither=0.0)
TOL = 2e-4
OCR = "bcdk"


def close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)
    assert err <= tol, err


def build(seed=0):
    pt = tables.model_classes["LCBNet"](**CONF, generator=torch.Generator().manual_seed(seed))
    seed_batchnorm(pt, seed).eval()
    with torch.no_grad():
        # a sharper head: the seeded small decoder's logits are nearly flat, and the
        # frontends' last-bit differences would reorder near-tied beams
        pt.decoder.output_layer.weight.mul_(10.0)
        pt.decoder.output_layer.bias[2] -= 30.0  # eos unlikely: beams would end at once
    jm = jtables.model_classes["LCBNet"](**CONF)
    tree = jax.tree_util.tree_map(np.asarray, convert_state_dict(pt.state_dict(), jm, "LCBNet"))
    return pt, jm, tree


@pytest.fixture(scope="module")
def pair():
    return build()


def test_params_round_trip(pair):
    pt, _, tree = pair
    back = params_from_jax(tree, pt)
    want = pt.state_dict()
    assert set(back) == set(want)
    for name, w in want.items():
        assert torch.equal(back[name], w), name


def test_fuse_ocr_and_bias_scores_match_jax(pair):
    pt, jm, tree = pair
    jp = to_jax(tree)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 90, 80)).astype(np.float32)
    lens = np.asarray([90, 61], np.int32)
    ocr = rng.integers(1, V, (2, 9)).astype(np.int32)
    with torch.no_grad():
        enc, _ = pt.encode(t(x), t(lens))
        fused = pt.fuse_ocr(enc, t(ocr).long())
        scores = pt.bias_scores(enc, t(ocr).long())
    jenc, _ = jax.jit(lambda p, a, b: jm.encode(p, a, b))(jp, jnp.asarray(x), jnp.asarray(lens))
    jfused = jax.jit(jm.fuse_ocr)(jp, jenc, jnp.asarray(ocr))
    jscores = jax.jit(jm.bias_scores)(jp, jenc, jnp.asarray(ocr))
    close(enc.numpy(), np.asarray(jenc), TOL)
    close(fused.numpy(), np.asarray(jfused), TOL)
    assert scores.shape == (2, 9)
    close(scores.numpy(), np.asarray(jscores), TOL)


def test_loss_stats_and_grads_match_jax(pair):
    pt, jm, tree = pair
    rng = np.random.default_rng(2)
    speech = rng.standard_normal((3, 70, 80)).astype(np.float32)
    slen = np.asarray([70, 52, 33], np.int32)
    tlen = np.asarray([5, 4, 2], np.int32)
    text = np.full((3, 5), -1, np.int32)
    for i in range(3):
        text[i, :tlen[i]] = rng.integers(3, V, tlen[i])
    check_loss_stats_grads(pt, jm, tree, speech, slen, text, tlen)


def write_lcbnet_dir(d, pt):
    torch.save(pt.state_dict(), os.path.join(d, "model.pt"))
    _write_tokens(d, TOKENS)
    conf = {k: v for k, v in CONF.items() if k not in ("input_size", "vocab_size")}
    model_conf = {k: conf.pop(k) for k in ("ctc_weight", "sos", "eos")}
    return _write_config(d, dict(
        model="LCBNet", model_conf=model_conf, encoder="ConformerEncoder",
        decoder="TransformerDecoder", **conf, frontend="WavFrontend", frontend_conf=FRONTEND,
        tokenizer="CharTokenizer", tokenizer_conf=dict(token_list="tokens.txt",
                                                       unk_symbol="<unk>")))


def test_automodel_generate_with_ocr_text_matches_jax(pair, tmp_path):
    d = write_lcbnet_dir(str(tmp_path), pair[0])
    rng = np.random.default_rng(3)
    wav = (rng.standard_normal(9600) * 0.1).astype(np.float32)
    port = AutoModel(model=d, device="cpu", log_level="WARNING")
    with shape_only_init(("LCBNet",)):
        ref = jauto.AutoModel(model=d, log_level="WARNING")
    # the search calls the scorer once a step; eager, each call retraces the layer scan
    ref.model.decoder.score_step = jax.jit(ref.model.decoder.score_step)
    fused = []
    original = port.model.fuse_ocr
    port.model.fuse_ocr = lambda *a, **k: fused.append(1) or original(*a, **k)
    for cfg in (dict(ocr_text=OCR), dict()):
        got = port.generate(input=[wav], key=["u"], beam_size=5, **cfg)
        want = ref.generate(input=[wav], key=["u"], beam_size=5, **cfg)
        assert got == want and got[0]["text"], (cfg, got, want)
    assert fused == [1]  # the OCR context reached the memory once, and only when given
