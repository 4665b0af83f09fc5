"""Whisper-LID of the PyTorch port against the JAX package (CPU), at a small width (the
Whisper encoder at d 64, 2 layers, 4 heads, FFN 128, 80 mel bins; ERes2NetV2 with one
block a layer, 8 channels, a 32-dim embedding; ``proj_dim`` 80; 20 frames kept; 6
languages). The same weights in both packages: the JAX model's seeded init (batch-norm
statistics drawn; the key projections' biases dropped, as Whisper has none and the JAX
converter's trees hold none) through ``params_from_jax``, as the JAX package has no
converter for this model. Limits:

* ``logits`` within 2e-4 of max |y| on a batch of 2 mel inputs;
* ``inference`` through both packages' Whisper frontends (30 s padding): labels equal,
  ``lid_logits`` within 2e-4;
* ``forward`` loss and stats within 1e-5 relative, every gradient within 1e-4 relative
  L2 of ``jax.jit(jax.value_and_grad(forward_jit))`` (the predictor's batch norms on their
  running statistics in both);
* ``AutoModel(model=<Whisper-LID dir>).generate`` equal to the JAX model's ``inference``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import funasr_tpu  # noqa: F401 (fills the JAX tables)
from funasr_tpu.frontends.whisper_frontend import WhisperFrontend as JaxWhisperFrontend
from funasr_tpu.register import tables as jtables
from funasr_tpu_torch import AutoModel, tables
from funasr_tpu_torch.convert import params_from_jax
from funasr_tpu_torch.frontends.whisper_frontend import WhisperFrontend
from funasr_tpu_torch.tokenizer.char_tokenizer import CharTokenizer
from test_torch_scama import check_loss_stats_grads
from torch_parity_util import _write_config, _write_tokens, t, to_jax
from torch_parity_util import one_torch_thread  # noqa: F401 (autouse)

LANGS = ["zh", "en", "yue", "ja", "ko", "<unk>"]
CONF = dict(vocab_size=len(LANGS),
            encoder_conf=dict(whisper_size="whisper-tiny", encoder_layers=2, decoder_layers=1,
                              d_model=64, encoder_attention_heads=4,
                              decoder_attention_heads=4, encoder_ffn_dim=128,
                              decoder_ffn_dim=128, num_mel_bins=80),
            lid_predictor_conf=dict(num_blocks=(1, 1, 1, 1), m_channels=8, embedding_size=32),
            proj_dim=80, clip_frames=20)
TOL = 2e-4


def close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)
    assert err <= tol, err


def seed_bn_stats(tree, seed=0):
    """Draw every batch norm's statistics and affine parameters in the JAX tree."""
    rng = np.random.default_rng(seed)

    def visit(p):
        if isinstance(p, dict) and "mean" in p:
            n = p["mean"].shape[0]
            p["mean"] = rng.normal(0, 0.1, n).astype(np.float32)
            p["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            if "scale" in p:
                p["scale"] = rng.uniform(0.8, 1.2, n).astype(np.float32)
                p["bias"] = rng.normal(0, 0.1, n).astype(np.float32)
        elif isinstance(p, dict):
            for v in p.values():
                visit(v)
        elif isinstance(p, list):
            for v in p:
                visit(v)

    visit(tree)
    return tree


@pytest.fixture(scope="module")
def pair():
    jm = jtables.model_classes["OpenAIWhisperLIDModel"](**CONF)
    init = jax.jit(jm.init_params)  # eager, ERes2NetV2's init compiles op by op
    tree = seed_bn_stats(jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0))))
    for layer in tree["encoder"]["layers"]:  # Whisper's key projection has no bias, as
        del layer["self_attn"]["linear_k"]["b"]  # the JAX converter's trees hold it
    pt = tables.model_classes["WhisperLID"](**CONF)
    pt.load_state_dict(params_from_jax(tree, pt))
    jm.logits = jax.jit(jm.logits)  # the JAX inference calls it eagerly
    return pt.eval(), jm, tree


def test_jax_init_holds_a_key_projection_bias_that_whisper_has_not():
    """A reference oddity, kept: the JAX model's own init gives each encoder layer's key
    projection a bias, which Whisper (and the JAX package's converters' trees) has not;
    the port has none, so a JAX-initialised tree loads only without it."""
    jm = jtables.model_classes["OpenAIWhisperLIDModel"](**CONF)
    shapes = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    assert all("b" in layer["self_attn"]["linear_k"] for layer in shapes["encoder"]["layers"])
    pt = tables.model_classes["WhisperLID"](**CONF)
    assert "encoder.layers.0.self_attn.k_proj.bias" not in pt.state_dict()


def test_lid_predictor_is_eres2netv2_in_both_tables():
    assert tables.lid_predictor_classes["LidPredictor"] is tables.model_classes["ERes2NetV2"]
    assert jtables.lid_predictor_classes["LidPredictor"].__name__ == "ERes2NetV2"
    assert tables.model_classes["WhisperLID"] is tables.model_classes["OpenAIWhisperLIDModel"]


def test_logits_match_jax(pair):
    pt, jm, tree = pair
    mel = np.random.default_rng(1).standard_normal((2, 64, 80)).astype(np.float32)
    with torch.no_grad():
        got = pt.logits(t(mel)).numpy()
    want = np.asarray(jax.jit(jm.logits)(to_jax(tree), jnp.asarray(mel), jnp.asarray([64, 50])))
    close(got, want, TOL)


def wavs(seed=2, lengths=(16000, 12000)):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in lengths]


def test_inference_matches_jax(pair):
    pt, jm, tree = pair
    tok = CharTokenizer(token_list=LANGS)
    got, _ = pt.inference(wavs(), key=["a", "b"], tokenizer=tok, frontend=WhisperFrontend())
    want, _ = jm.inference(to_jax(tree), wavs(), key=["a", "b"], tokenizer=tok,
                           frontend=JaxWhisperFrontend())
    for g, w in zip(got, want):
        assert g["key"] == w["key"] and g["text"] == w["text"]
        close(g["lid_logits"], w["lid_logits"], TOL)


def test_loss_stats_and_grads_match_jax(pair):
    pt, jm, tree = pair
    mel = np.random.default_rng(3).standard_normal((3, 64, 80)).astype(np.float32)
    lid = np.asarray([[3], [1], [0]], np.int32)
    check_loss_stats_grads(pt, jm, tree, mel, np.asarray([64, 50, 40], np.int32), lid,
                           np.ones(3, np.int32))
    assert not pt.lid_predictor.bn1.training


def test_automodel_generate_matches_jax(pair, tmp_path):
    pt, jm, tree = pair
    d = str(tmp_path)
    torch.save(pt.state_dict(), os.path.join(d, "model.pt"))
    _write_tokens(d, LANGS)
    _write_config(d, dict(model="OpenAIWhisperLIDModel",
                          model_conf={k: v for k, v in CONF.items() if k != "vocab_size"},
                          frontend="WhisperFrontend", frontend_conf=dict(n_mels=80),
                          tokenizer="CharTokenizer",
                          tokenizer_conf=dict(token_list="tokens.txt", unk_symbol="<unk>")))
    am = AutoModel(model=d, device="cpu", log_level="WARNING")
    got = am.generate(input=wavs()[0])
    want, _ = jm.inference(to_jax(tree), [wavs()[0]], key=[got[0]["key"]],
                           tokenizer=CharTokenizer(token_list=LANGS),
                           frontend=JaxWhisperFrontend())
    assert got[0]["text"] == want[0]["text"]
    close(got[0]["lid_logits"], want[0]["lid_logits"], TOL)
