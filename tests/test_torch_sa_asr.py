"""SA-ASR and LCBNetNAR of the PyTorch port against the JAX package (CPU), over a small
Paraformer (SAN-M encoder and decoder, 2 blocks each, d 32, k 11; CIF), speaker profiles
of 16 dims through a 4-head speaker attention, and a 2-block bias text encoder. The same
weights in both packages: the JAX model's seeded init through ``params_from_jax`` (neither
model has a JAX converter). Limits:

* ``SAASR.inference`` with 4 profiles: texts, token ids and ``spk_ids`` equal, and without
  profiles no ``spk_ids``;
* ``SAASR.forward`` with profiles and speaker labels: loss and stats within 1e-5
  relative, every gradient within 1e-4 relative L2 of ``jax.value_and_grad(forward_jit)``
  (the glancing sampler's uniforms drawn as JAX draws them; the training CIF's last-fire
  tie moved in both packages as ``test_torch_train_grads.py`` does);
* ``LCBNetNAR``: ``bias_fuse`` within 2e-4 of max |y|; ``inference`` texts equal, with the
  OCR text and without it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import funasr_tpu  # noqa: F401 (fills the JAX tables)
from funasr_tpu.frontends.wav_frontend import WavFrontend as JaxWavFrontend
from funasr_tpu.register import tables as jtables
from funasr_tpu_torch import tables
from funasr_tpu_torch.convert import params_from_jax
from funasr_tpu_torch.frontends.wav_frontend import WavFrontend
from funasr_tpu_torch.tokenizer.char_tokenizer import CharTokenizer
from test_torch_scama import GRAD_REL_L2, LOSS_RTOL, ZERO_SHARE, rel_l2
from test_torch_train_grads import cif_tie_moved  # noqa: F401 (fixture)
from torch_parity_util import t, to_jax
from torch_parity_util import one_torch_thread  # noqa: F401 (autouse)

TOKENS = ["<blank>", "<s>", "</s>"] + [chr(ord("一") + i) for i in range(30)] + ["<unk>"]
V = len(TOKENS)
BASE = dict(input_size=560, vocab_size=V,
            encoder_conf=dict(output_size=32, attention_heads=4, linear_units=48,
                              num_blocks=2, kernel_size=11, sanm_shfit=0, dropout_rate=0.0),
            decoder_conf=dict(attention_heads=4, linear_units=48, num_blocks=2,
                              att_layer_num=2, kernel_size=11, sanm_shfit=0),
            predictor_conf=dict(idim=32), sos=1, eos=2, predictor_bias=1)
MODELS = {"SAASR": dict(BASE, spk_embed_dim=16, spk_attention_heads=4, sampling_ratio=0.5),
          "LCBNetNAR": dict(BASE, bias_encoder_blocks=2, bias_attention_heads=4)}
FRONTEND = dict(fs=16000, window="hamming", n_mels=80, frame_length=25, frame_shift=10,
                lfr_m=7, lfr_n=6, dither=0.0)
TOL = 2e-4
S = 4


@functools.lru_cache(maxsize=None)
def build(name, seed=0):
    """The JAX model's seeded init, loaded into the port through ``params_from_jax``
    (which raises unless the names and shapes match the port's state dict exactly)."""
    jm = jtables.model_classes[name](**MODELS[name])
    tree = jax.tree_util.tree_map(np.asarray,
                                  jax.jit(jm.init_params)(jax.random.PRNGKey(seed)))
    pt = tables.model_classes[name](**MODELS[name])
    pt.load_state_dict(params_from_jax(tree, pt))
    # the JAX inference runs eagerly: its encoder and CIF jitted (one shape a test)
    jm.encode = jax.jit(jm.encode)
    jm.calc_predictor = jax.jit(jm.calc_predictor)
    return pt.eval(), jm, tree


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    return (request.param,) + build(request.param)


def test_params_from_jax_takes_every_leaf(pair):
    name, pt, _, tree = pair
    sd = pt.state_dict()
    n_leaves = len(jax.tree_util.tree_leaves(tree))
    assert sum(v.numel() for v in sd.values() if v.dtype != torch.int64) == sum(
        np.asarray(x).size for x in jax.tree_util.tree_leaves(tree))
    assert n_leaves > 0 and all(torch.isfinite(v).all() for v in sd.values())
    extra = {"SAASR": ("spk_proj.weight", "spk_attn.linear_k_v.weight", "spk_norm_w"),
             "LCBNetNAR": ("bias_attn.linear_q.weight",
                           "bias_text_encoder.encoders.1.feed_forward.w_2.weight")}[name]
    assert all(k in sd for k in extra)


def wavs(seed=6, lengths=(24000, 17000)):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in lengths]


def tok():
    return CharTokenizer(token_list=TOKENS)


def test_sa_asr_inference_ids_and_speakers_match_jax():
    pt, jm, tree = build("SAASR")
    profiles = np.random.default_rng(1).standard_normal((2, S, 16)).astype(np.float32)
    for prof in (profiles, None):
        got, _ = pt.inference(wavs(), key=["a", "b"], tokenizer=tok(),
                              frontend=WavFrontend(**FRONTEND), profiles=prof)
        want, _ = jm.inference(to_jax(tree), wavs(), key=["a", "b"], tokenizer=tok(),
                               frontend=JaxWavFrontend(**FRONTEND), profiles=prof)
        assert got == want
        assert ("spk_ids" in got[0]) == (prof is not None)
    assert all(0 <= s < S for r in got for s in r.get("spk_ids", []))
    ids, _ = pt.inference(wavs(), key=["a", "b"], frontend=WavFrontend(**FRONTEND),
                          profiles=profiles)
    assert ids[0]["text"] and len(ids[0]["text"]) == len(ids[0]["spk_ids"])


def test_sa_asr_loss_and_grads_with_profiles_match_jax(cif_tie_moved):
    pt, jm, tree = build("SAASR")
    rng = np.random.default_rng(2)
    b, l = 3, 5
    speech = rng.standard_normal((b, 40, 560)).astype(np.float32)
    slen = np.asarray([40, 31, 22], np.int32)
    tlen = np.asarray([5, 4, 2], np.int32)
    text = np.full((b, l), -1, np.int32)
    spk = np.full((b, l + 1), -1, np.int32)
    for i in range(b):
        text[i, :tlen[i]] = rng.integers(3, V, tlen[i])
        spk[i, :tlen[i] + 1] = rng.integers(0, S, tlen[i] + 1)
    profiles = rng.standard_normal((b, S, 16)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    _, k_smp = jax.random.split(key)
    uniform = np.asarray(jax.random.uniform(k_smp, (b, l + 1)))

    def loss_fn(p):
        loss, stats, _ = jm.forward_jit(p, jnp.asarray(speech), jnp.asarray(slen),
                                        jnp.asarray(text), jnp.asarray(tlen), key,
                                        profiles=jnp.asarray(profiles),
                                        spk_labels=jnp.asarray(spk))
        return loss, stats

    (jl, jst), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(to_jax(tree))
    pt.train()
    loss, stats, _ = pt(t(speech), t(slen), t(text).long(), t(tlen).long(),
                        sampler_uniform=torch.from_numpy(uniform.copy()),
                        profile=t(profiles), text_id=t(spk).long())
    loss.backward()
    pt.eval()
    assert set(stats) == set(jst) and "loss_spk" in stats
    for k, v in jst.items():
        got = float(stats[k].detach()) if torch.is_tensor(stats[k]) else float(stats[k])
        assert abs(got - float(v)) <= LOSS_RTOL * max(abs(float(v)), 1e-6), k
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jg), pt)
    floor = ZERO_SHARE * np.sqrt(sum(float((w ** 2).sum()) for w in want.values()))
    for n, p in pt.named_parameters():
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        if np.linalg.norm(want[n].numpy()) <= floor:
            assert np.linalg.norm(g) <= floor, n
        else:
            assert rel_l2(g, want[n].numpy()) <= GRAD_REL_L2, n
    assert pt.spk_proj.weight.grad.abs().sum() > 0


def test_lcbnet_nar_bias_fuse_and_texts_match_jax():
    pt, jm, tree = build("LCBNetNAR")
    jp = to_jax(tree)
    rng = np.random.default_rng(4)
    hidden = rng.standard_normal((2, 7, 32)).astype(np.float32)
    ids = rng.integers(3, V, (2, 5)).astype(np.int32)
    with torch.no_grad():
        got = pt.bias_fuse(t(hidden), t(ids).long()).numpy()
    want = np.asarray(jax.jit(jm.bias_fuse)(jp, jnp.asarray(hidden), jnp.asarray(ids)))
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max(), rtol=0)
    for cfg in (dict(ocr_text="".join(TOKENS[5:9])), {}):
        got, _ = pt.inference(wavs(), key=["a", "b"], tokenizer=tok(),
                              frontend=WavFrontend(**FRONTEND), **cfg)
        want, _ = jm.inference(jp, wavs(), key=["a", "b"], tokenizer=tok(),
                               frontend=JaxWavFrontend(**FRONTEND), **cfg)
        assert got == want and got[0]["text"], cfg
