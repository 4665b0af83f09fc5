"""emotion2vec of the PyTorch port against the JAX package (CPU), at a small width (embed 32,
1 prenet + 2 blocks, 4 heads, a 2-layer conv extractor from the config's string spec, 2
extra tokens), with an odd positional kernel (k 47) and an even one (k 6, whose extra
frame ``SamePad`` trims). The same weights in both packages: the port's seeded init, the
extra tokens drawn and the ALiBi scale partly negative (clipped at 0), through
``convert_state_dict``; ``params_from_jax`` back. Limits:

* ``extract_features`` within 2e-4 of max |y| on a batch of 2 (the positional LayerNorm
  over the population variance: the unbiased one moves it by ~3 %);
* the waveform normalisation equal to ``jnp.var``'s population form within 1e-6, on a
  200-sample clip whose two variances differ by 0.5 %;
* ``inference``: labels equal ("unuse" labels masked out), scores within 1e-4, the
  embedding within 2e-4, at utterance and frame granularity, directly and through
  ``AutoModel(model=<emotion2vec dir>).generate``;
* ``forward`` loss and ``acc`` within 1e-5 relative, every gradient within 1e-4 relative
  L2 of ``jax.jit(jax.value_and_grad(forward_jit))``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import funasr_tpu  # noqa: F401 (fills the JAX tables)
from funasr_tpu.convert.torch_to_jax import convert_state_dict
from funasr_tpu.register import tables as jtables
from funasr_tpu_torch import AutoModel, tables
from funasr_tpu_torch.convert import params_from_jax
from funasr_tpu_torch.tokenizer.char_tokenizer import CharTokenizer
from test_torch_scama import check_loss_stats_grads
from torch_parity_util import _write_config, _write_tokens, t, to_jax
from torch_parity_util import one_torch_thread  # noqa: F401 (autouse)

LABELS = ["生气/angry", "unuse_0", "开心/happy", "中立/neutral", "难过/sad", "unuse_1",
          "吃惊/surprised", "其他/other", "<unk>"]


def model_conf(width):
    return dict(embed_dim=32, depth=2, num_heads=4, mlp_ratio=2.0,
                modalities=dict(audio=dict(prenet_depth=1, num_extra_tokens=2,
                                           num_alibi_heads=4, conv_pos_depth=2,
                                           conv_pos_groups=4, conv_pos_width=width,
                                           feature_encoder_spec="[(16, 10, 5), (16, 3, 2)]")))


FEAT_TOL = 2e-4
SCORE_TOL = 1e-4


def close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)
    assert err <= tol, err


def build(width, seed=0):
    conf = dict(model_conf=model_conf(width), vocab_size=len(LABELS))
    pt = tables.model_classes["Emotion2vec"](**conf,
                                             generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        pt.audio.extra_tokens.copy_(torch.randn(pt.audio.extra_tokens.shape, generator=g))
        pt.audio.alibi_scale.copy_(torch.tensor([1.5, -0.5, 0.7, 0.0]).reshape(1, 1, 4, 1, 1))
    jm = jtables.model_classes["Emotion2vec"](**conf)
    tree = jax.tree_util.tree_map(np.asarray, convert_state_dict(pt.state_dict(), jm,
                                                                 "Emotion2vec"))
    return pt.eval(), jm, tree


@pytest.fixture(scope="module", params=[95, 12], ids=["k47", "k6"])
def pair(request):
    return build(request.param)


def wavs(seed=4, lengths=(9000, 6400)):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in lengths]


def test_params_round_trip(pair):
    pt, _, tree = pair
    back = params_from_jax(tree, pt)
    want = pt.state_dict()
    assert set(back) == set(want)
    for name, w in want.items():
        assert torch.equal(back[name], w), name


def test_extract_features_matches_jax(pair):
    pt, jm, tree = pair
    x = np.stack([w[:6400] for w in wavs()])
    with torch.no_grad():
        got = pt.extract_features(t(x)).numpy()
    want = np.asarray(jax.jit(jm.extract_features)(to_jax(tree), jnp.asarray(x)))
    assert got.shape[1] == ((6400 - 10) // 5 + 1 - 3) // 2 + 1
    close(got, want, FEAT_TOL)


def test_waveform_normalisation_is_the_population_form():
    pt, _, _ = build(95)
    x = np.random.default_rng(0).standard_normal((1, 200)).astype(np.float32) * 0.3 + 0.1
    got = pt._normalized(t(x)).numpy()
    want = np.asarray((jnp.asarray(x) - jnp.mean(x, -1, keepdims=True))
                      * jax.lax.rsqrt(jnp.var(x, -1, keepdims=True) + 1e-5))
    close(got, want, 1e-6)
    unbiased = (x - x.mean()) / np.sqrt(x.var(ddof=1) + 1e-5)
    assert np.max(np.abs(unbiased - want)) / np.max(np.abs(want)) > 1e-3


class Tok:
    token_list = LABELS


@pytest.mark.parametrize("granularity", ["utterance", "frame"])
def test_inference_matches_jax(pair, granularity):
    pt, jm, tree = pair
    got, _ = pt.inference(wavs(), key=["a", "b"], tokenizer=Tok(), granularity=granularity)
    want, _ = jm.inference(to_jax(tree), wavs(), key=["a", "b"], tokenizer=Tok(),
                           granularity=granularity)
    for g, w in zip(got, want):
        assert g["key"] == w["key"] and g["labels"] == w["labels"]
        assert len(g["labels"]) == 7 and not any(lb.startswith("unuse") for lb in g["labels"])
        np.testing.assert_allclose(g["scores"], w["scores"], atol=SCORE_TOL, rtol=0)
        close(g["feats"], w["feats"], FEAT_TOL)
    assert got[0]["feats"].ndim == (1 if granularity == "utterance" else 2)


def test_loss_acc_and_grads_match_jax(pair):
    pt, jm, tree = pair
    speech = np.stack([w[:6400] for w in wavs(7)] + [wavs(8)[1][:6400]])
    labels = np.asarray([[2], [0], [6]], np.int32)
    check_loss_stats_grads(pt, jm, tree, speech, np.full(3, 6400, np.int32), labels,
                           np.ones(3, np.int32))


def test_automodel_generate_matches_jax(tmp_path, pair):
    pt, jm, tree = pair
    d = str(tmp_path)
    torch.save(pt.state_dict(), os.path.join(d, "model.pt"))
    _write_tokens(d, LABELS)
    _write_config(d, dict(model="Emotion2vec", model_conf=model_conf(pt.conv_pos_width),
                          tokenizer="CharTokenizer",
                          tokenizer_conf=dict(token_list="tokens.txt", unk_symbol="<unk>")))
    am = AutoModel(model=d, device="cpu", log_level="WARNING")
    wav = wavs()[0]
    got = am.generate(input=wav, granularity="utterance", extract_embedding=True)
    want, _ = jm.inference(to_jax(tree), [wav], key=[got[0]["key"]],
                           tokenizer=CharTokenizer(token_list=LABELS))
    assert got[0]["labels"] == want[0]["labels"]
    np.testing.assert_allclose(got[0]["scores"], want[0]["scores"], atol=SCORE_TOL, rtol=0)
    close(got[0]["feats"], want[0]["feats"], FEAT_TOL)
