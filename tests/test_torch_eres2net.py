"""ERes2NetV2 of the PyTorch port against the JAX package (CPU): a small ERes2NetV2
(one block a layer, 8 channels, embedding 16, 80 mels, seeded batch-norm statistics), the
same weights in both packages (the port's seeded init through ``convert_state_dict``;
``params_from_jax`` takes it back). Limits:

* ``forward`` embeddings within 1e-4 relative L2 of the JAX ``forward`` (jitted), on a
  batch of 3 fbank sequences;
* ``inference`` (the per-clip fbank, its mean subtracted, the zero-padded batch) within
  1e-4 relative L2 of JAX's, directly and through ``AutoModel(model=<dir>)``;
* the speaker-attributed pipeline ``AutoModel(model, vad_model, punc_model,
  spk_model=<ERes2NetV2 dir>)`` equal to the JAX ``AutoModel``'s, as
  ``test_torch_spk_pipeline.py`` holds it with CAM++.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import funasr_tpu.models.eres2net.model  # noqa: F401 (registers ERes2NetV2 in JAX)
from funasr_tpu.auto import auto_model as jauto
from funasr_tpu.convert.torch_to_jax import convert_state_dict
from funasr_tpu.register import tables as jtables
from funasr_tpu_torch import AutoModel, tables
from funasr_tpu_torch.convert import params_from_jax
from torch_parity_util import (_write_config, seed_batchnorm, shape_only_init, t, to_jax,
                               two_voice_wav, write_bicif_dir, write_punc_dir, write_vad_dir)
from torch_parity_util import one_torch_thread  # noqa: F401 (autouse)

CONF = dict(num_blocks=[1, 1, 1, 1], m_channels=8, feat_dim=80, embedding_size=16)
EMB_REL_L2 = 1e-4


def rel_l2(got, want):
    return np.linalg.norm(np.asarray(got) - np.asarray(want)) / np.linalg.norm(want)


def build(seed=3):
    pt = tables.model_classes["ERes2NetV2"](**CONF, generator=torch.Generator().manual_seed(seed))
    seed_batchnorm(pt, seed).eval()
    jm = jtables.model_classes["ERes2NetV2"](**CONF)
    tree = jax.tree_util.tree_map(np.asarray,
                                  convert_state_dict(pt.state_dict(), jm, "ERes2NetV2"))
    return pt, jm, tree


@pytest.fixture(scope="module")
def pair():
    return build()


def write_eres2net_dir(d, pt):
    """An ERes2NetV2 directory as FunASR lays it out: its config names a WavFrontend, which
    the model does not use (it computes its own fbank)."""
    torch.save(pt.state_dict(), os.path.join(d, "model.pt"))
    return _write_config(d, dict(
        model="ERes2NetV2", model_conf=dict(CONF, pooling_func="TSTP", two_emb_layer=False),
        frontend="WavFrontend",
        frontend_conf=dict(fs=16000, window="hamming", n_mels=80, frame_length=25,
                           frame_shift=10, lfr_m=1, lfr_n=1, dither=0.0)))


def test_params_round_trip(pair):
    pt, _, tree = pair
    back = params_from_jax(tree, pt)
    want = pt.state_dict()
    assert set(back) == set(want)
    for name, w in want.items():
        assert torch.equal(back[name], w), name


def test_forward_matches_jax(pair):
    pt, jm, tree = pair
    x = np.random.default_rng(1).standard_normal((3, 57, 80)).astype(np.float32)
    with torch.no_grad():
        got = pt(t(x))
    want = jm._jit_forward(to_jax(tree), jnp.asarray(x))
    assert got.shape == (3, 16)
    assert rel_l2(got.numpy(), np.asarray(want)) <= EMB_REL_L2


def test_inference_and_automodel_match_jax(pair, tmp_path):
    pt, jm, tree = pair
    rng = np.random.default_rng(2)
    clips = [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in (8000, 5600)]
    got, _ = pt.inference(clips)
    want, _ = jm.inference(to_jax(tree), clips)
    assert rel_l2(got[0]["spk_embedding"], want[0]["spk_embedding"]) <= EMB_REL_L2
    d = write_eres2net_dir(str(tmp_path), pt)
    am = AutoModel(model=d, device="cpu", log_level="WARNING")
    assert type(am.model).__name__ == "ERes2NetV2"
    res = am.generate(input=clips, batch_size=2)
    assert rel_l2(res[0]["spk_embedding"], want[0]["spk_embedding"]) <= EMB_REL_L2


def test_speaker_pipeline_with_eres2netv2_matches_jax(pair, tmp_path):
    for name in ("asr", "vad", "punc", "spk"):
        os.makedirs(tmp_path / name)
    dirs = {"model": write_bicif_dir(str(tmp_path / "asr")),
            "vad_model": write_vad_dir(str(tmp_path / "vad")),
            "punc_model": write_punc_dir(str(tmp_path / "punc")),
            "spk_model": write_eres2net_dir(str(tmp_path / "spk"), pair[0])}
    kw = dict(dirs, device="cpu", log_level="WARNING")
    with shape_only_init(("BiCifParaformer", "FsmnVADStreaming", "CTTransformer",
                          "ERes2NetV2")):
        port, ref = AutoModel(**kw), jauto.AutoModel(**kw)
    assert type(port.spk_model).__name__ == "ERes2NetV2"
    wav, _ = two_voice_wav(32.0)
    got, want = [], []
    for am, out in ((port, got), (ref, want)):
        np.random.seed(0)
        out.extend(am.generate(input=[wav], key=["meeting"], max_end_silence_time=800,
                               preset_spk_num=2))
    assert got == want
    info = got[0]["sentence_info"]
    assert info and {s["spk"] for s in info} == {0, 1}
