"""CAM++ and the speaker clustering of the PyTorch port against the JAX package (CPU).

* CAM++ at a small width (feat 80, embedding 16, growth 4, bn_size 2, init 8), its batch
  norms' running statistics drawn from a numpy seed: ``forward`` on (2, 150, 80) and
  ``inference`` on raw int16 and float clips within 1e-4 relative L2 of JAX's (measured
  7.6e-8 for both); the state dict through the JAX package's ``convert_campplus`` and
  back through ``params_from_jax`` unchanged;
* the copies of ``models/campplus/utils.py`` equal to their originals;
* ``ClusterBackend`` (numpy k-means, no scikit-learn) against the JAX package's
  (scikit-learn's ``k_means``): labels equal after ``correct_labels`` on seeded
  well-separated embeddings, below 20 chunks, 20-200 with and without ``oracle_num``, and
  a case that ``merge_by_cos`` merges. (From 2048 chunks on, the JAX package falls back to
  the same spectral clustering when ``umap`` is absent, as it is in both places; the port
  takes it always.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funasr_tpu.convert.torch_to_jax import convert_campplus
from funasr_tpu.models.campplus import utils as jutils
from funasr_tpu.models.campplus.model import CAMPPlus as JaxCAMPPlus
from funasr_tpu_torch.convert import params_from_jax
from funasr_tpu_torch.models.campplus import cluster_backend as tcb
from funasr_tpu_torch.models.campplus import utils as tutils
from funasr_tpu_torch.models.campplus.model import CAMPPlus
from torch_parity_util import SPK_CONF, seed_batchnorm
from torch_parity_util import one_torch_thread  # noqa: F401 (autouse)

REL_TOL = 1e-4


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


@pytest.fixture(scope="module")
def pair():
    pt = seed_batchnorm(CAMPPlus(**SPK_CONF, generator=torch.Generator().manual_seed(0)), 0)
    pt.eval()
    jm = JaxCAMPPlus(**SPK_CONF)
    return pt, jm, jax.tree_util.tree_map(jnp.asarray, convert_campplus(pt.state_dict(), jm))


def test_forward_matches_jax(pair):
    pt, jm, params = pair
    x = np.random.default_rng(1).standard_normal((2, 150, 80)).astype(np.float32)
    with torch.inference_mode():
        got = pt(torch.from_numpy(x)).numpy()
    want = np.asarray(jm._jit_forward(params, jnp.asarray(x)))
    assert got.shape == want.shape == (2, 16)
    assert _rel(got, want) < REL_TOL


def test_inference_on_int16_and_float_clips_matches_jax(pair):
    pt, jm, params = pair
    rng = np.random.default_rng(2)
    # 24,240 samples: 150 frames, the forward test's shape (one JAX compile for both)
    clips = [(rng.standard_normal(24240) * 3000).astype(np.int16),
             (rng.standard_normal(20000) * 0.1).astype(np.float32)]
    got, meta = pt.inference(clips)
    want, jmeta = jm.inference(params, clips)
    assert len(got) == 1 and got[0]["spk_embedding"].shape == (2, 16)
    assert _rel(got[0]["spk_embedding"], want[0]["spk_embedding"]) < REL_TOL
    assert meta["batch_data_time"] == jmeta["batch_data_time"]
    one, _ = pt.inference(clips[0])  # a single clip: a batch of one
    assert _rel(one[0]["spk_embedding"], want[0]["spk_embedding"][:1]) < REL_TOL


def test_state_dict_round_trips_through_the_jax_layout(pair):
    pt, jm, _ = pair
    params = jax.tree_util.tree_map(np.asarray, convert_campplus(pt.state_dict(), jm))
    fresh = CAMPPlus(**SPK_CONF)
    fresh.load_state_dict(params_from_jax(params, fresh))
    for name, value in pt.state_dict().items():
        assert torch.equal(fresh.state_dict()[name], value), name


def test_utils_copies_match():
    rng = np.random.default_rng(3)
    segs = [[0.5, 4.0, rng.standard_normal(56000)], [5.2, 6.1, rng.standard_normal(14400)],
            [7.0, 8.5, rng.standard_normal(24000)], [9.0, 9.3, rng.standard_normal(4800)]]
    got, want = tutils.sv_chunk(segs), jutils.sv_chunk(segs)
    assert [c[:2] for c in got] == [c[:2] for c in want]
    assert all(np.array_equal(a[2], b[2]) for a, b in zip(got, want))
    labels = rng.integers(0, 3, len(got))
    assert np.array_equal(tutils.correct_labels(labels), jutils.correct_labels(labels))
    embs = rng.standard_normal((len(got), 8))
    for centers in (False, True):
        a = tutils.postprocess(got, None, labels, embs, return_spk_center=centers)
        b = jutils.postprocess(want, None, labels, embs, return_spk_center=centers)
        if centers:
            assert a[0] == b[0] and np.array_equal(a[1], b[1])
        else:
            assert a == b
    rows = [[0.0, 1.0, 0], [0.9, 1.2, 1], [1.2, 3.0, 1], [3.0, 3.5, 0], [3.6, 6.0, 0]]
    assert tutils.merge_seque([list(r) for r in rows]) == jutils.merge_seque([list(r) for r in rows])
    assert tutils.smooth([list(r) for r in rows]) == jutils.smooth([list(r) for r in rows])
    turns = tutils.postprocess(got, None, labels, embs)
    sentences = [{"text": "a", "start": 400, "end": 2100}, {"text": "b", "start": 5000, "end": 9100},
                 {"text": "c", "start": 9500, "end": 9600}]
    assert (tutils.distribute_spk([dict(s) for s in sentences], turns)
            == jutils.distribute_spk([dict(s) for s in sentences], turns))


def _blobs(sizes, dim=16, spread=0.15, seed=0, close=None):
    """Embeddings around random unit centres; ``close`` = (i, j): centre j a small step
    from centre i (cosine > 0.78, so merge_by_cos joins them)."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((len(sizes), dim))
    if close is not None:
        i, j = close
        centres[j] = centres[i] + 0.35 * np.linalg.norm(centres[i]) / np.sqrt(dim) \
            * rng.standard_normal(dim)
    x = np.concatenate([c + spread * rng.standard_normal((n, dim)) * np.linalg.norm(c)
                        / np.sqrt(dim) for c, n in zip(centres, sizes)])
    order = rng.permutation(len(x))
    truth = np.repeat(np.arange(len(sizes)), sizes)
    return x[order].astype(np.float32), truth[order]


CASES = {
    "below_20": (dict(sizes=[7, 6]), None),
    "two_speakers": (dict(sizes=[40, 25]), None),
    "two_speakers_oracle": (dict(sizes=[40, 25]), 2),
    "three_speakers": (dict(sizes=[60, 50, 45], seed=1), None),
    "three_speakers_oracle": (dict(sizes=[60, 50, 45], seed=1), 3),
    "merge_by_cos": (dict(sizes=[50, 40, 45], seed=2, close=(0, 1)), None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cluster_backend_labels_match_jax(case):
    # imported here: the JAX package's backend needs scikit-learn, which a GPU machine
    # running only the card tests may lack
    from funasr_tpu.models.campplus import cluster_backend as jcb

    kw, oracle = CASES[case]
    x, truth = _blobs(**kw)
    np.random.seed(0)
    got = tutils.correct_labels(tcb.ClusterBackend()(x.copy(), oracle_num=oracle))
    np.random.seed(0)
    want = jutils.correct_labels(jcb.ClusterBackend()(x.copy(), oracle_num=oracle))
    assert np.array_equal(got, want)
    if case == "below_20":
        assert not got.any()
    elif case == "merge_by_cos":
        assert got.max() == 1  # two of the three centres merged
        assert np.array_equal(got, tutils.correct_labels(np.where(truth == 1, 0, truth)))
    else:
        assert np.array_equal(got, tutils.correct_labels(truth))


def test_k_means_partition_matches_scikit_learn():
    from sklearn.cluster import k_means

    x, truth = _blobs([30, 20, 25, 10], dim=4, spread=0.1, seed=5)
    np.random.seed(1)
    _, got, inertia = tcb.k_means(x, 4)
    _, want, want_inertia = k_means(x, 4, n_init=10)
    assert np.array_equal(tutils.correct_labels(got), tutils.correct_labels(want))
    assert np.isclose(inertia, want_inertia, rtol=1e-4)
    assert np.array_equal(tutils.correct_labels(got), tutils.correct_labels(truth))


def test_cosine_similarity_matches_scikit_learn():
    from sklearn.metrics.pairwise import cosine_similarity

    x = np.random.default_rng(6).standard_normal((30, 12))
    x[3] = 0.0
    np.testing.assert_allclose(tcb.cosine_similarity(x), cosine_similarity(x, x), atol=1e-12)
