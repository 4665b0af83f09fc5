"""Diarization clustering backend, copied from
``funasr_tpu/models/campplus/cluster_backend.py`` without scikit-learn (FunASR
``funasr/models/campplus/cluster_backend.py``): p-pruned spectral clustering, then a
cosine merge of clusters at 0.78.

The JAX package takes ``cosine_similarity`` and ``k_means`` from scikit-learn; here they
are numpy: row-normalized dot products, and k-means with greedy k-means++ seeding,
Lloyd iterations, ``n_init=10`` restarts and the lowest inertia kept, its randomness
from numpy's global generator as scikit-learn's ``random_state=None`` draws it. The
draws differ from scikit-learn's, so the label numbers may too; ``utils.correct_labels``
renumbers them by first appearance, after which any correct k-means gives the same
partition of well-separated embeddings. Sets of 2048 chunks or more also go through
spectral clustering, which is what the JAX package does when ``umap`` is absent.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg


def cosine_similarity(x):
    """(N, C) -> (N, N) cosine similarities of the rows (a zero row scores 0)."""
    norms = np.linalg.norm(x, axis=1)
    xn = x / np.where(norms == 0.0, 1.0, norms)[:, None]
    return xn @ xn.T


def _kmeans_plusplus(x, k: int):
    """Greedy k-means++ seeding (2 + log k candidates per centre)."""
    n = x.shape[0]
    trials = 2 + int(np.log(k))
    centers = np.empty((k, x.shape[1]), x.dtype)
    centers[0] = x[np.random.randint(n)]
    d2 = ((x - centers[0]) ** 2).sum(axis=1)
    for c in range(1, k):
        cum = np.cumsum(d2)
        cand = np.searchsorted(cum, np.random.random_sample(trials) * cum[-1])
        cand = np.minimum(cand, n - 1)
        cand_d2 = np.minimum(d2[None, :], ((x[None, :, :] - x[cand][:, None, :]) ** 2).sum(-1))
        best = int(np.argmin(cand_d2.sum(axis=1)))
        centers[c] = x[cand[best]]
        d2 = cand_d2[best]
    return centers


def _lloyd(x, centers, max_iter: int, tol: float):
    for _ in range(max_iter):
        dist = ((x[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        labels = dist.argmin(axis=1)
        new = centers.copy()
        for c in range(centers.shape[0]):
            members = x[labels == c]
            if len(members):
                new[c] = members.mean(axis=0)
            else:  # an empty cluster takes the point farthest from its centre
                new[c] = x[dist[np.arange(len(x)), labels].argmax()]
        shift = ((new - centers) ** 2).sum()
        centers = new
        if shift <= tol:
            break
    dist = ((x[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    labels = dist.argmin(axis=1)
    return centers, labels, float(dist[np.arange(len(x)), labels].sum())


def k_means(x, k: int, n_init: int = 10, max_iter: int = 300, tol: float = 1e-4):
    """-> (centres (k, C), labels (N,), inertia) of the best of ``n_init`` runs."""
    x = np.asarray(x, np.float64)
    tol = float(np.mean(np.var(x, axis=0))) * tol
    best = None
    for _ in range(n_init):
        run = _lloyd(x, _kmeans_plusplus(x, k), max_iter, tol)
        if best is None or run[2] < best[2]:
            best = run
    return best


class SpectralCluster:
    """Adapted p-pruned unnormalized spectral clustering (speechbrain lineage)."""

    def __init__(self, min_num_spks: int = 1, max_num_spks: int = 15,
                 pval: float = 0.022):
        self.min_num_spks = min_num_spks
        self.max_num_spks = max_num_spks
        self.pval = pval

    def __call__(self, x, oracle_num=None):
        sim = cosine_similarity(x)
        pruned = self._p_prune(sim)
        sym = 0.5 * (pruned + pruned.T)
        lap = self._laplacian(sym)
        emb, k = self._spectral_embeddings(lap, oracle_num)
        _, labels, _ = k_means(emb, k, n_init=10)
        return labels

    def _p_prune(self, a):
        pval = max(self.pval, 6.0 / a.shape[0]) if a.shape[0] * self.pval < 6 \
            else self.pval
        n_zero = int((1 - pval) * a.shape[0])
        for i in range(a.shape[0]):
            low = np.argsort(a[i, :])[:n_zero]
            a[i, low] = 0
        return a

    @staticmethod
    def _laplacian(m):
        m[np.diag_indices(m.shape[0])] = 0
        d = np.diag(np.sum(np.abs(m), axis=1))
        return d - m

    def _spectral_embeddings(self, lap, k_oracle):
        lambdas, eig_vecs = scipy.linalg.eigh(lap)
        if k_oracle is not None:
            k = k_oracle
        else:
            gaps = np.diff(lambdas[self.min_num_spks - 1: self.max_num_spks + 1])
            k = int(np.argmax(gaps)) + self.min_num_spks
        return eig_vecs[:, :k], k


class ClusterBackend:
    """labels = cb(embeddings (N, C), oracle_num=None); <20 chunks -> single speaker."""

    def __init__(self, merge_thr: float = 0.78, **kwargs):
        self.merge_thr = merge_thr
        self.spectral_cluster = SpectralCluster()

    def __call__(self, x, oracle_num=None, **params):
        x = np.asarray(x)
        assert x.ndim == 2
        if x.shape[0] < 20:
            return np.zeros(x.shape[0], dtype="int")
        labels = self.spectral_cluster(x, oracle_num)
        if oracle_num is None and self.merge_thr is not None:
            labels = self.merge_by_cos(labels, x, self.merge_thr)
        return labels

    @staticmethod
    def merge_by_cos(labels, embs, cos_thr: float):
        assert 0 < cos_thr <= 1
        labels = np.asarray(labels).copy()
        while True:
            spk_num = labels.max() + 1
            if spk_num == 1:
                break
            centers = np.stack([embs[labels == i].mean(0) for i in range(spk_num)])
            centers = centers / np.linalg.norm(centers, axis=1, keepdims=True)
            affinity = np.triu(centers @ centers.T, 1)
            i, j = np.unravel_index(np.argmax(affinity), affinity.shape)
            if affinity[i, j] < cos_thr:
                break
            labels[labels == j] = i
            labels[labels > j] -= 1
        return labels
