"""Structured stand-ins for real datasets (twin of
``repro.data.pseudo_real``, numpy only: the same seed gives the
reference's arrays bit for bit).

``pseudo_mnist``: 10 classes of 28x28 grayscale "digits" built from
per-class stroke templates (random walks) + elastic jitter + noise —
matched dim (784), class count, and split sizes (60k/10k by default,
reducible).

``pseudo_cifar``: 10 classes of 32x32x3 textured patches — per-class
color palette + oriented gratings + noise (3072-d), 50k/10k.

``pseudo_sift`` / ``pseudo_glove``: ANN-benchmark-shaped vector
workloads for the recall/QPS sweep harness (docs/benchmarks.md
``pareto`` target): a SIFT-like d=128 set (non-negative, clustered,
heavy-tailed cluster scales) and a GloVe-like d=300 set (dense signed,
Zipf-weighted cluster sizes, norm spread).  ``skewed_queries`` draws a
query workload whose cluster popularity follows a power law — the
skewed-traffic scenario real serving sees.

All generators have genuine within-class/cluster structure so recall,
MAP, and IVF probe behavior are qualitatively like the real datasets.
Every benchmark that uses them labels the substitution.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _stroke_template(rng, hw: int = 28, n_steps: int = 60):
    canvas = np.zeros((hw, hw), np.float32)
    pos = np.array([hw / 2, hw / 2]) + rng.uniform(-6, 6, 2)
    vel = rng.uniform(-1.5, 1.5, 2)
    for _ in range(n_steps):
        vel = 0.8 * vel + rng.uniform(-1.0, 1.0, 2)
        pos = np.clip(pos + vel, 2, hw - 3)
        r, c = int(pos[0]), int(pos[1])
        canvas[r - 1: r + 2, c - 1: c + 2] += 0.4
    return np.clip(canvas, 0, 1)


def pseudo_mnist(n_train: int = 10000, n_test: int = 2000, seed: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(x_train (n,784), y_train, x_test, y_test), values in [0,1]."""
    rng = np.random.default_rng(seed)
    hw = 28
    templates = [_stroke_template(rng, hw) for _ in range(10)]

    def sample(n):
        y = rng.integers(0, 10, n).astype(np.int32)
        xs = np.empty((n, hw * hw), np.float32)
        for i in range(n):
            t = templates[y[i]]
            # elastic jitter: shift + small affine + noise
            sr, sc = rng.integers(-2, 3, 2)
            img = np.roll(np.roll(t, sr, 0), sc, 1)
            img = img * rng.uniform(0.7, 1.2) + 0.08 * rng.standard_normal((hw, hw))
            xs[i] = np.clip(img, 0, 1).ravel()
        return xs, y

    x_tr, y_tr = sample(n_train)
    x_te, y_te = sample(n_test)
    return x_tr, y_tr, x_te, y_te


def _clustered_vectors(rng, n: int, d: int, n_clusters: int,
                       cluster_weights: np.ndarray, scales: np.ndarray,
                       centers: np.ndarray):
    """Draw ``n`` vectors from a Gaussian mixture with per-cluster
    anisotropic covariance — returns (X (n, d) f32, cluster_ids (n,))."""
    cid = rng.choice(n_clusters, size=n, p=cluster_weights)
    X = np.empty((n, d), np.float32)
    axes = rng.standard_normal((n_clusters, d))     # per-cluster stretch
    for c in range(n_clusters):
        idx = cid == c
        k = int(idx.sum())
        if k == 0:
            continue
        z = rng.standard_normal((k, d))
        stretch = 1.0 + 1.5 * np.abs(axes[c]) / np.sqrt(d)
        X[idx] = centers[c] + scales[c] * z * stretch[None, :]
    return X, cid.astype(np.int32)


def pseudo_sift(n: int = 20000, n_queries: int = 256, d: int = 128,
                n_clusters: int = 64, seed: int = 0):
    """SIFT-like workload: (db (n, d), queries (nq, d), db_cluster_ids).

    Matches the gross statistics the d=128 SIFT descriptors have that
    matter to an ANN engine: non-negative heavy-tailed coordinates,
    strong cluster structure (local descriptors repeat across images),
    and cluster scales drawn log-normal so some clusters are tight and
    some diffuse.  Queries are held-out draws from the same mixture.
    """
    rng = np.random.default_rng(seed)
    centers = np.abs(rng.standard_normal((n_clusters, d))) * 1.5
    scales = np.exp(rng.normal(-0.7, 0.5, n_clusters))   # heavy-tailed
    weights = rng.dirichlet(np.full(n_clusters, 0.5))    # uneven sizes
    X, cid = _clustered_vectors(rng, n, d, n_clusters, weights, scales,
                                centers)
    Q, _ = _clustered_vectors(rng, n_queries, d, n_clusters, weights,
                              scales, centers)
    # SIFT is non-negative (gradient histogram magnitudes)
    return np.abs(X), np.abs(Q), cid


def pseudo_glove(n: int = 20000, n_queries: int = 256, d: int = 300,
                 n_clusters: int = 128, seed: int = 0):
    """GloVe-like workload: (db (n, d), queries (nq, d), db_cluster_ids).

    Dense signed embeddings with Zipf-weighted cluster sizes (word
    frequency is Zipfian, and frequent-word neighborhoods are denser)
    and a broad norm spread across clusters.
    """
    rng = np.random.default_rng(seed + 101)
    centers = rng.standard_normal((n_clusters, d)) * 1.2
    scales = np.exp(rng.normal(-0.5, 0.4, n_clusters))
    ranks = np.arange(1, n_clusters + 1, dtype=np.float64)
    weights = (1.0 / ranks) / np.sum(1.0 / ranks)        # Zipf sizes
    X, cid = _clustered_vectors(rng, n, d, n_clusters, weights, scales,
                                centers)
    Q, _ = _clustered_vectors(rng, n_queries, d, n_clusters, weights,
                              scales, centers)
    return X, Q, cid


def skewed_queries(db: np.ndarray, db_cluster_ids: np.ndarray,
                   n_queries: int = 256, *, alpha: float = 1.5,
                   noise: float = 0.15, seed: int = 0):
    """Power-law-skewed query workload over an existing clustered db.

    Cluster popularity ~ rank^-alpha over the clusters present in
    ``db_cluster_ids`` (rank order randomized by ``seed``), so a few
    clusters dominate the traffic — the hot-key pattern production
    query logs show.  Each query is a db point from the sampled cluster
    plus Gaussian noise scaled by ``noise`` times the db's global std.
    Returns (queries (n_queries, d) f32, query_cluster_ids).
    """
    rng = np.random.default_rng(seed + 7)
    clusters = np.unique(db_cluster_ids)
    ranks = rng.permutation(len(clusters)) + 1.0
    pop = ranks ** -float(alpha)
    pop /= pop.sum()
    qcid = rng.choice(clusters, size=n_queries, p=pop)
    sigma = float(np.std(db)) * noise
    out = np.empty((n_queries, db.shape[1]), np.float32)
    for i, c in enumerate(qcid):
        rows = np.nonzero(db_cluster_ids == c)[0]
        base = db[rng.choice(rows)]
        out[i] = base + sigma * rng.standard_normal(db.shape[1])
    return out, qcid.astype(np.int32)


def pseudo_cifar(n_train: int = 10000, n_test: int = 2000, seed: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(x_train (n,3072), y_train, x_test, y_test), values in [0,1]."""
    rng = np.random.default_rng(seed + 17)
    hw = 32
    yy, xx = np.meshgrid(np.arange(hw), np.arange(hw), indexing="ij")
    palettes = rng.uniform(0.1, 0.9, size=(10, 3))
    freqs = rng.uniform(0.15, 0.8, size=(10,))
    angles = rng.uniform(0, np.pi, size=(10,))

    def sample(n):
        y = rng.integers(0, 10, n).astype(np.int32)
        xs = np.empty((n, hw * hw * 3), np.float32)
        for i in range(n):
            c = y[i]
            phase = rng.uniform(0, 2 * np.pi)
            ang = angles[c] + rng.uniform(-0.2, 0.2)
            grating = 0.5 + 0.5 * np.sin(
                freqs[c] * (np.cos(ang) * xx + np.sin(ang) * yy) + phase)
            img = grating[:, :, None] * palettes[c][None, None, :]
            img = img + 0.1 * rng.standard_normal((hw, hw, 3))
            xs[i] = np.clip(img, 0, 1).ravel()
        return xs, y

    x_tr, y_tr = sample(n_train)
    x_te, y_te = sample(n_test)
    return x_tr, y_tr, x_te, y_te
