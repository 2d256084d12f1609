"""Synthetic data (twin of ``repro.data.synthetic``, numpy only): the
paper's Table-1 datasets from a Guyon-style generator, and a random
packed ICQ index for the serving smoke paths.

``guyon_dataset`` reimplements the NIPS-2003 variable-selection
benchmark generator (Guyon 2003, the method behind sklearn's
``make_classification``):

  - ``n_informative`` dimensions: class centroids placed at the vertices
    of a hypercube of side 2*class_sep, Gaussian clusters around them;
  - redundant dimensions: random linear combinations of the informative
    ones;
  - the remaining dimensions: pure noise;
  - optional random shuffle of columns.

It draws from ``numpy.random.default_rng(seed)`` in the reference's
order, so the same seed gives the reference's arrays bit for bit.
Table 1: three datasets, 10000 train / 1000 test, 64 features, with
32 / 16 / 8 informative features.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

SYNTHETIC_DATASETS: Dict[str, Dict] = {
    "dataset1": dict(n_train=10000, n_test=1000, n_features=64,
                     n_informative=32, n_classes=10, seed=1),
    "dataset2": dict(n_train=10000, n_test=1000, n_features=64,
                     n_informative=16, n_classes=10, seed=2),
    "dataset3": dict(n_train=10000, n_test=1000, n_features=64,
                     n_informative=8, n_classes=10, seed=3),
}


def guyon_dataset(n_samples: int, n_features: int, n_informative: int,
                  n_classes: int = 10, n_redundant: int | None = None,
                  class_sep: float = 1.5, seed: int = 0,
                  shuffle_features: bool = True
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (X (n, n_features) float32, y (n,) int32)."""
    rng = np.random.default_rng(seed)
    if n_redundant is None:
        n_redundant = max((n_features - n_informative) // 2, 0)
    n_noise = n_features - n_informative - n_redundant
    if n_noise < 0:
        raise ValueError(f"n_informative + n_redundant = "
                         f"{n_informative + n_redundant} exceeds "
                         f"n_features = {n_features}")

    # class centroids on hypercube vertices (random subset of corners)
    corners = rng.integers(0, 2, size=(n_classes, n_informative)
                           ).astype(np.float64)
    centroids = (2.0 * corners - 1.0) * class_sep
    # per-class random covariance shaping (as in Guyon's generator)
    y = rng.integers(0, n_classes, size=n_samples).astype(np.int32)
    X_inf = rng.standard_normal((n_samples, n_informative))
    for c in range(n_classes):
        idx = y == c
        A = rng.uniform(-1, 1, size=(n_informative, n_informative))
        X_inf[idx] = X_inf[idx] @ A * 0.5 + centroids[c]

    parts = [X_inf]
    if n_redundant:
        B = rng.uniform(-1, 1, size=(n_informative, n_redundant))
        parts.append(X_inf @ B / np.sqrt(n_informative))
    if n_noise:
        parts.append(0.1 * rng.standard_normal((n_samples, n_noise)))
    X = np.concatenate(parts, axis=1)

    if shuffle_features:
        X = X[:, rng.permutation(n_features)]
    return X.astype(np.float32), y


def make_table1_dataset(name: str):
    """One of the paper's Table-1 datasets -> (x_train, y_train, x_test,
    y_test)."""
    spec = SYNTHETIC_DATASETS[name]
    n = spec["n_train"] + spec["n_test"]
    X, y = guyon_dataset(n, spec["n_features"], spec["n_informative"],
                         spec["n_classes"], seed=spec["seed"])
    nt = spec["n_train"]
    return X[:nt], y[:nt], X[nt:], y[nt:]


def make_synthetic_index(seed: int, n: int, d: int = 16, K: int = 8,
                         m: int = 256, num_fast: int = 2,
                         sigma: float = 0.5):
    """Numpy arrays (codes (n, K) uint8 for m <= 256 else int32,
    C (K, m, d) f32, structure (xi (d,) bool, fast_mask (K,) bool,
    sigma () f32)) made from ``seed``; the first ``num_fast`` codebooks
    form the fast group.  ``make_index``/``build_index`` move them to a
    device (and nibble-pack the codes for ``code_bits=4``)."""
    rng = np.random.default_rng(seed)
    C = (rng.standard_normal((K, m, d), dtype=np.float32)
         * np.float32(1.0 / np.sqrt(K)))
    codes = rng.integers(0, m, size=(n, K)).astype(
        np.uint8 if m <= 256 else np.int32)
    fast = np.zeros((K,), bool)
    fast[:num_fast] = True
    structure = (np.ones((d,), bool), fast, np.asarray(sigma, np.float32))
    return codes, C, structure
