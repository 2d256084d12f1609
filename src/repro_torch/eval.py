"""Evaluation core for recall/QPS benchmarking and tuning (twin of
``repro.eval``).

Pure, oracle-tested primitives (tests/test_torch_eval.py):

  - ``recall_at_k``            set-overlap recall with -1 padding and
                               k > n handling;
  - ``tie_aware_recall_at_k``  distance-tie tolerant recall — any id
                               whose exact distance ties the k-th true
                               neighbor counts as a hit;
  - ``ground_truth`` /         brute-force (optionally filtered) exact
    ``cached_ground_truth``    neighbors, with an on-disk npz cache
                               keyed by the content of (db, queries, k,
                               filter);
  - ``pareto_frontier`` /      monotone recall-vs-QPS frontier
    ``select_operating_point`` extraction and faiss-style operating
                               point selection.

Scoring and selection are host-side numpy, copied from the reference.
``ground_truth`` runs the brute-force search
(``repro_torch.index.base.exact_search``, one full-f32 matrix product
per query chunk and the two-key top-k) on the card unless the caller
names another device, and hands numpy back.
"""
from __future__ import annotations

import hashlib
import os
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.index.base import as_torch, exact_search, resolve_device


def recall_at_k(retrieved, truth, k: Optional[int] = None):
    """Mean recall@k: |retrieved[:k] ∩ truth[:k]| / |valid truth[:k]|.

    retrieved: (nq, r) ids; truth: (nq, t) ids.  Entries ``< 0`` are
    padding (absent neighbors — e.g. a filtered search with fewer than
    k eligible rows, or ground truth over a database with n < k) and
    never count as hits nor toward the denominator.  ``k`` defaults to
    the retrieved width; ``k`` larger than either width just uses every
    available column — recall@k with k > n is measured against the n
    true neighbors that exist.  A query with an empty valid truth set
    scores recall 1.0 (vacuously complete).
    """
    r = np.asarray(retrieved)
    t = np.asarray(truth)
    if r.ndim != 2 or t.ndim != 2 or r.shape[0] != t.shape[0]:
        raise ValueError(f"recall_at_k: expected (nq, r) retrieved and "
                         f"(nq, t) truth with matching nq, got "
                         f"{r.shape} and {t.shape}")
    if k is not None:
        if k <= 0:
            raise ValueError(f"recall_at_k: k must be positive, got {k}")
        r, t = r[:, :k], t[:, :k]
    valid_t = t >= 0
    hits = (r[:, :, None] == t[:, None, :]) & valid_t[:, None, :] \
        & (r >= 0)[:, :, None]
    inter = hits.any(axis=1).sum(axis=1)          # truth ids recovered
    n_true = valid_t.sum(axis=1)
    per_q = np.where(n_true > 0, inter / np.maximum(n_true, 1), 1.0)
    return float(per_q.mean())


def tie_aware_recall_at_k(retrieved, queries, db, k: int, *,
                          filter=None, rtol: float = 1e-6):
    """Recall@k that accepts any ordering among distance ties.

    A retrieved id counts as a hit iff its exact L2 distance is within
    ``rtol`` (relative, plus absolute 1e-9) of the k-th smallest exact
    distance — so when several rows tie at the boundary, an engine may
    return any of them without being penalized.  The denominator is
    ``min(k, #eligible rows)``.  ``filter``: optional (n,) bool row
    predicate (filtered oracle).
    """
    q = np.asarray(queries, np.float64)
    x = np.asarray(db, np.float64)
    r = np.asarray(retrieved)[:, :k]
    d2 = (np.sum(q * q, -1)[:, None] - 2.0 * q @ x.T
          + np.sum(x * x, -1)[None, :])           # (nq, n)
    if filter is not None:
        pred = np.asarray(filter, bool)
        d2 = np.where(pred[None, :], d2, np.inf)
    n_valid = np.isfinite(d2).sum(axis=1)
    kth = np.partition(d2, min(k, d2.shape[1]) - 1,
                       axis=1)[:, min(k, d2.shape[1]) - 1]   # (nq,)
    recalls = []
    for i in range(r.shape[0]):
        denom = min(k, int(n_valid[i]))
        if denom == 0:
            recalls.append(1.0)
            continue
        ids = r[i][r[i] >= 0]
        thresh = kth[i] * (1.0 + rtol) + 1e-9
        hits = int(np.sum(d2[i, ids] <= thresh)) if len(ids) else 0
        recalls.append(min(hits, denom) / denom)
    return float(np.mean(recalls))


def ground_truth(db, queries, k: int, *, filter=None,
                 query_chunk: Optional[int] = 128, device=None):
    """Exact L2 top-k over ``db`` ((n, d)) for ``queries`` ((nq, d)),
    optionally restricted to rows where ``filter`` is True, computed on
    ``device`` (the card unless named; numpy or torch inputs).

    Returns (ids (nq, k) int64, distances (nq, k) f32) as numpy, padded
    with id -1 / distance +inf when fewer than k rows exist (n < k, or
    the filter passes fewer than k rows) — the exact shape
    ``recall_at_k`` expects as ``truth``.
    """
    dev = resolve_device(device)
    db_t = as_torch(db).to(dev, torch.float32)
    q_t = as_torch(queries).to(dev, torch.float32)
    n = db_t.shape[0]
    eff_k = min(k, n)
    ids, dist = exact_search(q_t, db_t, eff_k, query_chunk=query_chunk,
                             filter=filter)
    ids = ids.cpu().numpy().astype(np.int64)
    dist = dist.cpu().numpy().astype(np.float32)
    # normalize padding: absent slots are (-1, +inf)
    ids = np.where(np.isinf(dist), -1, ids)
    if eff_k < k:
        pad = k - eff_k
        ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
        dist = np.pad(dist, ((0, 0), (0, pad)),
                      constant_values=np.inf)
    return ids, dist


def _gt_cache_key(db, queries, k: int, filter) -> str:
    h = hashlib.sha256()
    for part in (np.ascontiguousarray(np.asarray(db, np.float32)),
                 np.ascontiguousarray(np.asarray(queries, np.float32))):
        h.update(str(part.shape).encode())
        h.update(part.tobytes())
    h.update(f"k={k}".encode())
    if filter is not None:
        h.update(np.ascontiguousarray(
            np.asarray(filter, bool)).tobytes())
    return h.hexdigest()[:24]


def cached_ground_truth(db, queries, k: int, *, cache_dir: Optional[str],
                        filter=None, query_chunk: Optional[int] = 128,
                        device=None):
    """``ground_truth`` (on ``device``) with an on-disk npz cache.

    The cache key is the sha256 of the *contents* of (db, queries, k,
    filter), so a stale file can never be returned for different data.
    ``cache_dir=None`` disables caching.  Returns (ids, distances,
    cache_hit: bool).
    """
    if cache_dir is None:
        ids, dist = ground_truth(db, queries, k, filter=filter,
                                 query_chunk=query_chunk, device=device)
        return ids, dist, False
    path = os.path.join(cache_dir,
                        f"gt_{_gt_cache_key(db, queries, k, filter)}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return z["ids"], z["distances"], True
    ids, dist = ground_truth(db, queries, k, filter=filter,
                             query_chunk=query_chunk, device=device)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = path + ".tmp.npz"         # savez appends .npz unless present
    np.savez(tmp, ids=ids, distances=dist)
    os.replace(tmp, path)
    return ids, dist, False


def pareto_frontier(points: Sequence[dict], *, x: str = "qps",
                    y: str = "recall"):
    """Indices of the Pareto-optimal points of ``points`` (maximize
    both ``x`` and ``y``), ordered by descending ``x``.

    The returned frontier is monotone by construction: walking it from
    the fastest point to the slowest, ``y`` strictly increases — i.e.
    recall is non-decreasing as QPS decreases.  Dominated and duplicate
    points are dropped.
    """
    order = sorted(range(len(points)),
                   key=lambda i: (-points[i][x], -points[i][y]))
    keep, best_y = [], -np.inf
    for i in order:
        if points[i][y] > best_y:
            keep.append(i)
            best_y = points[i][y]
    return keep


def is_monotone_frontier(points: Sequence[dict], *, x: str = "qps",
                         y: str = "recall") -> bool:
    """True iff ``points`` sorted by descending ``x`` have
    non-decreasing ``y`` — the shape ``pareto_frontier`` guarantees."""
    srt = sorted(points, key=lambda p: -p[x])
    ys = [p[y] for p in srt]
    return all(b >= a for a, b in zip(ys, ys[1:]))


def select_operating_point(points: Sequence[dict], target: float, *,
                           x: str = "qps", y: str = "recall"):
    """faiss-style selection: the index of the max-``x`` point whose
    ``y`` meets ``target``; falls back to the max-``y`` point (ties
    broken toward higher ``x``) when none reaches the target.  Returns
    (index, met_target: bool); raises on an empty sweep."""
    if not points:
        raise ValueError("select_operating_point: empty sweep")
    eligible = [i for i in range(len(points)) if points[i][y] >= target]
    if eligible:
        return max(eligible, key=lambda i: points[i][x]), True
    return max(range(len(points)),
               key=lambda i: (points[i][y], points[i][x])), False
