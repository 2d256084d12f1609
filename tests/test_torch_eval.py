"""The port's evaluation core (``repro_torch.eval``) held against
hand-computed answers and the reference's: recall@k (ties, -1 padding,
k > n, vacuous truth), the brute-force ground truth against a naive
numpy oracle (filtered and unfiltered) and against the reference's
``ground_truth`` / ``exact_search``, the content-keyed ground-truth
cache, and the Pareto frontier / operating-point selection.

Against the reference: ids equal wherever the k-th and (k+1)-th exact
distances of a query are more than 1e-5 relative apart, tie-aware
recall 1.0 otherwise; distances to rtol 1e-5 plus an atol of 1e-5 times
the largest squared norm (the two packages sum the d products in
another order).  Exactly equal rows tie exactly in both, and both rank
the lowest index first.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import eval as ref_ev
from repro.index import base as ref_base
from repro_torch import eval as ev
from repro_torch.index.base import exact_search


# ------------------------------------------------------------ recall ----

def test_recall_at_k_hand_computed():
    # q0: 2/3 recovered; q1: all 3 -> mean 5/6
    retrieved = np.array([[1, 2, 9], [4, 5, 6]])
    truth = np.array([[1, 2, 3], [6, 5, 4]])
    assert ev.recall_at_k(retrieved, truth) == pytest.approx(5 / 6)


def test_recall_at_k_order_independent():
    # set overlap, not position match
    assert ev.recall_at_k(np.array([[3, 2, 1]]),
                          np.array([[1, 2, 3]])) == 1.0


def test_recall_at_k_truncates_to_k():
    retrieved = np.array([[1, 9, 2]])
    truth = np.array([[1, 2, 9]])
    assert ev.recall_at_k(retrieved, truth, 2) == pytest.approx(0.5)


def test_recall_at_k_negative_ids_are_padding():
    # -1 in retrieved never matches; -1 in truth shrinks the denominator
    assert ev.recall_at_k(np.array([[1, -1, -1]]),
                          np.array([[1, 2, -1]])) == pytest.approx(0.5)
    # a -1 in retrieved must not "hit" a -1 in truth
    assert ev.recall_at_k(np.array([[-1]]), np.array([[-1]])) == 1.0


def test_recall_at_k_k_larger_than_n():
    # truth for a 2-row database padded to k=4: recall measured against
    # the 2 neighbors that exist
    retrieved = np.array([[0, 1, -1, -1]])
    truth = np.array([[1, 0, -1, -1]])
    assert ev.recall_at_k(retrieved, truth, 4) == 1.0


def test_recall_at_k_vacuous_truth_is_one():
    assert ev.recall_at_k(np.array([[0, 1]]),
                          np.array([[-1, -1]])) == 1.0


def test_recall_at_k_rejects_bad_shapes():
    with pytest.raises(ValueError, match="recall_at_k"):
        ev.recall_at_k(np.array([1, 2]), np.array([[1, 2]]))
    with pytest.raises(ValueError, match="k must be positive"):
        ev.recall_at_k(np.array([[1]]), np.array([[1]]), 0)


def test_tie_aware_recall_accepts_either_tied_row():
    # db rows 1 and 2 are identical -> both tie at the k=2 boundary;
    # an engine may return either without penalty
    db = np.array([[0.0], [1.0], [1.0], [5.0]])
    q = np.array([[0.0]])
    for pick in (1, 2):
        assert ev.tie_aware_recall_at_k(np.array([[0, pick]]), q, db,
                                        2) == 1.0
    # but a genuinely wrong id is still a miss
    assert ev.tie_aware_recall_at_k(np.array([[0, 3]]), q, db,
                                    2) == pytest.approx(0.5)


def test_tie_aware_recall_filtered_denominator():
    # filter passes one row -> denominator is 1, retrieving it = recall 1
    db = np.array([[0.0], [1.0], [2.0]])
    pred = np.array([False, True, False])
    assert ev.tie_aware_recall_at_k(np.array([[1, -1]]), np.array([[0.0]]),
                                    db, 2, filter=pred) == 1.0


# ------------------------------------------------------ ground truth ----

def _naive_gt(db, q, k, pred=None):
    d2 = ((q[:, None, :] - db[None, :, :]) ** 2).sum(-1)
    if pred is not None:
        d2 = np.where(pred[None, :], d2, np.inf)
    ids = np.argsort(d2, axis=1, kind="stable")[:, :k]
    out = np.where(np.take_along_axis(d2, ids, 1) < np.inf, ids, -1)
    return out


def test_ground_truth_matches_naive(rng):
    db = rng.standard_normal((40, 6)).astype(np.float32)
    q = rng.standard_normal((7, 6)).astype(np.float32)
    ids, dist = ev.ground_truth(db, q, 5, query_chunk=3, device="cpu")
    np.testing.assert_array_equal(ids, _naive_gt(db, q, 5))
    assert dist.shape == (7, 5) and np.all(np.diff(dist, axis=1) >= 0)


def test_ground_truth_filtered_matches_naive(rng):
    db = rng.standard_normal((30, 4)).astype(np.float32)
    q = rng.standard_normal((5, 4)).astype(np.float32)
    pred = rng.random(30) < 0.4
    ids, dist = ev.ground_truth(db, q, 6, filter=pred, device="cpu")
    np.testing.assert_array_equal(ids, _naive_gt(db, q, 6, pred))
    # every returned id passes the predicate
    assert all(pred[i] for i in ids.ravel() if i >= 0)


def test_ground_truth_pads_when_short(rng):
    db = rng.standard_normal((3, 4)).astype(np.float32)
    q = rng.standard_normal((2, 4)).astype(np.float32)
    ids, dist = ev.ground_truth(db, q, 5, device="cpu")
    assert ids.shape == (2, 5)
    np.testing.assert_array_equal(ids[:, 3:], -1)
    assert np.all(np.isinf(dist[:, 3:]))
    # filter passing < k rows pads the same way
    pred = np.zeros(3, bool)
    pred[1] = True
    ids_f, _ = ev.ground_truth(db, q, 5, filter=pred, device="cpu")
    np.testing.assert_array_equal(ids_f[:, 0], 1)
    np.testing.assert_array_equal(ids_f[:, 1:], -1)


def test_cached_ground_truth_content_keyed(rng, tmp_path):
    db = rng.standard_normal((20, 4)).astype(np.float32)
    q = rng.standard_normal((4, 4)).astype(np.float32)
    cd = str(tmp_path)
    ids1, d1, hit1 = ev.cached_ground_truth(db, q, 3, cache_dir=cd,
                                            device="cpu")
    ids2, d2, hit2 = ev.cached_ground_truth(db, q, 3, cache_dir=cd,
                                            device="cpu")
    assert (hit1, hit2) == (False, True)
    np.testing.assert_array_equal(ids1, ids2)
    np.testing.assert_array_equal(d1, d2)
    # perturbing one db value must miss the cache (content keying)
    db2 = db.copy()
    db2[0, 0] += 1.0
    _, _, hit3 = ev.cached_ground_truth(db2, q, 3, cache_dir=cd, device="cpu")
    assert hit3 is False
    # a different filter is a different key too
    pred = np.ones(20, bool)
    pred[0] = False
    _, _, hit4 = ev.cached_ground_truth(db, q, 3, cache_dir=cd,
                                        filter=pred, device="cpu")
    assert hit4 is False
    # cache_dir=None computes without touching disk
    _, _, hit5 = ev.cached_ground_truth(db, q, 3, cache_dir=None,
                                        device="cpu")
    assert hit5 is False


@pytest.mark.parametrize("filtered", [False, True])
def test_ground_truth_matches_reference(filtered):
    """The port's ``ground_truth`` against the reference's on one
    numpy database: ids equal where the ranks are apart, tie-aware
    recall 1.0 everywhere, distances to rtol 1e-5."""
    rng = np.random.default_rng(11)
    db = rng.standard_normal((3000, 32)).astype(np.float32)
    db[1500:1504] = db[7]                         # exact ties
    q = rng.standard_normal((23, 32)).astype(np.float32)
    pred = (rng.random(3000) < 0.5) if filtered else None
    if filtered:
        pred[[7, 1500, 1501, 1502, 1503]] = True
    k = 10
    got_i, got_d = ev.ground_truth(db, q, k, filter=pred, query_chunk=7,
                                   device="cpu")
    want_i, want_d = ref_ev.ground_truth(db, q, k + 1, filter=pred,
                                         query_chunk=7)
    assert got_i.dtype == np.int64 and got_d.dtype == np.float32
    atol = 1e-5 * float(np.max(np.sum(db * db, -1)))
    np.testing.assert_allclose(got_d, want_d[:, :k], rtol=1e-5, atol=atol)
    gap = np.abs(np.diff(want_d, axis=1)) > 1e-5 * np.abs(want_d[:, 1:])
    clear = np.ones((q.shape[0], k), bool)
    clear &= gap[:, :k]                           # apart from the next
    clear[:, 1:] &= gap[:, :k - 1]                # and from the previous
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got_i[clear], want_i[:, :k][clear])
    assert ev.tie_aware_recall_at_k(got_i, q, db, k, filter=pred) == 1.0
    if filtered:
        assert pred[got_i[got_i >= 0]].all()


def test_exact_search_ties_and_padding_match_reference():
    """Exactly equal rows tie exactly in both packages and rank lowest
    index first; a filter passing fewer than topk rows pads with id -1
    at +inf, in both."""
    rng = np.random.default_rng(12)
    db = rng.standard_normal((50, 8)).astype(np.float32)
    db[[10, 20, 30]] = db[5]
    q = db[[5, 0]] + 0.0
    pred = np.zeros(50, bool)
    pred[[5, 10, 20, 30, 40]] = True
    for f in (None, pred):
        got_i, got_d = exact_search(torch.from_numpy(q),
                                    torch.from_numpy(db), 8, filter=f,
                                    query_chunk=1)
        want_i, want_d = ref_base.exact_search(
            jnp.asarray(q), jnp.asarray(db), 8, filter=f, query_chunk=1)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                                   rtol=1e-5, atol=1e-4)
    assert got_i[0, :4].tolist() == [5, 10, 20, 30]
    assert got_i[1, 5:].tolist() == [-1, -1, -1]
    assert torch.isinf(got_d[1, 5:]).all()


def test_ground_truth_defaults_to_the_card():
    """Without ``device``, ground truth runs on the card; with no card
    visible it raises rather than carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default serves on it")
    db = np.zeros((4, 2), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ev.ground_truth(db, db, 2)


# ----------------------------------------------------- pareto / tune ----

def test_pareto_frontier_hand_computed():
    pts = [dict(qps=100, recall=0.5), dict(qps=50, recall=0.9),
           dict(qps=80, recall=0.4),          # dominated by the first
           dict(qps=50, recall=0.7),          # dominated by the second
           dict(qps=10, recall=0.95)]
    assert ev.pareto_frontier(pts) == [0, 1, 4]
    frontier = [pts[i] for i in ev.pareto_frontier(pts)]
    assert ev.is_monotone_frontier(frontier)
    assert not ev.is_monotone_frontier([pts[0], pts[2], pts[4]])


def test_pareto_frontier_drops_duplicates():
    pts = [dict(qps=10, recall=0.5), dict(qps=10, recall=0.5)]
    assert len(ev.pareto_frontier(pts)) == 1


def test_select_operating_point():
    pts = [dict(qps=100, recall=0.5), dict(qps=50, recall=0.85),
           dict(qps=20, recall=0.95)]
    # fastest point meeting the target
    assert ev.select_operating_point(pts, 0.8) == (1, True)
    assert ev.select_operating_point(pts, 0.5) == (0, True)
    # unreachable target falls back to max recall
    assert ev.select_operating_point(pts, 0.99) == (2, False)
    with pytest.raises(ValueError, match="empty sweep"):
        ev.select_operating_point([], 0.5)
