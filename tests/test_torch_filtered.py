"""Filtered and capped search of the port held against the reference's
jnp engine, and the port's own filtered == compacted identity.

``filter`` (an (n,) bool row predicate) and ``refine_cap`` (the static
survivor compaction) are jnp-engine options of the reference; the port
serves them with its plain versions on the CPU, and on the card through
the kernels at ``serve.backend="jnp"`` while auto and pallas refuse them
with the reference's ``ValueError`` (the card's route:
``tests/test_torch_filtered_card.py``; the card itself:
``tests/test_torch_gpu.py``).

One artifact per cell (flat f32, two-step f32 / int8, IVF f32 / int8),
built and saved by the reference at ``serve.backend="jnp"`` from
numpy-seeded arrays, is loaded by both packages.  With the port's
``build_lut`` patched to the reference's tables: ids equal (-1 in the
slots no eligible row fills), distances to rtol 1e-6 plus an atol of
1e-6 times the largest K-term LUT sum, with +inf in the same slots,
``pass_rate`` and ``avg_ops`` to a few ulp.  Filters: half the rows,
none (every slot -1), all (the unfiltered ranking) and three rows
(fewer than topk).

The reference's own claim that a filtered search equals a search over
the physically compacted database fails in its tier-1 runs (XLA rounds
the two shapes apart), so the port holds its own: a filtered
search over the whole database equals, bit for bit, the same filtered
composition over the compacted rows (ids mapped back), for the flat
kinds and for IVF over the same coarse centroids.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as ref_api
from repro.index import base as ref_base
from repro.index import flat as ref_flat_mod
from repro.index import FlatADC as RefFlatADC
from repro.index import TwoStep as RefTwoStep
from repro_torch.api import load_ann_engine
from repro_torch.index import flat as port_flat
from repro_torch.index import ivf as port_ivf
from repro_torch.index import make_index

N, NQ, D, K, M, TOPK = 2000, 12, 16, 8, 256, 10
CELLS = [("flat", "f32"), ("two-step", "f32"), ("two-step", "int8"),
         ("ivf", "f32"), ("ivf", "int8")]
FILTERS = ["half", "none", "all", "three"]


def arrays(seed=1):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, M, size=(N, K)).astype(np.uint8)
    C = (rng.standard_normal((K, M, D)) / np.sqrt(K)).astype(np.float32)
    structure = (np.ones(D, bool), np.arange(K) < 2, np.float32(2.0))
    emb = C[np.arange(K)[None, :], codes.astype(np.int64)].sum(axis=1)
    return codes, C, structure, emb.astype(np.float32)


def predicate(name: str) -> np.ndarray:
    rng = np.random.default_rng(5)
    if name == "half":
        return rng.random(N) < 0.5
    if name == "none":
        return np.zeros(N, bool)
    if name == "all":
        return np.ones(N, bool)
    pred = np.zeros(N, bool)
    pred[[17, 900, 1999]] = True
    return pred


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    from repro.core import icq as ref_icq
    root = tmp_path_factory.mktemp("filtered")
    codes, C, structure, emb = arrays()
    st = ref_icq.ICQStructure(*(jnp.asarray(a) for a in structure))
    paths = {}
    for kind, lut in CELLS:
        cfg = ref_api.ICQConfig().with_overrides({
            "train.d": D, "train.num_codebooks": K,
            "train.codebook_size": M, "index.kind": kind,
            "index.n_lists": 8, "index.n_probe": 3,
            "index.kmeans_iters": 8, "serve.topk": TOPK,
            "serve.backend": "jnp", "serve.lut_dtype": lut})
        idx = ref_api.build_index(
            jnp.asarray(codes), jnp.asarray(C), st, index_cfg=cfg.index,
            serve_cfg=cfg.serve, emb_db=jnp.asarray(emb),
            key=jax.random.PRNGKey(4))
        paths[(kind, lut)] = str(root / f"{kind}-{lut}")
        ref_api.Artifacts(config=cfg, index=idx).save(paths[(kind, lut)])
    q = np.random.default_rng(43).standard_normal((NQ, D)).astype(np.float32)
    return q, paths


def _reference_luts(monkeypatch):
    def build_lut(qs, C):
        return torch.tensor(np.asarray(ref_base.build_lut(
            jnp.asarray(qs.numpy()), jnp.asarray(C.numpy()))))
    monkeypatch.setattr(port_flat, "build_lut", build_lut)
    monkeypatch.setattr(port_ivf, "build_lut", build_lut)


def assert_same_answers(got, want, q, C):
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    luts = ref_base.build_lut(jnp.asarray(q), jnp.asarray(C))
    atol = 1e-6 * luts.shape[1] * float(jnp.abs(luts).max())
    gd, wd = got.distances.numpy(), np.asarray(want.distances)
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(wd))
    fin = np.isfinite(wd)
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=1e-6, atol=atol)
    ulp = 2.0 ** -23
    np.testing.assert_allclose(float(got.pass_rate), float(want.pass_rate),
                               rtol=4 * ulp, atol=1e-30)
    np.testing.assert_allclose(float(got.avg_ops), float(want.avg_ops),
                               rtol=4 * ulp)


@pytest.mark.parametrize("filt", FILTERS)
@pytest.mark.parametrize("kind,lut", CELLS)
def test_filtered_matches_reference_jnp(artifacts, monkeypatch, kind, lut,
                                        filt):
    q, paths = artifacts
    path = paths[(kind, lut)]
    pred = predicate(filt)
    ref_engine = ref_api.load_ann_engine(path)
    want = ref_engine.search(jnp.asarray(q), filter=jnp.asarray(pred))
    _reference_luts(monkeypatch)
    got = load_ann_engine(path, device="cpu").search(q, filter=pred)
    assert_same_answers(got, want, q, ref_engine.index.C)
    ids = got.indices.numpy()
    assert pred[ids[ids >= 0]].all()
    if filt == "none":
        assert (ids == -1).all() and np.isinf(got.distances.numpy()).all()
    if filt == "three":
        assert (ids[:, 3:] == -1).all()
        if kind == "flat":      # no margin test: every eligible row
            assert (np.sort(ids[:, :3], axis=1) == [17, 900, 1999]).all()


@pytest.mark.parametrize("filt", ["half", "three"])
@pytest.mark.parametrize("kind,lut", [("two-step", "f32"), ("ivf", "f32"),
                                      ("ivf", "int8")])
def test_filtered_crude_rung_matches_reference(artifacts, monkeypatch, kind,
                                               lut, filt):
    """``search_crude`` with a filter (the ladder's crude floor)."""
    q, paths = artifacts
    path = paths[(kind, lut)]
    pred = predicate(filt)
    ref_index = ref_api.load_ann_engine(path).index
    want = ref_index.search_crude(jnp.asarray(q), filter=jnp.asarray(pred))
    _reference_luts(monkeypatch)
    index = load_ann_engine(path, device="cpu").index
    got = index.search_crude(torch.from_numpy(q), filter=pred)
    assert_same_answers(got, want, q, ref_index.C)


@pytest.mark.parametrize("cap", [12, 64, 5000])
@pytest.mark.parametrize("kind,lut", [("two-step", "f32"),
                                      ("two-step", "int8"), ("ivf", "f32"),
                                      ("ivf", "int8")])
def test_refine_cap_matches_reference(artifacts, monkeypatch, kind, lut,
                                      cap):
    """``index.refine_cap``: the survivor compaction, clamped to
    ``min(max(cap, topk), n)`` (flat) or ``[topk, nc]`` (IVF), with and
    without a filter."""
    q, paths = artifacts
    path = paths[(kind, lut)]
    over = {"index.refine_cap": cap}
    ref_engine = ref_api.load_ann_engine(path, overrides=over)
    _reference_luts(monkeypatch)
    engine = load_ann_engine(path, device="cpu", overrides=over)
    assert engine.index.refine_cap == cap
    for pred in (None, predicate("half")):
        want = ref_engine.search(
            jnp.asarray(q), filter=None if pred is None else jnp.asarray(pred))
        got = engine.search(q, filter=pred)
        assert_same_answers(got, want, q, ref_engine.index.C)


def test_filtered_equals_compacted_database(artifacts):
    """The port's identity: excluded rows influence nothing (not the
    bootstrap, the threshold or the ranking).  A filtered search over the
    whole database equals, bit for bit, the same composition (an
    all-pass filter) over the physically compacted rows, ids mapped
    back; IVF keeps its coarse centroids, its lists re-assigned over the
    kept rows."""
    q, _ = artifacts
    codes, C, structure, emb = arrays()
    pred = predicate("half")
    keep = np.nonzero(pred)[0]
    qt = torch.from_numpy(q)
    for kind in ("flat", "two-step", "ivf"):
        opts = dict(device="cpu", topk=15, backend="jnp")
        if kind == "ivf":
            full = make_index("ivf", codes, C, structure, emb_db=emb,
                              n_lists=8, n_probe=3, generator=2, **opts)
            sub_ivf = port_ivf.ivf_assign(full.ivf.centroids,
                                          torch.from_numpy(emb[keep]))
            sub = make_index("ivf", codes[keep], C, structure, ivf=sub_ivf,
                             n_probe=3, **opts)
        else:
            full = make_index(kind, codes, C, structure, **opts)
            sub = make_index(kind, codes[keep], C, structure, **opts)
        for search in ("search", "search_crude"):
            r_f = getattr(full, search)(qt, filter=pred)
            r_c = getattr(sub, search)(qt, filter=np.ones(len(keep), bool))
            mapped = np.where(r_c.indices.numpy() >= 0,
                              keep[np.maximum(r_c.indices.numpy(), 0)], -1)
            np.testing.assert_array_equal(r_f.indices.numpy(), mapped,
                                          err_msg=f"{kind} {search}")
            assert torch.equal(r_f.distances, r_c.distances), (kind, search)


def test_options_refused_on_the_card_with_the_reference_words():
    """On the card (backend "cuda") ``filter`` and ``refine_cap`` raise
    the reference's ``ValueError``s, word for word: the ones its fused
    Pallas engines raise."""
    codes, C, structure, _ = arrays()
    from repro.core import icq as ref_icq
    st = ref_icq.ICQStructure(*(jnp.asarray(a) for a in structure))
    q = jnp.zeros((2, D))
    words = {}
    for what, call in (
            ("filter", lambda: RefTwoStep.build(
                jnp.asarray(codes), jnp.asarray(C), st, backend="pallas")
             .search(q, filter=jnp.ones(N, bool))),
            ("refine_cap", lambda: ref_flat_mod.two_step_search(
                q, jnp.asarray(codes), jnp.asarray(C), st, TOPK,
                backend="pallas", refine_cap=20)),
            ("adc filter", lambda: RefFlatADC.build(
                jnp.asarray(codes), jnp.asarray(C), backend="pallas")
             .search(q, filter=jnp.ones(N, bool)))):
        with pytest.raises(ValueError) as ei:
            call()
        words[what] = str(ei.value)
    dev = torch.device("cpu")
    with pytest.raises(ValueError) as ei:
        port_flat._check_filter(np.ones(N, bool), N, "cuda", dev)
    assert str(ei.value) == words["filter"] == words["adc filter"]
    with pytest.raises(ValueError) as ei:
        port_flat._check_refine_cap(20, "cuda")
    assert str(ei.value) == words["refine_cap"]
    assert port_flat._check_refine_cap(None, "cuda") is None
    assert port_flat._check_filter(None, N, "cuda", dev) is None
    with pytest.raises(ValueError, match="filter must be a"):
        make_index("flat", codes, C, device="cpu").search(
            torch.zeros((2, D)), filter=np.ones(N - 1, bool))

