"""The slice as a whole: a reference-saved artifact served through the
port's ``load_ann_engine(path, device="cpu")`` against the reference's
own engine at ``backend="jnp"``, for {flat, two-step} x {f32, int8} x
{8, 4 bit}.

(a) With the port's ``build_lut`` patched to return the reference's
    tables, ids and the number of margin-test passes are equal, and
    distances agree to rtol 1e-6 plus an atol of 1e-6 times the largest
    K-term LUT sum: the reference engine builds its tables inside its
    jitted search, where XLA may round the fused ``sq - 2 * einsum`` in
    another last bit than the eager call that feeds the port.
    ``pass_rate`` and ``avg_ops`` agree to one ulp: the reference's
    jitted mean of per-query means rounds in XLA's order.
(b) Unpatched, the LUTs differ by einsum order (about 1e-6): f32 ids are
    equal wherever neighbouring distances differ by more than rtol 1e-5
    and distances agree to rtol 1e-5 (plus the atol rule of (a) at 1e-5); int8 recall@k against the
    reference is >= 0.99, since a 1e-6 LUT difference may move one int8
    entry across a rounding step.

The reference's jnp and Pallas distances already differ in the last
ulp, so no test asks for bitwise distances across the packages.
Within the port, a tiled ``AnnEngine`` answers each row bitwise the same
however the rows were batched.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as ref_api
from repro.data.synthetic import make_synthetic_index as ref_synthetic
from repro.index import base as ref_base
from repro_torch.api import AnnEngine, load_ann_engine
from repro_torch.index import flat as port_flat

N, NQ, TOPK = 3000, 16, 10
CELLS = [(kind, lut, bits) for kind in ("flat", "two-step")
         for lut in ("f32", "int8") for bits in (8, 4)]


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """One reference-saved artifact per (kind, lut dtype, code bits)
    and the reference engine's answers for a fixed query batch."""
    root = tmp_path_factory.mktemp("slice")
    q = np.asarray(jax.random.normal(jax.random.PRNGKey(42), (NQ, 16)))
    out = {}
    for kind, lut, bits in CELLS:
        m = 16 if bits == 4 else 256
        cfg = ref_api.ICQConfig().with_overrides({
            "train.codebook_size": m, "index.kind": kind,
            "index.code_bits": bits, "serve.topk": TOPK,
            "serve.backend": "jnp", "serve.lut_dtype": lut})
        codes, C, st = ref_synthetic(jax.random.PRNGKey(bits), N, d=16,
                                     K=8, m=m, num_fast=2, sigma=2.0)
        idx = ref_api.build_index(codes, C, st, index_cfg=cfg.index,
                                  serve_cfg=cfg.serve)
        path = str(root / f"{kind}-{lut}-{bits}")
        ref_api.Artifacts(config=cfg, index=idx).save(path)
        res = ref_api.load_ann_engine(path).search(jnp.asarray(q))
        out[(kind, lut, bits)] = (path, res)
    return q, out


def engine_C(path):
    return jnp.asarray(ref_api.Artifacts.load(path).index.C)


def _port_search(path, q, k=None):
    return load_ann_engine(path, device="cpu").search(q, k=k)


@pytest.mark.parametrize("kind,lut_dtype,code_bits", CELLS)
def test_slice_matches_reference_given_same_luts(artifacts, monkeypatch,
                                                 kind, lut_dtype,
                                                 code_bits):
    q, cells = artifacts
    path, want = cells[(kind, lut_dtype, code_bits)]
    monkeypatch.setattr(port_flat, "build_lut", lambda qs, C: torch.tensor(
        np.asarray(ref_base.build_lut(jnp.asarray(qs.numpy()),
                                      jnp.asarray(C.numpy())))))
    got = _port_search(path, q)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    luts = ref_base.build_lut(jnp.asarray(q), engine_C(path))
    atol = 1e-6 * luts.shape[1] * float(jnp.abs(luts).max())
    np.testing.assert_allclose(got.distances.numpy(),
                               np.asarray(want.distances), rtol=1e-6,
                               atol=atol)
    passes = [round(float(r.pass_rate) * NQ * N) for r in (got, want)]
    assert passes[0] == passes[1]
    ulp = 2.0 ** -23
    np.testing.assert_allclose(float(got.pass_rate), float(want.pass_rate),
                               rtol=ulp)
    np.testing.assert_allclose(float(got.avg_ops), float(want.avg_ops),
                               rtol=ulp)
    if kind == "two-step":
        assert 0.0 < float(got.pass_rate) < 1.0
    assert got.meta.backend == "torch"
    assert got.meta.stages == (("adc",) if kind == "flat"
                               else ("crude", "refine"))


@pytest.mark.parametrize("kind,lut_dtype,code_bits", CELLS)
def test_slice_close_to_reference_end_to_end(artifacts, kind, lut_dtype,
                                             code_bits):
    q, cells = artifacts
    path, want = cells[(kind, lut_dtype, code_bits)]
    got = _port_search(path, q)
    got_i, want_i = got.indices.numpy(), np.asarray(want.indices)
    if lut_dtype == "int8":
        hits = [len(set(g) & set(w)) for g, w in zip(got_i, want_i)]
        assert sum(hits) / want_i.size >= 0.99
        return
    want_d = np.asarray(want.distances)
    luts = ref_base.build_lut(jnp.asarray(q), engine_C(path))
    atol = 1e-5 * luts.shape[1] * float(jnp.abs(luts).max())
    np.testing.assert_allclose(got.distances.numpy(), want_d, rtol=1e-5,
                               atol=atol)
    # ids must agree where the reference's ranking is not a near-tie
    gap = np.abs(np.diff(want_d, axis=1)) > 1e-5 * np.abs(want_d[:, 1:])
    clear = np.ones_like(want_i, bool)
    clear[:, 1:] &= gap
    clear[:, :-1] &= gap
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got_i[clear], want_i[clear])


@pytest.mark.parametrize("kind", ["flat", "two-step"])
def test_slice_serves_topk_past_256(artifacts, monkeypatch, kind):
    """k = 300, past the 256 that the flat top-k once capped on the
    card: the port's plain path against the reference's jnp engine on
    one artifact, given the same LUTs.  Pass counts equal; distances to
    rtol 1e-6 plus the atol rule of (a); ids equal wherever the
    reference's neighbouring distances differ by more than rtol 1e-6
    (among 300 of 3000 points an exact tie in the port can be one ulp
    apart in the reference's jitted crude + slow), and the same id set
    in every row."""
    q, cells = artifacts
    path, _ = cells[(kind, "f32", 8)]
    k = 300
    want = ref_api.load_ann_engine(path).search(jnp.asarray(q), k=k)
    monkeypatch.setattr(port_flat, "build_lut", lambda qs, C: torch.tensor(
        np.asarray(ref_base.build_lut(jnp.asarray(qs.numpy()),
                                      jnp.asarray(C.numpy())))))
    got = _port_search(path, q, k=k)
    assert got.indices.shape == (NQ, k)
    got_i, want_i = got.indices.numpy(), np.asarray(want.indices)
    want_d = np.asarray(want.distances)
    luts = ref_base.build_lut(jnp.asarray(q), engine_C(path))
    atol = 1e-6 * luts.shape[1] * float(jnp.abs(luts).max())
    np.testing.assert_allclose(got.distances.numpy(), want_d, rtol=1e-6,
                               atol=atol)
    gap = np.abs(np.diff(want_d, axis=1)) > 1e-6 * np.abs(want_d[:, 1:])
    clear = np.ones_like(want_i, bool)
    clear[:, 1:] &= gap
    clear[:, :-1] &= gap
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(got_i[clear], want_i[clear])
    for g, w in zip(got_i, want_i):
        assert set(g.tolist()) == set(w.tolist())
    passes = [round(float(r.pass_rate) * NQ * N) for r in (got, want)]
    assert passes[0] == passes[1]


@pytest.mark.parametrize("kind", ["flat", "two-step"])
def test_tiled_engine_is_batching_invariant(artifacts, kind):
    """Rows answered in one 37-row batch (three 16-row tiles) equal the
    same rows answered in other batchings and a direct index call on
    the first tile, bit for bit."""
    _, cells = artifacts
    path, _ = cells[(kind, "f32", 8)]
    engine = load_ann_engine(path, device="cpu", query_tile=16)
    assert isinstance(engine, AnnEngine) and engine.n == N
    q = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (37, 16)).astype(np.float32))
    full = engine.search(q)
    assert full.indices.shape == (37, TOPK)
    parts = [engine.search(q[a:b]) for a, b in ((0, 5), (5, 21), (21, 37))]
    for field in ("indices", "distances"):
        joined = torch.cat([getattr(p, field) for p in parts])
        assert torch.equal(joined, getattr(full, field))
    direct = engine.index.search(q[:16])
    assert torch.equal(direct.indices, full.indices[:16])
    assert torch.equal(direct.distances, full.distances[:16])
    assert engine.stats["full"] == 4


def test_unported_options_raise_by_name(artifacts):
    """Sharded serving serves: ``shard`` gives the
    row-sharded clone and ``mark_shard_dead`` needs a sharded engine; the
    pipelined executor (item 7) now serves, equal bit for bit to the
    sequential path over the same tiles (its parity is in
    ``test_torch_pipelined.py``); ``filter``, ``search_crude`` and
    ``refine_cap`` serve on the CPU (their parity with the reference is
    in ``test_torch_filtered.py`` and ``test_torch_ladder.py``)."""
    _, cells = artifacts
    path, _ = cells[("two-step", "f32", 8)]
    engine = load_ann_engine(path, device="cpu")
    q = np.zeros((2, 16), np.float32)
    piped = load_ann_engine(path, device="cpu",
                            overrides={"serve.pipeline": "tiles",
                                       "serve.pipeline_tile": 4})
    rows = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (10, 16)).astype(np.float32))
    got = piped.index.search(rows)
    want = dataclasses.replace(piped.index, pipeline="off",
                               query_chunk=4).search(rows)
    for field in ("indices", "distances", "pass_rate", "avg_ops"):
        assert torch.equal(getattr(got, field), getattr(want, field))
    with pytest.raises(ValueError, match="pipeline mode"):
        dataclasses.replace(piped.index, pipeline="overlap")
    from repro_torch.distributed import make_mesh_auto
    view = engine.index.shard(make_mesh_auto((2,), ("data",),
                                             devices="cpu"))
    assert torch.equal(view.search(rows).indices,
                       engine.index.search(rows).indices)
    with pytest.raises(ValueError, match="needs a sharded engine"):
        engine.mark_shard_dead(0)
    r = engine.search(q, filter=np.ones(N, bool))
    assert r.indices.shape == (2, TOPK) and bool((r.indices >= 0).all())
    r = engine.index.search_crude(torch.from_numpy(q))
    assert r.indices.shape == (2, TOPK) and float(r.pass_rate) == 0.0
    capped = load_ann_engine(path, device="cpu",
                             overrides={"index.refine_cap": 64})
    assert capped.index.refine_cap == 64
    assert capped.search(q).indices.shape == (2, TOPK)
