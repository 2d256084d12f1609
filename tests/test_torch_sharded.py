"""Sharded serving of the port on the CPU: every sharded engine held
against the port's unsharded engine (bit for bit) and against the
reference's single-device jnp engine, over the reference's own sharded
problem (``tests/test_index.py``: n = 1237, 9 queries, K = 4, m = 16,
d = 8, topk 17), made from a numpy seed.

A mesh of D shards on the CPU (``make_mesh_auto((D,), ("data",),
devices="cpu")``) is what the reference's forced host device count
gives it.  For D in {1, 2, 3, 4}, over flat, two-step and the IVF grid
(16/4, 16/1, 16/16, 13/5 lists/probes and 16/4 with refine_cap 20), f32
and int8 tables, 8- and 4-bit codes:

- ids, distances, ``pass_rate`` and ``avg_ops`` equal the unsharded
  port's bit for bit;
- with the port's LUTs patched to the reference's tables, ids equal the
  reference's single-device engine, distances to rtol 1e-5 plus an atol
  of 1e-5 times the largest K-term LUT sum, and the margin-test passes
  are as many.

The reference's own forced-4-device comparison is not run here: its
bitwise claims fail in the tier-1 runs (ROADMAP.md §3), and no JAX
subprocess is started.  Dead shards are held against the reference's
single-device search with ``filter=`` the surviving rows.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import icq as ref_icq
from repro.distributed.elastic import plan_mesh_shape as ref_plan
from repro.index import FlatADC as RefFlatADC
from repro.index import IVFTwoStep as RefIVFTwoStep
from repro.index import TwoStep as RefTwoStep
from repro.index import base as ref_base
from repro.index import ivf as ref_ivf
from repro_torch.api import (ArtifactError, Artifacts, AnnEngine,  # noqa
                             ICQConfig, build_ann_engine, load_ann_engine)
from repro_torch.core.encode import pack_nibbles
from repro_torch.core.icq import ICQStructure
from repro_torch.distributed import (Mesh, NamedSharding, make_elastic_mesh,
                                     make_mesh_auto, plan_mesh_shape,
                                     replicated)
from repro_torch.index import flat as port_flat
from repro_torch.index import ivf as port_ivf
from repro_torch.index import make_index, sharded
from repro_torch.index.base import mask_filtered_ids
from repro_torch.resilience import FaultInjector, FaultSpec
from repro_torch.api.config import ResilienceConfig
from repro_torch.serve import Tenant

N, NQ, K, M, DIM, KF, TOPK = 1237, 9, 4, 16, 8, 2, 17
SHARDS = (1, 2, 3, 4)
IVF_GRID = [(16, 4, None), (16, 1, None), (16, 16, None), (13, 5, None),
            (16, 4, 20)]
CELLS = ([("flat", lut, bits, None) for lut in ("f32", "int8")
          for bits in (8, 4)]
         + [("two-step", lut, bits, None) for lut in ("f32", "int8")
            for bits in (8, 4)]
         + [("ivf", lut, 8, g) for lut in ("f32", "int8") for g in IVF_GRID]
         + [("ivf", lut, 4, (16, 4, None)) for lut in ("f32", "int8")])


def _cell_id(cell):
    kind, lut, bits, g = cell
    return f"{kind}-{lut}-{bits}" + ("" if g is None else
                                     "-{}-{}-{}".format(*g))


def problem(n=N, seed=0):
    """Codes (n, K) uint8, C (K, M, DIM) f32, the fast mask, queries and
    the decoded embeddings, from a numpy seed."""
    rng = np.random.default_rng(seed)
    C = (rng.standard_normal((K, M, DIM)) * 0.3).astype(np.float32)
    codes = rng.integers(0, M, size=(n, K)).astype(np.uint8)
    fast = np.arange(K) < KF
    q = rng.standard_normal((NQ, DIM)).astype(np.float32)
    emb = C[np.arange(K)[None, :], codes.astype(np.int64)].sum(axis=1)
    return codes, C, fast, q, emb.astype(np.float32)


def cpu_mesh(D):
    return make_mesh_auto((D,), ("data",), devices="cpu")


def _stored(codes, bits):
    return (pack_nibbles(torch.from_numpy(codes), K).numpy() if bits == 4
            else codes)


@functools.lru_cache(maxsize=None)
def ref_partition(n, seed, n_lists):
    """The reference's coarse partition of ``problem(n, seed)``."""
    return ref_ivf.build_ivf(jax.random.PRNGKey(3),
                             jnp.asarray(problem(n, seed)[4]), n_lists)


def build_pair(cell, n=N, seed=0):
    """(reference index, port index, queries, reference LUTs) of one
    cell over the same numpy arrays; the IVF port index takes the
    reference's partition."""
    kind, lut, bits, g = cell
    codes, C, fast, q, emb = problem(n, seed)
    stored = _stored(codes, bits)
    ref_st = ref_icq.ICQStructure(xi=jnp.ones(DIM, bool),
                                  fast_mask=jnp.asarray(fast),
                                  sigma=jnp.asarray(1.0))
    st = ICQStructure(torch.ones(DIM, dtype=torch.bool),
                      torch.from_numpy(fast), torch.tensor(1.0))
    opts = dict(topk=TOPK, lut_dtype=lut, code_bits=bits)
    if kind == "ivf":
        n_lists, n_probe, cap = g
        ivf = ref_partition(n, seed, n_lists)
        ref = RefIVFTwoStep(codes=jnp.asarray(stored), C=jnp.asarray(C),
                            structure=ref_st, ivf=ivf,
                            list_codes=ref_ivf.ivf_list_codes(
                                ivf, jnp.asarray(stored)),
                            n_probe=n_probe, backend="jnp",
                            refine_cap=cap, **opts)
        port = make_index("ivf", stored, C, st, ivf=ref.ivf,
                          n_probe=n_probe, refine_cap=cap, device="cpu",
                          **opts)
    else:
        cls = RefFlatADC if kind == "flat" else RefTwoStep
        ref = cls.build(jnp.asarray(stored), jnp.asarray(C), ref_st,
                        backend="jnp", **opts)
        port = make_index(kind, stored, C, st, device="cpu", **opts)
    return ref, port, q, ref_base.build_lut(jnp.asarray(q), jnp.asarray(C))


def reference_luts(monkeypatch):
    """Patch the port's LUTs (unsharded and sharded) to the reference's
    tables."""
    def ref_lut(qs, C):
        return torch.tensor(np.asarray(ref_base.build_lut(
            jnp.asarray(qs.numpy()), jnp.asarray(C.numpy()))))
    for mod in (port_flat, port_ivf, sharded):
        monkeypatch.setattr(mod, "build_lut", ref_lut)


def same(a, b) -> bool:
    return (torch.equal(a.indices, b.indices)
            and torch.equal(a.distances, b.distances)
            and torch.equal(a.pass_rate, b.pass_rate)
            and torch.equal(a.avg_ops, b.avg_ops))


@pytest.fixture(scope="module")
def pairs():
    """Each cell's indexes and the reference's answers, computed once
    (with the reference's LUTs the port sees the same tables)."""
    return {cell: build_pair(cell) for cell in CELLS}


@pytest.fixture(scope="module")
def reference_answers(pairs):
    return {cell: ref.search(jnp.asarray(q))
            for cell, (ref, _, q, _) in pairs.items()}


@pytest.mark.parametrize("D", SHARDS)
@pytest.mark.parametrize("cell", CELLS, ids=[_cell_id(c) for c in CELLS])
def test_sharded_equals_unsharded_and_reference(pairs, reference_answers,
                                                monkeypatch, cell, D):
    ref, port, q, luts = pairs[cell]
    reference_luts(monkeypatch)
    qt = torch.from_numpy(q)
    one = port.search(qt)
    got = port.shard(cpu_mesh(D)).search(qt)
    assert same(got, one)
    want = reference_answers[cell]
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    atol = 1e-5 * luts.shape[1] * float(jnp.abs(luts).max())
    np.testing.assert_allclose(got.distances.numpy(),
                               np.asarray(want.distances), rtol=1e-5,
                               atol=atol)
    np.testing.assert_allclose(float(got.pass_rate), float(want.pass_rate),
                               rtol=4 * 2.0 ** -23)


@pytest.mark.parametrize("cell", [("flat", "f32", 8, None),
                                  ("two-step", "f32", 8, None),
                                  ("two-step", "int8", 4, None),
                                  ("ivf", "f32", 8, (16, 1, None)),
                                  ("ivf", "f32", 8, (16, 2, 20))],
                         ids=_cell_id)
def test_shards_smaller_than_topk(monkeypatch, cell):
    """n = 40 over 4 shards: each shard holds 10 rows, fewer than topk;
    the IVF slabs are thinner than topk (shard 0 owns the pad columns)."""
    ref, port, q, _ = build_pair(cell, n=40, seed=4)
    reference_luts(monkeypatch)
    qt = torch.from_numpy(q)
    got = port.shard(cpu_mesh(4)).search(qt)
    assert same(got, port.search(qt))
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(ref.search(jnp.asarray(q))
                                             .indices))


@pytest.mark.parametrize("D", SHARDS)
@pytest.mark.parametrize("kind", ["flat", "two-step", "ivf"])
def test_sharded_filter_and_refine_cap(D, kind):
    """The plain versions' options: a filtered and a capped sharded
    search equal the unsharded ones bit for bit."""
    cell = (kind, "f32", 8, (16, 4, None) if kind == "ivf" else None)
    _, port, q, _ = build_pair(cell)
    qt = torch.from_numpy(q)
    rng = np.random.default_rng(D)
    for pred in (rng.random(N) < 0.4, np.zeros(N, bool),
                 np.isin(np.arange(N), [5, 700, 1200])):
        got = port.shard(cpu_mesh(D)).search(qt, filter=pred)
        assert same(got, port.search(qt, filter=pred))
    if kind != "flat":
        capped = dataclasses.replace(port, refine_cap=25)
        assert same(capped.shard(cpu_mesh(D)).search(qt), capped.search(qt))


@pytest.mark.parametrize("cell", [("flat", "f32", 8, None),
                                  ("two-step", "f32", 8, None),
                                  ("two-step", "int8", 8, None),
                                  ("ivf", "f32", 8, (16, 4, None)),
                                  ("ivf", "int8", 8, (13, 5, None)),
                                  ("ivf", "f32", 8, (16, 4, 20))],
                         ids=_cell_id)
def test_dead_shard_is_the_survivors_ranking(monkeypatch, cell):
    """Shard 1 of 4 dead: ids equal the reference's single-device search
    filtered to the surviving rows (slots past the survivors -1), and
    coverage is the surviving share."""
    ref, port, q, luts = build_pair(cell)
    reference_luts(monkeypatch)
    view = port.shard(cpu_mesh(4)).mark_shard_dead(1)
    if cell[0] == "ivf":
        a, b = view.list_rows[1]
        dead_rows = port.ivf.lists[a:b]
        alive = np.ones(N, bool)
        alive[dead_rows[dead_rows >= 0].numpy()] = False
    else:
        alive = np.ones(N, bool)
        alive[310:620] = False
    got = view.search(torch.from_numpy(q))
    want = ref.search(jnp.asarray(q), filter=jnp.asarray(alive))
    np.testing.assert_array_equal(
        mask_filtered_ids(got.indices, got.distances).numpy(),
        np.asarray(want.indices))
    atol = 1e-5 * luts.shape[1] * float(jnp.abs(luts).max())
    np.testing.assert_allclose(got.distances.numpy(),
                               np.asarray(want.distances), rtol=1e-5,
                               atol=atol)
    assert view.coverage == alive.sum() / N
    assert alive[got.indices.numpy()].all()


def test_dead_shard_errors_and_row_layout():
    _, port, _, _ = build_pair(("two-step", "f32", 8, None))
    view = port.shard(cpu_mesh(4))
    assert view.rows == [(0, 310), (310, 620), (620, 930), (930, 1237)]
    with pytest.raises(ValueError, match=r"shard 4 outside \[0, 4\)"):
        view.mark_shard_dead(4)
    view.mark_shard_dead(0, 2)
    with pytest.raises(ValueError, match="cannot mark all 4 shards dead"):
        view.mark_shard_dead(1, 3)
    assert view.dead_shards == {0, 2}
    assert view.coverage == (310 + 307) / N
    with pytest.raises(ValueError, match="already sharded"):
        view.shard(cpu_mesh(2))


def test_dead_ivf_shard_equals_emptied_lists():
    """A dead list shard answers as the unsharded index whose dead lists
    are emptied (id -1), all four fields bit for bit."""
    _, port, q, _ = build_pair(("ivf", "f32", 8, (16, 16, None)))
    view = port.shard(cpu_mesh(4)).mark_shard_dead(1)
    a, b = view.list_rows[1]
    lists = port.ivf.lists.clone()
    lists[a:b] = -1
    emptied = dataclasses.replace(port, ivf=port.ivf._replace(lists=lists))
    qt = torch.from_numpy(q)
    assert same(view.search(qt), emptied.search(qt))


def test_sharded_add_keeps_dead_shards():
    """``add`` grows the source and shards it again: the grown clone
    equals the grown unsharded index sharded afresh, with the dead set
    kept."""
    _, port, q, _ = build_pair(("two-step", "f32", 8, None))
    view = port.shard(cpu_mesh(3)).mark_shard_dead(2)
    new = problem(60, seed=9)[4]
    grown = view.add(new)
    assert grown.dead_shards == {2} and grown.n == N + 60
    want = port.add(new).shard(cpu_mesh(3)).mark_shard_dead(2)
    qt = torch.from_numpy(q)
    assert same(grown.search(qt), want.search(qt))


def test_pipelined_source_serves_pipeline_off():
    _, port, q, _ = build_pair(("two-step", "f32", 8, None))
    piped = dataclasses.replace(port, pipeline="tiles", pipeline_tile=4)
    view = piped.shard(cpu_mesh(2))
    assert view.pipeline == "off"
    qt = torch.from_numpy(q)
    assert same(view.search(qt), port.search(qt))


# ------------------------------------------------------------- engines ----

def _save(tmp_path, kind="two-step"):
    codes, C, fast, q, emb = problem()
    st = (np.ones(DIM, bool), fast, np.float32(1.0))
    engine = build_ann_engine(codes, C, st, topk=TOPK, index=kind,
                              emb_db=emb, n_lists=16, n_probe=4,
                              device="cpu")
    cfg = ICQConfig().with_overrides({
        "train.d": DIM, "train.num_codebooks": K,
        "train.codebook_size": M, "index.kind": kind, "index.n_lists": 16,
        "index.n_probe": 4, "serve.topk": TOPK})
    path = str(tmp_path / kind)
    Artifacts(config=cfg, index=engine.index).save(path)
    return path, engine, q


@pytest.mark.parametrize("kind", ["two-step", "ivf"])
def test_engine_mesh_serves_full_rung_with_coverage(tmp_path, kind):
    path, plain, q = _save(tmp_path, kind)
    mesh = cpu_mesh(4)
    for engine in (AnnEngine(plain.index, mesh),
                   load_ann_engine(path, mesh=mesh),
                   Tenant.from_artifacts("t", path, mesh=mesh).engine):
        assert engine._levels() == ("full",)
        r = engine.search(q)
        want = plain.search(q)
        assert same(r, want)
        assert r.meta.coverage == 1.0 and not r.meta.degraded
        engine.mark_shard_dead(1)
        r = engine.search(q)
        assert r.meta.coverage == engine.coverage < 1.0
        assert r.meta.degraded and engine.stats["degraded"] == 1
    with pytest.raises(ValueError, match="needs a sharded engine"):
        plain.mark_shard_dead(0)


def test_build_ann_engine_mesh_add_keeps_dead(tmp_path):
    codes, C, fast, q, emb = problem()
    st = (np.ones(DIM, bool), fast, np.float32(1.0))
    mesh = cpu_mesh(4)
    engine = build_ann_engine(codes, C, st, topk=TOPK, mesh=mesh)
    assert engine.device == torch.device("cpu")
    assert engine._levels() == ("full",)
    engine.mark_shard_dead(3)
    new = problem(50, seed=7)[4]
    engine.add(new)
    assert engine.n == N + 50 and engine._view.dead_shards == {3}
    plain = build_ann_engine(codes, C, st, topk=TOPK, device="cpu").add(new)
    keep = np.ones(N + 50, bool)
    a, b = engine._view.rows[3]
    keep[a:b] = False
    r = engine.search(q)
    assert keep[r.indices.numpy()].all()
    sub = plain.index.shard(cpu_mesh(4)).mark_shard_dead(3).search(
        torch.from_numpy(q))
    assert torch.equal(r.indices, sub.indices)


def test_sharded_batch_is_retried_in_place(tmp_path):
    path, plain, q = _save(tmp_path)
    engine = load_ann_engine(path, mesh=cpu_mesh(2))
    engine.resilience = ResilienceConfig(max_retries=1,
                                         backoff_base_ms=0.001)
    stage = "kernels.batched_refine_topk"
    # the first attempt fails at shard 0's refine; the retry's two
    # refine launches pass (each check draws three uniforms)
    for seed in range(1000):
        u = np.random.default_rng(seed).random(9)
        if u[0] < 0.5 <= min(u[3], u[6]):
            break
    inj = FaultInjector(seed=seed, spec=FaultSpec(p_raise=0.5,
                                                  targets=(stage,)))
    with inj.installed():
        r = engine.search(q)
    assert engine.stats["retries"] == 1
    assert same(r, plain.search(q))


def test_session_index_mesh():
    from repro_torch.api import icq_session
    from repro_torch.data import make_table1_dataset
    x, y, q, _ = make_table1_dataset("dataset2")
    cfg = ICQConfig().with_overrides({
        "train.quantizer": "cq", "train.d": 16, "train.codebook_size": 16,
        "train.epochs": 1})
    s = icq_session(cfg, device="cpu")
    s.fit(x[:400], y[:400])
    plain, sharded_s = s.index(), s.index(mesh=cpu_mesh(3))
    assert sharded_s.engine._levels() == ("full",)
    assert same(sharded_s.search(q[:5]), plain.search(q[:5]))


# ---------------------------------------------------------------- meshes ----

@pytest.mark.parametrize("n,divisors,expect", [
    (256, (16, 128), (16, 16)),
    (255, (16, 128), (8, 16)),
    (8, (4,), (2, 4)),
    (8, (3,), (8, 1)),
])
def test_plan_mesh_shape_matches_reference(n, divisors, expect):
    got = plan_mesh_shape(n, model_divisors=divisors)
    assert got == ref_plan(n, model_divisors=divisors) == expect


def test_meshes_on_the_cpu():
    mesh = make_mesh_auto((2, 2), ("data", "model"), devices="cpu")
    assert mesh.shape == {"data": 2, "model": 2} and mesh.size == 4
    assert mesh.axis_devices("data") == [torch.device("cpu")] * 2
    el = make_elastic_mesh(["cpu"] * 7, model_divisors=(2,), max_model=2)
    assert el.shape == {"data": 2, "model": 2}
    x = torch.arange(10.0)[:, None]
    parts = NamedSharding(cpu_mesh(3), ("data",)).put(x)
    assert [p.shape[0] for p in parts] == [4, 4, 2]
    reps = replicated(cpu_mesh(3)).put(x)
    assert all(r is reps[0] for r in reps)
    with pytest.raises(ValueError, match="cannot be laid out"):
        make_mesh_auto((3,), ("data",), devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="'data' axis"):
        build_pair(("flat", "f32", 8, None))[1].shard(
            make_mesh_auto((2,), ("model",), devices="cpu"))


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is visible")
def test_cuda_mesh_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Mesh(["cuda:0"], ("data",))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_mesh_auto((4,), ("data",))
