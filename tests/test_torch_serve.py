"""The port's request path (``repro_torch.serve``) held against itself
and the reference's: the coalescer state machine (pure, fake-clock
driven), serving-loop parity (a coalesced response equals a direct
``AnnEngine.search`` on the request's rows, ids and distances bit for
bit, for every index kind, and its ids equal the reference loop's on
the same artifact), lifecycle, backpressure, tenants and spec
conflicts, degraded serving under an injected delay, and loadgen
seeding (the same request stream as the reference's from one seed).

The engines are one artifact per index kind, built and saved by the
reference at ``serve.backend="jnp"`` and loaded by both packages.
"""
import time
import types
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as ref_api
import repro.serve as ref_serve
from repro.core import icq as ref_icq
from repro.index import base as ref_base
from repro_torch.api import build_ann_engine, load_ann_engine
from repro_torch.index import flat as port_flat
from repro_torch.index import ivf as port_ivf
from repro_torch.resilience import (FaultInjector, FaultSpec, ResultMeta,
                                    RetriesExhausted, SearchBudget)
from repro_torch.serve import (Coalescer, PendingRequest, ServeError,
                               ServingLoop, Tenant, load_tenants,
                               make_workload, parse_tenant_specs,
                               poisson_arrivals, run_closed_loop,
                               run_open_loop, summarize)

N, D, K, M, TOPK = 2000, 16, 8, 32, 10
KINDS = ("flat", "two-step", "ivf")


def _req(nq, t=0.0, tenant="t"):
    q = np.arange(nq * D, dtype=np.float32).reshape(nq, D)
    return PendingRequest(tenant, q, None, None, t, Future())


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, M, size=(N, K)).astype(np.uint8)
    C = (rng.standard_normal((K, M, D)) / np.sqrt(K)).astype(np.float32)
    structure = (np.ones(D, bool), np.arange(K) < 2, np.float32(1.0))
    emb = C[np.arange(K)[None, :], codes.astype(np.int64)].sum(axis=1)
    return codes, C, structure, emb.astype(np.float32)


# --------------------------------------------------------------- engines --
@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    """One reference-saved artifact per index kind (jnp backend)."""
    root = tmp_path_factory.mktemp("serve")
    codes, C, structure, emb = _arrays()
    st = ref_icq.ICQStructure(*(jnp.asarray(a) for a in structure))
    out = {}
    for kind in KINDS:
        cfg = ref_api.ICQConfig().with_overrides({
            "train.d": D, "train.num_codebooks": K,
            "train.codebook_size": M, "index.kind": kind,
            "index.n_lists": 16, "index.n_probe": 4,
            "index.kmeans_iters": 8, "serve.topk": TOPK,
            "serve.backend": "jnp"})
        idx = ref_api.build_index(
            jnp.asarray(codes), jnp.asarray(C), st, index_cfg=cfg.index,
            serve_cfg=cfg.serve, emb_db=jnp.asarray(emb),
            key=jax.random.PRNGKey(1))
        out[kind] = str(root / kind)
        ref_api.Artifacts(config=cfg, index=idx).save(out[kind])
    return out


@pytest.fixture(scope="module")
def engines(paths):
    """The port's CPU engine of each artifact."""
    return {kind: load_ann_engine(p, device="cpu")
            for kind, p in paths.items()}


# ------------------------------------------------- coalescer state machine --
class TestCoalescer:
    def test_flush_on_full_tile_fires_immediately(self):
        c = Coalescer(tile=4, window_s=10.0)   # window can't be the trigger
        assert c.submit(_req(3), now=0.0) == []
        flushes = c.submit(_req(1), now=0.1)
        assert len(flushes) == 1
        assert flushes[0].reason == "full"
        assert flushes[0].rows == flushes[0].tile == 4
        assert c.pending_rows == 0

    def test_flush_on_window_expiry(self):
        c = Coalescer(tile=8, window_s=0.5)
        c.submit(_req(3), now=1.0)
        assert c.next_deadline() == pytest.approx(1.5)
        assert c.poll(now=1.49) == []
        flushes = c.poll(now=1.5)
        assert len(flushes) == 1
        assert flushes[0].reason == "window"
        assert flushes[0].rows == 3 and flushes[0].tile == 8
        assert flushes[0].fill == pytest.approx(3 / 8)
        assert c.poll(now=2.0) == [] and c.next_deadline() is None

    def test_oversize_burst_splits_across_tiles(self):
        c = Coalescer(tile=4, window_s=1.0)
        flushes = c.submit(_req(10), now=0.0)
        assert [f.reason for f in flushes] == ["full", "full"]
        assert [f.rows for f in flushes] == [4, 4]
        assert c.pending_rows == 2
        spans = [(s.req_start, s.rows) for f in flushes for s in f.slices]
        assert spans == [(0, 4), (4, 4)]
        tail = c.flush_all()
        assert [f.rows for f in tail] == [2]
        assert tail[0].slices[0].req_start == 8

    def test_fifo_packing_and_row_routing(self):
        c = Coalescer(tile=6, window_s=1.0)
        a, b, d = _req(2, t=0.0), _req(3, t=0.1), _req(4, t=0.2)
        c.submit(a, now=0.0)
        c.submit(b, now=0.1)
        flushes = c.submit(d, now=0.2)
        assert len(flushes) == 1
        f = flushes[0]
        assert [(s.request.rid, s.req_start, s.batch_start, s.rows)
                for s in f.slices] == [
            (a.rid, 0, 0, 2), (b.rid, 0, 2, 3), (d.rid, 0, 5, 1)]
        np.testing.assert_array_equal(
            f.queries(),
            np.concatenate([a.queries, b.queries, d.queries[:1]]))
        assert c.next_deadline() == pytest.approx(0.2 + 1.0)

    def test_deliver_and_assemble_reorders_split_parts(self):
        req = _req(5)
        ids_a = np.arange(10).reshape(2, 5)
        ids_b = np.arange(15).reshape(3, 5) + 100
        assert not req.deliver(2, ids_b, ids_b * 0.5, "resB", fill=1.0)
        assert req.deliver(0, ids_a, ids_a * 0.5, "resA", fill=0.5)
        ids, dists, last, fill = req.assemble()
        np.testing.assert_array_equal(ids, np.concatenate([ids_a, ids_b]))
        assert last == "resB"
        assert fill == pytest.approx((2 * 0.5 + 3 * 1.0) / 5)

    def test_flush_all_drains_everything(self):
        c = Coalescer(tile=4, window_s=9.0)
        c.submit(_req(3), now=0.0)
        c.submit(_req(3), now=0.0)
        drained = c.flush_all()
        assert sum(f.rows for f in drained) == 2
        assert all(f.reason == "drain" for f in drained)
        assert c.pending_rows == 0 and c.flush_all() == []

    def test_invalid_knobs_rejected(self):
        with pytest.raises(ServeError, match="tile"):
            Coalescer(tile=0, window_s=1.0)
        with pytest.raises(ServeError, match="window"):
            Coalescer(tile=4, window_s=-0.1)


# ------------------------------------------------------ loop bitwise parity --
REQUEST_ROWS = (1, 2, 4, 1, 5, 3)     # 5 > tile: the split path


def _requests(seed=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((nq, D)).astype(np.float32)
            for nq in REQUEST_ROWS]


class TestServingLoopParity:
    @pytest.mark.parametrize("kind", KINDS)
    def test_coalesced_bitwise_identical_to_direct(self, engines, kind):
        """Scheduling never changes math: ids AND distances of a
        coalesced response equal a direct search on the same rows, for
        every index kind, across coalesced, split and padded flushes."""
        eng = engines[kind]
        reqs = _requests()
        with ServingLoop(Tenant(name="t", engine=eng), window_ms=1.0,
                         tile=4) as loop:
            loop.warm()
            futs = [loop.submit(q) for q in reqs]
            results = [f.result(timeout=60) for f in futs]
        assert eng.query_tile == 4             # pinned to the lane tile
        for q, res in zip(reqs, results):
            ref = eng.search(q)
            assert isinstance(res.indices, np.ndarray)
            np.testing.assert_array_equal(res.indices,
                                          ref.indices.numpy())
            np.testing.assert_array_equal(res.distances,
                                          ref.distances.numpy())

    @pytest.mark.parametrize("kind", KINDS)
    def test_loop_matches_reference_loop(self, paths, monkeypatch, kind):
        """The port's loop and the reference's, each over its package's
        engine of one artifact, deliver the same ids (the port's LUTs
        patched to the reference's tables), distances to rtol 1e-6
        plus the K-term atol."""
        reqs = _requests(5)
        with ref_serve.ServingLoop(
                ref_serve.Tenant(name="t",
                                 engine=ref_api.load_ann_engine(paths[kind])),
                window_ms=1.0, tile=4) as loop:
            want = [loop.submit(q).result(timeout=60) for q in reqs]

        def build_lut(qs, C):
            return torch.from_numpy(np.array(ref_base.build_lut(
                jnp.asarray(qs.numpy()), jnp.asarray(C.numpy()))))
        monkeypatch.setattr(port_flat, "build_lut", build_lut)
        monkeypatch.setattr(port_ivf, "build_lut", build_lut)
        eng = load_ann_engine(paths[kind], device="cpu")
        with ServingLoop(Tenant(name="t", engine=eng), window_ms=1.0,
                         tile=4) as loop:
            got = [loop.submit(q).result(timeout=60) for q in reqs]
        C = eng.index.C.numpy()
        for q, g, w in zip(reqs, got, want):
            np.testing.assert_array_equal(g.indices, np.asarray(w.indices))
            luts = np.asarray(ref_base.build_lut(jnp.asarray(q),
                                                 jnp.asarray(C)))
            atol = 1e-6 * K * float(np.abs(luts).max())
            np.testing.assert_allclose(g.distances, np.asarray(w.distances),
                                       rtol=1e-6, atol=atol)

    def test_searcher_tenant_parity_and_meta(self, engines):
        """A searcher-backed tenant (an embedding model in front; the
        duck-typed contract ``.engine``, ``.model``, ``.config.serve``)
        serves bitwise what the engine returns on the embedded rows, and
        only the loop's results carry queue_ms/batch_fill."""
        eng = engines["two-step"]
        proj = np.random.default_rng(9).standard_normal(
            (32, D)).astype(np.float32)
        model = types.SimpleNamespace(embed=lambda x: x @ proj)
        serve_cfg = types.SimpleNamespace(batch_tile=4, batch_window_ms=1.0)
        searcher = types.SimpleNamespace(
            engine=eng, model=model,
            config=types.SimpleNamespace(serve=serve_cfg))
        tenant = Tenant.from_searcher("s", searcher)
        assert (tenant.tile, tenant.window_ms) == (4, 1.0)
        q = np.random.default_rng(2).standard_normal((3, 32)).astype(
            np.float32)
        with ServingLoop(tenant) as loop:
            res = loop.search(q, k=5)
        ref = eng.search(model.embed(q), 5)
        np.testing.assert_array_equal(res.indices, ref.indices.numpy())
        np.testing.assert_array_equal(res.distances, ref.distances.numpy())
        assert res.meta.queue_ms is not None and res.meta.queue_ms >= 0
        assert res.meta.batch_fill == pytest.approx(3 / 4)
        assert ref.meta.queue_ms is None and ref.meta.batch_fill is None

    def test_offline_meta_defaults_are_none(self):
        m = ResultMeta()
        assert m.queue_ms is None and m.batch_fill is None

    def test_pipelined_tenant_is_bitwise_identical_to_direct(self, paths):
        """A tenant whose artifact is served pipelined (the loop pins
        its engine to one tile a call) answers what a direct call
        answers."""
        eng = load_ann_engine(paths["two-step"], device="cpu",
                              overrides={"serve.pipeline": "tiles"})
        reqs = _requests(8)
        with ServingLoop(Tenant(name="p", engine=eng), window_ms=1.0,
                         tile=4) as loop:
            results = [loop.submit(q).result(timeout=60) for q in reqs]
        assert "_pipeline_plans" in eng.index.__dict__
        for q, res in zip(reqs, results):
            ref = eng.search(q)
            np.testing.assert_array_equal(res.indices, ref.indices.numpy())
            np.testing.assert_array_equal(res.distances,
                                          ref.distances.numpy())


# --------------------------------------------------------- loop lifecycle --
class TestServingLoopLifecycle:
    def test_close_drains_pending_requests(self, engines):
        loop = ServingLoop(Tenant(name="t", engine=engines["two-step"]),
                           window_ms=10_000.0, tile=32).start()
        q = np.zeros((2, D), np.float32)
        fut = loop.submit(q)
        loop.close()
        res = fut.result(timeout=5)
        assert res.indices.shape == (2, TOPK)
        with pytest.raises(ServeError, match="closed"):
            loop.submit(q)
        loop.close()                           # idempotent
        with pytest.raises(ServeError, match="already started"):
            loop.start().start()
        loop.close()

    def test_never_started_close_serves_inline(self, engines):
        loop = ServingLoop(Tenant(name="t", engine=engines["two-step"]),
                           window_ms=10_000.0, tile=8)
        fut = loop.submit(np.zeros((1, D), np.float32))
        loop.close()
        assert fut.result(timeout=5).indices.shape == (1, TOPK)

    def test_max_queue_backpressure(self, engines):
        loop = ServingLoop(Tenant(name="t", engine=engines["two-step"]),
                           window_ms=10_000.0, tile=32, max_queue=4)
        for _ in range(4):
            loop.submit(np.zeros((1, D), np.float32))
        with pytest.raises(ServeError, match="queue full"):
            loop.submit(np.zeros((1, D), np.float32))
        loop.close()

    def test_submit_validation(self, engines):
        t1 = Tenant(name="a", engine=engines["flat"])
        t2 = Tenant(name="b", engine=engines["two-step"])
        with ServingLoop([t1, t2], window_ms=1.0, tile=4) as loop:
            with pytest.raises(ServeError, match="pass "):
                loop.submit(np.zeros((1, D), np.float32))
            with pytest.raises(ServeError, match="unknown tenant"):
                loop.submit(np.zeros((1, D), np.float32), tenant="zzz")
            with pytest.raises(ServeError, match="d="):
                loop.submit(np.zeros((1, D + 1), np.float32), tenant="a")
            with pytest.raises(ServeError, match="shape"):
                loop.submit(np.zeros((1, 1, D), np.float32), tenant="a")

    def test_engine_failure_fails_only_its_flush(self, engines, paths):
        """An engine exception fails exactly the requests of its flush
        (through their futures); the worker keeps serving."""
        inj = FaultInjector(seed=0, spec=FaultSpec(
            p_raise=1.0, targets=("engine.search",)))
        eng = load_ann_engine(paths["flat"], device="cpu",
                              fault_injector=inj,
                              overrides={"resilience.max_retries": 0})
        good = Tenant(name="good", engine=engines["flat"])
        bad = Tenant(name="bad", engine=eng)
        with ServingLoop([good, bad], window_ms=1.0, tile=4) as loop:
            f_bad = loop.submit(np.zeros((1, D), np.float32), tenant="bad")
            with pytest.raises(RetriesExhausted):
                f_bad.result(timeout=30)
            res = loop.search(np.zeros((1, D), np.float32), tenant="good",
                              timeout=30)
        assert res.indices.shape == (1, TOPK)


# ------------------------------------------------------------ multi-tenant --
class TestTenants:
    def test_parse_tenant_specs_conflicts(self, tmp_path):
        a, b = tmp_path / "a", tmp_path / "b"
        a.mkdir(), b.mkdir()
        assert parse_tenant_specs([f"x={a}", f"y={b}"]) == [
            ("x", str(a)), ("y", str(b))]
        with pytest.raises(ServeError, match="NAME=ARTIFACTS_DIR"):
            parse_tenant_specs(["noequals"])
        with pytest.raises(ServeError, match="duplicate tenant name"):
            parse_tenant_specs([f"x={a}", f"x={b}"])
        with pytest.raises(ServeError, match="both point at"):
            parse_tenant_specs([f"x={a}", f"y={tmp_path}/./a"])

    def test_tenant_name_validation(self, engines):
        with pytest.raises(ServeError, match="name"):
            Tenant(name="", engine=engines["flat"])
        with pytest.raises(ServeError, match="name"):
            Tenant(name="a=b", engine=engines["flat"])
        with pytest.raises(ServeError, match="duplicate"):
            ServingLoop([Tenant(name="a", engine=engines["flat"]),
                         Tenant(name="a", engine=engines["two-step"])])
        with pytest.raises(ServeError, match="Tenant"):
            ServingLoop([engines["flat"]])

    def test_load_tenants_from_artifacts(self, paths):
        """``load_tenants`` opens each spec through ``load_ann_engine``
        on the named device, with the coalescing knobs of its embedded
        ``ServeConfig``; a mesh serves every tenant sharded."""
        tenants = load_tenants([f"f={paths['flat']}",
                                f"i={paths['ivf']}"], device="cpu",
                               overrides={"serve.batch_tile": 8})
        assert sorted(tenants) == ["f", "i"]
        assert tenants["i"].engine.device.type == "cpu"
        assert (tenants["f"].tile, tenants["f"].window_ms) == (8, 2.0)
        assert tenants["i"].d == D
        from repro_torch.distributed import make_mesh_auto
        sharded = load_tenants(
            [f"f={paths['flat']}"],
            mesh=make_mesh_auto((2,), ("data",), devices="cpu"))
        assert sharded["f"].engine._levels() == ("full",)
        assert sharded["f"].engine.device.type == "cpu"

    def test_per_tenant_routing_is_isolated(self, engines):
        t1 = Tenant(name="flat", engine=engines["flat"])
        t2 = Tenant(name="ivf", engine=engines["ivf"])
        q = np.random.default_rng(7).standard_normal((2, D)).astype(
            np.float32)
        with ServingLoop([t1, t2], window_ms=1.0, tile=4) as loop:
            r1 = loop.search(q, tenant="flat")
            r2 = loop.search(q, tenant="ivf")
        np.testing.assert_array_equal(
            r1.indices, engines["flat"].search(q).indices.numpy())
        np.testing.assert_array_equal(
            r2.indices, engines["ivf"].search(q).indices.numpy())


# ----------------------------------------------------- degraded, not broken --
class TestDegradedServing:
    def test_fault_delay_under_deadline_degrades_without_errors(self):
        """Injected stage delays and a tight per-tenant deadline: the
        ladder serves degraded responses; no request errors out."""
        codes, C, structure, _ = _arrays(1)
        inj = FaultInjector(seed=0, spec=FaultSpec(
            p_delay=0.9, delay_ms=15.0, targets=("engine.search",)))
        eng = build_ann_engine(codes, C, structure, topk=TOPK,
                               fault_injector=inj, device="cpu")
        tenant = Tenant(name="t", engine=eng,
                        budget=SearchBudget(deadline_ms=1.0))
        rng = np.random.default_rng(5)
        with inj.installed():
            with ServingLoop(tenant, window_ms=0.5, tile=4) as loop:
                futs = [loop.submit(
                    rng.standard_normal((1, D)).astype(np.float32))
                    for _ in range(12)]
                results = [f.result(timeout=60) for f in futs]
        assert len(results) == 12
        assert all(r.meta is not None for r in results)
        assert any(r.meta.degraded for r in results)
        assert all(r.meta.deadline_ms == 1.0 for r in results)
        assert eng.stats["retries"] == 0 and eng.stats["failovers"] == 0


# ---------------------------------------------------------------- loadgen --
class TestLoadgen:
    def test_poisson_arrivals_seeded_and_bounded(self):
        a = poisson_arrivals(100.0, 2.0, rng=np.random.default_rng(0))
        b = poisson_arrivals(100.0, 2.0, rng=np.random.default_rng(0))
        np.testing.assert_array_equal(a, b)
        assert (a >= 0).all() and (a < 2.0).all()
        assert (np.diff(a) >= 0).all()
        assert 100 < len(a) < 320
        c = poisson_arrivals(100.0, 2.0, rng=np.random.default_rng(9))
        assert not np.array_equal(a, c)
        with pytest.raises(ValueError, match="rate_hz"):
            poisson_arrivals(0.0, 1.0, rng=np.random.default_rng(0))

    def test_make_workload_same_seed_as_reference(self):
        """One seed gives the same request stream as the reference's
        loadgen: arrival times, tenants and query rows."""
        pools = {"b": np.ones((8, D), np.float32) * 2,
                 "a": np.arange(8 * D, dtype=np.float32).reshape(8, D)}
        w1 = make_workload(pools, 80.0, 1.0, rng=np.random.default_rng(4))
        w2 = ref_serve.make_workload(pools, 80.0, 1.0,
                                     rng=np.random.default_rng(4))
        assert len(w1) == len(w2) > 0
        for s1, s2 in zip(w1, w2):
            assert s1.t_arrival == s2.t_arrival
            assert s1.tenant == s2.tenant
            np.testing.assert_array_equal(s1.queries, s2.queries)
        assert {s.tenant for s in w1} <= {"a", "b"}

    def test_open_and_closed_loop_records_and_summary(self, engines):
        pools = {"t": np.asarray(
            np.random.default_rng(1).standard_normal((8, D)), np.float32)}
        work = make_workload(pools, 200.0, 0.2,
                             rng=np.random.default_rng(2))
        with ServingLoop(Tenant(name="t", engine=engines["two-step"]),
                         window_ms=1.0, tile=4) as loop:
            loop.warm()
            t0 = time.time()
            recs = run_open_loop(loop, work)
            wall = time.time() - t0
            closed = run_closed_loop(loop, work[:10], concurrency=3)
        s = summarize(recs, wall_s=wall)
        assert s["requests"] == len(work)
        assert np.isfinite(s["p50_ms"]) and np.isfinite(s["p99_ms"])
        assert s["p50_ms"] <= s["p99_ms"]
        assert s["qps"] > 0 and s["rows_per_s"] >= s["qps"]
        assert 0 < s["mean_batch_fill"] <= 1.0
        assert s["mean_queue_ms"] >= 0
        assert [r["nq"] for r in closed] == [
            w.queries.shape[0] for w in work[:10]]
        assert summarize([], wall_s=1.0)["requests"] == 0
