"""The degradation ladder, retries and fault injection of the port's
``AnnEngine`` held against the reference's, and ``build_ann_engine``.

One artifact per index kind (flat, two-step, IVF), built and saved by
the reference at ``serve.backend="jnp"`` from numpy-seeded arrays, is
loaded by both packages.  With the port's ``build_lut`` patched to the
reference's tables, each rung the port serves on the CPU (flat {full,
crude}; two-step {full, capped, crude}; IVF {full, capped, probes,
crude}) equals the reference's rung: ids equal, distances to rtol 1e-6
plus an atol of 1e-6 times the largest K-term LUT sum (the reference
builds its tables inside its jitted search, where XLA may round the
last bit apart), the number of margin-test passes equal, ``pass_rate``
and ``avg_ops`` to a few ulp (XLA rounds its means and fuses the IVF
multiply-adds in its own order).  ``ResultMeta`` carries the same rung,
stages and flags.

The deadline's choice is driven by EMA values set in the test, not by
timing.  ``FaultInjector`` and ``retry_with_backoff`` are copies of the
reference's and must give the same fault sequence and schedule; an
injected kernel fault is retried in place and counted, never failed
over.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as ref_api
from repro.index import base as ref_base
from repro.resilience import BackoffPolicy as RefBackoffPolicy
from repro.resilience import FaultInjector as RefFaultInjector
from repro.resilience import FaultSpec as RefFaultSpec
from repro.resilience import InjectedFault as RefInjectedFault
from repro.resilience import SearchBudget as RefBudget
from repro.resilience import retry_with_backoff as ref_retry
from repro_torch.api import (Artifacts, ICQConfig, ResilienceConfig,
                             build_ann_engine, load_ann_engine)
from repro_torch.index import flat as port_flat
from repro_torch.index import ivf as port_ivf
from repro_torch.kernels import ops
from repro_torch.kernels.stages import crude_lut_operands
from repro_torch.resilience import (BackoffPolicy, FaultInjector, FaultSpec,
                                    InjectedFault, RetriesExhausted,
                                    SearchBudget, retry_with_backoff)

N, NQ, D, K, M, TOPK = 3000, 16, 16, 8, 256, 10
RUNGS = {"flat": ("full", "crude"),
         "two-step": ("full", "capped", "crude"),
         "ivf": ("full", "capped", "probes", "crude")}
CELLS = [(kind, rung) for kind, rungs in RUNGS.items() for rung in rungs]


def arrays(seed=0):
    """Codes (N, K) uint8, codebooks (K, M, D) f32 and an ICQ structure
    (2 fast codebooks, a margin that passes a few percent) from a numpy
    seed, and their embeddings."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, M, size=(N, K)).astype(np.uint8)
    C = (rng.standard_normal((K, M, D)) / np.sqrt(K)).astype(np.float32)
    structure = (np.ones(D, bool), np.arange(K) < 2, np.float32(2.0))
    emb = C[np.arange(K)[None, :], codes.astype(np.int64)].sum(axis=1)
    return codes, C, structure, emb.astype(np.float32)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """One reference-saved artifact per index kind, and the queries."""
    from repro.core import icq as ref_icq
    root = tmp_path_factory.mktemp("ladder")
    codes, C, structure, emb = arrays()
    st = ref_icq.ICQStructure(*(jnp.asarray(a) for a in structure))
    paths = {}
    for kind in RUNGS:
        cfg = ref_api.ICQConfig().with_overrides({
            "train.d": D, "train.num_codebooks": K,
            "train.codebook_size": M, "index.kind": kind,
            "index.n_lists": 8, "index.n_probe": 4,
            "index.kmeans_iters": 8, "serve.topk": TOPK,
            "serve.backend": "jnp"})
        idx = ref_api.build_index(
            jnp.asarray(codes), jnp.asarray(C), st, index_cfg=cfg.index,
            serve_cfg=cfg.serve, emb_db=jnp.asarray(emb),
            key=jax.random.PRNGKey(9))
        paths[kind] = str(root / kind)
        ref_api.Artifacts(config=cfg, index=idx).save(paths[kind])
    q = np.random.default_rng(42).standard_normal((NQ, D)).astype(np.float32)
    return q, paths


def _reference_luts(monkeypatch):
    def build_lut(qs, C):
        return torch.tensor(np.asarray(ref_base.build_lut(
            jnp.asarray(qs.numpy()), jnp.asarray(C.numpy()))))
    monkeypatch.setattr(port_flat, "build_lut", build_lut)
    monkeypatch.setattr(port_ivf, "build_lut", build_lut)


def _atol(q, path):
    C = jnp.asarray(ref_api.Artifacts.load(path).index.C)
    luts = ref_base.build_lut(jnp.asarray(q), C)
    return 1e-6 * luts.shape[1] * float(jnp.abs(luts).max())


def assert_same_answers(got, want, q, path, *, n_cand=None):
    """ids equal, distances to rtol 1e-6 plus the K-term atol, equal
    pass counts, pass_rate and avg_ops to a few ulp."""
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_allclose(got.distances.numpy(),
                               np.asarray(want.distances), rtol=1e-6,
                               atol=_atol(q, path))
    ulp = 2.0 ** -23
    np.testing.assert_allclose(float(got.pass_rate), float(want.pass_rate),
                               rtol=4 * ulp, atol=1e-30)
    np.testing.assert_allclose(float(got.avg_ops), float(want.avg_ops),
                               rtol=4 * ulp)
    if n_cand is not None:
        passes = [round(float(r.pass_rate) * n_cand) for r in (got, want)]
        assert passes[0] == passes[1]


# ------------------------------------------------------------- rungs ----

@pytest.mark.parametrize("kind,rung", CELLS)
def test_rung_matches_reference_jnp(artifacts, monkeypatch, kind, rung):
    """Each rung the port serves on the CPU, forced by the budget, equals
    the reference's rung under ``backend="jnp"`` on one artifact, with
    the same ``ResultMeta``."""
    q, paths = artifacts
    want = ref_api.load_ann_engine(paths[kind]).search(
        jnp.asarray(q), budget=RefBudget(force_level=rung))
    _reference_luts(monkeypatch)
    engine = load_ann_engine(paths[kind], device="cpu")
    assert engine._levels() == RUNGS[kind]
    got = engine.search(q, budget=SearchBudget(force_level=rung))
    assert_same_answers(got, want, q, paths[kind],
                        n_cand=None if kind == "ivf" else NQ * N)
    for field in ("level", "level_name", "degraded", "stages",
                  "coverage"):
        assert getattr(got.meta, field) == getattr(want.meta, field), field
    assert got.meta.backend == "torch" and got.meta.wall_ms > 0.0
    if kind != "flat" and rung != "crude":
        assert 0.0 < float(got.pass_rate) < 1.0
    if rung == "crude" and kind != "flat":
        assert float(got.pass_rate) == 0.0


@pytest.mark.parametrize("kind", ["flat", "two-step", "ivf"])
def test_crude_rung_equals_full_path_candidates(artifacts, kind):
    """A crude-only budget serves bit for bit the index's
    ``search_crude`` and the crude top-k the full path bootstraps its
    threshold from (the crude stage's candidate list, ids mapped through
    the slab for IVF)."""
    q, paths = artifacts
    engine = load_ann_engine(paths[kind], device="cpu")
    r = engine.search(q, budget=SearchBudget(allow_refine=False))
    assert r.meta.level_name == "crude" and r.meta.degraded
    qt = torch.from_numpy(q)
    ref = engine.index.search_crude(qt)
    assert torch.equal(r.indices, ref.indices)
    assert torch.equal(r.distances, ref.distances)
    index = engine.index
    luts = port_flat.build_lut(qt, index.C)
    if kind == "flat":
        want = index.search(qt)
        assert torch.equal(r.indices, want.indices)
        return
    lf, _, _ = crude_lut_operands(luts, index.structure.fast_mask,
                                  quantized=False)
    if kind == "two-step":
        _, vals, idx = ops.batched_crude_topk(index.codes, lf, TOPK)
        assert torch.equal(r.indices, idx) and torch.equal(r.distances,
                                                           vals)
        return
    probes = port_ivf.coarse_probe(qt, index.ivf.centroids, index.n_probe)
    cand_ids, cand_codes = port_ivf.gather_candidates(
        probes, index.ivf.lists, index.list_codes, TOPK)
    _, vals, pos = ops.ivf_crude_topk(cand_codes, cand_ids, lf, TOPK)
    safe = torch.where(cand_ids >= 0, cand_ids, torch.zeros_like(cand_ids))
    assert torch.equal(r.indices, safe.gather(1, pos.long()))
    assert torch.equal(r.distances, vals)


def test_probes_rung_is_full_search_at_half_the_probes(artifacts):
    """The probes rung halves ``n_probe`` (4 -> 2, floored at
    ``resilience.min_n_probe``) and serves the full two-step there;
    ``max_n_probe`` clamps it."""
    q, paths = artifacts
    engine = load_ann_engine(paths["ivf"], device="cpu")
    r = engine.search(q, budget=SearchBudget(force_level="probes"))
    half = load_ann_engine(paths["ivf"], device="cpu",
                           overrides={"index.n_probe": 2}).search(q)
    assert torch.equal(r.indices, half.indices)
    assert torch.equal(r.distances, half.distances)
    r = engine.search(q, budget=SearchBudget(max_n_probe=1))
    assert r.meta.level_name == "probes"
    one = load_ann_engine(paths["ivf"], device="cpu",
                          overrides={"index.n_probe": 1}).search(q)
    assert torch.equal(r.indices, one.indices)
    floor = load_ann_engine(paths["ivf"], device="cpu")
    floor.resilience = ResilienceConfig(min_n_probe=3)
    assert floor._level_index("probes", SearchBudget()).n_probe == 3


def test_ladder_caps_promote_rungs(artifacts):
    q, paths = artifacts
    engine = load_ann_engine(paths["ivf"], device="cpu")
    capped = engine.search(q, budget=SearchBudget(refine_cap=32))
    assert capped.meta.level_name == "capped"
    assert capped.meta.stages == ("probe", "crude", "refine-capped")
    probes = engine.search(q, budget=SearchBudget(max_n_probe=2))
    assert probes.meta.level_name == "probes"
    full = engine.search(q)
    assert full.meta.level_name == "full" and full.meta.stages == \
        ("probe", "crude", "refine")
    assert not full.meta.degraded
    with pytest.raises(ValueError, match="not servable"):
        load_ann_engine(paths["flat"], device="cpu").search(
            q, budget=SearchBudget(force_level="capped"))


def test_deadline_picks_rung_from_ema(artifacts):
    """The deadline's choice from the warm-time EMAs (set here, so the
    choice is deterministic): the least degraded rung whose estimate
    fits, a rung without one inheriting the best less degraded estimate,
    the crude floor when nothing fits; no deadline serves full."""
    q, paths = artifacts
    engine = load_ann_engine(paths["two-step"], device="cpu")
    pick = engine._pick_level
    assert pick(SearchBudget(deadline_ms=1.0)) == "full"    # cold: optimistic
    engine._ema.update(full=50.0, capped=20.0, crude=2.0)
    assert pick(SearchBudget()) == "full"
    assert pick(SearchBudget(deadline_ms=100.0)) == "full"
    assert pick(SearchBudget(deadline_ms=30.0)) == "capped"
    assert pick(SearchBudget(deadline_ms=5.0)) == "crude"
    assert pick(SearchBudget(deadline_ms=1.0)) == "crude"
    assert pick(SearchBudget(deadline_ms=1e9, allow_refine=False)) == "crude"
    del engine._ema["capped"]
    assert pick(SearchBudget(deadline_ms=30.0)) == "crude"
    engine._ema["capped"] = 20.0
    engine.resilience = ResilienceConfig(deadline_ms=30.0)
    r = engine.search(q)
    assert r.meta.level_name == "capped" and r.meta.deadline_ms == 30.0
    assert r.meta.degraded and engine.stats["degraded"] == 1


def test_ema_takes_warm_batches_only(artifacts):
    """A rung's first batch is not timed into its EMA; later batches are,
    with weight 0.3."""
    q, paths = artifacts
    engine = load_ann_engine(paths["two-step"], device="cpu")
    engine.search(q)
    assert "full" not in engine._ema
    w1 = engine.search(q).meta.wall_ms
    assert engine._ema["full"] == w1
    w2 = engine.search(q).meta.wall_ms
    assert engine._ema["full"] == pytest.approx(0.7 * w1 + 0.3 * w2)
    warm = load_ann_engine(paths["two-step"], device="cpu").warm(NQ)
    w = warm.search(q).meta.wall_ms
    assert warm._ema["full"] == w


def test_meta_attached_and_wall_measured(artifacts):
    q, paths = artifacts
    engine = load_ann_engine(paths["two-step"], device="cpu")
    r = engine.search(q)
    assert r.meta is not None and r.meta.wall_ms > 0.0
    assert r.meta.coverage == 1.0 and r.meta.backend == "torch"
    assert r.meta.level == 0 and not r.meta.deadline_exceeded
    assert engine.stats["full"] == 1 and engine.stats["retries"] == 0
    assert engine.stats["failovers"] == 0


# ------------------------------------------------ faults and retries ----

def _fates(injector_cls, fault_cls, seed, spec):
    inj = injector_cls(seed=seed, spec=spec, sleep=lambda s: None)
    fates = []
    for i in range(60):
        try:
            inj.check(f"kernels.stage{i % 3}")
            fates.append("ok")
        except fault_cls:
            fates.append("raise")
    return fates, dict(inj.counts)


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_fault_sequence_matches_reference(seed):
    """Same seed and spec: the same raise/delay/corrupt draws, counts and
    byte flips as the reference's injector."""
    kw = dict(p_raise=0.3, p_delay=0.2, p_corrupt=0.1, delay_ms=0.0,
              targets=("kernels.stage0", "kernels.stage2"))
    got = _fates(FaultInjector, InjectedFault, seed, FaultSpec(**kw))
    want = _fates(RefFaultInjector, RefInjectedFault, seed,
                  RefFaultSpec(**kw))
    assert got == want and "raise" in got[0]
    a = np.arange(97, dtype=np.float32)
    np.testing.assert_array_equal(
        FaultInjector(seed=seed).corrupt_array(a),
        RefFaultInjector(seed=seed).corrupt_array(a))


def test_retry_schedule_matches_reference():
    kw = dict(max_retries=3, base_ms=10.0, max_ms=25.0)
    pol, ref_pol = BackoffPolicy(**kw), RefBackoffPolicy(**kw)
    assert [pol.delay_ms(i) for i in range(5)] == \
        [ref_pol.delay_ms(i) for i in range(5)] == [10.0, 20.0, 25.0,
                                                    25.0, 25.0]
    for retry, policy in ((retry_with_backoff, pol), (ref_retry, ref_pol)):
        calls, slept, seen = {"n": 0}, [], []

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise OSError("transient")
            return "ok"
        assert retry(flaky, policy=policy, sleep=slept.append,
                     on_retry=lambda a, e, d: seen.append((a, d))) == "ok"
        assert calls["n"] == 3 and slept == [0.01, 0.02]
        assert seen == [(0, 10.0), (1, 20.0)]

    def always():
        raise OSError("down")
    with pytest.raises(RetriesExhausted) as ei:
        retry_with_backoff(always, policy=BackoffPolicy(max_retries=1),
                           sleep=lambda s: None)
    assert isinstance(ei.value.__cause__, OSError)


def _raise_then_pass_seed(p: float) -> int:
    """The first seed whose injector raises on its first check and not on
    its second (each check draws three uniforms: raise, delay, corrupt)."""
    for seed in range(1000):
        u = np.random.default_rng(seed).random(6)
        if u[0] < p <= u[3]:
            return seed
    raise AssertionError("no seed found")


@pytest.mark.parametrize("kind", ["two-step", "ivf"])
def test_kernel_fault_is_retried_and_counted(artifacts, kind):
    """A fault injected at the crude kernel's stage fails the first
    attempt; the engine retries the batch in place (no failover),
    counts the retry and serves the clean engine's answer."""
    q, paths = artifacts
    stage = ("kernels.batched_crude_topk" if kind == "two-step"
             else "kernels.ivf_crude_topk")
    clean = load_ann_engine(paths[kind], device="cpu").search(q)
    inj = FaultInjector(seed=_raise_then_pass_seed(0.5),
                        spec=FaultSpec(p_raise=0.5, targets=(stage,)))
    engine = load_ann_engine(paths[kind], device="cpu")
    engine.resilience = ResilienceConfig(max_retries=1,
                                         backoff_base_ms=0.001)
    with inj.installed():
        r = engine.search(q)
    assert inj.counts == {f"{stage}:raise": 1}
    assert engine.stats["retries"] == 1 and engine.stats["failovers"] == 0
    assert r.meta.backend == "torch"
    assert torch.equal(r.indices, clean.indices)
    assert torch.equal(r.distances, clean.distances)
    assert ops._FAULT_HOOK is None


def test_permanent_fault_exhausts_retries(artifacts):
    """A fault at every attempt: one attempt, then 1 + max_retries
    retries (the reference's count), each retry counted, then
    ``RetriesExhausted`` chained to the injected fault; with
    ``max_retries=0`` the batch is tried twice."""
    q, paths = artifacts
    for retries in (0, 2):
        inj = FaultInjector(seed=0, spec=FaultSpec(
            p_raise=1.0, targets=("engine.search",)))
        engine = load_ann_engine(paths["flat"], device="cpu",
                                 fault_injector=inj)
        engine.resilience = ResilienceConfig(max_retries=retries,
                                             backoff_base_ms=0.001)
        with pytest.raises(RetriesExhausted) as ei:
            engine.search(q)
        assert isinstance(ei.value.__cause__, InjectedFault)
        assert inj.counts == {"engine.search:raise": retries + 2}
        assert engine.stats["retries"] == retries + 1
        assert engine.stats["failovers"] == 0


def _fault_outcome(engine, inj, q):
    try:
        engine.search(q)
        outcome = "served"
    except RuntimeError as e:
        assert "attempt(s) failed" in str(e)
        outcome = "raised"
    return outcome, dict(inj.counts)


@pytest.mark.parametrize("fault,retries", [("permanent", 0),
                                           ("permanent", 2),
                                           ("transient", 0)])
def test_attempts_match_reference(artifacts, fault, retries):
    """The same seeded injector at ``engine.search`` and the same
    ``ResilienceConfig`` give both packages the same attempts: equal
    ``inj.counts`` and the same outcome, served or raised.  A transient
    fault (the first check raises, the second passes) is served even at
    ``max_retries=0``; a permanent one raises after 2 + max_retries."""
    q, paths = artifacts
    seed, p = (0, 1.0) if fault == "permanent" else (
        _raise_then_pass_seed(0.5), 0.5)
    res = dict(max_retries=retries, backoff_base_ms=0.001)
    ref_inj = RefFaultInjector(seed=seed, spec=RefFaultSpec(
        p_raise=p, targets=("engine.search",)))
    ref_engine = ref_api.load_ann_engine(paths["flat"],
                                         fault_injector=ref_inj)
    ref_engine.resilience = ref_api.ResilienceConfig(**res)
    inj = FaultInjector(seed=seed, spec=FaultSpec(
        p_raise=p, targets=("engine.search",)))
    engine = load_ann_engine(paths["flat"], device="cpu",
                             fault_injector=inj)
    engine.resilience = ResilienceConfig(**res)
    got = _fault_outcome(engine, inj, q)
    assert got == _fault_outcome(ref_engine, ref_inj, q)
    assert got[0] == ("served" if fault == "transient" else "raised")
    assert engine.stats["retries"] == got[1]["engine.search:raise"] - (
        fault == "permanent")


def test_refused_argument_is_not_retried(artifacts):
    """A ``ValueError`` (a refused argument, not a failed batch) raises at
    once, unwrapped and uncounted, whatever ``max_retries`` says."""
    q, paths = artifacts
    engine = load_ann_engine(paths["two-step"], device="cpu")
    assert engine.resilience.max_retries == 2
    with pytest.raises(ValueError, match="filter must be a"):
        engine.search(q, filter=np.ones(N - 1, bool))
    with pytest.raises(ValueError, match="not servable"):
        engine.search(q, budget=SearchBudget(force_level="probes"))
    assert engine.stats["retries"] == 0


def test_every_kernel_op_checks_its_stage():
    """The fault hook fires at each kernel op's stage, as the
    reference's ``kernels.ops`` names them, before any work."""
    seen = []
    hook = seen.append
    prev = ops.set_fault_hook(hook)
    try:
        codes = torch.zeros((4, 2), dtype=torch.uint8)
        lut = torch.zeros((2, 16))
        ops.adc(codes, lut)
        ops.two_step(codes, lut, torch.tensor([True, False]), 0.0)
        lf = torch.zeros((1, 32))
        ops.batched_crude_topk(codes, lf, 2)
        ops.batched_refine_topk(codes, lf, torch.zeros((1, 4)),
                                torch.zeros(1), 2)
        ops.fastscan_crude_topk(codes[:, :1], lf, 2)
        slab, ids = codes[None], torch.zeros((1, 4), dtype=torch.int32)
        ops.ivf_crude_topk(slab, ids, lf, 2)
        ops.ivf_fastscan_crude_topk(slab[:, :, :1], ids, lf, 2)
        ops.ivf_refine_topk(slab, lf, torch.zeros((1, 4)), torch.zeros(1),
                            2)
        x = torch.zeros((4, 8))
        ops.kmeans_assign(x, torch.zeros((2, 8)))
        ops.icm_encode(x, torch.zeros((4, 2), dtype=torch.int32),
                       torch.zeros((2, 16, 8)), iters=1)
        t = torch.zeros((1, 4, 2, 8))
        ops.flash_attention(t, t, t)
    finally:
        assert ops.set_fault_hook(prev) is hook
    assert seen == ["kernels." + s for s in (
        "adc", "two_step", "batched_crude_topk", "batched_refine_topk",
        "fastscan_crude_topk", "ivf_crude_topk", "ivf_fastscan_crude_topk",
        "ivf_refine_topk", "kmeans_assign", "icm_encode",
        "flash_attention")]


# ------------------------------------------------------ front door ----

@pytest.mark.parametrize("kind", ["flat", "two-step"])
def test_build_ann_engine_equals_load_ann_engine(artifacts, kind):
    """The kwarg front door over the artifact's arrays serves what
    ``load_ann_engine`` serves from the artifact, bit for bit, at every
    rung."""
    q, paths = artifacts
    codes, C, structure, _ = arrays()
    built = build_ann_engine(codes, C, structure, topk=TOPK, index=kind,
                             backend="jnp", device="cpu")
    loaded = load_ann_engine(paths[kind], device="cpu")
    assert built._levels() == loaded._levels()
    for rung in built._levels():
        b = built.search(q, budget=SearchBudget(force_level=rung))
        w = loaded.search(q, budget=SearchBudget(force_level=rung))
        assert torch.equal(b.indices, w.indices), rung
        assert torch.equal(b.distances, w.distances), rung
        assert float(b.pass_rate) == float(w.pass_rate)


def test_build_ann_engine_ivf_round_trips(tmp_path, artifacts):
    """An IVF engine from the front door (its own k-means, seeded) serves
    what its saved and reloaded artifact serves, bit for bit; ``mesh``
    serves the full rung of the list-sharded index, equal to it, and
    ``pipeline`` serves what the sequential path serves over the same
    tiles."""
    q, _ = artifacts
    codes, C, structure, emb = arrays()
    built = build_ann_engine(codes, C, structure, topk=TOPK, index="ivf",
                             emb_db=emb, n_lists=8, n_probe=4,
                             generator=5, refine_cap=40, device="cpu")
    assert built.index.n_probe == 4 and built.index.refine_cap == 40
    cfg = ICQConfig().with_overrides({
        "train.d": D, "train.num_codebooks": K, "train.codebook_size": M,
        "index.kind": "ivf", "index.n_lists": 8, "index.n_probe": 4,
        "index.refine_cap": 40, "serve.topk": TOPK})
    Artifacts(config=cfg, index=built.index).save(str(tmp_path / "ivf"))
    loaded = load_ann_engine(str(tmp_path / "ivf"), device="cpu")
    for rung in built._levels():
        b = built.search(q, budget=SearchBudget(force_level=rung))
        w = loaded.search(q, budget=SearchBudget(force_level=rung))
        assert torch.equal(b.indices, w.indices), rung
        assert torch.equal(b.distances, w.distances), rung
    from repro_torch.distributed import make_mesh_auto
    sharded = build_ann_engine(
        codes, C, structure, topk=TOPK, index="ivf", emb_db=emb, n_lists=8,
        n_probe=4, generator=5, refine_cap=40,
        mesh=make_mesh_auto((4,), ("data",), devices="cpu"))
    assert sharded._levels() == ("full",)
    s, b = sharded.search(q), built.search(q)
    assert torch.equal(s.indices, b.indices)
    assert torch.equal(s.distances, b.distances)
    piped = build_ann_engine(codes, C, structure, topk=TOPK, index="ivf",
                             emb_db=emb, n_lists=8, n_probe=4,
                             generator=5, device="cpu", pipeline="tiles",
                             pipeline_tile=NQ)
    assert piped.index.pipeline == "tiles"
    plain = build_ann_engine(codes, C, structure, topk=TOPK, index="ivf",
                             emb_db=emb, n_lists=8, n_probe=4,
                             generator=5, device="cpu", query_chunk=NQ)
    b, w = piped.search(q), plain.search(q)
    assert torch.equal(b.indices, w.indices)
    assert torch.equal(b.distances, w.distances)
