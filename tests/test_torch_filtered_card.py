"""``filter=`` and ``refine_cap`` on the card's composition, run on the
CPU with each kernel's plain version in the kernel's place, held
against the reference's jnp engine.

On the card ``serve.backend="jnp"`` resolves to "cuda-jnp": the
hand-written kernels with the jnp engine's options.  Here
``card_route`` makes the port take that route on CPU tensors: every
module's ``resolve_backend`` answers as it would for a CUDA device,
``ops._on_card`` is true, and each search kernel's ``*_cuda`` wrapper is
its plain ``*_torch`` version counting ``build.LAUNCHES`` as the kernel
would (``crude_topk_pred`` for the row-predicate crude).  The launch
counts show which kernels the card would run.

Artifacts as in ``tests/test_torch_filtered.py``: built and saved by
the reference at ``serve.backend="jnp"`` from numpy-seeded arrays (flat
f32, two-step f32 / int8, two-step int8 over 4-bit codes, IVF f32 /
int8), the port's ``build_lut`` patched to the reference's tables.  Ids
equal (-1 in the slots no eligible row fills), +inf in the same slots,
distances to rtol 1e-6 plus an atol of 1e-6 times the largest K-term LUT
sum, ``pass_rate`` and ``avg_ops`` to a few ulp.  Filters: half the
rows, none, all and three rows (fewer than topk: the flat bootstrap's
+inf slots, which the reference's dense rule ranks by their finite
full-table sums).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as ref_api
from repro.index import base as ref_base
from repro.index import flat as ref_flat_mod
from repro.kernels import stages as ref_stages
from repro_torch.api import load_ann_engine
from repro_torch.api import serving as port_serving
from repro_torch.api import session as port_session
from repro_torch import index as port_index
from repro_torch.index import base as port_base
from repro_torch.index import flat as port_flat
from repro_torch.index import ivf as port_ivf
from repro_torch.index import pipelined as port_pipelined
from repro_torch.index import sharded as port_sharded
from repro_torch.kernels import batched_search as bs
from repro_torch.kernels import build, ops
from repro_torch.resilience import SearchBudget

N, NQ, D, K, TOPK = 2000, 12, 16, 8, 10
# (kind, lut_dtype, code_bits); 4-bit codes need m <= 16
CELLS = [("flat", "f32", 8), ("two-step", "f32", 8), ("two-step", "int8", 8),
         ("two-step", "int8", 4), ("ivf", "f32", 8), ("ivf", "int8", 8)]
FILTERS = ["half", "none", "all", "three"]
KERNELS = ("crude_topk", "refine_topk", "ivf_crude_topk", "ivf_refine_topk",
           "select_topk", "rerank_topk")


def arrays(m, seed=1):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, m, size=(N, K)).astype(np.uint8)
    C = (rng.standard_normal((K, m, D)) / np.sqrt(K)).astype(np.float32)
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
    root = tmp_path_factory.mktemp("filtered_card")
    paths = {}
    for kind, lut, bits in CELLS:
        codes, C, structure, emb = arrays(16 if bits == 4 else 256)
        st = ref_icq.ICQStructure(*(jnp.asarray(a) for a in structure))
        cfg = ref_api.ICQConfig().with_overrides({
            "train.d": D, "train.num_codebooks": K,
            "train.codebook_size": C.shape[1], "index.kind": kind,
            "index.code_bits": bits, "index.n_lists": 8,
            "index.n_probe": 3, "index.kmeans_iters": 8,
            "serve.topk": TOPK, "serve.backend": "jnp",
            "serve.lut_dtype": lut})
        idx = ref_api.build_index(
            jnp.asarray(codes), jnp.asarray(C), st, index_cfg=cfg.index,
            serve_cfg=cfg.serve, emb_db=jnp.asarray(emb),
            key=jax.random.PRNGKey(4))
        paths[(kind, lut, bits)] = str(root / f"{kind}-{lut}-{bits}")
        ref_api.Artifacts(config=cfg, index=idx).save(
            paths[(kind, lut, bits)])
    q = np.random.default_rng(43).standard_normal((NQ, D)).astype(np.float32)
    return q, paths


@pytest.fixture(scope="module")
def reference():
    """One reference engine per (artifact, refine_cap), loaded once: its
    compiled searches serve every filter of a shape."""
    engines = {}

    def get(path, cap=None):
        key = (path, cap)
        if key not in engines:
            over = None if cap is None else {"index.refine_cap": cap}
            engines[key] = ref_api.load_ann_engine(path, overrides=over)
        return engines[key]
    return get


def card_route(monkeypatch):
    """The card's route on CPU tensors (module docstring)."""
    real = port_base.resolve_backend

    def resolve(backend, device):
        return real(backend, torch.device("cuda"))
    for mod in (port_flat, port_ivf, port_pipelined, port_sharded,
                port_serving, port_session, port_index):
        monkeypatch.setattr(mod, "resolve_backend", resolve)
    monkeypatch.setattr(ops, "_on_card", lambda t: True)

    def counted(name, fn, key=None):
        def launch(*args, **kw):
            build.LAUNCHES[key(kw) if key else name] += 1
            return fn(*args, **kw)
        return launch
    for name in KERNELS:
        key = ((lambda kw: "crude_topk" if kw.get("pred") is None
                else "crude_topk_pred") if name == "crude_topk" else None)
        monkeypatch.setattr(bs, f"{name}_cuda",
                            counted(name, getattr(bs, f"{name}_torch"), key))
    for k in build.LAUNCHES:
        monkeypatch.setitem(build.LAUNCHES, k, 0)


def reference_luts(monkeypatch):
    def build_lut(qs, C):
        return torch.tensor(np.asarray(ref_base.build_lut(
            jnp.asarray(qs.numpy()), jnp.asarray(C.numpy()))))
    monkeypatch.setattr(port_flat, "build_lut", build_lut)
    monkeypatch.setattr(port_ivf, "build_lut", build_lut)


def launched() -> dict:
    out = {k: v for k, v in build.LAUNCHES.items() if v}
    for k in build.LAUNCHES:
        build.LAUNCHES[k] = 0
    return out


def assert_same_answers(got, want, luts):
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
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


def _luts(q, ref_index):
    return ref_base.build_lut(jnp.asarray(q), ref_index.C)


# ------------------------------------------------------ the plain versions --

@pytest.mark.parametrize("lut_dtype,code_bits", [("f32", 8), ("int8", 8),
                                                 ("int8", 4), ("f32", 4)])
@pytest.mark.parametrize("filt", ["half", "three"])
def test_predicate_crude_plain_matches_reference(lut_dtype, code_bits, filt):
    """The row-predicate crude's plain version against the reference's
    filtered ``CrudeStage`` crude, bit for bit; its candidate list is
    ``lax.top_k`` of the masked crude, the +inf slots holding the lowest
    filtered rows in order."""
    m = 16 if code_bits == 4 else 256
    codes, C, structure, _ = arrays(m)
    fast = jnp.asarray(structure[1])
    q = np.random.default_rng(7).standard_normal((NQ, D)).astype(np.float32)
    luts = ref_base.build_lut(jnp.asarray(q), jnp.asarray(C))
    stored = codes
    if code_bits == 4:
        from repro.core.encode import pack_nibbles
        stored = np.asarray(pack_nibbles(jnp.asarray(codes), K))
    pred = predicate(filt)
    quant = lut_dtype == "int8"
    want = ref_stages.CrudeStage(backend="jnp", quantized=quant,
                                 code_bits=code_bits)(
        jnp.asarray(stored), luts, fast, pred=jnp.asarray(pred)).crude
    lf, sc, of = ref_stages.crude_lut_operands(luts, fast, quantized=quant,
                                               code_bits=code_bits)
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))
    crude, vals, idx = bs.crude_topk_torch(
        t(stored), t(lf), TOPK, t(sc), t(of), code_bits=code_bits,
        pred=torch.from_numpy(pred))
    np.testing.assert_array_equal(crude.numpy(), np.asarray(want))
    neg, top = jax.lax.top_k(-want, TOPK)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(top))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(-neg))
    if filt == "three":
        np.testing.assert_array_equal(
            idx.numpy()[:, 3:], np.tile([0, 1, 2, 3, 4, 5, 6], (NQ, 1)))


@pytest.mark.parametrize("cap", [TOPK, 700, N])
@pytest.mark.parametrize("filt", ["half", "three", "all"])
def test_select_plain_matches_reference_compaction(cap, filt):
    """The survivor selection's plain version against the survivors the
    reference's compaction (``_two_step_block_compact``: its filtered
    crude, ``from_dense`` threshold, ``lax.top_k`` of the masked crude)
    keeps; the re-rank's plain version against its full-table sum."""
    codes, C, structure, _ = arrays(256)
    fast = jnp.asarray(structure[1])
    q = np.random.default_rng(9).standard_normal((NQ, D)).astype(np.float32)
    luts = ref_base.build_lut(jnp.asarray(q), jnp.asarray(C))
    pred = jnp.asarray(predicate(filt))
    crude = ref_stages.CrudeStage(backend="jnp")(
        jnp.asarray(codes), luts, fast, pred=pred).crude
    thr = ref_stages.ThresholdStage(topk=TOPK).from_dense(
        luts, jnp.asarray(codes).astype(jnp.int32), crude, fast,
        jnp.float32(2.0))
    masked = jnp.where(crude < thr[:, None], crude, jnp.inf)
    neg_s, surv = jax.lax.top_k(-masked, cap)
    vals, idx = ops.select_topk(torch.from_numpy(np.array(crude)),
                                torch.from_numpy(np.array(thr)), cap)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(surv))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(-neg_s))
    valid = jnp.isfinite(-neg_s)
    full = ref_base.lut_sum(luts, jnp.take(jnp.asarray(codes).astype(
        jnp.int32), surv, axis=0))
    neg, pos = jax.lax.top_k(-jnp.where(valid, full, jnp.inf), TOPK)
    dist, got_pos = ops.rerank_topk(
        torch.from_numpy(codes[np.asarray(surv)]),
        torch.from_numpy(np.array(luts)).reshape(NQ, -1),
        torch.from_numpy(np.array(valid)), TOPK)
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(pos))
    np.testing.assert_array_equal(dist.numpy(), np.asarray(-neg))


# ------------------------------------------------------------ end to end --

def _expected_launches(kind, *, filtered, capped=False, crude_only=False):
    if kind == "ivf":
        want = {"ivf_crude_topk": 1}
        if not crude_only:
            want.update({"select_topk": 1, "rerank_topk": 1} if capped
                        else {"ivf_refine_topk": 1})
        return want
    want = {"crude_topk_pred" if filtered else "crude_topk": 1}
    if kind == "two-step" and not crude_only:
        want.update({"select_topk": 1, "rerank_topk": 1} if capped
                    else {"refine_topk": 1})
    return want


@pytest.mark.parametrize("kind,lut,bits", CELLS)
def test_filtered_card_route_matches_reference_jnp(artifacts, reference,
                                                   monkeypatch, kind, lut,
                                                   bits):
    """Each filter through ``AnnEngine.search`` at ``serve.backend="jnp"``
    on the card's route (one crude launch, the row-predicate instance on
    the flat kinds, and one refine), equal to the reference's jnp
    engine; no filtered row returned."""
    q, paths = artifacts
    ref_engine = reference(paths[(kind, lut, bits)])
    card_route(monkeypatch)
    reference_luts(monkeypatch)
    engine = load_ann_engine(paths[(kind, lut, bits)], device="cpu")
    assert engine.backend == "cuda-jnp"
    for filt in FILTERS:
        pred = predicate(filt)
        want = ref_engine.search(jnp.asarray(q), filter=jnp.asarray(pred))
        launched()
        got = engine.search(q, filter=pred)
        assert launched() == _expected_launches(kind, filtered=True), filt
        assert_same_answers(got, want, _luts(q, ref_engine.index))
        ids = got.indices.numpy()
        assert pred[ids[ids >= 0]].all(), filt
        if filt == "none":
            assert (ids == -1).all()
        if filt == "three":
            assert (ids[:, 3:] == -1).all()


@pytest.mark.parametrize("filt", ["half", "three"])
@pytest.mark.parametrize("kind,lut,bits", [("two-step", "int8", 4),
                                           ("ivf", "int8", 8)])
def test_filtered_crude_rung_on_card_route(artifacts, reference, monkeypatch,
                                           kind, lut, bits, filt):
    """The crude rung filtered (``SearchBudget(force_level="crude")``):
    the crude kernel alone, equal to the reference's ``search_crude``."""
    q, paths = artifacts
    ref_index = reference(paths[(kind, lut, bits)]).index
    pred = predicate(filt)
    want = ref_index.search_crude(jnp.asarray(q), filter=jnp.asarray(pred))
    card_route(monkeypatch)
    reference_luts(monkeypatch)
    engine = load_ann_engine(paths[(kind, lut, bits)], device="cpu")
    got = engine.search(q, budget=SearchBudget(force_level="crude"),
                        filter=pred)
    assert got.meta.level_name == "crude"
    assert launched() == _expected_launches(kind, filtered=True,
                                            crude_only=True)
    assert_same_answers(got, want, _luts(q, ref_index))


@pytest.mark.parametrize("kind,lut,bits,cap", [
    ("two-step", "f32", 8, 20), ("two-step", "int8", 8, 20),
    ("two-step", "int8", 4, 20), ("ivf", "f32", 8, 20), ("ivf", "int8", 8, 20),
    ("two-step", "f32", 8, N), ("ivf", "int8", 8, N)])
def test_refine_cap_card_route_matches_reference_jnp(artifacts, reference,
                                                     monkeypatch, kind, lut,
                                                     bits, cap):
    """``index.refine_cap`` (clamped into [topk, n], IVF [topk, nc]) on
    the card's route, with and without a filter: the survivor selection
    and the re-rank, equal to the reference's jnp engine; the capped
    rung through ``SearchBudget(refine_cap=)`` equal to it too."""
    q, paths = artifacts
    path = paths[(kind, lut, bits)]
    ref_engine = reference(path, cap)
    card_route(monkeypatch)
    reference_luts(monkeypatch)
    engine = load_ann_engine(path, device="cpu",
                             overrides={"index.refine_cap": cap})
    for filt in (None, "three"):
        pred = None if filt is None else predicate(filt)
        want = ref_engine.search(
            jnp.asarray(q), filter=None if pred is None else jnp.asarray(pred))
        launched()
        got = engine.search(q, filter=pred)
        assert launched() == _expected_launches(
            kind, filtered=pred is not None, capped=True), filt
        assert_same_answers(got, want, _luts(q, ref_engine.index))
    budgeted = load_ann_engine(path, device="cpu").search(
        q, budget=SearchBudget(refine_cap=cap))
    assert budgeted.meta.level_name == "capped"
    plain = engine.search(q)
    assert torch.equal(budgeted.indices, plain.indices)
    assert torch.equal(budgeted.distances, plain.distances)


@pytest.mark.parametrize("kind", ["two-step", "ivf"])
def test_sharded_filtered_on_card_route_under_auto(artifacts, monkeypatch,
                                                   kind):
    """A sharded engine on the card serves ``filter`` under every backend
    (here auto, the fused engine unsharded): over 3 CPU shards, equal bit
    for bit to the unsharded jnp engine, one row-predicate crude launch
    a row shard."""
    from repro_torch.distributed import make_mesh_auto
    q, paths = artifacts
    path = paths[(kind, "f32", 8)]
    card_route(monkeypatch)
    unsharded = load_ann_engine(path, device="cpu")
    mesh = make_mesh_auto((3,), ("data",), devices="cpu")
    sharded = load_ann_engine(path, device="cpu", mesh=mesh,
                              overrides={"serve.backend": "auto"})
    assert sharded.backend == "cuda"
    pred = predicate("half")
    want = unsharded.search(q, filter=pred)
    launched()
    got = sharded.search(q, filter=pred)
    counts = launched()
    assert counts == ({"crude_topk_pred": 3, "refine_topk": 3}
                      if kind == "two-step"
                      else {"ivf_crude_topk": 3, "ivf_refine_topk": 3})
    for field in ("indices", "distances", "pass_rate", "avg_ops"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field


# ------------------------------------------------------- the backend rule --

@pytest.fixture(scope="module")
def reference_rule(artifacts):
    """The reference's pallas and jnp engines on one artifact: whether
    each offers the capped rung, and the words each raises for
    ``filter`` and ``refine_cap`` (none where it serves them)."""
    q, paths = artifacts
    path = paths[("two-step", "f32", 8)]
    out = {}
    for ref_be in ("pallas", "jnp"):
        engine = ref_api.load_ann_engine(
            path, overrides={"serve.backend": ref_be})
        words = {}
        try:
            engine.search(jnp.asarray(q), filter=jnp.ones(N, bool))
        except ValueError as e:
            words["engine"] = str(e)
        try:        # the index's refusal (the engine would fail over)
            ref_flat_mod.two_step_search(
                jnp.asarray(q), engine.index.codes, engine.index.C,
                engine.index.structure, TOPK, backend=ref_be, refine_cap=20)
        except ValueError as e:
            words["refine_cap"] = str(e)
        out[ref_be] = ("capped" in engine._levels(), words)
    return out


@pytest.mark.parametrize("backend", ["auto", "pallas", "jnp"])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_backend_rule_matches_reference(artifacts, reference_rule, backend,
                                        device):
    """config backend x device -> whether ``filter`` / ``refine_cap`` /
    the capped rung are offered: on the card auto and pallas are the
    reference's pallas engine (refused with its words, no capped rung),
    jnp its jnp engine; on the CPU every backend serves them.  The
    reference is asked the same of its pallas and jnp engines."""
    q, paths = artifacts
    be = port_base.resolve_backend(backend, torch.device(device))
    ref_be = "pallas" if device == "cuda" and backend != "jnp" else "jnp"
    ref_capped, ref_words = reference_rule[ref_be]
    engine = load_ann_engine(paths[("two-step", "f32", 8)], device="cpu")
    engine.backend = be                  # the engine's resolved backend
    assert ("capped" in engine._levels()) == ref_capped
    words = {}
    try:
        engine.search(q, filter=np.ones(N, bool))
    except ValueError as e:
        words["engine"] = str(e)
    try:
        port_flat._check_refine_cap(20, be)
    except ValueError as e:
        words["refine_cap"] = str(e)
    assert words == ref_words
    if be == "cuda":
        with pytest.raises(ValueError, match="like refine_cap, filter is a "
                                             "jnp-engine option"):
            port_flat._check_filter(np.ones(N, bool), N, be,
                                    torch.device("cpu"))
    else:
        assert port_flat._check_filter(np.ones(N, bool), N, be,
                                       torch.device("cpu")).all()
