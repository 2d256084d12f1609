"""Growing a served index on the CPU: ``Index.add`` (ICM encode of the
new rows, ``ivf_extend`` for IVF) and ``AnnEngine.add``, mirroring the
reference's incremental-build tests (``tests/test_index.py``).

Within the port, a grown index equals the index built over all rows at
once, bit for bit: codes, lists, list lengths and the in-list codes slab
(IVF: ``ivf_assign`` with the same centroids), and the ids and distances
of a search.  Against the reference, the same numpy inputs grown by both
packages give equal codes and lists; with the port's ``build_lut``
patched to the reference's tables, equal ids and distances to rtol 1e-5
(the ROADMAP's parity rules; the IVF reference serves through its
Pallas kernels in interpret mode, whose threshold bootstrap the port
follows).  Grown artifacts load both ways.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as ref_api
from repro.core import codebooks as ref_cb
from repro.core import encode as ref_enc
from repro.core import icq as ref_icq
from repro.index import base as ref_base
from repro_torch.api import (AnnEngine, Artifacts, ICQConfig, build_index,
                             load_ann_engine)
from repro_torch.index import flat as port_flat
from repro_torch.index import ivf as port_ivf
from repro_torch.index import make_index
from repro_torch.launch import serve as port_serve

N, N1, D, K, M, TOPK = 900, 700, 16, 4, 16, 9
KINDS = ["flat", "two-step", "ivf"]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def problem():
    """An additive-codebook problem with genuine interactions (the
    reference's projected residual codebooks over numpy embeddings), its
    structure, and the codes of all N rows."""
    rng = np.random.default_rng(5)
    emb = (rng.standard_normal((N, D))
           * np.linspace(0.3, 2.0, D)).astype(np.float32)
    C = ref_cb.init_residual(jax.random.PRNGKey(5), jnp.asarray(emb), K, M,
                             iters=5)
    xi = jnp.asarray([1] * (D // 3) + [0] * (D - D // 3), bool)
    fast = jnp.zeros((K,), bool).at[:2].set(True)
    C = np.asarray(ref_icq.project_codebooks(C, xi, fast))
    st = tuple(np.asarray(a) for a in (xi, fast, np.float32(1.0)))
    codes = np.asarray(ref_enc.pack_codes(
        ref_enc.icm_encode(jnp.asarray(emb), jnp.asarray(C), 3,
                           backend="jnp"), M))
    q = rng.standard_normal((7, D)).astype(np.float32)
    return emb, C, st, codes, q


def _port_index(kind, codes, C, st, **opts):
    return make_index(kind, codes, C, None if kind == "flat" else st,
                      device="cpu", topk=TOPK, **opts)


def _assert_same_search(a, b):
    assert torch.equal(a.indices, b.indices)
    assert torch.equal(a.distances, b.distances)


@pytest.mark.parametrize("kind", KINDS)
def test_add_equals_rebuild(problem, kind):
    emb, C, st, codes, q = problem
    opts = dict(n_lists=8, n_probe=4, kmeans_iters=5, generator=1,
                emb_db=emb[:N1]) if kind == "ivf" else {}
    grown = _port_index(kind, codes[:N1], C, st, **opts).add(emb[N1:])
    if kind == "ivf":
        ivf = port_ivf.ivf_assign(grown.ivf.centroids, _t(emb))
        full = _port_index(kind, codes, C, st, ivf=ivf, n_probe=4)
        for f in ("lists", "list_lens", "centroids"):
            assert torch.equal(getattr(grown.ivf, f), getattr(full.ivf, f))
        assert grown.ivf.imbalance == full.ivf.imbalance
        assert torch.equal(grown.list_codes, full.list_codes)
    else:
        full = _port_index(kind, codes, C, st)
    assert grown.codes.dtype == full.codes.dtype == torch.uint8
    assert torch.equal(grown.codes, full.codes)
    _assert_same_search(grown.search(_t(q)), full.search(_t(q)))


def _patch_luts(monkeypatch):
    """The port's LUTs are the reference's tables (ids then compare
    exactly; see the module docstring)."""
    def ref_luts(qs, C):
        return torch.tensor(np.asarray(ref_base.build_lut(
            jnp.asarray(qs.numpy()), jnp.asarray(C.numpy()))))
    monkeypatch.setattr(port_flat, "build_lut", ref_luts)
    monkeypatch.setattr(port_ivf, "build_lut", ref_luts)


def _assert_close_search(got, want, q, C):
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    luts = ref_base.build_lut(jnp.asarray(q), jnp.asarray(C))
    atol = 1e-5 * luts.shape[1] * float(jnp.abs(luts).max())
    np.testing.assert_allclose(got.distances.numpy(),
                               np.asarray(want.distances), rtol=1e-5,
                               atol=atol)


def _ref_index(kind, codes, C, st, emb_db=None):
    """The reference's index over ``codes``: flat and two-step at the
    jnp backend, IVF (8 lists, 4 probed) through its Pallas kernels in
    interpret mode."""
    cfg = ref_api.ICQConfig().with_overrides({
        "train.d": D, "train.num_codebooks": K, "train.codebook_size": M,
        "index.kind": kind, "index.n_lists": 8, "index.n_probe": 4,
        "index.kmeans_iters": 5, "serve.topk": TOPK,
        "serve.backend": "pallas" if kind == "ivf" else "jnp"})
    structure = None if kind == "flat" else ref_icq.ICQStructure(
        *(jnp.asarray(a) for a in st))
    return cfg, ref_api.build_index(
        jnp.asarray(codes), jnp.asarray(C), structure, index_cfg=cfg.index,
        serve_cfg=cfg.serve,
        emb_db=None if emb_db is None else jnp.asarray(emb_db),
        key=jax.random.PRNGKey(2))


@pytest.mark.parametrize("kind", KINDS)
def test_add_matches_reference_add(problem, monkeypatch, kind):
    emb, C, st, codes, q = problem
    _, ref = _ref_index(kind, codes[:N1], C, st,
                        emb_db=emb[:N1] if kind == "ivf" else None)
    opts = {"ivf": ref.ivf, "n_probe": 4} if kind == "ivf" else {}
    port = _port_index(kind, codes[:N1], C, st, **opts)
    ref_grown = ref.add(jnp.asarray(emb[N1:]))
    grown = port.add(emb[N1:])
    np.testing.assert_array_equal(grown.codes.numpy(),
                                  np.asarray(ref_grown.codes))
    if kind == "ivf":
        np.testing.assert_array_equal(grown.ivf.lists.numpy(),
                                      np.asarray(ref_grown.ivf.lists))
        np.testing.assert_array_equal(grown.ivf.list_lens.numpy(),
                                      np.asarray(ref_grown.ivf.list_lens))
        np.testing.assert_array_equal(grown.list_codes.numpy(),
                                      np.asarray(ref_grown.list_codes))
        assert grown.ivf.imbalance == pytest.approx(ref_grown.ivf.imbalance)
    _patch_luts(monkeypatch)
    _assert_close_search(grown.search(_t(q)), ref_grown.search(
        jnp.asarray(q)), q, C)


def test_add_grows_max_len_when_lists_overflow(problem):
    emb, C, st, codes, _ = problem
    idx = _port_index("ivf", codes[:200], C, st, emb_db=emb[:200],
                      n_lists=4, n_probe=4, kmeans_iters=5, generator=0)
    rng = np.random.default_rng(6)
    clones = emb[0] + 0.001 * rng.standard_normal((100, D)).astype(
        np.float32)           # 100 near-identical rows, one cell
    grown = idx.add(clones)
    assert grown.ivf.lists.shape[1] > idx.ivf.lists.shape[1]
    assert grown.codes.shape[0] == 300
    assert int(grown.ivf.list_lens.sum()) == 300
    full = port_ivf.ivf_assign(idx.ivf.centroids,
                               torch.cat([_t(emb[:200]), _t(clones)]))
    assert torch.equal(grown.ivf.lists, full.lists)
    assert grown.search(_t(emb[:1])).indices.shape == (1, TOPK)
    with pytest.raises(ValueError, match="ids 0 .. 99"):
        port_ivf.ivf_extend(idx.ivf, _t(clones), start_id=100)


def test_ann_engine_add_grows_in_place(problem):
    emb, C, st, codes, q = problem
    engine = AnnEngine(_port_index("two-step", codes[:N1], C, st),
                       query_tile=4)
    r0 = engine.search(q)
    assert engine.n == N1
    assert engine.add(_t(emb[N1:]), icm_iters=3, point_chunk=64) is engine
    assert engine.n == N and engine.device.type == "cpu"
    assert engine.query_tile == 4
    r1 = engine.search(q)
    assert r1.indices.shape == r0.indices.shape
    full = AnnEngine(_port_index("two-step", codes, C, st), query_tile=4)
    _assert_same_search(r1, full.search(q))


@pytest.mark.parametrize("kind", ["two-step", "ivf"])
@pytest.mark.parametrize("grown_by", ["reference", "port"])
def test_grown_artifact_loads_both_ways(problem, tmp_path, monkeypatch,
                                        kind, grown_by):
    emb, C, st, codes, q = problem
    cfg, ref = _ref_index(kind, codes[:N1], C, st,
                          emb_db=emb[:N1] if kind == "ivf" else None)
    path = str(tmp_path / f"{kind}-{grown_by}")
    if grown_by == "reference":
        ref_api.Artifacts(config=cfg, index=ref.add(jnp.asarray(
            emb[N1:]))).save(path)
    else:
        pcfg = ICQConfig.from_dict(cfg.to_dict())
        opts = {"ivf": ref.ivf, "n_probe": 4} if kind == "ivf" else {}
        port = _port_index(kind, codes[:N1], C, st, **opts)
        Artifacts(config=pcfg, index=port.add(emb[N1:])).save(path)
    want = ref_api.load_ann_engine(path).search(jnp.asarray(q))
    _patch_luts(monkeypatch)
    engine = load_ann_engine(path, device="cpu")
    assert engine.n == N
    _assert_close_search(engine.search(q), want, q, C)


def test_serve_cli_ann_add_saves_the_grown_index(tmp_path, capsys):
    path = str(tmp_path / "grown")
    port_serve.main(["--ann", "--device", "cpu", "--ann-n", "1500",
                     "--ann-queries", "8", "--batches", "1", "--ann-add",
                     "128", "--save-artifacts", path])
    out = capsys.readouterr().out
    assert "ann-add: +128 vectors" in out and "n=1628" in out
    assert load_ann_engine(path, device="cpu").n == 1628
    with pytest.raises(SystemExit):
        port_serve.main(["--load-artifacts", path, "--ann-add", "5"])


def test_build_index_then_add_keeps_the_config_kind(problem):
    """``build_index`` indexes grow as their kind: a 4-bit two-step index
    appends nibble rows."""
    emb, C, st, codes, _ = problem
    cfg = ICQConfig().with_overrides({
        "train.d": D, "train.num_codebooks": K, "train.codebook_size": M,
        "index.code_bits": 4, "serve.topk": TOPK})
    idx = build_index(codes[:N1], C, st, index_cfg=cfg.index,
                      serve_cfg=cfg.serve, device="cpu")
    grown = idx.add(emb[N1:])
    full = build_index(codes, C, st, index_cfg=cfg.index,
                       serve_cfg=cfg.serve, device="cpu")
    assert grown.codes.shape == (N, K // 2)
    assert torch.equal(grown.codes, full.codes)
