"""The port's IVF index held against the reference's.

Kernel level: the plain slab crude and refine (``ops.ivf_crude_topk`` /
``ops.ivf_refine_topk`` on CPU tensors) get the same numpy operands as
the reference's ``ivf_crude_topk_pallas`` / ``ivf_refine_topk_pallas``
in interpret mode (LUTs built by the reference).  Slab positions must
be equal; values match to rtol 1e-6 plus an atol of 1e-6 times the
largest magnitude a K-term LUT sum can reach (interpret mode sums
through a one-hot dot in XLA's order).  On the same LUT the plain crude
equals the reference's jnp slab sums bit for bit.

Build: ``kmeans_assign`` against ``kmeans_assign_pallas`` and the jnp
``core.codebooks.kmeans_assign`` (ids equal, distances to rtol 1e-5 plus
an atol of 1e-6 times the size of the terms they cancel); ``kmeans``,
``build_ivf`` and ``ivf_assign`` given the reference's initial draw:
centroids to rtol 1e-5 (plus an atol of 1e-6 for coordinates near zero,
since the two packages sum the members in another blocking), equal
lists and list lengths.

End to end: an IVF artifact saved by the reference and one saved by
the port, each served by both packages (the reference at
``backend="pallas"`` in interpret mode: its jnp path bootstraps f32
thresholds from one full-table sum, the kernel path from crude + slow,
and the port follows the kernel path).  With the port's LUTs patched to
the reference's tables: ids equal, distances to rtol 1e-6 plus the atol
above, equal pass counts (``pass_rate`` to one ulp, ``avg_ops``, whose
multiply-adds XLA fuses, to four).

The CUDA kernels themselves are held against the plain versions on the
card (``tests/test_torch_gpu.py`` and ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as ref_api
from repro.core import codebooks as ref_cb
from repro.core.encode import pack_nibbles as ref_pack_nibbles
from repro.data.synthetic import make_synthetic_index as ref_synthetic
from repro.index import base as ref_base
from repro.index import ivf as ref_ivf
from repro.kernels import batched_search as ref_bs
from repro.kernels import stages as ref_stages
from repro.kernels.kmeans import kmeans_assign_pallas
from repro_torch.api import (Artifacts, ICQConfig, build_index,
                             load_ann_engine)
from repro_torch.core import codebooks as port_cb
from repro_torch.index import ivf as port_ivf
from repro_torch.index import make_index
from repro_torch.kernels import ops, stages

RTOL = 1e-6
TOPK = 10


def _t(a):
    return torch.from_numpy(np.array(a))


def _atol(luts):
    return RTOL * luts.shape[1] * float(np.abs(luts).max())


def _slab_problem(seed, nq, nc, K, m, d=16, num_fast=2, thin_row=True):
    """A ragged candidate slab: codes (nq, nc, K) with duplicated rows
    (exact ties), ids with -1 holes inside every row, one row with
    fewer than TOPK valid columns; the reference's LUTs; the fast
    mask."""
    rng = np.random.default_rng(seed)
    C = (rng.standard_normal((K, m, d)) / np.sqrt(K)).astype(np.float32)
    codes = rng.integers(0, m, size=(nq, nc, K)).astype(np.uint8)
    codes[:, 40:47] = codes[:, 3:4]
    ids = rng.integers(0, 10 * nc, size=(nq, nc)).astype(np.int32)
    ids[rng.random((nq, nc)) < 0.2] = -1
    if thin_row:
        ids[1, TOPK // 2:] = -1
    q = rng.standard_normal((nq, d), dtype=np.float32)
    fast = np.zeros((K,), bool)
    fast[:num_fast] = True
    luts = np.asarray(ref_base.build_lut(jnp.asarray(q), jnp.asarray(C)))
    return codes, ids, luts, fast


def _stored(codes, K, code_bits):
    if code_bits == 4:
        return np.asarray(ref_pack_nibbles(jnp.asarray(codes), K))
    return codes


def _geometry(code_bits):
    return (7, 16) if code_bits == 4 else (8, 256)


SLAB_CASES = [(lut, bits) for lut in ("f32", "int8") for bits in (8, 4)]


@pytest.mark.parametrize("lut_dtype,code_bits", SLAB_CASES)
def test_slab_crude_plain_matches_pallas(lut_dtype, code_bits):
    """Ragged nq and nc against the (4, 128) Pallas tiles, odd K under
    the nibble format, -1 holes and a slab row thinner than topk."""
    K, m = _geometry(code_bits)
    codes, ids, luts, fast = _slab_problem(3 + code_bits, 5, 300, K, m)
    stored = _stored(codes, K, code_bits)
    lut_flat, scale, offset = ref_stages.crude_lut_operands(
        jnp.asarray(luts), jnp.asarray(fast),
        quantized=lut_dtype == "int8", code_bits=code_bits)
    want = ref_bs.ivf_crude_topk_pallas(
        jnp.asarray(stored), jnp.asarray(ids), lut_flat, scale, offset,
        topk=TOPK, interpret=True, code_bits=code_bits)
    got = ops.ivf_crude_topk(
        _t(stored), _t(ids), _t(lut_flat), TOPK,
        lut_scale=None if scale is None else _t(scale),
        lut_offset=None if offset is None else _t(offset),
        code_bits=code_bits)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL, atol=_atol(luts))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=RTOL, atol=_atol(luts))
    # the thin row's top-k ends in +inf slots at its lowest invalid
    # positions, as the reference's two-key merge orders them
    assert np.isinf(got[1].numpy()[1, TOPK // 2:]).all()
    jnp_crude, _ = ref_ivf._ivf_crude_scores(
        jnp.asarray(luts), jnp.asarray(stored), jnp.asarray(ids >= 0),
        jnp.asarray(fast), quantized=lut_dtype == "int8", need_slow=False,
        code_bits=code_bits)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jnp_crude))


@pytest.mark.parametrize("code_bits", [8, 4])
@pytest.mark.parametrize("survivors", ["many", "fewer_than_topk"])
def test_slab_refine_plain_matches_pallas(code_bits, survivors):
    """The margin test, slow sum and top-k of slab positions; with fewer
    survivors than topk the +inf tail carries the lowest positions."""
    K, m = _geometry(code_bits)
    codes, ids, luts, fast = _slab_problem(13 + code_bits, 6, 270, K, m)
    stored = _stored(codes, K, code_bits)
    lut_flat, _, _ = ref_stages.crude_lut_operands(
        jnp.asarray(luts), jnp.asarray(fast), quantized=False,
        code_bits=code_bits)
    crude = np.asarray(ref_bs.ivf_crude_topk_pallas(
        jnp.asarray(stored), jnp.asarray(ids), lut_flat, topk=TOPK,
        interpret=True, code_bits=code_bits)[0])
    rank = 4 if survivors == "fewer_than_topk" else 120
    thr = np.sort(crude, axis=1)[:, rank].astype(np.float32)
    thr[1] = np.sort(crude[1])[2]         # the thin row: finite threshold
    lut_slow = ref_stages.slow_lut_operand(jnp.asarray(luts),
                                           jnp.asarray(fast),
                                           code_bits=code_bits)
    want_v, want_p = ref_bs.ivf_refine_topk_pallas(
        jnp.asarray(stored), lut_slow, jnp.asarray(crude), jnp.asarray(thr),
        topk=TOPK, interpret=True, code_bits=code_bits)
    got_v, got_p = ops.ivf_refine_topk(_t(stored), _t(lut_slow), _t(crude),
                                       _t(thr), TOPK, code_bits=code_bits)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=RTOL,
                               atol=_atol(luts))
    if survivors == "fewer_than_topk":
        assert np.isinf(got_v.numpy()[:, rank:]).all()


@pytest.mark.parametrize("quantized", [False, True])
def test_slab_stages_match_reference(quantized):
    """``ThresholdStage.from_slab_candidates`` and ``RefineStage.slab``
    (positions to ids through ``safe``, +inf tail included) against the
    reference's stages on the same slab."""
    K, m = 8, 256
    codes, ids, luts, fast = _slab_problem(29, 5, 260, K, m)
    sigma = np.float32(3.0)
    ref_crude = ref_stages.CrudeStage(backend="pallas", topk=TOPK,
                                      block_q=4, block_n=128, interpret=True,
                                      quantized=quantized)
    out = ref_crude.slab(jnp.asarray(codes), jnp.asarray(ids),
                         jnp.asarray(ids >= 0), jnp.asarray(luts),
                         jnp.asarray(fast))
    ref_t = ref_stages.ThresholdStage(topk=TOPK, quantized=quantized)
    want_thr = ref_t.from_slab_candidates(
        jnp.asarray(luts), jnp.asarray(codes), out.cand_vals, out.cand_idx,
        jnp.asarray(fast), sigma)
    port_t = stages.ThresholdStage(topk=TOPK, quantized=quantized)
    got_thr = port_t.from_slab_candidates(
        _t(luts), _t(codes), _t(out.cand_vals), _t(out.cand_idx), _t(fast),
        _t(sigma))
    np.testing.assert_allclose(got_thr.numpy(), np.asarray(want_thr),
                               rtol=RTOL, atol=_atol(luts))
    safe = np.where(ids >= 0, ids, 0).astype(np.int32)
    want_ids, want_d, _ = ref_stages.RefineStage(
        backend="pallas", topk=TOPK, block_q=4, block_n=128,
        interpret=True).slab(jnp.asarray(codes), jnp.asarray(luts),
                             out.crude, want_thr, jnp.asarray(fast),
                             jnp.asarray(safe))
    got_ids, got_d, passed = stages.RefineStage(topk=TOPK).slab(
        _t(codes), _t(luts), _t(out.crude), _t(want_thr), _t(fast),
        _t(safe))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=RTOL,
                               atol=_atol(luts))
    assert passed.shape == ids.shape


# ------------------------------------------------------------- the build --

def test_kmeans_assign_matches_reference():
    """Ragged n and L: ids equal, distances close; the first index wins
    an exact tie (duplicated centroid rows)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2000, 16)).astype(np.float32)
    cent = rng.standard_normal((37, 16)).astype(np.float32)
    cent[20] = cent[7]
    want_i, want_d = kmeans_assign_pallas(jnp.asarray(x), jnp.asarray(cent),
                                          interpret=True)
    got_i, got_d = ops.kmeans_assign(_t(x), _t(cent))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert got_i.dtype == torch.int32 and not (got_i.numpy() == 20).any()
    xsq = (x ** 2).sum(1)
    atol = 1e-6 * float(xsq.max() + (cent ** 2).sum(1).max())
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5,
                               atol=atol)
    np.testing.assert_array_equal(
        port_cb.kmeans_assign(_t(x), _t(cent)).numpy(),
        np.asarray(ref_cb.kmeans_assign(jnp.asarray(x), jnp.asarray(cent))))


@pytest.mark.parametrize("caller_tf32", [True, False])
def test_distance_products_keep_the_callers_tf32_setting(caller_tf32):
    """The full-f32 products of the LUT, the probe and the assignment
    leave the process-wide TF32 flag as the caller set it."""
    flags = torch.backends.cuda.matmul
    saved = flags.allow_tf32
    x = torch.from_numpy(_emb(50))
    try:
        flags.allow_tf32 = caller_tf32
        ops.kmeans_assign(x, x[:5].clone())
        port_ivf.coarse_probe(x[:4], x[:6], 2)
        port_ivf.build_lut(x[:4], x[:6].reshape(2, 3, 16))
        assert flags.allow_tf32 is caller_tf32
    finally:
        flags.allow_tf32 = saved


def _emb(n, d=16, seed=2):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def test_kmeans_update_is_a_segment_mean():
    """Means per cluster in ascending point order, an empty cluster 0,
    bit for bit the reference's scatter-add."""
    rng = np.random.default_rng(4)
    x = _emb(500)
    ids = rng.integers(0, 6, 500).astype(np.int32)
    ids[ids == 3] = 2
    want_m, want_c = ref_cb.kmeans_update(jnp.asarray(x), jnp.asarray(ids),
                                          6)
    got_m, got_c = port_cb.kmeans_update(_t(x), _t(ids), 6)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


@pytest.mark.parametrize("n,n_lists", [(3000, 8), (6, 8)])
def test_build_ivf_matches_reference(n, n_lists):
    """Same initial draw: centroids close, lists and lengths equal
    (with ``n_lists > n`` the sentinel rows and empty lists too), and
    ``ivf_assign`` over the fitted centroids equal."""
    emb = _emb(n)
    key = jax.random.PRNGKey(5)
    want = ref_ivf.build_ivf(key, jnp.asarray(emb), n_lists,
                             kmeans_iters=10)
    init = np.asarray(jax.random.choice(key, n, (min(n, n_lists),),
                                        replace=False))
    got = port_ivf.build_ivf(_t(emb), n_lists, 10, init_ids=_t(init))
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(got.lists.numpy(), np.asarray(want.lists))
    np.testing.assert_array_equal(got.list_lens.numpy(),
                                  np.asarray(want.list_lens))
    assert got.lists.dtype == torch.int32
    assert got.imbalance == want.imbalance
    again = port_ivf.ivf_assign(got.centroids, _t(emb))
    ref_again = ref_ivf.ivf_assign(want.centroids, jnp.asarray(emb))
    np.testing.assert_array_equal(again.lists.numpy(),
                                  np.asarray(ref_again.lists))


def test_build_is_deterministic_from_a_seed():
    emb = _t(_emb(800))
    a, b = (port_ivf.build_ivf(emb, 8, 5, generator=11) for _ in range(2))
    assert torch.equal(a.lists, b.lists)
    assert torch.equal(a.centroids, b.centroids)
    c = port_ivf.build_ivf(emb, 8, 5, generator=12)
    assert not torch.equal(a.centroids, c.centroids)


# ----------------------------------------------------------- end to end --

N, NQ, D = 2000, 8, 16
E2E_CELLS = [(lut, bits) for lut in ("f32", "int8") for bits in (8, 4)]


def _config(config_cls, lut_dtype, code_bits):
    return config_cls().with_overrides({
        "train.codebook_size": 16 if code_bits == 4 else 256,
        "index.kind": "ivf", "index.n_lists": 8, "index.n_probe": 3,
        "index.kmeans_iters": 8, "index.code_bits": code_bits,
        "serve.topk": TOPK, "serve.backend": "pallas",
        "serve.lut_dtype": lut_dtype})


@pytest.fixture(scope="module")
def ivf_artifacts(tmp_path_factory):
    """Per cell, an IVF artifact saved by the reference and one saved by
    the port (its own k-means, run through the port's build)."""
    root = tmp_path_factory.mktemp("ivf")
    out = {}
    for lut, bits in E2E_CELLS:
        m = 16 if bits == 4 else 256
        codes, C, st = ref_synthetic(jax.random.PRNGKey(bits), N, d=D, K=8,
                                     m=m, num_fast=2, sigma=2.0)
        emb = ref_cb.decode(C, codes)
        cfg = _config(ref_api.ICQConfig, lut, bits)
        idx = ref_api.build_index(codes, C, st, index_cfg=cfg.index,
                                  serve_cfg=cfg.serve, emb_db=emb,
                                  key=jax.random.PRNGKey(9))
        ref_path = str(root / f"ref-{lut}-{bits}")
        ref_api.Artifacts(config=cfg, index=idx).save(ref_path)
        pcfg = _config(ICQConfig, lut, bits)
        pidx = build_index(np.asarray(codes), np.asarray(C),
                           tuple(np.asarray(a) for a in st),
                           index_cfg=pcfg.index, serve_cfg=pcfg.serve,
                           emb_db=np.asarray(emb), generator=3,
                           device="cpu")
        port_path = str(root / f"port-{lut}-{bits}")
        Artifacts(config=pcfg, index=pidx).save(port_path)
        out[(lut, bits)] = (ref_path, port_path)
    q = np.asarray(jax.random.normal(jax.random.PRNGKey(42), (NQ, D)))
    return q, out


def _assert_same_answers(got, want, q, C):
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    luts = ref_base.build_lut(jnp.asarray(q), jnp.asarray(C))
    atol = RTOL * luts.shape[1] * float(jnp.abs(luts).max())
    np.testing.assert_allclose(got.distances.numpy(),
                               np.asarray(want.distances), rtol=RTOL,
                               atol=atol)
    # one pass more or less moves pass_rate by 1 / (passes), far more
    # than the one ulp allowed for the reference's jitted means; XLA
    # fuses the Average-Ops multiply-adds, a few ulps more
    ulp = 2.0 ** -23
    np.testing.assert_allclose(float(got.pass_rate), float(want.pass_rate),
                               rtol=ulp)
    np.testing.assert_allclose(float(got.avg_ops), float(want.avg_ops),
                               rtol=4 * ulp)
    assert 0.0 < float(got.pass_rate) < 1.0


@pytest.mark.parametrize("lut_dtype,code_bits", E2E_CELLS)
@pytest.mark.parametrize("saved_by", ["reference", "port"])
def test_ivf_artifact_served_by_both(ivf_artifacts, monkeypatch, saved_by,
                                     lut_dtype, code_bits):
    q, cells = ivf_artifacts
    ref_path, port_path = cells[(lut_dtype, code_bits)]
    path = ref_path if saved_by == "reference" else port_path
    want = ref_api.load_ann_engine(path).search(jnp.asarray(q))
    monkeypatch.setattr(port_ivf, "build_lut", lambda qs, C: torch.tensor(
        np.asarray(ref_base.build_lut(jnp.asarray(qs.numpy()),
                                      jnp.asarray(C.numpy())))))
    engine = load_ann_engine(path, device="cpu")
    got = engine.search(q)
    _assert_same_answers(got, want, q, engine.index.C.numpy())
    assert got.meta.backend == "torch"
    assert got.meta.stages == ("probe", "crude", "refine")
    ref_index = ref_api.Artifacts.load(path).index
    np.testing.assert_array_equal(engine.index.ivf.lists.numpy(),
                                  np.asarray(ref_index.ivf.lists))
    np.testing.assert_array_equal(engine.index.list_codes.numpy(),
                                  np.asarray(ref_index.list_codes))
    assert engine.index.ivf.imbalance == ref_index.ivf.imbalance


def test_ivf_n_probe_follows_the_config_on_load(ivf_artifacts):
    _, cells = ivf_artifacts
    ref_path, port_path = cells[("f32", 8)]
    for path in (ref_path, port_path):
        engine = load_ann_engine(path, device="cpu",
                                 overrides={"index.n_probe": 5})
        assert engine.index.n_probe == 5
        assert ref_api.load_ann_engine(
            path, overrides={"index.n_probe": 5}).index.n_probe == 5
    art = Artifacts.load(port_path, device="cpu")
    bad = Artifacts(config=art.config.with_overrides({"index.n_probe": 2}),
                    index=art.index)
    with pytest.raises(Exception, match="n_probe"):
        bad.save(port_path + "-bad")


def test_ivf_build_needs_embeddings_and_raises_unported_options():
    codes, C, _ = ref_synthetic(jax.random.PRNGKey(0), 300, d=D, K=8,
                                m=256, num_fast=2)
    codes, C = np.asarray(codes), np.asarray(C)
    cfg = _config(ICQConfig, "f32", 8)
    structure = (np.ones(D, bool), np.arange(8) < 2, np.float32(1.0))
    with pytest.raises(Exception, match="emb_db"):
        build_index(codes, C, structure, index_cfg=cfg.index,
                    serve_cfg=cfg.serve, device="cpu")
    emb = np.asarray(ref_cb.decode(jnp.asarray(C), jnp.asarray(codes)))
    index = make_index("ivf", codes, C, structure, device="cpu", emb_db=emb,
                       n_lists=4, n_probe=2, kmeans_iters=3, topk=TOPK)
    q = np.zeros((2, D), np.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        index.search_crude(q)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        index.add(emb[:3])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        index.search(_t(q), filter=np.ones(300, bool))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_index("ivf", codes, C, structure, device="cpu", emb_db=emb,
                   n_lists=4, refine_cap=20)
    with pytest.raises(ValueError, match="n_probe"):
        make_index("ivf", codes, C, structure, device="cpu", emb_db=emb,
                   n_lists=4, n_probe=9, topk=TOPK).search(_t(q))
