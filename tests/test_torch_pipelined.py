"""The port's pipelined executor (``index/pipelined.py``) held against
the port's sequential search and the reference's pipelined search.

Within the port, bit for bit: a pipelined index (``pipeline="tiles"``,
tile T) returns the ids, distances, ``pass_rate`` and ``avg_ops`` of
the same index served sequentially over the same tiles
(``pipeline="off"``, ``query_chunk=T``), for the three kinds, f32 and
int8 LUTs, 8- and 4-bit codes, ragged tiles, the crude rung, the IVF
``n_probe`` override, ``filter`` and ``refine_cap``.  The comparison is
over the same tiles because the LUT build's matrix product may round
apart at another row count (CPU BLAS picks its path by shape), as XLA's
does in the reference; so a batch shorter than one tile, which the
executor runs zero-padded to the tile, is held against the sequential
search of the padded tile.

Against the reference's pipelined search at ``backend="jnp"``, with the
port's LUTs patched to the reference's tables: ids equal, distances to
rtol 1e-5 plus an atol of 1e-6 times the largest K-term LUT sum (the
reference builds its tables inside its jitted phases, where XLA may
round the last bit apart).  A reference artifact saved with
``serve.pipeline="tiles"`` loads in the port and serves equal to the
reference.  The two-stream schedule itself runs only on the card
(``tests/test_torch_gpu.py`` and ``chip_smoke.py`` phase 10).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as ref_api
from repro.core import icq as ref_icq
from repro.core.encode import pack_nibbles as ref_pack_nibbles
from repro.index import base as ref_base
from repro.index import make_index as ref_make_index
from repro_torch.api import load_ann_engine
from repro_torch.core.codebooks import decode
from repro_torch.index import flat as port_flat
from repro_torch.index import ivf as port_ivf
from repro_torch.index import make_index
from repro_torch.index.pipelined import (PIPELINE_MODES, maybe_pipelined,
                                         plan_for, resolve_pipeline,
                                         resolve_tile)

KINDS = ("flat", "two-step", "ivf")
CASES = [(kind, lut, bits) for kind in KINDS for lut in ("f32", "int8")
         for bits in (8, 4)]
TOPK = 10


def _problem(seed, n, nq, K=6, m=16, kf=3, d=16, sigma=0.6):
    """Codes (m <= 16, so the same codes serve both code_bits layouts),
    codebooks, an ICQ structure (numpy) and queries from a numpy
    seed."""
    rng = np.random.default_rng(seed)
    C = (rng.standard_normal((K, m, d)) * 0.3).astype(np.float32)
    codes = rng.integers(0, m, size=(n, K)).astype(np.uint8)
    codes[n // 2:n // 2 + 5] = codes[3]             # exact ties
    st = (np.ones(d, bool), np.arange(K) < kf, np.float32(sigma))
    q = rng.standard_normal((nq, d)).astype(np.float32)
    return q, codes, C, st


def _pair(kind, codes, C, st, *, code_bits=8, lut_dtype="f32", seed=0,
          **opts):
    """The reference's jnp index and the port's CPU index over the same
    arrays (an IVF over the reference's partition), both with
    ``opts``."""
    stored = (np.asarray(ref_pack_nibbles(jnp.asarray(codes), C.shape[0]))
              if code_bits == 4 else codes)
    kw = dict(topk=TOPK, code_bits=code_bits, lut_dtype=lut_dtype, **opts)
    ref_kw = dict(kw)
    if kind == "ivf":
        emb = np.asarray(C)[np.arange(C.shape[0])[None, :],
                            codes.astype(np.int64)].sum(axis=1)
        ref_kw.update(emb_db=jnp.asarray(emb), n_lists=8, kmeans_iters=5,
                      key=jax.random.PRNGKey(seed))
        kw.setdefault("n_probe", 4)
        ref_kw.setdefault("n_probe", 4)
    ref = ref_make_index(
        kind, jnp.asarray(stored), jnp.asarray(C),
        ref_icq.ICQStructure(*(jnp.asarray(a) for a in st)),
        backend="jnp", **ref_kw)
    if kind == "ivf":
        kw["ivf"] = ref.ivf
    port = make_index(kind, stored, C, st, device="cpu", **kw)
    return ref, port


def _t(a):
    return torch.from_numpy(np.array(a))


def _sequential(index):
    """The same index served sequentially over its pipeline's tiles."""
    return dataclasses.replace(index, pipeline="off",
                               query_chunk=resolve_tile(
                                   index.pipeline_tile, "torch"))


def assert_bitwise(got, want, fields=("indices", "distances", "pass_rate",
                                      "avg_ops")):
    for field in fields:
        assert torch.equal(getattr(got, field), getattr(want, field)), field


def assert_equals_sequential(index, q, method="search", *args, **kw):
    """The pipelined search of ``q`` against the sequential one over the
    same tiles.  A batch shorter than one tile runs zero-padded to the
    tile (the sequential path runs it at its own row count), so it is
    held against the sequential search of the padded tile: that tile's
    four fields, and its first rows' ids and distances."""
    tile = resolve_tile(index.pipeline_tile, "torch")
    got = getattr(index, method)(q, *args, **kw)
    seq = getattr(_sequential(index), method)
    if q.shape[0] >= tile:
        assert_bitwise(got, seq(q, *args, **kw))
        return got
    padded = torch.cat([q, q.new_zeros((tile - q.shape[0], q.shape[1]))])
    whole = getattr(index, method)(padded, *args, **kw)
    assert_bitwise(whole, seq(padded, *args, **kw))
    assert torch.equal(got.indices, whole.indices[:q.shape[0]])
    assert torch.equal(got.distances, whole.distances[:q.shape[0]])
    return got


def _reference_luts(monkeypatch):
    def build_lut(qs, C):
        return _t(ref_base.build_lut(jnp.asarray(qs.numpy()),
                                     jnp.asarray(C.numpy())))
    monkeypatch.setattr(port_flat, "build_lut", build_lut)
    monkeypatch.setattr(port_ivf, "build_lut", build_lut)


def assert_matches_reference(got, want, q, C):
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    luts = np.asarray(ref_base.build_lut(jnp.asarray(q), jnp.asarray(C)))
    atol = 1e-6 * luts.shape[1] * float(np.abs(luts).max())
    fin = np.isfinite(np.asarray(want.distances))
    np.testing.assert_array_equal(np.isfinite(got.distances.numpy()), fin)
    np.testing.assert_allclose(got.distances.numpy()[fin],
                               np.asarray(want.distances)[fin], rtol=1e-5,
                               atol=atol)


# ------------------------------------------------ pipelined vs sequential --

@pytest.mark.parametrize("kind,lut_dtype,code_bits", CASES)
def test_pipelined_equals_sequential_and_reference(monkeypatch, kind,
                                                   lut_dtype, code_bits):
    """3 kinds x {f32, int8} x {8, 4} bit, tile 32 over 70 queries (two
    full tiles and a ragged one): the port's pipelined search equals its
    sequential search over the same tiles bit for bit, and its ids equal
    the reference's pipelined search."""
    q, codes, C, st = _problem(17, 1200, 70)
    ref, port = _pair(kind, codes, C, st, code_bits=code_bits,
                      lut_dtype=lut_dtype, pipeline="tiles",
                      pipeline_tile=32)
    assert_equals_sequential(port, _t(q))
    assert len(port.__dict__["_pipeline_plans"]) == 1
    want = ref.search(jnp.asarray(q), TOPK)
    _reference_luts(monkeypatch)
    fresh = dataclasses.replace(port)                # a plan of its own
    assert_matches_reference(fresh.search(_t(q)), want, q, C)


@pytest.mark.parametrize("seed", range(6))
def test_pipelined_random_shapes(seed):
    """Random n, nq, tile (nq not a tile multiple, tiles smaller and
    larger than nq), odd K under the nibble format, K_fast at the
    edges: pipelined == sequential over the same tiles, bit for bit."""
    rng = np.random.default_rng(100 + seed)
    K = int(rng.choice([3, 5, 7]))
    kf = int(rng.choice([1, K - 1]))
    n = int(rng.integers(300, 1500))
    nq = int(rng.integers(3, 97))
    tile = int(rng.choice([5, 8, 17, 32, 128]))
    code_bits = int(rng.choice([8, 4]))
    lut_dtype = str(rng.choice(["f32", "int8"]))
    kind = str(rng.choice(KINDS))
    q, codes, C, st = _problem(1000 + seed, n, nq, K=K, kf=kf)
    _, port = _pair(kind, codes, C, st, code_bits=code_bits,
                    lut_dtype=lut_dtype, seed=seed, pipeline="tiles",
                    pipeline_tile=tile)
    got = assert_equals_sequential(port, _t(q), "search", 7)
    assert got.indices.shape == (nq, 7)


@pytest.mark.parametrize("kind", ["two-step", "ivf"])
def test_pipelined_filter_and_refine_cap(monkeypatch, kind):
    """The plain versions' options go through the executor: a filter
    predicate (the one per-call operand) and the refine_cap
    compaction, each equal to the sequential path bit for bit and in
    ids to the reference's pipelined search."""
    q, codes, C, st = _problem(19, 1200, 50)
    pred = np.zeros(1200, bool)
    pred[::3] = True
    ref, port = _pair(kind, codes, C, st, pipeline="tiles",
                      pipeline_tile=16)
    got = assert_equals_sequential(port, _t(q), filter=pred)
    assert bool((got.indices[got.indices >= 0] % 3 == 0).all())
    want = ref.search(jnp.asarray(q), TOPK, filter=jnp.asarray(pred))
    ref_c, port_c = _pair(kind, codes, C, st, pipeline="tiles",
                          pipeline_tile=16, refine_cap=24)
    assert_equals_sequential(port_c, _t(q))
    want_c = ref_c.search(jnp.asarray(q), TOPK)
    _reference_luts(monkeypatch)
    assert_matches_reference(dataclasses.replace(port).search(
        _t(q), filter=pred), want, q, C)
    assert_matches_reference(dataclasses.replace(port_c).search(_t(q)),
                             want_c, q, C)


@pytest.mark.parametrize("kind", KINDS)
def test_pipelined_crude_rung_and_probe_override(kind):
    """The ladder's crude rung through the executor (a single-phase
    plan: the refine dropped) equals the sequential crude rung, and the
    IVF ``n_probe`` override gets a plan of its own."""
    q, codes, C, st = _problem(23, 1200, 50)
    _, port = _pair(kind, codes, C, st, pipeline="tiles", pipeline_tile=16)
    assert_equals_sequential(port, _t(q), "search_crude")
    if kind == "ivf":
        got = assert_equals_sequential(port, _t(q), "search_crude",
                                       n_probe=2)
        assert not torch.equal(got.avg_ops, port.search_crude(_t(q)).avg_ops)
        keys = sorted(port.__dict__["_pipeline_plans"], key=str)
        assert [k[3] for k in keys] == [2, None]
        assert plan_for(port, TOPK, crude_only=True).refine_fn is None


def test_auto_mode_and_plan_cache():
    """``auto`` declines a batch of one tile or less (the sequential
    path serves) and engages beyond one tile; plans are cached per
    instance, and ``add`` starts an instance with no plan cache whose
    plan sees the grown database."""
    q, codes, C, st = _problem(29, 800, 40)
    _, auto = _pair("two-step", codes, C, st, pipeline="auto",
                    pipeline_tile=32)
    assert maybe_pipelined(auto, _t(q[:32]), TOPK) is None
    assert "_pipeline_plans" not in auto.__dict__
    assert_bitwise(auto.search(_t(q[:32])),
                   dataclasses.replace(auto, pipeline="off")
                   .search(_t(q[:32])))
    assert_equals_sequential(auto, _t(q))
    plans = auto.__dict__["_pipeline_plans"]
    assert list(plans) == [(TOPK, False, False, None)]
    auto.search(_t(q))
    assert len(plans) == 1
    assert plan_for(auto, TOPK) is plans[(TOPK, False, False, None)]
    new = decode(_t(C), _t(codes[:37]).long())
    grown = auto.add(new)
    assert "_pipeline_plans" not in grown.__dict__
    assert grown.codes.shape[0] == 837
    assert_equals_sequential(grown, _t(q))
    # a tiles-mode index engages even for a single tile
    tiles = dataclasses.replace(auto, pipeline="tiles")
    assert maybe_pipelined(tiles, _t(q[:5]), TOPK) is not None


def test_resolve_helpers_and_validation():
    assert PIPELINE_MODES == ("off", "tiles", "auto")
    for mode in PIPELINE_MODES:
        assert resolve_pipeline(mode) == mode
    with pytest.raises(ValueError, match="pipeline mode"):
        resolve_pipeline("overlap")
    assert resolve_tile(None, "torch") == 16
    assert resolve_tile(None, "cuda") == 64
    assert resolve_tile(8, "torch") == 8
    with pytest.raises(ValueError, match="pipeline_tile"):
        resolve_tile(0, "torch")
    q, codes, C, st = _problem(31, 300, 4)
    with pytest.raises(ValueError, match="pipeline mode"):
        _pair("flat", codes, C, st, pipeline="overlap")
    _, port = _pair("two-step", codes, C, st, pipeline="tiles",
                    pipeline_tile=0)
    with pytest.raises(ValueError, match="pipeline_tile"):
        port.search(_t(q))


@pytest.mark.parametrize("kind", KINDS)
def test_reference_pipelined_artifact_serves_in_port(tmp_path, monkeypatch,
                                                     kind):
    """An artifact the reference saved with ``serve.pipeline="tiles"``
    loads in the port (it raised before the executor was ported) and
    serves what the reference's engine serves over it; the port's
    engine result equals its sequential search over the same tiles."""
    q, codes, C, st = _problem(37, 1500, 40, K=8, m=16, kf=2)
    ref_idx, _ = _pair(kind, codes, C, st, pipeline="tiles",
                       pipeline_tile=16)
    cfg = ref_api.ICQConfig().with_overrides({
        "train.d": 16, "train.num_codebooks": 8, "train.codebook_size": 16,
        "index.kind": kind, "index.n_lists": 8, "index.n_probe": 4,
        "serve.topk": TOPK, "serve.backend": "jnp",
        "serve.pipeline": "tiles", "serve.pipeline_tile": 16})
    path = str(tmp_path / kind)
    ref_api.Artifacts(config=cfg, index=ref_idx).save(path)
    want = ref_api.load_ann_engine(path).search(jnp.asarray(q))
    engine = load_ann_engine(path, device="cpu")
    assert engine.index.pipeline == "tiles"
    assert engine.index.pipeline_tile == 16
    assert_bitwise(engine.search(q), _sequential(engine.index).search(_t(q)))
    _reference_luts(monkeypatch)
    again = load_ann_engine(path, device="cpu").search(q)
    assert_matches_reference(again, want, q, C)
