"""The port's session (``repro_torch.api.session``) on the CPU at small
size, within the port and against the reference's.

Within the port, fit -> index -> search -> save -> load is bit for bit:
``load_ann_engine`` over the saved index and ``from_artifacts``'s
rebuilt model serve the in-process ids and distances exactly.  Across
the packages, an artifact with a model section saved by either is
served by the other: ids equal, distances to rtol 1e-5 (the two
frameworks round the embedding products differently) with an atol of
1e-6 of the largest LUT sum.  ``tune`` on an explicit grid measures the
reference's recall for every candidate over the same saved model.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ICQConfig as RefICQConfig
from repro.api import ICQSession as RefICQSession
from repro.api import icq_session as ref_icq_session
from repro.api import load_ann_engine as ref_load_ann_engine
from repro_torch.api import (ArtifactError, ConfigError, ICQConfig,
                             ICQSession, Searcher, icq_session,
                             load_ann_engine)
from repro_torch.data import make_table1_dataset
from repro_torch.serve import ServingLoop, Tenant

N, NQ = 400, 8


@pytest.fixture(scope="module")
def data():
    xtr, ytr, xte, _ = make_table1_dataset("dataset2")
    return xtr[:N], ytr[:N], xte[:NQ]


def _overrides(quantizer, kind, backend):
    """Table 1 rows (64 features): the joint trainer embeds to d = 16,
    the baselines quantize the raw 64 dimensions."""
    return {"train.quantizer": quantizer,
            "train.d": 16 if quantizer in ("icq", "sq", "pqn") else 64,
            "train.num_codebooks": 4, "train.codebook_size": 16,
            "train.num_fast": 1, "train.epochs": 2,
            "index.kind": kind, "index.n_lists": 8, "index.n_probe": 4,
            "serve.topk": 10, "serve.backend": backend}


def _port_cfg(quantizer, kind):
    return ICQConfig().with_overrides(_overrides(quantizer, kind, "auto"))


def _ref_cfg(quantizer, kind):
    return RefICQConfig().with_overrides(_overrides(quantizer, kind, "jnp"))


def _equal(a, b):
    return (torch.equal(a.indices, b.indices)
            and torch.equal(a.distances, b.distances))


@pytest.mark.parametrize("kind", ["flat", "two-step", "ivf"])
@pytest.mark.parametrize("quantizer", ["icq", "pq", "cq"])
def test_lifecycle_round_trip_is_bitwise(data, tmp_path, quantizer, kind):
    """fit -> index -> search -> save, then ``load_ann_engine`` fed
    ``from_artifacts``'s model embeddings, and ``from_artifacts``'s own
    ``index()`` (flat and two-step) serve the in-process result bit for
    bit; the reloaded model embeds bit for bit."""
    xtr, ytr, xte = data
    session = icq_session(_port_cfg(quantizer, kind), device="cpu")
    model = session.fit(xtr, ytr, seed=0)
    assert model.codes.shape == (N, 4)
    searcher = session.index()
    assert isinstance(searcher, Searcher) and searcher.n == N
    r0 = searcher.search(xte)
    assert r0.indices.shape == (NQ, 10)
    path = searcher.save(str(tmp_path / "art"))
    engine = load_ann_engine(path, device="cpu")
    s2 = ICQSession.from_artifacts(path, device="cpu")
    q = torch.from_numpy(xte)
    assert torch.equal(s2.model.embed(q), model.embed(q))
    assert _equal(engine(s2.model.embed(q)), r0)
    if kind != "ivf":         # ivf needs the fit embeddings (emb_db)
        assert _equal(s2.index().search(xte), r0)
    searcher.add(xtr[:16])
    assert searcher.n == N + 16


def _lut_atol(emb, C):
    luts = (np.sum(C ** 2, -1)[None]
            - 2.0 * np.einsum("qd,kmd->qkm", emb, C))
    return 1e-6 * C.shape[0] * float(np.abs(luts).max())


def _close_results(ids, dist, ref_ids, ref_dist, emb, C):
    np.testing.assert_array_equal(np.asarray(ids), np.asarray(ref_ids))
    np.testing.assert_allclose(np.asarray(dist), np.asarray(ref_dist),
                               rtol=1e-5, atol=_lut_atol(emb, C))


@pytest.mark.parametrize("quantizer,kind", [("icq", "two-step"),
                                            ("cq", "ivf")])
def test_reference_artifact_served_by_port(data, tmp_path, quantizer,
                                           kind):
    """The reference's session saves model + index; the port rebuilds
    the model and serves the index on the CPU: ids equal, distances to
    rtol 1e-5."""
    xtr, ytr, xte = data
    ref = ref_icq_session(_ref_cfg(quantizer, kind))
    ref.fit(xtr, ytr, key=jax.random.PRNGKey(1))
    ref_searcher = ref.index()
    want = ref_searcher.search(jnp.asarray(xte))
    path = ref_searcher.save(str(tmp_path / "ref"))
    session = ICQSession.from_artifacts(path, device="cpu")
    engine = load_ann_engine(path, device="cpu")
    emb = session.model.embed(torch.from_numpy(xte))
    got = engine(emb)
    _close_results(got.indices, got.distances, want.indices,
                   want.distances, emb.numpy(), session.model.C.numpy())
    np.testing.assert_array_equal(session.model.codes.numpy(),
                                  np.asarray(ref.model.codes))


@pytest.mark.parametrize("quantizer,kind", [("icq", "two-step"),
                                            ("cq", "ivf")])
def test_port_artifact_served_by_reference(data, tmp_path, quantizer,
                                           kind):
    """The port's session saves model + index; the reference rebuilds
    the model (``ICQSession.from_artifacts``) and serves the index
    (``load_ann_engine``): ids equal, distances to rtol 1e-5."""
    xtr, ytr, xte = data
    session = icq_session(_port_cfg(quantizer, kind), device="cpu")
    session.fit(xtr, ytr, seed=1)
    searcher = session.index()
    got = searcher.search(xte)
    path = searcher.save(str(tmp_path / "port"))
    ref = RefICQSession.from_artifacts(path)
    engine = ref_load_ann_engine(path, overrides={"serve.backend": "jnp"})
    emb = ref.model.embed(jnp.asarray(xte))
    want = engine(emb)
    _close_results(got.indices, got.distances, want.indices,
                   want.distances, np.asarray(emb),
                   np.asarray(ref.model.C))


def test_opq_reload_fails_in_both_packages(data, tmp_path):
    """An OPQ model's embedding is its rotation, which neither package
    records as an embed kind: the reference's reloaded model fails to
    embed (``KeyError``), the port's reload raises an ``ArtifactError``
    naming the rotation, for an artifact saved by either package.
    ``load_ann_engine`` (the index alone) still serves the port's
    artifact, bit for bit on the searcher's embeddings."""
    xtr, ytr, xte = data
    ref = ref_icq_session(_ref_cfg("opq", "flat"))
    ref.fit(xtr, ytr, key=jax.random.PRNGKey(2))
    ref_path = ref.index().save(str(tmp_path / "ref"))
    session = icq_session(_port_cfg("opq", "flat"), device="cpu")
    session.fit(xtr, ytr, seed=2)
    searcher = session.index()
    port_path = searcher.save(str(tmp_path / "port"))
    for path in (ref_path, port_path):
        with pytest.raises(KeyError):
            RefICQSession.from_artifacts(path).model.embed(
                jnp.asarray(xte))
        with pytest.raises(ArtifactError, match="OPQ rotation"):
            ICQSession.from_artifacts(path, device="cpu")
    engine = load_ann_engine(port_path, device="cpu")
    assert _equal(engine(searcher.embed(xte)), searcher.search(xte))


def test_tune_recall_matches_reference(data, tmp_path):
    """``tune`` over one saved CQ model (identity embedding) on an
    explicit two-candidate grid, in each package: every candidate's
    recall@10 equals the reference's."""
    xtr, ytr, xte = data
    ref = ref_icq_session(_ref_cfg("cq", "two-step"))
    ref.fit(xtr, ytr, key=jax.random.PRNGKey(3))
    path = ref.save(str(tmp_path / "model"))
    grid = [{}, {"train.num_fast": 1, "serve.lut_dtype": "int8"}]
    kw = dict(queries=xte, grid=grid, k=10, repeats=1, target_recall=0.5,
              apply=False)
    want = RefICQSession.from_artifacts(path)
    want.tune(db=xtr, **kw)
    got = ICQSession.from_artifacts(path, device="cpu")
    got.tune(db=xtr, **kw)
    rw, rg = want.last_tune["points"], got.last_tune["points"]
    assert [p["overrides"] for p in rg] == [p["overrides"] for p in rw]
    assert [p["recall"] for p in rg] == [p["recall"] for p in rw]
    assert got.last_tune["selected"]["overrides"] in grid + [
        p["overrides"] for p in rg]
    assert all(p["qps"] > 0 for p in rg)


def _model_mesh():
    from repro_torch.distributed import make_mesh_auto
    return make_mesh_auto((2,), ("model",), devices="cpu")


def _guard_session():
    return icq_session(ICQConfig(), device="cpu")


@pytest.mark.parametrize("call,error,match", [
    (lambda: _guard_session().index(), ConfigError, "before session.fit"),
    (lambda: icq_session({"train": {}}), ConfigError,
     "needs an api ICQConfig"),
    (lambda: _guard_session().tune(queries=np.zeros((2, 16))), ConfigError,
     "before session.fit"),
    (lambda: _guard_session().save("unused"), ConfigError,
     "before session.fit"),
    (lambda: _guard_session().fit(np.zeros((8, 64), np.float32),
                                  mesh=_model_mesh()),
     ValueError, "needs a mesh with a 'data' axis"),
    (lambda: icq_session(ICQConfig().with_overrides(
        {"train.quantizer": "pq"}), device="cpu").fit(
            np.zeros((8, 16), np.float32), mesh=_model_mesh()),
     ConfigError, "only wired for the joint"),
], ids=["index", "config", "tune", "save", "mesh", "mesh-baseline"])
def test_session_guards(call, error, match):
    """The reference's session guards (``test_api.py::test_session_
    guards`` and its siblings), and ``mesh=`` without a ``data``
    axis."""
    with pytest.raises(error, match=match):
        call()


def test_session_guards_need_queries_and_a_model(data, tmp_path):
    """``tune`` without queries, and ``from_artifacts`` of an index-only
    save, raise the reference's ``ConfigError``s; ``index(mesh=)``
    needs a ``data`` axis."""
    xtr, ytr, _ = data
    session = icq_session(_port_cfg("pq", "flat"), device="cpu")
    session.fit(xtr, ytr)
    with pytest.raises(ConfigError, match="needs queries="):
        session.tune()
    with pytest.raises(ValueError, match="'data' axis"):
        session.index(mesh=_model_mesh())
    path = str(tmp_path / "index_only")
    from repro_torch.api import Artifacts
    Artifacts(config=session.config,
              index=session.index().engine.index).save(path)
    with pytest.raises(ConfigError, match="hold no model"):
        ICQSession.from_artifacts(path, device="cpu")


def test_tenant_from_searcher_answers_as_search(data):
    """A tenant over a real ``Searcher`` embeds raw rows as
    ``Searcher.search`` does: the loop's answer to one request equals
    the direct call on the same rows, bit for bit."""
    xtr, ytr, xte = data
    session = icq_session(_port_cfg("icq", "two-step"), device="cpu")
    session.fit(xtr, ytr, seed=4)
    searcher = session.index()
    tenant = Tenant.from_searcher("s", searcher)
    assert tenant.model is searcher and tenant.d == 16
    with ServingLoop(tenant) as loop:
        got = loop.search(xte[:3], k=5)
        want = searcher.search(xte[:3], 5)
    np.testing.assert_array_equal(got.indices, want.indices.numpy())
    np.testing.assert_array_equal(got.distances, want.distances.numpy())
    assert got.meta.batch_fill is not None


def test_save_model_only_and_rebuild(data, tmp_path):
    """``ICQSession.save`` writes the model alone; the rebuilt session
    indexes the stored codes and serves what the original's ``index()``
    serves (the reference's layout: ``model/...`` arrays only)."""
    xtr, ytr, xte = data
    session = icq_session(_port_cfg("cq", "two-step"), device="cpu")
    session.fit(xtr, ytr, seed=5)
    path = session.save(str(tmp_path / "model"))
    with np.load(os.path.join(path, "arrays.npz")) as z:
        assert all(k.startswith("model/") for k in z.files)
    s2 = ICQSession.from_artifacts(path, device="cpu")
    assert _equal(s2.index().search(xte), session.index().search(xte))
