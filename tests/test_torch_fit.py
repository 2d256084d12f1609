"""The port's training slice as a whole held against the reference's,
and the port's own ``fit``, on the CPU at small size.

Both packages start from the reference's ``init_train_state`` and run
the reference's ``epoch_batches`` stacks (carried across as numpy): the
reference's scan-compiled epoch (``compile_epoch``) against the port's
``run_epoch`` loop for 2 epochs of 4 batches, then ``finalize`` on
both.  The trained codebooks agree to rtol 1e-4 (atol 1e-6 of their
largest magnitude), the structure (xi, fast_mask) is equal and sigma
agrees to rtol 1e-5, the database codes are equal (as the encode tests
hold them, ``tests/test_torch_encode.py``), and the test queries served by
each package's two-step search (top-50, the Figure 1 protocol) return
equal ids and MAP to 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ICQConfig as RefICQConfig
from repro.core import mean_average_precision as ref_map
from repro.index import two_step_search as ref_two_step
from repro.trainer import compile_epoch as ref_compile_epoch
from repro.trainer import epoch_batches as ref_epoch_batches
from repro.trainer import finalize as ref_finalize
from repro.trainer import joint as ref_joint
from repro_torch.configs import ICQConfig
from repro_torch.core import embed as port_embed
from repro_torch.data import guyon_dataset
from repro_torch.index import make_index
from repro_torch.index.base import mean_average_precision
from repro_torch.train.optimizer import AdamW
from repro_torch.trainer import (epoch_batches, finalize, fit,
                                 make_train_step, run_epoch,
                                 train_state_from_numpy)

CFG = dict(d=8, num_codebooks=4, codebook_size=16, num_fast=1)
N, NQ, BS, EPOCHS, TOPK = 512, 64, 128, 2, 50


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def data():
    """Guyon data (Table 1's generator) at 32 features, 12 informative."""
    x, y = guyon_dataset(N + NQ, 32, 12, 10, seed=5)
    return x[:N], y[:N], x[N:], y[N:]


@pytest.fixture(scope="module")
def reference(data):
    """The reference's init, batch stacks, 2 compiled epochs, finalize
    and its two-step search of the test queries, as numpy."""
    xs, ys, xq, yq = data
    cfg = RefICQConfig(**CFG)
    st = ref_joint.init_train_state(
        jax.random.PRNGKey(2), cfg, d_raw=xs.shape[1], mode="icq",
        sample_batch=(jnp.asarray(xs), jnp.asarray(ys)))
    init = jax.tree.map(np.asarray, (st["params"], st["opt_state"]))
    step = ref_joint.make_train_step(cfg, st["embed_apply"], st["opt"],
                                     "icq")
    epoch_fn = ref_compile_epoch(step, cfg.d, donate=False)
    params, opt_state = st["params"], st["opt_state"]
    stacks, mets = [], []
    for ep in range(EPOCHS):
        xb, yb = ref_epoch_batches(jax.random.PRNGKey(100 + ep),
                                   jnp.asarray(xs), jnp.asarray(ys), BS)
        stacks.append((np.asarray(xb), np.asarray(yb)))
        params, opt_state, var_state, m = epoch_fn(params, opt_state, xb, yb)
        mets.append(jax.tree.map(np.asarray, m))
    model = ref_finalize(params, st["embed_apply"], var_state, cfg,
                         jnp.asarray(xs), encode_backend="jnp")
    res = ref_two_step(model.embed(jnp.asarray(xq)), model.codes, model.C,
                       model.structure, TOPK, backend="jnp")
    served = dict(ids=np.asarray(res.indices),
                  map=float(ref_map(res.indices, jnp.asarray(ys),
                                    jnp.asarray(yq))))
    trained = jax.tree.map(np.asarray, dict(
        params=params, opt_state=opt_state, var_state=var_state))
    out = dict(C=np.asarray(model.C), codes=np.asarray(model.codes),
               xi=np.asarray(model.structure.xi),
               fast_mask=np.asarray(model.structure.fast_mask),
               sigma=float(model.structure.sigma))
    return init, stacks, mets, trained, out, served


@pytest.fixture(scope="module")
def port_run(data, reference):
    """The port's ``run_epoch`` over the same stacks from the same init,
    then ``finalize`` and a two-step index over the codes."""
    xs, ys, xq, yq = data
    init, stacks, _, _, _, _ = reference
    cfg = ICQConfig(**CFG)
    params, _, opt_state = train_state_from_numpy(init[0], None, init[1],
                                                  device="cpu")
    step = make_train_step(cfg, port_embed.linear_apply,
                           AdamW(lr=lambda s: 1e-3, weight_decay=0.0,
                                 clip_norm=1.0), "icq")
    mets = []
    for xb, yb in stacks:
        params, opt_state, var_state, m = run_epoch(step, params, opt_state,
                                                    _t(xb), _t(yb))
        mets.append(m)
    model = finalize(params, port_embed.linear_apply, var_state, cfg, _t(xs))
    index = make_index("two-step", model.codes, model.C, model.structure,
                       device="cpu", topk=TOPK)
    res = index.search(model.embed(_t(xq)))
    mapv = float(mean_average_precision(res.indices, _t(ys), _t(yq)))
    return dict(params=params, opt_state=opt_state, var_state=var_state,
                mets=mets, model=model, ids=res.indices.numpy(), map=mapv)


def _close(got, want, rtol, what):
    if isinstance(want, dict):
        for k in want:
            _close(got[k], want[k], rtol, f"{what}/{k}")
        return
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = float(np.max(np.abs(want))) if np.size(want) else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * scale,
                               err_msg=what)


def test_epochs_match_reference(reference, port_run):
    """After 2 epochs: params, optimizer and variance state to rtol 1e-4,
    each epoch's last-batch loss terms to 1e-4."""
    _, _, ref_mets, trained, _, _ = reference
    for k in ("params", "opt_state", "var_state"):
        _close(port_run[k], trained[k], 1e-4, k)
    for got, want in zip(port_run["mets"], ref_mets):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k], 1e-4, k)


def test_finalize_matches_reference(reference, port_run):
    """C to rtol 1e-4, xi and fast_mask equal, sigma to 1e-5, the codes
    equal."""
    _, _, _, _, out, _ = reference
    model = port_run["model"]
    _close(model.C, out["C"], 1e-4, "C")
    np.testing.assert_array_equal(model.structure.xi.numpy(), out["xi"])
    np.testing.assert_array_equal(model.structure.fast_mask.numpy(),
                                  out["fast_mask"])
    np.testing.assert_allclose(float(model.structure.sigma), out["sigma"],
                               rtol=1e-5)
    assert model.codes.dtype == torch.uint8
    np.testing.assert_array_equal(model.codes.numpy(), out["codes"])


def test_served_top50_matches_reference(reference, port_run):
    """The test queries, embedded and served two-step by each package:
    equal top-50 ids and MAP to 1e-6 (the Figure 1 metric)."""
    served = reference[-1]
    np.testing.assert_array_equal(port_run["ids"], served["ids"])
    assert abs(port_run["map"] - served["map"]) <= 1e-6
    assert port_run["map"] > 0.2


def test_fit_is_seeded(data):
    """The port's own ``fit`` on the CPU: the same seed twice gives
    identical codebooks and codes; another seed other ones; the export
    is served by the port's ``TwoStep``."""
    xs, ys, xq, yq = data
    cfg = ICQConfig(**CFG)
    kw = dict(epochs=2, batch_size=BS, device="cpu")
    m1, m1b, m2 = (fit(s, xs, ys, cfg, **kw) for s in (1, 1, 2))
    assert torch.equal(m1.codes, m1b.codes) and torch.equal(m1.C, m1b.C)
    assert not torch.equal(m1.codes, m2.codes)
    assert m1.codes.shape == (N, 4) and m1.codes.dtype == torch.uint8
    idx = make_index("two-step", m1.codes, m1.C, m1.structure,
                     device="cpu", topk=TOPK)
    r = idx.search(m1.embed(_t(xq)))
    assert r.indices.shape == (NQ, TOPK)
    assert float(mean_average_precision(r.indices, _t(ys), _t(yq))) > 0.1


@pytest.mark.parametrize("mode", ["cq", "pq"])
def test_fit_modes_export_plain_structure(data, mode):
    """Modes cq and pq export xi = the top d // 2 variances, every
    codebook fast and sigma 0; pq codebooks keep their subspaces."""
    xs, ys, _, _ = data
    m = fit(0, xs[:256], ys[:256], ICQConfig(**CFG), mode=mode, epochs=1,
            batch_size=64, device="cpu")
    assert int(m.structure.xi.sum()) >= 4
    assert bool(m.structure.fast_mask.all()) and float(m.structure.sigma) == 0
    if mode == "pq":
        slices = torch.eye(4, dtype=torch.bool).repeat_interleave(2, 1)
        assert not ((m.C != 0).any(1) & ~slices).any()


def test_epoch_batches_permute_and_drop_tail(data):
    xs, ys, _, _ = data
    xb, yb = epoch_batches(3, _t(xs[:300]), _t(ys[:300]), 128)
    assert xb.shape == (2, 128, 32) and yb.shape == (2, 128)
    flat = xb.reshape(-1, 32).numpy()
    rows = {r.tobytes() for r in xs[:300]}
    assert all(r.tobytes() in rows for r in flat)
    assert len({r.tobytes() for r in flat}) == 256


def test_fit_refuses_unported_options(data):
    """The data-parallel options refuse what they cannot serve, with the
    reference's errors: ``fit``'s ``mesh=`` without a ``data`` axis or
    with a batch that does not divide over it, and the step's
    ``axis_name`` without the mesh that holds it."""
    from repro_torch.distributed import make_mesh_auto

    xs, ys, _, _ = data
    cfg = ICQConfig(**CFG)
    with pytest.raises(ValueError, match="needs a mesh with a 'data' axis"):
        fit(0, xs, ys, cfg, device="cpu",
            mesh=make_mesh_auto((2,), ("model",), devices="cpu"))
    with pytest.raises(ValueError, match="must divide over the 3-way"):
        fit(0, xs, ys, cfg, device="cpu", batch_size=64,
            mesh=make_mesh_auto((3,), ("data",), devices="cpu"))
    with pytest.raises(ValueError, match="needs the mesh"):
        make_train_step(cfg, port_embed.linear_apply,
                        AdamW(lr=lambda s: 1e-3), "icq", axis_name="data")
