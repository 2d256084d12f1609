"""The data-parallel training of the port on the CPU: meshes of D shards
on the CPU (``make_mesh_auto((D,), ("data",), devices="cpu")``).

- ``variance.global_batch_moments`` over D shards against the
  reference's ``batch_moments`` of the whole batch (rtol 1e-6; the
  variance also with an atol of 4 ulps of E[x^2], the rounding of the
  reference's own E[x^2] - m^2) and against that expression evaluated
  by jnp on the same shards (rtol 1e-6);
- one data-parallel step per mode from the reference's init against the
  reference's single-device step, to ``tests/test_torch_train.py``'s
  step gate (loss terms rtol 1e-5, params and states 1e-4, each with an
  atol of 1e-6 of the leaf's magnitude);
- a data-parallel ``fit`` against the port's single-device ``fit`` on
  Table 1's dataset3[:512] (d = 16, 4 x 16 codebooks, 2 epochs of 128):
  codes agree on more than 98% and Lambda to rtol 1e-3, atol 1e-5, the
  reference's own criteria (``tests/test_trainer.py``);
- a batch that does not divide over the mesh raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ICQConfig as RefICQConfig
from repro.core import variance as ref_var
from repro.trainer import joint as ref_joint
from repro_torch.configs import ICQConfig
from repro_torch.core import embed as port_embed
from repro_torch.core import variance as port_var
from repro_torch.data import make_table1_dataset
from repro_torch.distributed import make_mesh_auto
from repro_torch.train import optimizer as port_opt
from repro_torch.trainer import fit
from repro_torch.trainer import joint as port_joint

CFG = dict(d=8, num_codebooks=4, codebook_size=16, num_fast=1)


def cpu_mesh(D):
    return make_mesh_auto((D,), ("data",), devices="cpu")


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree.detach().numpy() if isinstance(tree, torch.Tensor)
                      else tree)


def assert_close(got, want, rtol, what=""):
    """Nested dicts of arrays: equal keys, each leaf to ``rtol`` plus an
    atol of 1e-6 times its largest magnitude (``test_torch_train``'s
    gate)."""
    got, want = _np(got), _np(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            assert_close(got[k], want[k], rtol, f"{what}/{k}")
        return
    assert got.shape == want.shape and got.dtype == want.dtype, what
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * scale,
                               err_msg=what)


@pytest.mark.parametrize("D", [1, 2, 3, 4])
def test_global_batch_moments_match_whole_batch(D):
    rng = np.random.default_rng(D)
    x = (rng.standard_normal((48, 16)) * np.linspace(0.5, 3.0, 16)
         + np.linspace(-1.0, 1.0, 16)).astype(np.float32)
    m_want, v_want = ref_var.batch_moments(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    m, v = port_var.global_batch_moments(xt, cpu_mesh(D))
    np.testing.assert_allclose(m.detach().numpy(), np.asarray(m_want),
                               rtol=1e-6, atol=1e-7)
    # the reference's data-parallel expression, E[x^2] - m^2 from the
    # shards' means, evaluated by jnp on the same shards
    parts = np.split(x, D)
    m_dp = sum(jnp.mean(jnp.asarray(p), axis=0) for p in parts) / D
    ex2 = sum(jnp.mean(jnp.square(jnp.asarray(p)), axis=0)
              for p in parts) / D
    np.testing.assert_allclose(v.detach().numpy(),
                               np.asarray(ex2 - jnp.square(m_dp)), rtol=1e-6)
    # against the whole batch's variance: E[x^2] - m^2 cancels, so its
    # rounding is a few ulps of E[x^2], not of the variance
    np.testing.assert_allclose(
        v.detach().numpy(), np.asarray(v_want), rtol=1e-6,
        atol=4 * float(np.spacing(np.float32(np.max(np.asarray(ex2))))))
    # differentiable: every shard's rows receive the gradient
    g, = torch.autograd.grad(v.sum(), xt)
    assert bool((g != 0).any(dim=1).all())
    shards = list(torch.chunk(torch.from_numpy(x), D))
    m2, v2 = port_var.global_batch_moments(shards, cpu_mesh(D))
    assert torch.equal(m2, m.detach()) and torch.equal(v2, v.detach())


@pytest.fixture(scope="module")
def joint_problem():
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((256, 24)) * np.linspace(0.2, 2.0, 24)
         ).astype(np.float32)
    y = rng.integers(0, 10, 256).astype(np.int32)
    return x, y


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("mode", ["icq", "cq", "pq"])
def test_dp_step_matches_reference_single_device(joint_problem, mode, D):
    """One data-parallel step over D shards from the reference's init
    equals the reference's single-device step on the same 64 rows, to
    the step gate; the outputs live on the mesh's first device."""
    x, y = joint_problem
    ref_cfg = RefICQConfig(**CFG)
    st = ref_joint.init_train_state(
        jax.random.PRNGKey(11), ref_cfg, d_raw=24, mode=mode,
        sample_batch=(jnp.asarray(x), jnp.asarray(y)))
    batch = (jnp.asarray(x[:64]), jnp.asarray(y[:64]))
    step = jax.jit(ref_joint.make_train_step(
        ref_cfg, st["embed_apply"], st["opt"], mode, st["pq_mask"]))
    want = jax.tree.map(np.asarray, step(st["params"], st["opt_state"],
                                         st["var_state"], batch))
    p, v, o = port_joint.train_state_from_numpy(
        *jax.tree.map(np.asarray, (st["params"], st["var_state"],
                                   st["opt_state"])), device="cpu")
    pq_mask = port_joint._pq_support_mask(4, 8) if mode == "pq" else None
    adam = port_opt.AdamW(lr=lambda s: 1e-3, weight_decay=0.0,
                          clip_norm=1.0)
    dp = port_joint.make_train_step(ICQConfig(**CFG),
                                    port_embed.linear_apply, adam, mode,
                                    pq_mask, axis_name="data",
                                    mesh=cpu_mesh(D))
    got = dp(p, o, v, (torch.from_numpy(x[:64]), torch.from_numpy(y[:64])))
    g_params, g_opt, g_var, g_mets = got
    r_params, r_opt, r_var, r_mets = want
    assert sorted(g_mets) == sorted(r_mets)
    for k in r_mets:
        if k == "psi_size":
            assert int(g_mets[k]) == int(r_mets[k])
        else:
            assert_close(g_mets[k], r_mets[k], 1e-5, k)
    assert_close(g_params, r_params, 1e-4, "params")
    assert_close(g_opt, r_opt, 1e-4, "opt_state")
    assert_close(g_var, r_var, 1e-4, "var_state")
    assert not any(t.requires_grad for t in port_opt.tree_leaves(
        {"params": g_params, "opt": g_opt, "var": g_var}))


def test_dp_fit_matches_single_device_fit():
    xtr, ytr, _, _ = make_table1_dataset("dataset3")
    xtr, ytr = xtr[:512], ytr[:512]
    cfg = ICQConfig(d=16, num_codebooks=4, codebook_size=16, num_fast=2)
    kw = dict(mode="icq", epochs=2, batch_size=128, device="cpu")
    m_dp = fit(1, xtr, ytr, cfg, mesh=cpu_mesh(4), **kw)
    m_sd = fit(1, xtr, ytr, cfg, **kw)
    agree = float((m_dp.codes == m_sd.codes).float().mean())
    assert agree > 0.98, agree
    assert torch.allclose(m_dp.lam, m_sd.lam, rtol=1e-3, atol=1e-5)


def test_batch_that_does_not_divide_raises(joint_problem):
    x, y = joint_problem
    xtr, ytr, _, _ = make_table1_dataset("dataset3")
    cfg = ICQConfig(d=16, num_codebooks=4, codebook_size=16, num_fast=2)
    with pytest.raises(ValueError, match="batch_size=100 must divide over "
                                         "the 3-way 'data' axis"):
        fit(1, xtr[:300], ytr[:300], cfg, mesh=cpu_mesh(3), batch_size=100,
            device="cpu")
    st = port_joint.init_train_state(0, ICQConfig(**CFG), d_raw=24,
                                     device="cpu")
    step = port_joint.make_train_step(
        ICQConfig(**CFG), st["embed_apply"], st["opt"], "icq",
        axis_name="data", mesh=cpu_mesh(3))
    with pytest.raises(ValueError, match="64 rows does not divide"):
        step(st["params"], st["opt_state"], st["var_state"],
             (torch.from_numpy(x[:64]), torch.from_numpy(y[:64])))
