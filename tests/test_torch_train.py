"""The port's training core held against the reference's, module by
module and one joint step per mode, on the CPU at small size.

The same numpy inputs (made from a seed) go through each reference
function and its twin in ``repro_torch``.  Both packages compute in
f32 and sum in their own orders, so values agree to rtol 1e-5 (loss
terms, forward values) and 1e-4 (gradients, optimizer state), each
with an atol of 1e-6 times the leaf's largest magnitude for entries
near zero.  Discrete outputs (masks, codes, psi_size) are equal; a hard
code may differ only where its two scores lie within 4 ulps.

The joint steps start from the reference's ``init_train_state``,
carried across as numpy through ``train_state_from_numpy`` (the two
frameworks' random streams differ).  Gradients are read through an
optimizer stand-in that returns them as the new params, so they are
the ones the step hands to AdamW (Theta's boosted 10x in mode icq).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as ref_api
from repro.configs.base import ICQConfig as RefICQConfig
from repro.core import embed as ref_embed
from repro.core import encode as ref_enc
from repro.core import icq as ref_icq
from repro.core import losses as ref_losses
from repro.core import prior as ref_prior
from repro.core import variance as ref_var
from repro.data import synthetic as ref_synth
from repro.train import optimizer as ref_opt
from repro.trainer import joint as ref_joint
from repro_torch.api import ICQConfig as PortApiConfig
from repro_torch.configs import ICQConfig
from repro_torch.core import embed as port_embed
from repro_torch.core import encode as port_enc
from repro_torch.core import icq as port_icq
from repro_torch.core import losses as port_losses
from repro_torch.core import prior as port_prior
from repro_torch.core import variance as port_var
from repro_torch.data import synthetic as port_synth
from repro_torch.train import optimizer as port_opt
from repro_torch.trainer import joint as port_joint

CFG = dict(d=8, num_codebooks=4, codebook_size=16, num_fast=1)
PRIOR = dict(pi1=0.9, pi2=0.1, alpha2=-10.0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree.detach().numpy() if isinstance(tree, torch.Tensor)
                      else tree)


def assert_close(got, want, rtol, what=""):
    """Nested dicts of arrays: equal keys, each leaf to ``rtol`` plus an
    atol of 1e-6 times its largest magnitude."""
    got, want = _np(got), _np(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            assert_close(got[k], want[k], rtol, f"{what}/{k}")
        return
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (what, got.shape, want.shape, got.dtype, want.dtype)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * scale,
                               err_msg=what)


def assert_codes_near(got, want, x, C):
    """Hard codes equal, or a differing code's two scores within 4 ulps
    of the scores' magnitude (a near tie)."""
    got, want = np.asarray(got), np.asarray(want)
    x, C = np.asarray(x, np.float64), np.asarray(C, np.float64)
    for i, k in zip(*np.nonzero(got != want)):
        s = (C[k] ** 2).sum(1) - 2.0 * C[k] @ x[i]
        ulp = np.spacing(np.float32(np.abs(s).max()))
        assert abs(s[got[i, k]] - s[want[i, k]]) <= 4 * ulp, (i, k)


# ------------------------------------------------------------- configs ----

def test_hyperparams_match_reference():
    """``TrainConfig.hyperparams`` gives the reference's record, field
    for field, and the config hash does not move."""
    over = {"train.d": 32, "train.num_fast": 3, "train.gamma_p": 0.5}
    port = PortApiConfig().with_overrides(over)
    ref = ref_api.ICQConfig().with_overrides(over)
    assert port.config_hash() == ref.config_hash()
    got = port.train.hyperparams(icm_iters=5)
    want = ref.train.hyperparams(icm_iters=5)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert isinstance(got, ICQConfig)


@pytest.mark.parametrize("name", sorted(ref_synth.SYNTHETIC_DATASETS))
def test_table1_dataset_equals_reference(name):
    assert port_synth.SYNTHETIC_DATASETS == ref_synth.SYNTHETIC_DATASETS
    for got, want in zip(port_synth.make_table1_dataset(name),
                         ref_synth.make_table1_dataset(name)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_metrics_match_reference():
    """MAP (the paper's metric) and recall against the reference's, on
    ids with ties, misses and a query with no relevant point."""
    from repro.index import base as ref_base
    from repro_torch.index import base as port_base
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 300, (40, 25)).astype(np.int32)
    db_labels = rng.integers(0, 7, 300).astype(np.int32)
    q_labels = rng.integers(0, 8, 40).astype(np.int32)   # label 7: none
    assert_close(port_base.mean_average_precision(
        _t(ids), _t(db_labels), _t(q_labels)),
        ref_base.mean_average_precision(jnp.asarray(ids),
                                        jnp.asarray(db_labels),
                                        jnp.asarray(q_labels)), 1e-6)
    true = rng.integers(0, 300, (40, 25)).astype(np.int32)
    true[:, :5] = ids[:, :5]
    assert_close(port_base.recall_at(_t(ids), _t(true)),
                 ref_base.recall_at(jnp.asarray(ids), jnp.asarray(true)),
                 1e-6)


# --------------------------------------------------------------- prior ----

def _theta(s1, s2, mu2):
    return {"raw_sigma1": np.float32(s1), "raw_sigma2": np.float32(s2),
            "mu2": np.float32(mu2)}


PRIOR_CASES = {
    # variances spread over the two modes
    "bulk": (np.linspace(0.01, 2.5, 12), _theta(-1.5, 0.2, 2.0)),
    # far above the minor mode: alpha2 * z near -500, log_ndtr's deep
    # left tail, where erfc-based forms give NaN gradients
    "deep-tail": (np.array([0.0, 0.05, 0.3, 11.0, 14.0, 20.0]),
                  _theta(-2.0, -1.0, 1.0)),
}


@pytest.mark.parametrize("case", sorted(PRIOR_CASES))
def test_prior_nll_and_gradients_match_reference(case):
    lam, theta = PRIOR_CASES[case]
    lam = lam.astype(np.float32)

    def ref_f(lam, theta):
        return ref_prior.nll(lam, theta, **PRIOR)
    want, (g_lam, g_th) = jax.value_and_grad(ref_f, argnums=(0, 1))(
        jnp.asarray(lam), jax.tree.map(jnp.asarray, theta))
    lam_t = _t(lam).requires_grad_(True)
    th_t = {k: _t(v).requires_grad_(True) for k, v in theta.items()}
    got = port_prior.nll(lam_t, th_t, **PRIOR)
    grads = torch.autograd.grad(got, [lam_t, *th_t.values()])
    assert_close(got, want, 1e-5, "nll")
    assert all(torch.isfinite(g).all() for g in grads)
    assert_close(grads[0], g_lam, 1e-4, "d lam")
    assert_close(dict(zip(th_t, grads[1:])), g_th, 1e-4, "d theta")
    np.testing.assert_array_equal(
        port_prior.psi_mask(_t(lam), {k: _t(v) for k, v in theta.items()},
                            **PRIOR).numpy(),
        np.asarray(ref_prior.psi_mask(jnp.asarray(lam), theta, **PRIOR)))


def test_prior_inits_and_topk_match_reference():
    rng = np.random.default_rng(3)
    lam = (rng.gamma(0.5, 1.0, 16)).astype(np.float32)
    lam[[2, 9]] = lam.max()               # a tie at the top
    assert_close(port_prior.init_theta(), ref_prior.init_theta(), 0, "init")
    assert_close(port_prior.init_theta_from_data(_t(lam)),
                 ref_prior.init_theta_from_data(jnp.asarray(lam)), 0,
                 "from data")
    for k in (1, 2, 3, 8, 16):
        np.testing.assert_array_equal(
            port_prior.psi_mask_topk(_t(lam), k).numpy(),
            np.asarray(ref_prior.psi_mask_topk(jnp.asarray(lam), k)))


# ------------------------------------------------------------ variance ----

def test_variance_updates_and_merge_match_reference():
    """A sequence of ``update`` calls over ragged batches, and the Chan
    merge of two states."""
    rng = np.random.default_rng(4)
    batches = [(rng.standard_normal((b, 6)) * [1, 2, 3, 0.5, 0.1, 4]
                + 3).astype(np.float32) for b in (32, 32, 17, 5)]
    ref_s, port_s = ref_var.init_state(6), port_var.init_state(6)
    states = []
    for xb in batches:
        ref_s = ref_var.update(ref_s, jnp.asarray(xb))
        port_s = port_var.update(port_s, _t(xb))
        assert_close(port_s, ref_s, 1e-5, "update")
        states.append((port_s, ref_s))
    assert_close(port_var.lambda_exact(port_s), ref_var.lambda_exact(ref_s),
                 1e-5, "exact")
    (pa, ra), (pb, rb) = states[0], states[-1]
    assert_close(port_var.welford_merge(pa, pb), ref_var.welford_merge(ra, rb),
                 1e-5, "merge")


# -------------------------------------------------------------- losses ----

@pytest.fixture(scope="module")
def codebook_problem():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((40, 8)) * np.linspace(0.3, 2.0, 8)
         ).astype(np.float32)
    C = (rng.standard_normal((4, 16, 8)) * 0.7).astype(np.float32)
    xi = (np.arange(8) % 3 == 0)
    return x, C, xi


def test_st_decode_forward_and_gradients_match_reference(codebook_problem):
    x, C, _ = codebook_problem
    for tau in (1.0, 0.3):
        def ref_f(x, C):
            xbar, _ = ref_enc.st_decode(x, C, tau)
            return jnp.sum(xbar * jnp.cos(x)), xbar
        (_, xbar), (gx, gC) = jax.value_and_grad(
            ref_f, argnums=(0, 1), has_aux=True)(jnp.asarray(x),
                                                 jnp.asarray(C))
        xt, Ct = _t(x).requires_grad_(True), _t(C).requires_grad_(True)
        got, codes = port_enc.st_decode(xt, Ct, tau)
        grads = torch.autograd.grad(torch.sum(got * torch.cos(xt)),
                                    [xt, Ct])
        assert_close(got, xbar, 1e-5, "xbar")
        assert_close(grads[0], gx, 1e-4, "d x")
        assert_close(grads[1], gC, 1e-4, "d C")
        assert_codes_near(codes.numpy(),
                          ref_enc.soft_assign(jnp.asarray(x),
                                              jnp.asarray(C))[1], x, C)


def test_loss_terms_match_reference(codebook_problem):
    x, C, xi = codebook_problem
    rng = np.random.default_rng(6)
    logits = (rng.standard_normal((40, 10)) * 3).astype(np.float32)
    labels = rng.integers(0, 10, 40).astype(np.int32)
    J, T = jnp.asarray, _t
    assert_close(port_losses.classification_loss(T(logits), T(labels)),
                 ref_losses.classification_loss(J(logits), J(labels)), 1e-5)
    a, p, n = (rng.standard_normal((3, 40, 8))).astype(np.float32)
    assert_close(port_losses.triplet_loss(T(a), T(p), T(n), 2.0),
                 ref_losses.triplet_loss(J(a), J(p), J(n), 2.0), 1e-5)
    got, codes = port_losses.quantization_loss(T(x), T(C))
    want, ref_codes = ref_losses.quantization_loss(J(x), J(C))
    assert_close(got, want, 1e-5, "l_c")
    assert_codes_near(codes.numpy(), ref_codes, x, C)
    for eps in (None, 1.5):
        assert_close(port_losses.cq_penalty(T(C), T(np.asarray(ref_codes)),
                                            eps),
                     ref_losses.cq_penalty(J(C), ref_codes, eps), 1e-5, "cq")
    soft = np.linspace(0.0, 1.0, 8).astype(np.float32)
    for w in (xi, soft):
        assert_close(port_losses.icq_loss(T(C), T(w)),
                     ref_losses.icq_loss(J(C), J(w)), 1e-5, "icq")


# ----------------------------------------------------------------- icq ----

def test_icq_structure_functions_match_reference(codebook_problem):
    """compute_xi (prior split, and both fallbacks), codebook_energies,
    fast_set, fast_set_topk (with tied fractions), project_codebooks,
    margin_sigma and build_structure (eq. 8 hit and the top-k
    fallback)."""
    _, C, xi = codebook_problem
    J, T = jnp.asarray, _t
    cfg = ICQConfig(**CFG)
    ref_cfg = RefICQConfig(**CFG)
    lam = np.array([3.0, 0.1, 0.05, 2.8, 0.2, 0.01, 0.15, 0.3], np.float32)
    thetas = [_theta(-1.5, 0.0, 2.9),          # a split of 2 dims
              _theta(3.0, -3.0, 50.0),         # no dim: fallback
              _theta(-9.0, 3.0, 0.0)]          # every dim: fallback
    for th in thetas:
        th_t = {k: T(v) for k, v in th.items()}
        for md in (1, 3):
            np.testing.assert_array_equal(
                port_icq.compute_xi(T(lam), th_t, cfg, min_dims=md).numpy(),
                np.asarray(ref_icq.compute_xi(J(lam), th, ref_cfg,
                                              min_dims=md)))
    # codebooks 0 and 2 live inside psi (eq. 8 holds for them)
    Cs = C.copy()
    Cs[[0, 2]] *= np.where(xi, 1.0, 0.05)
    Cs[3] = Cs[1]                              # tied energy fractions
    for CC in (C, Cs):
        for a, b in zip(port_icq.codebook_energies(T(CC), T(xi)),
                        ref_icq.codebook_energies(J(CC), J(xi))):
            assert_close(a, b, 1e-5, "energies")
        np.testing.assert_array_equal(
            port_icq.fast_set(T(CC), T(xi)).numpy(),
            np.asarray(ref_icq.fast_set(J(CC), J(xi))))
        for nf in (1, 2, 3):
            np.testing.assert_array_equal(
                port_icq.fast_set_topk(T(CC), T(xi), nf).numpy(),
                np.asarray(ref_icq.fast_set_topk(J(CC), J(xi), nf)))
        fm = np.array([True, False, True, False])
        assert_close(port_icq.project_codebooks(T(CC), T(xi), T(fm)),
                     ref_icq.project_codebooks(J(CC), J(xi), J(fm)), 0)
    assert_close(port_icq.margin_sigma(T(lam), T(xi), 0.5),
                 ref_icq.margin_sigma(J(lam), J(xi), 0.5), 1e-6)
    for nf in (1, 2):
        c2, r2 = (dataclasses.replace(cfg, num_fast=nf),
                  dataclasses.replace(ref_cfg, num_fast=nf))
        for CC in (C, Cs):
            got = port_icq.build_structure(T(CC), T(lam), {
                k: T(v) for k, v in thetas[0].items()}, c2)
            want = ref_icq.build_structure(J(CC), J(lam), thetas[0], r2)
            np.testing.assert_array_equal(got.xi.numpy(),
                                          np.asarray(want.xi))
            np.testing.assert_array_equal(got.fast_mask.numpy(),
                                          np.asarray(want.fast_mask))
            assert_close(got.sigma, want.sigma, 1e-6, "sigma")


# ----------------------------------------------------------- optimizer ----

@pytest.mark.parametrize("clip", [1e3, 0.05])
def test_adamw_five_steps_match_reference(clip):
    """Five AdamW steps (clip inactive at 1e3, active at 0.05; decay on
    the matrix only) under the cosine schedule."""
    rng = np.random.default_rng(7)
    params = {"w": rng.standard_normal((5, 3)).astype(np.float32),
              "b": {"x": rng.standard_normal(3).astype(np.float32),
                    "s": np.float32(0.7)}}
    kw = dict(b1=0.8, weight_decay=0.1, clip_norm=clip)
    ref = ref_opt.AdamW(lr=ref_opt.cosine_schedule(1e-2, 2, 5), **kw)
    port = port_opt.AdamW(lr=port_opt.cosine_schedule(1e-2, 2, 5), **kw)
    rp = jax.tree.map(jnp.asarray, params)
    pp = port_opt.tree_map(_t, params)
    rs, ps = ref.init(rp), port.init(pp)
    for i in range(5):
        g = jax.tree.map(lambda a: (rng.standard_normal(np.shape(a)) * 3
                                    ).astype(np.float32), params)
        rp, rs, rn = ref.update(jax.tree.map(jnp.asarray, g), rs, rp)
        pp, ps, pn = port.update(port_opt.tree_map(_t, g), ps, pp)
        assert_close(pn, rn, 1e-5, "gnorm")
        assert_close(pp, rp, 1e-5, f"params {i}")
        assert_close(ps, rs, 1e-5, f"state {i}")
    assert (float(pn) > clip) == (clip < 1.0)
    ref_lr = ref_opt.cosine_schedule(3e-3, 10, 100, 0.2)
    port_lr = port_opt.cosine_schedule(3e-3, 10, 100, 0.2)
    for s in (0, 1, 9, 10, 11, 55, 100, 150):
        assert_close(port_lr(s), ref_lr(s), 1e-6, f"lr {s}")


# --------------------------------------------------------------- embed ----

def test_embedders_match_reference():
    """linear and cnn forward (NHWC input, HWIO weights, SAME padding,
    2x2 VALID pool) and the classifier head, with the reference's
    params carried across."""
    rng = np.random.default_rng(8)
    key = jax.random.PRNGKey(3)
    x = rng.standard_normal((6, 20)).astype(np.float32)
    lin = ref_embed.linear_init(key, 20, 8, 5)
    want = ref_embed.linear_apply(lin, jnp.asarray(x))
    got = port_embed.linear_apply(port_opt.tree_map(_t, _np(lin)), _t(x))
    assert_close(got, want, 1e-5, "linear")
    img = rng.standard_normal((3, 12, 12, 2)).astype(np.float32)
    cnn = ref_embed.cnn_init(key, 12, 2, 8, 5, width=4)
    pc = port_opt.tree_map(_t, _np(cnn))
    want = ref_embed.cnn_apply(cnn, jnp.asarray(img))
    got = port_embed.cnn_apply(pc, _t(img))
    assert_close(got, want, 1e-5, "cnn")
    assert_close(port_embed.classify(pc, got),
                 ref_embed.classify(cnn, want), 1e-5, "classify")
    params, apply = port_embed.build_embedder(
        "cnn", torch.Generator().manual_seed(0), d=8, img_hw=12, channels=2)
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: tuple(v.shape) for k, v in ref_embed.cnn_init(
            key, 12, 2, 8, 10).items()}
    assert apply(params, _t(img)).shape == (3, 8)


# ---------------------------------------------------- one joint step ----

class _GradsAsParams:
    """Optimizer stand-in: returns the gradients it is handed as the new
    params (after Theta's boost, before any clip)."""

    def __init__(self, norm):
        self.norm = norm

    def update(self, grads, state, params):
        return grads, state, self.norm(grads)


@pytest.fixture(scope="module")
def joint_problem():
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((256, 24)) * np.linspace(0.2, 2.0, 24)
         ).astype(np.float32)
    y = rng.integers(0, 10, 256).astype(np.int32)
    return x, y


@pytest.fixture(scope="module", params=["icq", "cq", "pq"])
def joint_step(request, joint_problem):
    """The reference's init in one mode, its jitted step (with AdamW and
    with the gradient stand-in) on one batch of 64, as numpy."""
    mode = request.param
    x, y = joint_problem
    cfg = RefICQConfig(**CFG)
    st = ref_joint.init_train_state(
        jax.random.PRNGKey(11), cfg, d_raw=24, mode=mode,
        sample_batch=(jnp.asarray(x), jnp.asarray(y)))
    batch = (jnp.asarray(x[:64]), jnp.asarray(y[:64]))
    out = {}
    for name, opt in (("adam", st["opt"]),
                      ("grads", _GradsAsParams(ref_opt.global_norm))):
        step = jax.jit(ref_joint.make_train_step(
            cfg, st["embed_apply"], opt, mode, st["pq_mask"]))
        out[name] = jax.tree.map(np.asarray, step(
            st["params"], st["opt_state"], st["var_state"], batch))
    init = jax.tree.map(np.asarray, (st["params"], st["var_state"],
                                     st["opt_state"]))
    return mode, init, out


def test_joint_step_matches_reference(joint_step, joint_problem):
    """One step from the reference's init: loss terms to rtol 1e-5,
    gradients to 1e-4, the updated params, optimizer and variance state
    to 1e-4; psi_size and the batch's hard codes equal (a code may
    differ only at a near tie)."""
    mode, (params, var_state, opt_state), out = joint_step
    x, y = joint_problem
    cfg = ICQConfig(**CFG)
    p, v, o = port_joint.train_state_from_numpy(params, var_state,
                                                opt_state, device="cpu")
    pq_mask = port_joint._pq_support_mask(4, 8) if mode == "pq" else None
    batch = (_t(x[:64]), _t(y[:64]))
    adam = port_opt.AdamW(lr=lambda s: 1e-3, weight_decay=0.0,
                          clip_norm=1.0)
    got = {}
    for name, opt in (("adam", adam),
                      ("grads", _GradsAsParams(port_opt.global_norm))):
        step = port_joint.make_train_step(cfg, port_embed.linear_apply, opt,
                                          mode, pq_mask)
        got[name] = step(p, o, v, batch)
    g_params, g_opt, g_var, g_mets = got["adam"]
    r_params, r_opt, r_var, r_mets = out["adam"]
    assert sorted(g_mets) == sorted(r_mets)
    for k in r_mets:
        if k == "psi_size":
            assert int(g_mets[k]) == int(r_mets[k])
            assert g_mets[k].dtype == torch.int32
        else:
            assert_close(g_mets[k], r_mets[k], 1e-5, k)
    assert_close(got["grads"][0], out["grads"][0], 1e-4, "grads")
    assert_close(g_params, r_params, 1e-4, "params")
    assert_close(g_opt, r_opt, 1e-4, "opt_state")
    assert_close(g_var, r_var, 1e-4, "var_state")
    assert not any(t.requires_grad for t in port_opt.tree_leaves(
        {"params": g_params, "opt": g_opt, "var": g_var}))
    emb = port_embed.linear_apply(p["embed"], batch[0])
    codes = port_enc.soft_assign(emb, p["C"])[1]
    ref_codes = ref_enc.soft_assign(
        ref_embed.linear_apply(params["embed"], jnp.asarray(x[:64])),
        jnp.asarray(params["C"]))[1]
    assert_codes_near(codes.numpy(), ref_codes, emb.numpy(), params["C"])


def test_step_refuses_data_parallel_and_unknown_modes():
    cfg = ICQConfig(**CFG)
    opt = port_opt.AdamW(lr=lambda s: 1e-3)
    with pytest.raises(ValueError, match="needs the mesh"):
        port_joint.make_train_step(cfg, port_embed.linear_apply, opt, "icq",
                                   axis_name="data")
    with pytest.raises(ValueError, match="unknown trainer mode"):
        port_joint.make_train_step(cfg, port_embed.linear_apply, opt, "opq")
