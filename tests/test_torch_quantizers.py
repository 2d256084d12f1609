"""The port's quantizers (``repro_torch.trainer.quantizers``) held
against the reference's on the CPU at small size (d = 16, K = 4,
m = 16, n = 500).

The two packages draw different random numbers, so every check starts
from shared inputs: the reference's init state or round init, carried
across as numpy (ROADMAP.md section 3, "Training is chaotic").
Tolerances (rounding of f32 products in two frameworks): codebooks to
rtol 1e-4 with an atol of 1e-6 of the tensor's largest magnitude,
rotations to rtol 1e-4 and atol 1e-5; variances to rtol 1e-6; codes
equal (the CQ step's ICM codes equal except at near ties, which are
counted and must stay under 1% of the rows).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ICQConfig as RefICQConfig
from repro.core import codebooks as ref_cb
from repro.core import encode as ref_enc
from repro.core import losses as ref_losses
from repro.trainer import make_quantizer as ref_make_quantizer
from repro.trainer import quantizers as ref_q
from repro_torch.configs import ICQConfig
from repro_torch.core import codebooks as cb
from repro_torch.core import encode as enc
from repro_torch.core import losses
from repro_torch.core.baselines import fit_pqn, fit_sq
from repro_torch.data import make_table1_dataset
from repro_torch.trainer import (QUANTIZER_KINDS, CQQuantizer,
                                 JointQuantizer, OPQQuantizer, PQQuantizer,
                                 fit, fit_cq, fit_opq, fit_pq,
                                 make_quantizer)
from repro_torch.trainer import quantizers as port_q

CFG = dict(d=16, num_codebooks=4, codebook_size=16, num_fast=2)
N = 500


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-4, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-6 * float(np.abs(want).max()),
                               err_msg=what)


@pytest.fixture(scope="module")
def x():
    """Table 1's dataset3, its first 16 features (as the reference's
    baseline tests take them)."""
    xtr, _, _, _ = make_table1_dataset("dataset3")
    return np.ascontiguousarray(xtr[:N, :16])


def test_pq_finalize_matches_reference(x):
    """PQ's ``finalize`` from the reference's C: codes equal, lam to
    rtol 1e-6, the plain structure."""
    cfg, pcfg = RefICQConfig(**CFG), ICQConfig(**CFG)
    q = ref_q.PQQuantizer(cfg)
    st = q.init(jax.random.PRNGKey(3), jnp.asarray(x))
    ref = q.finalize(st, jnp.asarray(x))
    got = PQQuantizer(pcfg, device="cpu").finalize({"C": _t(st["C"])}, x)
    assert got.codes.dtype == torch.uint8 and got.mode == "pq"
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(ref.codes))
    np.testing.assert_allclose(got.lam.numpy(), np.asarray(ref.lam),
                               rtol=1e-6)
    assert bool(got.structure.fast_mask.all())
    assert float(got.structure.sigma) == 0.0


def _opq_rounds(x):
    """The reference's OPQ state after its first and second rounds and
    its export."""
    q = ref_q.OPQQuantizer(RefICQConfig(**CFG), kmeans_iters=5)
    s0 = q.init(jax.random.PRNGKey(4), jnp.asarray(x))
    s1 = q.step(s0, jnp.asarray(x))
    s2 = q.step(s1, jnp.asarray(x))
    return s1, s2, q.finalize(s2, jnp.asarray(x))


def _opq_step(s1, s2, x, monkeypatch):
    """The port's second round from the reference's state after the
    first, its k-means init fed the reference's C for that round."""
    monkeypatch.setattr(port_q.cb, "init_pq",
                        lambda gen, xr, K, m, iters: _t(s2["C"]))
    pq = OPQQuantizer(ICQConfig(**CFG), kmeans_iters=5, device="cpu")
    state = {"R": _t(s1["R"]), "C": _t(s1["C"]), "seed": 0, "round": 1}
    return pq, pq.step(state, (x, None))


def test_opq_step_matches_reference(x, monkeypatch):
    """OPQ's second round from the reference's state after its first,
    with the round's k-means init fed the reference's C for that round
    (the port's ``init_pq`` is patched): R to rtol 1e-4 and atol 1e-5
    (R's entries are at most 1), then ``finalize``'s codes equal and the
    rotated lam to rtol 1e-4.  The features are standardized: on the
    raw ones the Procrustes product X^T Xbar is ill-conditioned (see
    the next test)."""
    x = (x - x.mean(0)) / x.std(0)
    s1, s2, ref = _opq_rounds(x)
    pq, got = _opq_step(s1, s2, x, monkeypatch)
    assert got["round"] == 2
    np.testing.assert_allclose(got["R"].numpy(), np.asarray(s2["R"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["R"].numpy() @ got["R"].numpy().T,
                               np.eye(16), atol=1e-5)
    model = pq.finalize({"R": _t(s2["R"]), "C": _t(s2["C"])}, x)
    np.testing.assert_array_equal(model.codes.numpy(),
                                  np.asarray(ref.codes))
    _close(model.lam, ref.lam, what="lam")
    assert sorted(model.embed_params) == ["R", "base"]
    _close(model.embed(_t(x[:8])), ref.embed(jnp.asarray(x[:8])),
           what="embed")


def test_opq_step_ill_conditioned_as_close_as_reference(x, monkeypatch):
    """On the raw features X^T Xbar spans singular values 2e3 to 6e-2,
    so an f32 rounding of it moves R = U V^T by ~1e-4 in either
    package: the port's R is no farther from the float64 Procrustes
    solution (from the reference's codes) than twice the reference's R
    is."""
    s1, s2, _ = _opq_rounds(x)
    _, got = _opq_step(s1, s2, x, monkeypatch)
    xr = x.astype(np.float64) @ np.asarray(s1["R"], np.float64)
    C = np.asarray(s2["C"], np.float64)
    codes = np.asarray(ref_enc.encode_pq(jnp.asarray(xr, jnp.float32),
                                         s2["C"]))
    xbar = sum(C[k][codes[:, k]] for k in range(C.shape[0]))
    u, _, vt = np.linalg.svd(x.astype(np.float64).T @ xbar)
    exact = u @ vt
    ref_err = np.abs(np.asarray(s2["R"]) - exact).max()
    port_err = np.abs(got["R"].numpy() - exact).max()
    assert port_err <= 2 * ref_err + 1e-6, (port_err, ref_err)


def test_cq_step_matches_reference(x):
    """CQ's step (5 AdamW updates of C, then the warm ICM re-encode)
    from the reference's init state: C and the optimizer moments to
    rtol 1e-4, codes equal except near ties (counted, < 1% of rows)."""
    cfg, pcfg = RefICQConfig(**CFG), ICQConfig(**CFG)
    q = ref_q.CQQuantizer(cfg, grad_steps=5)
    st = q.init(jax.random.PRNGKey(5), jnp.asarray(x))
    ref = q.step(st, jnp.asarray(x))
    state = {"C": _t(st["C"]), "codes": _t(st["codes"]),
             "opt_state": jax.tree.map(_t, st["opt_state"])}
    got = CQQuantizer(pcfg, grad_steps=5, device="cpu").step(state, x)
    _close(got["C"], ref["C"], what="C")
    for k in ("m", "v"):
        _close(got["opt_state"][k]["C"], ref["opt_state"][k]["C"],
               what=k)
    assert int(got["opt_state"]["step"]) == 5
    rows = (got["codes"].numpy() != np.asarray(ref["codes"])).any(1)
    assert rows.sum() < 0.01 * N, f"{rows.sum()} rows differ"
    # the export keeps the last step's codes, packed
    model = CQQuantizer(pcfg, device="cpu").finalize(got, x)
    assert model.codes.dtype == torch.uint8 and model.mode == "cq"
    np.testing.assert_array_equal(model.codes.numpy(),
                                  got["codes"].numpy())


def test_cq_fit_reduces_penalty(x):
    """As the reference's ``test_cq_reduces_cq_penalty``: 3 rounds of
    25 steps bring the CQ penalty of the port's fit below that of its
    residual init re-encoded."""
    pcfg = ICQConfig(**CFG)
    xs = _t(x)
    m = fit_cq(0, xs, pcfg, rounds=3, grad_steps=25, device="cpu")
    pen, _ = losses.cq_penalty(m.C, m.codes)
    C0 = cb.init_residual(torch.Generator().manual_seed(0), xs, 4, 16,
                          iters=5)
    pen0, _ = losses.cq_penalty(C0, enc.icm_encode(xs, C0, 2))
    assert float(pen) < float(pen0)


def test_opq_fit_rotation_orthogonal_and_not_worse_than_pq(x):
    """OPQ's rotation stays orthogonal and its quantization error is at
    most 5% above PQ's (the reference's baseline tests)."""
    pcfg = ICQConfig(**CFG)
    xs = _t(x)
    mp = fit_pq(1, xs, pcfg, device="cpu")
    mo = fit_opq(1, xs, pcfg, rounds=5, device="cpu")
    R = mo.embed_params["R"].numpy()
    np.testing.assert_allclose(R @ R.T, np.eye(16), atol=1e-4)
    ep = float(cb.quantization_mse(xs, mp.C, mp.codes))
    eo = float(cb.quantization_mse(mo.embed(xs), mo.C, mo.codes))
    assert eo <= ep * 1.05
    sup = (mp.C != 0).any(1)                   # (K, d) disjoint supports
    assert bool((sup.sum(0) <= 1).all())


@pytest.mark.parametrize("kind", ["icq", "sq", "pqn", "pq", "opq", "cq"])
def test_make_quantizer_builds_every_kind(kind):
    """Each kind builds the reference's class and joint mode, and takes
    a ``device``."""
    q = make_quantizer(kind, ICQConfig(**CFG), device="cpu")
    ref = ref_make_quantizer(kind, RefICQConfig(**CFG))
    assert type(q).__name__ == type(ref).__name__
    assert q.device == "cpu"
    if isinstance(q, JointQuantizer):
        assert q.mode == ref.mode
    assert sorted(QUANTIZER_KINDS) == ["cq", "icq", "opq", "pq", "pqn",
                                       "sq"]


def test_make_quantizer_unknown_kind_error_matches_reference():
    with pytest.raises(ValueError) as got:
        make_quantizer("lsh", ICQConfig(**CFG))
    with pytest.raises(ValueError) as want:
        ref_make_quantizer("lsh", RefICQConfig(**CFG))
    assert str(got.value) == str(want.value)


def test_joint_quantizer_protocol_matches_fit_step():
    """``JointQuantizer``'s init/step/finalize on the CPU: the step is
    the joint trainer's step and ``finalize`` exports packed codes."""
    xtr, ytr, _, _ = make_table1_dataset("dataset1")
    xs, ys = xtr[:256], ytr[:256]
    q = JointQuantizer(ICQConfig(**CFG), mode="icq", device="cpu")
    st = q.init(0, xs, ys)
    st2 = q.step(st, (xs[:64], ys[:64]))
    assert int(st2["opt_state"]["step"]) == 1
    assert not torch.equal(st2["params"]["C"], st["params"]["C"])
    assert "total" in st2["last_metrics"]
    model = q.finalize(st2, xs)
    assert model.codes.shape == (256, 4) and model.mode == "icq"


def test_fit_sq_and_pqn_equal_fit_modes():
    """``fit_sq`` is ``fit(mode="cq")`` with the linear embedder and
    ``fit_pqn`` is ``fit(mode="pq")``, with the cnn embedder when
    ``img_hw`` is given: bit for bit from the same seed."""
    cfg = ICQConfig(**CFG)
    xtr, ytr, _, _ = make_table1_dataset("dataset1")
    xs, ys = xtr[:256], ytr[:256]
    kw = dict(epochs=1, batch_size=64, device="cpu")
    a = fit_sq(2, xs, ys, cfg, **kw)
    b = fit(2, xs, ys, cfg, embed_kind="linear", mode="cq", **kw)
    assert a.mode == "cq" and torch.equal(a.C, b.C)
    assert torch.equal(a.codes, b.codes)
    a = fit_pqn(2, xs, ys, cfg, **kw)
    b = fit(2, xs, ys, cfg, embed_kind="linear", mode="pq", **kw)
    assert a.mode == "pq" and torch.equal(a.C, b.C)
    img = np.random.default_rng(0).random((96, 8, 8, 1), np.float32)
    lab = np.arange(96, dtype=np.int32) % 10
    kw = dict(epochs=1, batch_size=32, img_hw=8, channels=1,
              device="cpu")
    a = fit_pqn(3, img, lab, cfg, **kw)
    b = fit(3, img, lab, cfg, embed_kind="cnn", mode="pq", **kw)
    assert "c1" in a.embed_params and torch.equal(a.C, b.C)
    assert torch.equal(a.codes, b.codes)


def test_cq_penalty_of_reference_codes_matches(x):
    """The CQ objective the port differentiates equals the reference's
    on the same C and codes (rtol 1e-5)."""
    cfg = RefICQConfig(**CFG)
    C = ref_cb.init_residual(jax.random.PRNGKey(6), jnp.asarray(x), 4, 16,
                             iters=5)
    codes = ref_enc.icm_encode(jnp.asarray(x), C, 2)
    rec = ref_cb.decode(C, codes)
    want = float(jnp.mean(jnp.sum(jnp.square(jnp.asarray(x) - rec), -1))
                 + cfg.gamma_cq * ref_losses.cq_penalty(C, codes)[0])
    got = float(port_q._cq_loss(_t(C), _t(codes), _t(x), cfg.gamma_cq))
    assert got == pytest.approx(want, rel=1e-5)


def test_codeword_gather_gradient_is_deterministic():
    """The gradient of ``decode`` in C (the CQ step's and the joint
    step's codeword gather) is the same on every run, across threads,
    and equals the float64 scatter-add to rtol 1e-5: a sorted segment
    sum, where plain indexing's accumulating scatter changes its float
    sums from run to run."""
    g = torch.Generator().manual_seed(0)
    C = torch.randn((4, 64, 32), generator=g).requires_grad_(True)
    codes = torch.randint(0, 64, (50_000, 4), generator=g,
                          dtype=torch.int32)
    codes[codes == 5] = 6                     # an unused codeword
    w = torch.randn((50_000, 32), generator=g)
    grads = [torch.autograd.grad((cb.decode(C, codes) * w).sum(), [C])[0]
             for _ in range(3)]
    assert all(torch.equal(grads[0], x) for x in grads[1:])
    want = torch.zeros((4, 64, 32), dtype=torch.float64)
    for k in range(4):
        want[k].index_add_(0, codes[:, k].long(), w.double())
    np.testing.assert_allclose(grads[0].numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    assert float(grads[0][:, 5].abs().max()) == 0.0
