"""FSDP execution over the mesh's ``data`` / ``pod`` axes on the CPU
(``distributed.fsdp``; ``launch.steps._fsdp_train_step``), at
``smoke_config`` size over CPU meshes (pod 2, data 2, model 1), (pod 1,
data 2, model 2) and (data 4).

A params tree laid out by the full rule-table specs (``fsdp.place``, or
``reshard_state``'s output) runs the FSDP step: each position gathers
every layer from its FSDP group's blocks where the model reads it, the
backward reduce-scatters the gradient into the owners' f32 accumulators,
and the means and AdamW run block by block.  The kinds: dense
(tinyllama), MoE + MLA (deepseek-v2), SSM (mamba2: FSDP on ``w_in``'s d
beside the segment layout on ``model``), hybrid (recurrentgemma at 3
layers, a tail layer) and encoder-decoder (whisper).  Gates against the
port's step without FSDP on the same mesh: the loss to 1e-6 relative,
params and both moments within 2e-5 of each leaf's largest (the clip's
norm sums its blocks in another order), and with the clip off every leaf
bit for bit (the same sums in the same order).  Against the reference's
unsharded step: the loss to 1e-5, params and moments within 2e-4 (an
MoE over ``data`` excepted: its data shards route and cap their own
tokens).  The port draws the params (``init`` from seed 0); they cross
over as numpy.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.launch.steps import build_train_step as ref_build_train_step
from repro_torch import configs
from repro_torch.distributed import CheckpointManager, reshard_state
from repro_torch.distributed import fsdp
from repro_torch.distributed import sharding as shrules
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import make_mesh_auto
from repro_torch.launch import steps
from repro_torch.launch.serve import lm_batch
from repro_torch.models import build_model
from repro_torch.models.transformer import params_from_numpy
from repro_torch.quant import grad_compress
from repro_torch.train import optimizer as port_opt

REF_TOL = 2e-4
PORT_TOL = 2e-5
LOSS_RTOL = 1e-5
NAMES = ("pod", "data", "model")
CASES = {"tinyllama": ("tinyllama-1.1b", (), 8),
         "deepseek": ("deepseek-v2-236b", (), 8),
         "mamba2": ("mamba2-1.3b", (), 8),
         "recurrentgemma": ("recurrentgemma-9b", (("num_layers", 3),), 40),
         "whisper": ("whisper-large-v3", (), 8)}
ROWS = 4


def _cfgs(case, **repl):
    arch, items, _ = CASES[case]
    repl = dict(items, optimizer_dtype="float32", remat=True, **repl)
    return (dataclasses.replace(ref_configs.smoke_config(arch), **repl),
            dataclasses.replace(configs.smoke_config(arch), **repl))


def _mesh(shape, names=NAMES):
    return make_mesh_auto(shape, names, devices="cpu")


@functools.lru_cache(maxsize=None)
def _params(case):
    _, cfg = _cfgs(case)
    return port_opt.tree_map(lambda t: t.numpy(),
                             build_model(cfg).init(0, device="cpu"))


def _batch(cfg, case, n_micro=1, seed=3):
    parts = [lm_batch(cfg, ROWS, CASES[case][2], seed + i)
             for i in range(n_micro)]
    batch = {k: np.stack([p[k] for p in parts]) for k in parts[0]}
    batch["labels"] = batch["tokens"]
    return batch


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = tol * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max err {err} > {bound}"


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _trees_close(got, want, tol, what):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys(), (what, got.keys() ^ want.keys())
    for name, w in want.items():
        _close(got[name], w, tol, f"{what} {name}")


def _trees_equal(got, want, what):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys(), (what, got.keys() ^ want.keys())
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    assert not bad, f"{what}: not bit for bit at {bad}"


def _whole(tree):
    return fsdp.gather(tree) if tp.is_placed(tree) else tree


def _state(out):
    """(params, {m, v, ef_residual...}, metrics) with every placed tree
    gathered whole."""
    p, o, m = out
    o = dict(o, m=_whole(o["m"]), v=_whole(o["v"]))
    if "ef_residual" in o:
        o["ef_residual"] = [_whole(r) for r in o["ef_residual"]]
    return _whole(p), o, m


def _no_clip(monkeypatch):
    """``build_train_step``'s optimizer without the clip: the update is
    then elementwise in the gradient, so equal gradients give equal
    params and moments bit for bit."""
    make = steps.make_optimizer
    monkeypatch.setattr(steps, "make_optimizer", lambda cfg, **kw: (
        dataclasses.replace(make(cfg, **kw), clip_norm=0.0)))


def _steps(cfg, mesh, *, n_micro=1, icq_grad=False):
    return steps.build_train_step(cfg, n_micro=n_micro, multi_pod=True,
                                  icq_grad=icq_grad, mesh=mesh)


@functools.lru_cache(maxsize=None)
def _ref_step(case):
    rcfg, _ = _cfgs(case)
    step, _, _, init = ref_build_train_step(rcfg, n_micro=1)
    params = jax.tree.map(jnp.asarray, _params(case))
    return jax.jit(step)(params, init(params), _batch(rcfg, case))


def _held(placed, pos) -> int:
    return sum(st.shards[pos].numel() * st.shards[pos].element_size()
               for (st,) in shrules.zip_leaves(placed))


@pytest.mark.parametrize("case,shape", [
    ("tinyllama", (2, 2, 1)), ("tinyllama", (1, 2, 2)),
    ("deepseek", (1, 2, 2)), ("mamba2", (1, 2, 2)),
    ("recurrentgemma", (2, 2, 1)), ("whisper", (1, 2, 2))])
def test_fsdp_step_matches_the_unsharded_layouts(case, shape):
    """One AdamW step from params laid out by the full specs: each
    position holds ``shard_bytes`` of them for params, m and v, and the
    output keeps the layout; the loss, norm, params and moments against
    the port's step on whole params over the same mesh and against the
    reference's unsharded step (the module docstring's gates)."""
    _, cfg = _cfgs(case)
    mesh = _mesh(shape)
    batch = _batch(cfg, case)
    params = params_from_numpy(_params(case), device="cpu")
    step, _, _, init = _steps(cfg, mesh)
    placed = fsdp.place(params, mesh)
    state = init(placed)
    want = shrules.shard_bytes(params, fsdp.shardings(params, mesh))
    for pos in np.ndindex(*mesh.devices.shape):
        assert _held(placed, pos) == _held(state["m"], pos) == \
            _held(state["v"], pos) == want, (case, pos)
    out = step(placed, state, batch)
    for tree in (out[0], out[1]["m"], out[1]["v"]):
        for got, ref in shrules.zip_leaves(tree, placed):
            assert got.sharding == ref.sharding
    pp, po, pm = _state(out)
    p0, o0, m0 = _state(step(params, init(params), batch))
    np.testing.assert_allclose(float(pm["loss"]), float(m0["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(pm["gnorm"]), float(m0["gnorm"]),
                               rtol=PORT_TOL)
    _trees_close(pp, p0, PORT_TOL, f"{case} params vs without FSDP")
    _trees_close({k: po[k] for k in "mv"}, {k: o0[k] for k in "mv"},
                 PORT_TOL, f"{case} moments vs without FSDP")
    if not cfg.num_experts:
        rp, ro, rm = _ref_step(case)
        np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                                   rtol=LOSS_RTOL)
        _trees_close(pp, rp, REF_TOL, f"{case} params vs reference")
        _trees_close({k: po[k] for k in "mv"}, {k: ro[k] for k in "mv"},
                     REF_TOL, f"{case} moments vs reference")


@pytest.mark.parametrize("shape,icq_grad", [((2, 2, 1), False),
                                            ((2, 2, 1), True),
                                            ((1, 2, 2), False)])
def test_fsdp_step_without_the_clip_is_bit_for_bit(shape, icq_grad,
                                                   monkeypatch):
    """With the clip off, the FSDP step equals the step on whole params
    over the same mesh bit for bit at n_micro 1: the loss, params, m, v
    and (icq_grad, FSDP over data) each pod's residuals; so the
    gradient's data and pod means, and icq_grad's int8 mean, are the
    same sums in the same order."""
    _no_clip(monkeypatch)
    _, cfg = _cfgs("tinyllama")
    mesh = _mesh(shape)
    batch = _batch(cfg, "tinyllama")
    params = params_from_numpy(_params("tinyllama"), device="cpu")
    step, _, _, init = _steps(cfg, mesh, icq_grad=icq_grad)
    placed = fsdp.place(params, mesh, fsdp_over_pod=not icq_grad)
    got = _state(step(placed, init(placed), batch))
    want = _state(step(params, init(params), batch))
    assert torch.equal(got[2]["loss"], want[2]["loss"])
    _trees_equal(got[0], want[0], "params")
    for k in "mv":
        _trees_equal(got[1][k], want[1][k], k)
    if icq_grad:
        assert len(got[1]["ef_residual"]) == shape[0]
        for r, w in zip(got[1]["ef_residual"], want[1]["ef_residual"]):
            _trees_equal(r, port_opt.tree_map(lambda t: t.cpu(), w),
                         "residual")


def test_icq_grad_row_scale_spans_the_fsdp_shards():
    """``ef_quantize`` of a tensor's shards along its last dim (FSDP's
    blocks of ``wo``, ``w_down``, ``embed``) equals the whole tensor's
    codes, scales and residuals bit for bit: each row's scale is its
    largest over every shard; FSDP over ``pod`` under icq_grad raises."""
    gen = torch.Generator().manual_seed(0)
    g = torch.randn(3, 6, 8, generator=gen)
    g[1, 2, 6] = 40.0                         # a row's largest in shard 3
    r = torch.randn(3, 6, 8, generator=gen) * 1e-3
    q, s, res = grad_compress.ef_quantize(g, r)
    qs, ss, rs = grad_compress.ef_quantize(list(g.split(2, -1)),
                                           list(r.split(2, -1)))
    assert torch.equal(torch.cat(qs, -1), q)
    assert torch.equal(torch.cat(rs, -1), res)
    assert all(torch.equal(si, s) for si in ss)
    _, cfg = _cfgs("tinyllama")
    mesh = _mesh((2, 2, 1))
    params = params_from_numpy(_params("tinyllama"), device="cpu")
    step, _, _, init = _steps(cfg, mesh, icq_grad=True)
    with pytest.raises(ValueError, match="fsdp_over_pod"):
        init(fsdp.place(params, mesh))


def test_n_micro_2_and_a_second_step(monkeypatch):
    """Two microbatches over (2, 2, 1), then a second step from the
    first's output (its layout kept): against the step on whole params
    within the port's gates (each owner adds a microbatch's slices as
    they come, the step without FSDP sums each position's microbatches
    first)."""
    _, cfg = _cfgs("tinyllama")
    mesh = _mesh((2, 2, 1))
    batch = _batch(cfg, "tinyllama", n_micro=2)
    params = params_from_numpy(_params("tinyllama"), device="cpu")
    step, _, _, init = _steps(cfg, mesh, n_micro=2)
    placed = fsdp.place(params, mesh)
    one = step(placed, init(placed), batch)
    assert fsdp.is_fsdp(one[0]) and fsdp.is_fsdp(one[1]["m"])
    two = step(*one[:2], batch)
    want = step(*step(params, init(params), batch)[:2], batch)
    got, want = _state(two), _state(want)
    np.testing.assert_allclose(float(got[2]["loss"]),
                               float(want[2]["loss"]), rtol=1e-6)
    _trees_close(got[0], want[0], PORT_TOL, "two steps: params")
    _trees_close({k: got[1][k] for k in "mv"},
                 {k: want[1][k] for k in "mv"}, PORT_TOL,
                 "two steps: moments")
    assert int(got[1]["step"]) == 2


@pytest.mark.parametrize("case", ["tinyllama", "mamba2"])
def test_place_holds_the_rule_tables_blocks(case):
    """Over (pod 2, data 2, model 2): each position's block of every leaf
    is the full spec's (``param_shardings``; the SSM's fused leaves in
    the segment layout on ``model``, contiguous on the FSDP dim), a dim
    that does not divide its axes stays whole, and ``gather`` gives the
    tree back bit for bit."""
    _, cfg = _cfgs(case)
    mesh = _mesh((2, 2, 2))
    params = params_from_numpy(_params(case), device="cpu")
    placed = fsdp.place(params, mesh)
    rules = shrules.param_shardings(params, mesh)
    for (leaf, st, sh) in shrules.zip_leaves(params, placed, rules):
        assert tuple(st.sharding.spec) == tuple(sh.spec)
        if st.sharding.segments:
            perm = shrules.segment_perm(st.sharding.segments, 2)
            leaf = leaf.index_select(leaf.ndim - 1, perm)
        for pos in np.ndindex(*mesh.devices.shape):
            assert torch.equal(st.shards[pos],
                               leaf[sh._slices(pos, leaf.shape)])
    _trees_equal(fsdp.gather(placed), params, "gather")
    # widths of 66 and 6 do not divide over (pod, data): whole
    odd = {"w_down": torch.zeros(2, 6, 66), "wq": torch.zeros(2, 6, 8)}
    spec = {k: tuple(st.sharding.spec) for k, st in
            fsdp.place(odd, mesh).items()}
    assert spec == {"w_down": (None, "model", None),
                    "wq": (None, None, "model")}


def test_reshard_state_output_is_taken_by_the_step():
    """``reshard_state`` of whole params onto (data 4) and onto (data 2,
    model 2) (the full specs, the SSM's fused leaves in contiguous
    blocks) runs the FSDP step: equal bit for bit to the step from
    ``fsdp.place``'s layout, mamba2 included."""
    for case, shape in (("tinyllama", (4,)), ("mamba2", (2, 2))):
        _, cfg = _cfgs(case)
        names = ("data",) if len(shape) == 1 else ("data", "model")
        mesh = _mesh(shape, names)
        batch = _batch(cfg, case)
        params = params_from_numpy(_params(case), device="cpu")
        step, _, _, init = steps.build_train_step(cfg, n_micro=1, mesh=mesh)
        moved = reshard_state(params, mesh, mesh)
        assert fsdp.is_fsdp(moved)
        got = _state(step(moved, init(moved), batch))
        placed = fsdp.place(params, mesh)
        want = _state(step(placed, init(placed), batch))
        assert torch.equal(got[2]["loss"], want[2]["loss"])
        _trees_equal(got[0], want[0], f"{case} params")
        _trees_equal(got[1]["m"], want[1]["m"], f"{case} m")


def test_checkpoint_of_fsdp_state_resumes_bit_for_bit(tmp_path):
    """A step's FSDP state saved (each leaf whole, the reference's
    layout), restored into the step's layout, and stepped: equal bit for
    bit to the uninterrupted second step; the same checkpoint restored
    through ``reshard_state`` onto (data 2, model 2) steps equal to the
    uninterrupted state resharded."""
    _, cfg = _cfgs("tinyllama")
    a = _mesh((4,), ("data",))
    b = _mesh((2, 2), ("data", "model"))
    batch = _batch(cfg, "tinyllama")
    params = params_from_numpy(_params("tinyllama"), device="cpu")
    step, _, _, init = steps.build_train_step(cfg, n_micro=1, mesh=a)
    placed = fsdp.place(params, a)
    p1, o1, _ = step(placed, init(placed), batch)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"params": p1, "opt": o1})
    flat = np.load(tmp_path / "step_00000001" / "arrays.npz")
    assert flat["params/seg0/attn/wq"].shape == tuple(
        params["seg0"]["attn"]["wq"].shape)
    back = mgr.restore(1, {"params": p1, "opt": o1})
    assert fsdp.is_fsdp(back["params"])
    got = _state(step(back["params"], back["opt"], batch))
    want = _state(step(p1, o1, batch))
    assert torch.equal(got[2]["loss"], want[2]["loss"])
    _trees_equal(got[0], want[0], "resumed params")
    _trees_equal(got[1]["v"], want[1]["v"], "resumed v")
    step_b, _, _, _ = steps.build_train_step(cfg, n_micro=1, mesh=b)

    def on_b(p, o):
        return (reshard_state(p, a, b),
                {"m": reshard_state(o["m"], a, b),
                 "v": reshard_state(o["v"], a, b), "step": o["step"]})
    got = _state(step_b(*on_b(back["params"], back["opt"]), batch))
    want = _state(step_b(*on_b(p1, o1), batch))
    assert torch.equal(got[2]["loss"], want[2]["loss"])
    _trees_equal(got[0], want[0], "resharded params")
