"""LM sharding of the port against the reference, on the CPU: the rule
tables (every param, cache and batch leaf of every arch at full size on
four meshes, the shapes only: the reference's ``jax.eval_shape`` under
an ``abstract_mesh``, the port's ``eval_shape`` under a mesh of meta
devices), the ICQ-KV cache rules, ``reshard_state``, the cross-shard
attention combine, the cross-pod combine programs, and the sharded train
step (a one-shard ``icq_grad`` step against the reference's, a (2, 2,
1) step against the unsharded one).

Tolerances: specs equal; the reshard round trip and the layouts bit for
bit; the combines to 1e-6 (f32 sums of a few terms); train steps as in
``test_torch_lm_train.py`` (the loss to 1e-5 relative, every leaf within
1e-4 of its largest magnitude).  An ``icq_grad`` step is held on what
carries the gradient: the gradient that its first AdamW step took, read
back from the moments (``_step_grads``), within one int8 step of each
leaf's largest pod gradient (``_check_icq``), its pre-clip norm, and its
error-feedback residuals; its params within the most an AdamW first
step can differ by (twice the learning rate).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as RP

from repro import configs as ref_configs
from repro.distributed import sharding as ref_sh
from repro.launch import steps as ref_steps
from repro.models import build_model as ref_build_model
from repro.quant import grad_compress as ref_gc
from repro.quant import kv_cache as ref_kv
from repro.quant import serve_icq as ref_serve_icq
from repro.quant.int8 import dequantize_int8 as ref_dequantize
from repro_torch import configs
from repro_torch.distributed import reshard_state
from repro_torch.distributed import sharding as sh
from repro_torch.launch import combine as port_combine
from repro_torch.launch import steps
from repro_torch.models import build_model
from repro_torch.models.transformer import params_from_numpy
from repro_torch.quant import ICQKVConfig
from repro_torch.quant import kv_cache as port_kv
from repro_torch.quant import serve_icq as port_serve_icq
from repro_torch.train import optimizer as port_opt

MESHES = [((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = ["1x1", "2x2", "16x16", "2x16x16"]
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-4
EPS32 = float(np.finfo(np.float32).eps)


def _meshes(sizes, names):
    return (ref_sh.abstract_mesh(sizes, names),
            sh.make_mesh_auto(sizes, names, devices="meta"))


def _ref_flat(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _port_flat(tree):
    out = []
    sh.tree_map_with_path(lambda p, l: out.append((p, l)), tree)
    return out


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """(reference, port) param and decode_32k cache shape trees of the
    arch at full size."""
    shape = configs.SHAPES["decode_32k"]
    rmodel = ref_build_model(ref_configs.get_config(arch))
    pmodel = build_model(configs.get_config(arch))
    rparams = jax.eval_shape(rmodel.init, jax.random.PRNGKey(0))
    rcache = jax.eval_shape(functools.partial(
        rmodel.init_cache, shape.global_batch, shape.seq_len, jnp.bfloat16))
    pparams = steps.eval_shape(pmodel.init, 0, device="cpu")
    pcache = pmodel.init_cache(shape.global_batch, shape.seq_len,
                               torch.bfloat16, device="meta")
    return rparams, rcache, pparams, pcache


def _specs_equal(ref_leaves, port_leaves, ref_rule, port_rule, what):
    ref = {ref_sh._path_str(p): tuple(ref_rule(p, l))
           for p, l in ref_leaves}
    port = {sh._path_str(p): tuple(port_rule(p, l)) for p, l in port_leaves}
    assert ref.keys() == port.keys(), (what, ref.keys() ^ port.keys())
    bad = {k: (ref[k], port[k]) for k in ref if ref[k] != port[k]}
    assert not bad, (what, bad)
    for p, l in port_leaves:                # shapes equal too
        assert tuple(l.shape) == tuple(dict(
            (ref_sh._path_str(rp), rl.shape) for rp, rl in ref_leaves)[
                sh._path_str(p)]), (what, p)
    return len(ref)


@pytest.mark.parametrize("mesh_def", MESHES, ids=MESH_IDS)
def test_rule_tables_equal_reference_for_every_arch(mesh_def):
    """Every param (also with ``fsdp_over_pod=False``), cache
    (``init_cache`` of decode_32k) and batch leaf (the serve and train
    batches of every shape) of all ten archs at full size: the port's
    spec equals the reference's, leaf for leaf."""
    rmesh, pmesh = _meshes(*mesh_def)
    n = 0
    for arch in configs.list_archs():
        rparams, rcache, pparams, pcache = _shapes(arch)
        rl, pl = _ref_flat(rparams), _port_flat(pparams)
        for over_pod in (True, False):
            n += _specs_equal(
                rl, pl,
                lambda p, l: ref_sh.param_pspec(p, l, rmesh, over_pod),
                lambda p, l: sh.param_pspec(p, l, pmesh, over_pod),
                f"{arch} params")
        rcfg, pcfg = (ref_configs.get_config(arch),
                      configs.get_config(arch))
        n += _specs_equal(_ref_flat(rcache), _port_flat(pcache),
                          lambda p, l: ref_sh.cache_pspec(p, l, rcfg, rmesh),
                          lambda p, l: sh.cache_pspec(p, l, pcfg, pmesh),
                          f"{arch} cache")
        for shape in configs.shapes_for(pcfg).values():
            for train in (True, False):
                n_micro = 4 if train else 1
                rb = ref_steps.batch_struct(rcfg, shape, n_micro,
                                            train=train)
                pb = steps.meta_batch(steps.batch_struct(
                    pcfg, shape, n_micro, train=train))
                for k in rb:
                    assert tuple(rb[k].shape) == tuple(pb[k].shape), k
                    assert tuple(ref_sh.batch_pspec(rb[k], rmesh)) == \
                        tuple(sh.batch_pspec(pb[k], pmesh)), (arch, k)
                rs = ref_steps.batch_shardings(rb, rmesh, train=train)
                ps = steps.batch_shardings(pb, pmesh, train=train)
                for k in rb:
                    assert tuple(rs[k].spec) == tuple(ps[k].spec), (arch, k)
    assert n > 400


@pytest.mark.parametrize("mesh_def", MESHES[1:3], ids=MESH_IDS[1:3])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma-7b"])
def test_icq_kv_cache_shardings_equal_reference(arch, mesh_def):
    rmesh, pmesh = _meshes(*mesh_def)
    rcfg, pcfg = ref_configs.get_config(arch), configs.get_config(arch)
    kv = ICQKVConfig(d_fast=16)
    _, rinit = ref_serve_icq.build_icq_decode(rcfg, ref_kv.ICQKVConfig(
        d_fast=16))
    _, pinit = port_serve_icq.build_icq_decode(pcfg, kv, mesh=pmesh)
    rc = jax.eval_shape(functools.partial(rinit, 32, 4096))
    pc = pinit(32, 4096, device="meta")
    rs = ref_serve_icq.icq_kv_cache_shardings(rc, rcfg, rmesh)
    ps = port_serve_icq.icq_kv_cache_shardings(pc, pcfg, pmesh)
    ref = {ref_sh._path_str(p): tuple(s.spec) for p, s in
           jax.tree_util.tree_flatten_with_path(
               rs, is_leaf=lambda x: hasattr(x, "spec"))[0]}
    port = {sh._path_str(p): tuple(s.spec) for p, s in _port_flat(ps)}
    assert ref == port


def test_named_sharding_lays_out_and_gathers():
    """A spec over two axes: every position holds its block (row-major
    over the entry's axes), replicated positions share one tensor, the
    gather is ``x`` bit for bit; the data-shard layout of () and
    ("data",) is unchanged."""
    mesh = sh.make_mesh_auto((2, 3), ("data", "model"), devices="cpu")
    x = torch.arange(12 * 6, dtype=torch.float32).reshape(12, 6)
    s = sh.NamedSharding(mesh, sh.P(("data", "model"), None))
    st = s.put(x)
    assert s.shard_shape(x.shape) == (2, 6)
    for d in range(2):
        for m in range(3):
            j = d * 3 + m
            assert torch.equal(st.shards[d, m], x[2 * j:2 * j + 2])
    assert torch.equal(s.gather(st), x)
    s2 = sh.NamedSharding(mesh, sh.P(None, "data"))
    st2 = s2.lay_out(x)
    assert st2.shards[0, 0] is st2.shards[0, 2]
    assert torch.equal(st2.gather(), x)
    rows = sh.NamedSharding(sh.make_mesh_auto((4,), ("data",),
                                              devices="cpu"), ("data",))
    parts = rows.put(torch.arange(10.0))
    assert [len(p) for p in parts] == [3, 3, 3, 1]
    assert torch.equal(rows.gather(parts), torch.arange(10.0))


def test_reshard_state_round_trips_bit_for_bit():
    """tinyllama's smoke params from (data 4) to (data 2, model 2) and
    back: every shard the new mesh's param rules' block, the gathered
    leaves equal the originals bit for bit."""
    cfg = configs.smoke_config("tinyllama-1.1b")
    params = build_model(cfg).init(0, device="cpu")
    a = sh.make_mesh_auto((4,), ("data",), devices="cpu")
    b = sh.make_mesh_auto((2, 2), ("data", "model"), devices="cpu")
    on_a = reshard_state(params, b, a)
    on_b = reshard_state(on_a, a, b, cfg)
    back = reshard_state(on_b, b, a)
    rules = sh.param_shardings(params, b)
    n_split = 0
    for (path, leaf), (_, st) in zip(_port_flat(params), _port_flat(on_b)):
        rule = rules
        for key in path:
            rule = rule[key]
        assert tuple(st.sharding.spec) == tuple(rule.spec), path
        assert tuple(st.shards[0, 0].shape) == rule.shard_shape(leaf.shape)
        n_split += st.shards[0, 0].numel() < leaf.numel()
    for (path, leaf), (_, st) in zip(_port_flat(params), _port_flat(back)):
        assert torch.equal(st.gather(), leaf), path
    assert n_split >= 5


def test_combine_attention_partials_equals_local_combine():
    """Per-shard (m, l, o) partials of a position-sharded ICQ-KV cache,
    each on its shard: the gathered combine equals
    ``combine_partials_local`` bit for bit and the reference's to 1e-6."""
    rng = np.random.default_rng(0)
    b, s, kvh, g, dh, shards = 2, 64, 2, 2, 32, 4
    kvc = ICQKVConfig(d_fast=8)
    k = rng.standard_normal((b, s, kvh, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, dh)).astype(np.float32)
    q = rng.standard_normal((b, 1, kvh * g, dh)).astype(np.float32)
    cache = port_kv.build_icq_kv_cache(kvc, torch.tensor(k), torch.tensor(v),
                                       max_len=s)
    sl = s // shards
    parts = []
    for i in range(shards):
        local = {n: (t if n in ("perm", "len") else t[:, i * sl:(i + 1) * sl])
                 for n, t in cache.items()}
        parts.append(port_kv.icq_kv_attention_partial(
            torch.tensor(q), local, kvc, s - 1, 8, shard_offset=i * sl))
    mesh = sh.make_mesh_auto((1, shards), ("data", "model"), devices="cpu")
    got = port_kv.combine_attention_partials(*zip(*parts), mesh=mesh)
    want = port_kv.combine_partials_local(
        *(torch.stack(p) for p in zip(*parts)))
    assert torch.equal(got, want)
    ref = ref_kv.combine_partials_local(
        *(jnp.asarray(torch.stack(p).numpy()) for p in zip(*parts)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_combine_programs_numerics():
    """Over a singleton pod: the f32 combine is the identity and the int8
    one dequant(quant(g)) (the reference's test); over 2 pods of 2 x 2
    devices, run position by position, the f32 mean and the int8 mean
    of the pods' dequantized payloads, equal to the reference's
    ``ef_quantize`` / ``dequantize_int8`` to 1e-6."""
    g = (torch.randn(64, 32, generator=torch.Generator().manual_seed(0))
         * 0.01)
    r = torch.zeros_like(g)
    out, _ = port_combine._combine_fp32([g], [r])
    assert torch.equal(out, g)
    out, res = port_combine._combine_int8([g], [r])
    rq, rs, _ = ref_gc.ef_quantize(jnp.asarray(g.numpy()),
                                   jnp.asarray(r.numpy()))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_dequantize(
        rq, rs)), atol=1e-6)
    np.testing.assert_allclose((res[0] + out).numpy(), g.numpy(),
                               atol=1e-7)
    cfg = configs.smoke_config("tinyllama-1.1b")
    mesh = sh.make_mesh_auto((2, 2, 2), ("pod", "data", "model"),
                             devices="cpu")
    for compressed in (False, True):
        plan = port_combine.plan_combine_cell(cfg, mesh,
                                              compressed=compressed)
        rows = plan.args[0].shape[0]
        assert rows % 4 == 0 and rows * 256 >= cfg.param_count()
        pods = [torch.randn(plan.args[0].shape,
                            generator=torch.Generator().manual_seed(p))
                for p in range(2)]
        lay = [plan.in_shardings[0].lay_out(x) for x in pods]
        grid = np.empty(mesh.devices.shape, dtype=object)
        zeros = np.empty(mesh.devices.shape, dtype=object)
        for pos in np.ndindex(*grid.shape):
            grid[pos] = lay[pos[0]].shards[pos]
            zeros[pos] = torch.zeros_like(grid[pos])
        means, _ = port_combine.run_combine(plan, grid, zeros)
        got = torch.cat([means[0, d, m] for d in range(2)
                         for m in range(2)])
        if compressed:
            want = sum(ref_dequantize(*ref_gc.ef_quantize(
                jnp.asarray(x.numpy()), jnp.zeros(x.shape))[:2])
                for x in pods) / 2
        else:
            want = (pods[0] + pods[1]).numpy() / 2
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-6)
        lowered, _ = port_combine.lower_combine(cfg, mesh,
                                                compressed=compressed)
        block = rows // 4 * 256
        assert lowered.wire_bytes == (block + rows // 4 * 4 if compressed
                                      else 4.0 * block)


def _batch(cfg, b, n_micro, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (n_micro, b, 16), dtype=np.int32)
    return {"tokens": toks, "labels": toks.copy()}


def _leaves(tree):
    """{path: f32 numpy array} of a port or a reference tree."""
    return {sh._path_str(p): (l.float().numpy()
                              if isinstance(l, torch.Tensor)
                              else np.asarray(l, np.float32))
            for p, l in _port_flat(tree)}


def _close(got, want, tol, what, atol=0.0):
    """Every leaf of ``got`` within ``atol`` + ``tol`` of the largest
    magnitude of ``want``'s leaf."""
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys(), what
    for k, w in want.items():
        bound = atol + tol * max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(got[k] - w).max()) <= bound, (what, k)


def _step_grads(opt, out):
    """The combined gradient that a first AdamW step (zero moments before
    it) took, read back from its moments and its pre-clip norm: m = (1 -
    b1) c g and v = (1 - b2) (c g)^2 with c = min(1, clip_norm / gnorm).
    Returns ({path: g from m}, {path: |g| from v})."""
    _, state, metrics = out
    c = min(1.0, opt.clip_norm / max(float(metrics["gnorm"]), 1e-9))
    g = {k: m / ((1 - opt.b1) * c) for k, m in _leaves(state["m"]).items()}
    a = {k: np.sqrt(v / (1 - opt.b2)) / c
         for k, v in _leaves(state["v"]).items()}
    return g, a


def _first_lr(opt):
    return float(opt.lr(torch.ones((), dtype=torch.int32)))


def _check_icq(opt, out, plain, pod_grads, what):
    """An ``icq_grad`` first step ``out`` against the plain step ``plain``
    over the same rows, ``pod_grads`` each pod's own gradient.  Each
    pod's gradient row is rounded to its int8 grid (step = the row's
    largest / 127), which moves an element by at most half a step, so the
    pods' mean moves by at most B / 2, B = M / 127 with M the leaf's
    largest magnitude over the pods' gradients.  Held: every gradient
    element (from m; its magnitude from v) within B of the plain step's;
    the pre-clip norm within the norm of those half steps; the
    residuals' pod mean equal to the plain gradient less the compressed
    one within LEAF_TOL of M (the sharded plain step's own bound); every
    residual within half a step (1 + LEAF_TOL); the params within twice
    the first step's learning rate (an AdamW first step moves an element
    by less than the rate) and f32 rounding."""
    g, a = _step_grads(opt, out)
    g0, _ = _step_grads(opt, plain)
    res = [_leaves(r) for r in out[1]["ef_residual"]]
    assert len(res) == len(pod_grads), what
    norm_sq = 0.0
    for k, want in g0.items():
        M = max(float(np.abs(pg[k]).max()) for pg in pod_grads)
        B = M / 127
        assert float(np.abs(g[k] - want).max()) <= B, (what, "m", k)
        assert float(np.abs(a[k] - np.abs(want)).max()) <= B, (what, "v", k)
        mean_res = sum(r[k] for r in res) / len(res)
        assert float(np.abs(mean_res - (want - g[k])).max()) \
            <= LEAF_TOL * M, (what, "residual", k)
        assert max(float(np.abs(r[k]).max()) for r in res) \
            <= (1 + LEAF_TOL) * M / 254, (what, "residual bound", k)
        norm_sq += want.size * (B / 2) ** 2
    gn, gn0 = float(out[2]["gnorm"]), float(plain[2]["gnorm"])
    assert abs(gn - gn0) <= np.sqrt(norm_sq) + LOSS_RTOL * gn0, (what, gn,
                                                                 gn0)
    _close(out[0], plain[0], 2 * EPS32, (what, "params"),
           atol=2 * _first_lr(opt))


@functools.lru_cache(maxsize=None)
def _nparams():
    cfg = configs.smoke_config("tinyllama-1.1b")
    return port_opt.tree_map(lambda t: t.numpy(),
                             build_model(cfg).init(0, device="cpu"))


def test_icq_grad_step_on_one_pod_matches_reference():
    """The compressed cross-pod combine on a (1, 1, 1) mesh, from the same
    weights and batch as the reference's step under its shard_map
    (``tests/test_launch.py``): the loss and the pre-clip norm to 1e-5;
    the gradient (from the moments) and the residual within one int8
    step of the leaf's largest, M / 127, and 3 LEAF_TOL M of the
    reference's (a rounding flip moves an element by one step of its
    row, the two sides' gradients and row maxima agreeing within
    LEAF_TOL of M); the port's ``icq_grad`` step against its plain step as
    ``_check_icq`` holds it; one residual tree."""
    rcfg = dataclasses.replace(ref_configs.smoke_config("tinyllama-1.1b"),
                               microbatch_size=1)
    pcfg = dataclasses.replace(configs.smoke_config("tinyllama-1.1b"),
                               microbatch_size=1)
    nparams = _nparams()
    batch = _batch(pcfg, 2, 1, 3)
    rmesh = ref_sh.make_mesh_auto((1, 1, 1), ("pod", "data", "model"))
    rstep, _, _, rinit = ref_steps.build_train_step(
        rcfg, n_micro=1, multi_pod=True, icq_grad=True, mesh=rmesh)
    rparams = jax.tree.map(jnp.asarray, nparams)
    rout = jax.jit(ref_sh.shard_map_compat(
        rstep, rmesh, (RP(),) * 3, (RP(),) * 3))(rparams, rinit(rparams),
                                                 batch)
    pmesh = sh.make_mesh_auto((1, 1, 1), ("pod", "data", "model"),
                              devices="cpu")
    outs = {}
    for icq in (False, True):
        pstep, _, opt, pinit = steps.build_train_step(
            pcfg, n_micro=1, multi_pod=True, icq_grad=icq, mesh=pmesh)
        params = params_from_numpy(nparams, device="cpu")
        state = pinit(params)
        assert ("ef_residual" in state) == icq
        if icq:
            assert len(state["ef_residual"]) == 1
        outs[icq] = pstep(params, state, batch)
    out = outs[True]
    np.testing.assert_allclose(float(out[2]["loss"]), float(rout[2]["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(out[2]["gnorm"]),
                               float(rout[2]["gnorm"]), rtol=LOSS_RTOL)
    plain_g, _ = _step_grads(opt, outs[False])
    largest = {k: float(np.abs(g).max()) for k, g in plain_g.items()}
    g, _ = _step_grads(opt, out)
    rg, _ = _step_grads(opt, rout)
    res, rres = _leaves(out[1]["ef_residual"][0]), _leaves(
        rout[1]["ef_residual"])
    assert g.keys() == rg.keys() == res.keys() == rres.keys()
    for k, M in largest.items():
        flip = M / 127 + 3 * LEAF_TOL * M
        assert float(np.abs(g[k] - rg[k]).max()) <= flip, ("m", k)
        assert float(np.abs(res[k] - rres[k]).max()) <= flip, ("residual",
                                                               k)
    _check_icq(opt, out, outs[False], [plain_g], "icq vs plain")
    _close(out[0], rout[0], 2 * EPS32, "params", atol=2 * _first_lr(opt))


def _pod_grads(step0, init0, opt, nparams, batch, pods):
    """Each pod's own gradient: the unsharded step over the pod's rows
    (rows split over (pod, data) in pod-major blocks)."""
    rows = batch["tokens"].shape[1] // pods
    out = []
    for p in range(pods):
        params = params_from_numpy(nparams, device="cpu")
        part = {k: v[:, p * rows:(p + 1) * rows] for k, v in batch.items()}
        out.append(_step_grads(opt, step0(params, init0(params),
                                          part))[0])
    return out


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("icq_grad", [False, True])
def test_sharded_step_matches_unsharded(n_micro, icq_grad):
    """A (2, 2, 1) (pod, data, model) step over 8 rows a microbatch (2
    rows a shard) against the unsharded step from the same params and
    batch: the loss and the pre-clip norm to 1e-5; params and moments
    within 1e-4 of each leaf's largest (plain); as ``_check_icq`` holds
    it, against each pod's own gradient (icq_grad: one residual tree a
    pod)."""
    cfg = configs.smoke_config("tinyllama-1.1b")
    nparams = _nparams()
    batch = _batch(cfg, 8, n_micro, 7 + n_micro)
    step0, _, opt, init0 = steps.build_train_step(cfg, n_micro=n_micro)
    params = params_from_numpy(nparams, device="cpu")
    plain = step0(params, init0(params), batch)
    mesh = sh.make_mesh_auto((2, 2, 1), ("pod", "data", "model"),
                             devices="cpu")
    step, _, _, init = steps.build_train_step(
        cfg, n_micro=n_micro, multi_pod=True, icq_grad=icq_grad, mesh=mesh)
    params = params_from_numpy(nparams, device="cpu")
    out = step(params, init(params), batch)
    (p0, o0, m0), (p1, o1, m1) = plain, out
    np.testing.assert_allclose(float(m1["loss"]), float(m0["loss"]),
                               rtol=LOSS_RTOL)
    if icq_grad:
        pods = _pod_grads(step0, init0, opt, nparams, batch, 2)
        _check_icq(opt, out, plain, pods, "icq vs unsharded")
    else:
        np.testing.assert_allclose(float(m1["gnorm"]), float(m0["gnorm"]),
                                   rtol=LOSS_RTOL)
        _close(p1, p0, LEAF_TOL, "params")
        _close({"m": o1["m"], "v": o1["v"]}, {"m": o0["m"], "v": o0["v"]},
               LEAF_TOL, "moments")


def test_sharded_step_replicates_rows_that_do_not_split():
    """3 rows over (2, 2, 1): ``batch_pspec`` replicates them, so each pod
    computes all rows (one data shard a pod) and the step equals the
    unsharded one (plain: loss, norm, params and moments bit for bit;
    icq_grad: every pod's gradient the unsharded one, as ``_check_icq``
    holds it, one residual a pod)."""
    cfg = configs.smoke_config("tinyllama-1.1b")
    nparams = _nparams()
    batch = _batch(cfg, 3, 1, 4)
    step0, _, opt, init0 = steps.build_train_step(cfg, n_micro=1)
    params = params_from_numpy(nparams, device="cpu")
    plain = step0(params, init0(params), batch)
    p0, o0, m0 = plain
    g0, _ = _step_grads(opt, plain)
    mesh = sh.make_mesh_auto((2, 2, 1), ("pod", "data", "model"),
                             devices="cpu")
    for icq in (False, True):
        step, _, _, init = steps.build_train_step(
            cfg, n_micro=1, multi_pod=True, icq_grad=icq, mesh=mesh)
        out = step(params, init(params), batch)
        p1, o1, m1 = out
        assert float(m1["loss"]) == float(m0["loss"])
        if icq:
            _check_icq(opt, out, plain, [g0, g0], "icq replicated")
        else:
            assert float(m1["gnorm"]) == float(m0["gnorm"])
            _close(p1, p0, 0.0, "params")
            _close({"m": o1["m"], "v": o1["v"]},
                   {"m": o0["m"], "v": o0["v"]}, 0.0, "moments")
