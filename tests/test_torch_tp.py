"""Tensor-parallel execution over the mesh's ``model`` axis on the CPU
(``distributed.tensor_parallel``; the layers' ``*_tp`` functions; the
split train step), at ``smoke_config`` size over CPU meshes (model 2),
(data 2, model 2) and (pod 1, data 2, model 2).

The configs: tinyllama (4 query heads over 1 KV head: its ``wk`` / ``wv``
split inside the head, the cache split by sequence), tinyllama with 2
KV heads (the heads split, the cache split by heads), deepseek-v2 (MLA
and MoE), moonshot (MoE with a dense first layer) and internvl2 (the
VLM's ``vis_proj`` split).  The port draws the params (``init`` from
seed 0); they cross over as numpy, and the same numpy batch goes
through the reference's *unsharded* ``prefill`` / ``decode_step`` and
train step (the result GSPMD gives, up to the order of its sums) and
through the port's split ones.  Gates against the reference: logits
within 2e-4 of the largest, the loss to 1e-5, params, both moments and
the pre-clip norm within 2e-4 of each leaf's largest, greedy tokens
equal over 4 steps.  Against the port's unsharded path: logits and
every leaf within 2e-5 of the largest (f32 partials summed in another
order: measured about 1e-6), the loss to 1e-6.  The train step runs with
f32 moments (deepseek's and internvl's smoke configs keep them in bf16,
where a moment rounding to the other side of a bf16 step moves it by
2^-8 of itself whatever the gradient).
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
from repro.models import build_model as ref_build_model
from repro_torch import configs
from repro_torch.distributed import sharding as shrules
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import make_mesh_auto
from repro_torch.launch.steps import build_serve_fns, build_train_step
from repro_torch.models import build_model
from repro_torch.models import mla as mla_mod
from repro_torch.models.transformer import params_from_numpy
from repro_torch.train import optimizer as port_opt

REF_TOL = 2e-4
PORT_TOL = 2e-5
LOSS_RTOL = 1e-5
MESHES = {"m2": ((2,), ("model",)),
          "d2m2": ((2, 2), ("data", "model")),
          "p1d2m2": ((1, 2, 2), ("pod", "data", "model"))}
CASES = {"tinyllama": ("tinyllama-1.1b", ()),
         "tinyllama-kvh2": ("tinyllama-1.1b", (("num_kv_heads", 2),)),
         "deepseek": ("deepseek-v2-236b", ()),
         "moonshot": ("moonshot-v1-16b-a3b", ()),
         "internvl": ("internvl2-76b", ())}
B, S, STEPS, MAX_LEN = 2, 8, 4, 16


def _mesh(name):
    shape, names = MESHES[name]
    return make_mesh_auto(shape, names, devices="cpu")


def _cfgs(case, **repl):
    arch, items = CASES[case]
    repl = dict(items, **repl)
    return (dataclasses.replace(ref_configs.smoke_config(arch), **repl),
            dataclasses.replace(configs.smoke_config(arch), **repl))


@functools.lru_cache(maxsize=None)
def _params(case):
    _, cfg = _cfgs(case)
    return port_opt.tree_map(lambda t: t.numpy(),
                             build_model(cfg).init(0, device="cpu"))


def _batch(cfg, lead=(), seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, lead + (B, S), dtype=np.int32)
    batch = {"tokens": toks}
    if cfg.frontend == "vision_stub":
        batch["patch_emb"] = rng.standard_normal(
            lead + (B, cfg.num_vision_tokens, cfg.vision_dim)).astype(
                np.float32)
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


@functools.lru_cache(maxsize=None)
def _ref_serve(case):
    """The reference's unsharded prefill and 4 greedy decode steps:
    (logits of each stage, the greedy tokens fed after each)."""
    rcfg, _ = _cfgs(case)
    model = ref_build_model(rcfg)
    params = jax.tree.map(jnp.asarray, _params(case))
    prefill = jax.jit(model.prefill, static_argnums=2)
    decode = jax.jit(model.decode_step)
    logits, cache = prefill(params, _batch(rcfg), MAX_LEN)
    outs, toks = [np.asarray(logits)], []
    for _ in range(STEPS):
        tok = np.asarray(jnp.argmax(logits[:, -1], -1)).astype(np.int32)
        toks.append(tok[:, None])
        logits, cache = decode(params, tok[:, None], cache)
        outs.append(np.asarray(logits))
    return outs, toks


def _serve(cfg, params, mesh, toks):
    """The port's prefill and decode steps fed ``toks``: (logits of each
    stage, its greedy tokens, the final caches)."""
    prefill, decode, _ = build_serve_fns(cfg, mesh=mesh)
    logits, caches = prefill(params, _batch(cfg), MAX_LEN)
    outs, greedy = [logits], []
    for tok in toks:
        greedy.append(logits[:, -1].argmax(-1).numpy().astype(np.int32))
        logits, caches = decode(params, tok, caches)
        outs.append(logits)
    return outs, greedy, caches


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("case", list(CASES))
def test_split_serving_matches_reference(case, mesh_name):
    """Prefill and 4 greedy decode steps split over the mesh's model
    axis (placed params) against the reference's unsharded ones and the
    port's unsharded ones; the caches, gathered from their blocks,
    against the unsharded port's; greedy tokens equal."""
    _, cfg = _cfgs(case)
    mesh = _mesh(mesh_name)
    want, toks = _ref_serve(case)
    params = params_from_numpy(_params(case), device="cpu")
    placed = tp.place(params, mesh)
    got, greedy, caches = _serve(cfg, placed, mesh, toks)
    plain, _, plain_caches = _serve(cfg, params, None, toks)
    assert build_model(cfg, mesh=mesh).split
    for i, (g, w, p) in enumerate(zip(got, want, plain)):
        _close(g, w, REF_TOL, f"{case} stage {i} vs reference")
        _close(g, p, PORT_TOL, f"{case} stage {i} vs unsharded")
    for i, (g, t) in enumerate(zip(greedy, toks)):
        assert np.array_equal(g, t[:, 0]), (case, i)
    assert int(caches["pos"]) == int(plain_caches["pos"])
    whole = {k: tp.view_whole(v) for k, v in caches.items() if k != "pos"}
    _trees_close(whole, {k: v for k, v in plain_caches.items()
                         if k != "pos"}, PORT_TOL, f"{case} caches")


def test_cache_layouts_follow_cache_pspec():
    """The split caches hold exactly ``cache_pspec``'s model split:
    tinyllama (1 KV head over 2 shards) by sequence, with 2 KV heads by
    heads, deepseek's latent and rope key by sequence; a prompt past
    the blocks' boundary lands in both."""
    mesh = _mesh("m2")
    for case, names, dim in (("tinyllama", ("k", "v"), 1),
                             ("tinyllama-kvh2", ("k", "v"), 2),
                             ("deepseek", ("latent", "k_rope"), 1)):
        _, cfg = _cfgs(case)
        model = build_model(cfg, mesh=mesh)
        caches = model.init_cache(B, MAX_LEN)
        whole = build_model(cfg).init_cache(B, MAX_LEN, device="cpu")
        for seg in (k for k in caches if k != "pos"):
            for name in names:
                split = caches[seg][name]
                sh = shrules.NamedSharding(mesh, shrules.model_pspec(
                    (seg, name), whole[seg][name], mesh, cfg))
                assert split.dim == dim + 1, (case, seg, name)
                for blk in split:
                    assert tuple(blk.shape) == sh.shard_shape(
                        whole[seg][name].shape)


@pytest.mark.parametrize("case", ["tinyllama", "deepseek"])
def test_split_paths_past_attn_chunk(case, monkeypatch):
    """Past ``attn_chunk`` (4 of an 8-token prompt): the CPU's chunked
    paths, and deepseek's MLA by the card's block-wise path
    (``_MLABlockwise``, on the CPU through the flash kernel's plain
    versions) under autograd: the split prefill, decode and gradients
    against the unsharded port's."""
    _, cfg = _cfgs(case, attn_chunk=4)
    mesh = _mesh("m2")
    params = params_from_numpy(_params(case), device="cpu")
    for blockwise in ((False, True) if case == "deepseek" else (False,)):
        if blockwise:
            monkeypatch.setattr(mla_mod, "on_card", lambda t: True)
        _, toks = _ref_serve(case)
        got, _, _ = _serve(cfg, params, mesh, toks[:2])
        want, _, _ = _serve(cfg, params, None, toks[:2])
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, PORT_TOL, f"{case} {blockwise} stage {i}")
        batch = dict(_batch(cfg), labels=_batch(cfg)["tokens"])
        grads = []
        for m in (mesh, None):
            model = build_model(cfg, mesh=m)
            if m is None:
                leaves = [t.detach().requires_grad_(True)
                          for t in port_opt.tree_leaves(params)]
                loss, _ = model.train_forward(
                    port_opt.tree_unflatten(params, leaves), batch)
                grads.append(port_opt.tree_unflatten(
                    params, torch.autograd.grad(loss, leaves)))
                continue
            v = tp.group_view(tp.place(params, mesh), mesh)
            lv, leaves = tp.live(v)
            loss, _ = model.train_forward(lv, batch)
            gr = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads.append(tp.view_whole(tp.grads_view(v, lv, leaves, gr)))
        _trees_close(grads[0], grads[1], PORT_TOL, f"{case} grads")


@functools.lru_cache(maxsize=None)
def _ref_step(case):
    rcfg, _ = _cfgs(case, optimizer_dtype="float32")
    step, _, _, init = ref_build_train_step(rcfg, n_micro=1)
    params = jax.tree.map(jnp.asarray, _params(case))
    batch = _batch(rcfg, lead=(1,), seed=3)
    batch["labels"] = batch["tokens"]
    return jax.jit(step)(params, init(params), batch)


def _gathered(out):
    p, o, m = out
    return tp.gather(p), dict(o, m=tp.gather(o["m"]),
                              v=tp.gather(o["v"])), m


@pytest.mark.parametrize("case,mesh_name", [
    ("tinyllama", "m2"), ("tinyllama", "d2m2"), ("tinyllama", "p1d2m2"),
    ("tinyllama-kvh2", "p1d2m2"), ("deepseek", "m2"), ("deepseek", "d2m2"),
    ("moonshot", "m2"), ("moonshot", "p1d2m2"), ("internvl", "d2m2")])
def test_split_train_step_matches_reference(case, mesh_name):
    """One AdamW step split over the model axis (each data shard's model
    group on its rows, the data and pod means block by block, AdamW on
    the blocks; params and moments placed) from the same params and
    batch: the loss, the pre-clip norm, params and both moments
    (gathered from their blocks) against the port's step over the same
    (pod, data) shards with the model axis at 1, and against the
    reference's unsharded step (an MoE over model only: its data shards
    route and cap their own tokens, as the port's data-parallel step
    does); the placed layout kept."""
    _, cfg = _cfgs(case, optimizer_dtype="float32")
    mesh = _mesh(mesh_name)
    batch = _batch(cfg, lead=(1,), seed=3)
    batch["labels"] = batch["tokens"]
    multi_pod = "pod" in mesh.axis_names
    step, _, _, init = build_train_step(cfg, n_micro=1, multi_pod=multi_pod,
                                        mesh=mesh)
    params = params_from_numpy(_params(case), device="cpu")
    out = step(params, init(params), batch)
    assert tp.is_placed(out[0]) and tp.is_placed(out[1]["m"])
    pp, po, pm = _gathered(out)
    if not (cfg.num_experts and "data" in mesh.axis_names):
        rp, ro, rm = _ref_step(case)
        np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(pm["gnorm"]), float(rm["gnorm"]),
                                   rtol=REF_TOL)
        _trees_close(pp, rp, REF_TOL, f"{case} params")
        _trees_close({"m": po["m"], "v": po["v"]},
                     {"m": ro["m"], "v": ro["v"]}, REF_TOL,
                     f"{case} moments")
        assert int(po["step"]) == int(ro["step"]) == 1
    unsplit = make_mesh_auto(
        tuple(1 if a == "model" else n for a, n in mesh.shape.items()),
        mesh.axis_names, devices="cpu")
    step0, _, _, init0 = build_train_step(cfg, n_micro=1,
                                          multi_pod=multi_pod, mesh=unsplit)
    p0, o0, m0 = step0(params, init0(params), batch)
    np.testing.assert_allclose(float(pm["loss"]), float(m0["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(pm["gnorm"]), float(m0["gnorm"]),
                               rtol=PORT_TOL)
    _trees_close(pp, p0, PORT_TOL, f"{case} params vs unsharded")
    _trees_close({"m": po["m"], "v": po["v"]},
                 {"m": o0["m"], "v": o0["v"]}, PORT_TOL,
                 f"{case} moments vs unsharded")


def test_split_step_takes_its_placed_output_and_icq_grad():
    """A second step takes the first's placed params and state (two
    microbatches); the icq_grad step over (pod 1, data 2, model 2) keeps
    one residual tree of blocks a pod and lands within an int8 step (a
    rounding flip: 1/127 of a row's largest) of the unsplit icq_grad
    step over (pod 1, data 2)."""
    _, cfg = _cfgs("tinyllama")
    mesh = _mesh("p1d2m2")
    batch = _batch(cfg, lead=(2,), seed=4)
    batch["labels"] = batch["tokens"]
    params = params_from_numpy(_params("tinyllama"), device="cpu")
    step, _, _, init = build_train_step(cfg, n_micro=2, multi_pod=True,
                                        mesh=mesh)
    one = step(params, init(params), batch)
    two = step(*one[:2], batch)
    step0, _, _, init0 = build_train_step(cfg, n_micro=2)
    want = step0(*step0(params, init0(params), batch)[:2], batch)
    got = _gathered(two)
    _trees_close(got[0], want[0], PORT_TOL, "two steps: params")
    _trees_close({k: got[1][k] for k in "mv"},
                 {k: want[1][k] for k in "mv"}, PORT_TOL,
                 "two steps: moments")
    assert int(got[1]["step"]) == 2
    outs = []
    for m in (mesh, make_mesh_auto((1, 2, 1), ("pod", "data", "model"),
                                   devices="cpu")):
        step, _, _, init = build_train_step(cfg, n_micro=2, multi_pod=True,
                                            icq_grad=True, mesh=m)
        out = step(params, init(params), batch)
        outs.append(_gathered(out) if tp.is_placed(out[0]) else out)
    assert len(outs[0][1]["ef_residual"]) == 1
    _trees_close({k: outs[0][1][k] for k in "mv"},
                 {k: outs[1][1][k] for k in "mv"}, 1.01 / 127,
                 "icq_grad moments")
    np.testing.assert_allclose(float(outs[0][2]["loss"]),
                               float(outs[1][2]["loss"]), rtol=1e-6)


@pytest.mark.parametrize("arch", configs.list_archs())
def test_model_pspec_keeps_the_rule_tables_model_entries(arch):
    """``model_pspec`` of every param leaf at full size over (2, 2, 16):
    the rule table's spec with its ``data`` / ``pod`` entries dropped."""
    mesh = make_mesh_auto((2, 2, 16), ("pod", "data", "model"),
                          devices="meta")
    from repro_torch.launch.steps import eval_shape
    params = eval_shape(build_model(configs.get_config(arch)).init, 0,
                        device="cpu")
    for (path, leaf), (sh,) in zip(
            _paths(params), shrules.zip_leaves(
                shrules.model_shardings(params, mesh))):
        full = shrules.param_pspec(path, leaf, mesh)
        assert tuple(sh.spec) == tuple(
            "model" if "model" in shrules.entry_axes(e) else None
            for e in full), (arch, path)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("case", list(CASES))
def test_place_holds_the_rule_tables_blocks(case):
    """Over (pod 1, data 2, model 2): each position's block of every
    leaf is ``lay_out``'s of the model-only spec (the rows / columns /
    experts of its model index), the bytes one position holds equal
    ``shard_bytes`` of the model-only specs, the split leaves are split
    (the heads', ``d_ff``'s, the experts', the vocabulary's), and
    ``gather`` gives the tree back bit for bit."""
    _, cfg = _cfgs(case)
    mesh = _mesh("p1d2m2")
    params = params_from_numpy(_params(case), device="cpu")
    placed = tp.place(params, mesh)
    shardings = shrules.model_shardings(params, mesh)
    held = 0
    for (path, leaf), (st,), (sh,) in zip(
            _paths(params), shrules.zip_leaves(placed),
            shrules.zip_leaves(shardings)):
        for pos in np.ndindex(*mesh.devices.shape):
            want = leaf[sh._slices(pos, leaf.shape)]
            assert torch.equal(st.shards[pos], want), (case, path, pos)
        held += st.shards[0, 0, 1].numel() * leaf.element_size()
        if path[-1] in ("wq", "wo", "w_gate", "w_up", "w_down", "embed",
                        "we_gate", "we_up", "we_down", "w_uq", "w_uk",
                        "w_uv", "head", "vis_proj"):
            assert sh.spec != shrules.P(*([None] * leaf.ndim)), path
    assert held == shrules.shard_bytes(params, shardings)
    _trees_close(tp.gather(placed), params, 0.0, f"{case} gather")


@pytest.mark.parametrize("case", ["tinyllama", "deepseek"])
def test_split_decode_over_a_cache_the_rules_keep_whole(case):
    """A cache length that does not divide over the model axis (13 over
    2): ``cache_pspec``'s guard keeps K / V (tinyllama's one KV head) and
    MLA's latent whole, each shard attends with its heads over all of
    it; prefill and 3 steps against the unsharded port's."""
    _, cfg = _cfgs(case)
    mesh = _mesh("m2")
    params = params_from_numpy(_params(case), device="cpu")
    _, toks = _ref_serve(case)
    outs = []
    for m in (mesh, None):
        prefill, decode, _ = build_serve_fns(cfg, mesh=m)
        logits, caches = prefill(params, _batch(cfg), 13)
        got = [logits]
        for tok in toks[:3]:
            logits, caches = decode(params, tok, caches)
            got.append(logits)
        outs.append((got, caches))
    leaf = outs[0][1]["seg0"]["latent" if case == "deepseek" else "k"]
    assert leaf.dim is None
    for i, (g, w) in enumerate(zip(outs[0][0], outs[1][0])):
        _close(g, w, PORT_TOL, f"{case} stage {i}")
