"""Tensor-parallel execution of the SSM, hybrid and encoder-decoder
layers and of ICQ-KV's decode over the mesh's ``model`` axis, on the CPU
at ``smoke_config`` size (``distributed.tensor_parallel``; the ``*_tp``
functions of ``models/{nn,ssm,rglru,attention}.py``,
``quant/{kv_cache,serve_icq}.py``).

The configs: mamba2 (the SSM's segment layout: ``w_in`` and the conv
split segment by segment, B and C all-gathered, the gated norm's sums of
squares all-reduced), recurrentgemma at 3 layers (one (rglru, local)
group and an rglru tail; its one KV head split inside the head, the
ring of the window split by sequence, a prompt of 40 past the window of
32 so that the ring wraps; and a cache of 27 slots, a ring that does not
divide and stays whole) and whisper (the encoder, the decoder's
self and cross attention by heads, the cross cache by heads).  The
port draws the params (``init`` from seed 0); they cross over as numpy,
and the same numpy batch goes through the reference's *unsharded*
``prefill`` / ``decode_step`` and train step and through the port's
split ones.  Gates against the reference: logits within 2e-4 of the
largest, the loss to 1e-5, params, both moments and the pre-clip norm
within 2e-4 of each leaf's largest, greedy tokens equal over 4 steps.
Against the port's unsharded path: logits and every leaf within 2e-5
of the largest, the loss to 1e-6 (the gates of ``test_torch_tp.py``).
ICQ-KV: split by KV heads (model 2) and by positions (model 8, and
model 2 over one KV head), against the reference's unsharded
``build_icq_decode`` and the port's unsplit one; the global survivors'
positions equal the unsplit step's wherever the crude gap at rank top_c
exceeds 1e-5 of the row's largest sum of |products|
(``quant.kv_cache._crude_gap``).
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
from repro.quant import kv_cache as ref_quant
from repro.quant import serve_icq as ref_serve_icq
from repro_torch import configs
from repro_torch.distributed import sharding as shrules
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import make_mesh_auto
from repro_torch.launch.serve import icq_caches_from_prefill, lm_batch
from repro_torch.launch.steps import build_serve_fns, build_train_step
from repro_torch.models import build_model
from repro_torch.models.transformer import params_from_numpy
from repro_torch.quant import ICQKVConfig
from repro_torch.quant import kv_cache
from repro_torch.quant import serve_icq
from repro_torch.train import optimizer as port_opt

REF_TOL = 2e-4
PORT_TOL = 2e-5
LOSS_RTOL = 1e-5
MESHES = {"m2": ((2,), ("model",)),
          "m8": ((8,), ("model",)),
          "d2m2": ((2, 2), ("data", "model")),
          "p1d2m2": ((1, 2, 2), ("pod", "data", "model"))}
# case -> (arch, config overrides, prompt, cache length)
CASES = {"mamba2": ("mamba2-1.3b", (), 8, 16),
         "recurrentgemma": ("recurrentgemma-9b", (("num_layers", 3),), 40,
                            48),
         "whisper": ("whisper-large-v3", (), 8, 16),
         # a ring of 27 slots (the cache, below the window of 32): it
         # does not divide over model 2, so it stays whole on each shard
         "recurrentgemma_whole_ring": ("recurrentgemma-9b",
                                       (("num_layers", 3),), 20, 27)}
ARCHS = ("mamba2", "recurrentgemma", "whisper")
B, STEPS = 2, 4


def _mesh(name):
    shape, names = MESHES[name]
    return make_mesh_auto(shape, names, devices="cpu")


def _cfgs(case, **repl):
    arch, items, _, _ = CASES[case]
    repl = dict(items, **repl)
    return (dataclasses.replace(ref_configs.smoke_config(arch), **repl),
            dataclasses.replace(configs.smoke_config(arch), **repl))


@functools.lru_cache(maxsize=None)
def _params(case):
    _, cfg = _cfgs(case)
    return port_opt.tree_map(lambda t: t.numpy(),
                             build_model(cfg).init(0, device="cpu"))


def _batch(cfg, case, seed=0):
    return lm_batch(cfg, B, CASES[case][2], seed)


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
    logits, cache = prefill(params, _batch(rcfg, case), CASES[case][3])
    outs, toks = [np.asarray(logits)], []
    for _ in range(STEPS):
        tok = np.asarray(jnp.argmax(logits[:, -1], -1)).astype(np.int32)
        toks.append(tok[:, None])
        logits, cache = decode(params, tok[:, None], cache)
        outs.append(np.asarray(logits))
    return outs, toks


def _serve(cfg, case, params, mesh, toks):
    """The port's prefill and decode steps fed ``toks``: (logits of each
    stage, its greedy tokens, the final caches)."""
    prefill, decode, _ = build_serve_fns(cfg, mesh=mesh)
    logits, caches = prefill(params, _batch(cfg, case), CASES[case][3])
    outs, greedy = [logits], []
    for tok in toks:
        greedy.append(logits[:, -1].argmax(-1).numpy().astype(np.int32))
        logits, caches = decode(params, tok, caches)
        outs.append(logits)
    return outs, greedy, caches


@pytest.mark.parametrize("mesh_name", ["m2", "p1d2m2"])
@pytest.mark.parametrize("case", list(CASES))
def test_split_serving_matches_reference(case, mesh_name):
    """Prefill and 4 greedy decode steps split over the mesh's model
    axis (placed params) against the reference's unsharded ones and the
    port's unsharded ones; every cache buffer, gathered from its blocks,
    against the unsharded port's; greedy tokens equal."""
    _, cfg = _cfgs(case)
    mesh = _mesh(mesh_name)
    want, toks = _ref_serve(case)
    params = params_from_numpy(_params(case), device="cpu")
    placed = tp.place(params, mesh)
    got, greedy, caches = _serve(cfg, case, placed, mesh, toks)
    plain, _, plain_caches = _serve(cfg, case, params, None, toks)
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


@functools.lru_cache(maxsize=None)
def _ref_step(case):
    rcfg, _ = _cfgs(case, optimizer_dtype="float32")
    step, _, _, init = ref_build_train_step(rcfg, n_micro=1)
    params = jax.tree.map(jnp.asarray, _params(case))
    batch = {k: v[None] for k, v in _batch(rcfg, case, seed=3).items()}
    batch["labels"] = batch["tokens"]
    return jax.jit(step)(params, init(params), batch)


def _gathered(out):
    p, o, m = out
    return tp.gather(p), dict(o, m=tp.gather(o["m"]),
                              v=tp.gather(o["v"])), m


@pytest.mark.parametrize("case,mesh_name", [
    ("mamba2", "m2"), ("mamba2", "p1d2m2"), ("recurrentgemma", "m2"),
    ("recurrentgemma", "p1d2m2"), ("whisper", "m2"), ("whisper", "p1d2m2"),
    ("whisper", "d2m2")])
def test_split_train_step_matches_reference(case, mesh_name):
    """One AdamW step split over the model axis (each data shard's model
    group on its rows, remat on, the data and pod means block by block,
    AdamW on the blocks) from the same params and batch: the loss, the
    pre-clip norm, params and both moments (gathered from their blocks,
    the SSM's segments back in the reference's layout) against the
    reference's unsharded step and the port's step over the same (pod,
    data) shards with the model axis at 1."""
    _, cfg = _cfgs(case, optimizer_dtype="float32", remat=True)
    mesh = _mesh(mesh_name)
    batch = {k: v[None] for k, v in _batch(cfg, case, seed=3).items()}
    batch["labels"] = batch["tokens"]
    multi_pod = "pod" in mesh.axis_names
    step, _, _, init = build_train_step(cfg, n_micro=1, multi_pod=multi_pod,
                                        mesh=mesh)
    params = params_from_numpy(_params(case), device="cpu")
    out = step(params, init(params), batch)
    assert tp.is_placed(out[0]) and tp.is_placed(out[1]["m"])
    pp, po, pm = _gathered(out)
    rp, ro, rm = _ref_step(case)
    np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(pm["gnorm"]), float(rm["gnorm"]),
                               rtol=REF_TOL)
    _trees_close(pp, rp, REF_TOL, f"{case} params")
    _trees_close({"m": po["m"], "v": po["v"]},
                 {"m": ro["m"], "v": ro["v"]}, REF_TOL, f"{case} moments")
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


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("case", ARCHS)
def test_place_holds_shard_bytes_and_round_trips(case):
    """Over (pod 1, data 2, model 2): each position holds exactly
    ``shard_bytes`` of the rule table's model-only specs; the SSM's
    fused leaves hold the segment layout (shard j: the j-th slice of z,
    x, B, C and dt; of x, B and C in the conv), every other leaf the
    rule table's block; ``gather`` and ``view_whole`` give the tree
    back bit for bit."""
    _, cfg = _cfgs(case)
    mesh = _mesh("p1d2m2")
    params = params_from_numpy(_params(case), device="cpu")
    placed = tp.place(params, mesh)
    rules = shrules.model_shardings(params, mesh)
    held = 0
    for (path, leaf), (st,), (sh,) in zip(
            _paths(params), shrules.zip_leaves(placed),
            shrules.zip_leaves(rules)):
        held += st.shards[0, 0, 1].numel() * leaf.element_size()
        for pos in np.ndindex(*mesh.devices.shape):
            blk = st.shards[pos]
            if cfg.ssm and path[-1] in ("w_in", "conv_w", "conv_b"):
                d_in, n = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
                widths = ((d_in, d_in, n, n, d_in // cfg.ssm_head_dim)
                          if path[-1] == "w_in" else (d_in, n, n))
                j, starts = pos[2], np.cumsum((0,) + widths)
                want = torch.cat([leaf[..., o + j * w // 2:
                                       o + (j + 1) * w // 2]
                                  for o, w in zip(starts, widths)], -1)
                assert st.sharding.segments == widths
            else:
                assert not st.sharding.segments, path
                want = leaf[sh._slices(pos, leaf.shape)]
            assert torch.equal(blk, want), (case, path, pos)
    assert held == shrules.shard_bytes(params, rules)
    _trees_close(tp.gather(placed), params, 0.0, f"{case} gather")
    _trees_close(tp.view_whole(tp.group_view(placed, mesh)), params, 0.0,
                 f"{case} view_whole")


def test_a_segment_that_does_not_divide_raises():
    """An SSM state of 15 columns: ``w_in``'s 2 d_in + 30 + nheads
    columns divide over model 2, but B's and C's do not: the segment
    layout raises, as a split that would cut a query head does."""
    cfg = dataclasses.replace(configs.smoke_config("mamba2-1.3b"),
                              ssm_state=15)
    params = build_model(cfg).init(0, device="cpu")
    with pytest.raises(ValueError, match="do not each split"):
        tp.place(params, _mesh("m2"))


def test_split_cache_layouts():
    """The split caches over model 2 hold as many bytes a shard as
    ``cache_pspec``'s model split: the SSM's state by heads and its conv
    window by segments, the RG-LRU's state and window by channels, the
    ring and its positions by sequence; whisper's cross cache by KV
    heads (dim 3 of the stacked (L, b, Senc, kvh, dh)) where the rule
    splits ``dh``, at the same bytes."""
    mesh = _mesh("m2")
    for case, want in (("mamba2", {"state": 2, "conv": 3}),
                       ("recurrentgemma", {"h": 2, "conv": 3, "k": 2,
                                           "k_pos": 2}),
                       ("whisper", {"ck": 3, "cv": 3, "k": 3})):
        _, cfg = _cfgs(case)
        caches = build_model(cfg, mesh=mesh).init_cache(B, 16)
        whole = build_model(cfg).init_cache(B, 16, device="cpu")
        seen, leaves = set(), dict(_paths(whole))
        for path, split in _paths(caches):
            if path[-1] == "pos":
                continue
            leaf = leaves[path]
            sh = shrules.NamedSharding(mesh, shrules.model_pspec(
                path, leaf, mesh, cfg))
            rule = int(np.prod(sh.shard_shape(leaf.shape)))
            assert sum(b.numel() for b in split) == 2 * rule, (case, path)
            if path[-1] in want and path[0] in ("seg0", "groups"):
                assert split.dim == want[path[-1]], (case, path, split.dim)
                seen.add(path[-1])
        assert seen == set(want), (case, seen)


# ---------------------------------------------------------------- ICQ-KV --

ICQ = {"heads": ("m2", 8, 4), "positions": ("m8", 8, 4),
       "positions-1kv": ("m2", 4, 1)}
ICQ_S, ICQ_LEN, TOP_C = 24, 64, 6
# a crude score's rounding between the two paths, over its row's largest
# sum of |products| (``kv_cache._crude_mag``): an appended key's bf16
# ``k_fast`` one rounding step apart (2^-7 of a product at most), plus
# the queries' own difference (PORT_TOL)
SCORE_BOUND = 2.0 ** -7 + PORT_TOL


def _icq_cfgs(name):
    _, heads, kvh = ICQ[name]
    repl = dict(num_heads=heads, num_kv_heads=kvh)
    return (dataclasses.replace(ref_configs.smoke_config("tinyllama-1.1b"),
                                **repl),
            dataclasses.replace(configs.smoke_config("tinyllama-1.1b"),
                                **repl))


@pytest.mark.parametrize("name", list(ICQ))
def test_split_icq_decode_matches_reference(name):
    """ICQ-KV's decode split over the model axis (``build_icq_decode(mesh=
    )``), by KV heads where they divide (4 over 2) and by positions
    otherwise (4 over 8; 1 over 2), 4 steps from caches quantized from
    the unsplit prefill's K / V: logits against the reference's unsharded
    ``build_icq_decode`` (2e-4) and the port's unsplit step (2e-5),
    greedy tokens equal; every layer's global survivors (the top_c of
    all 64 positions) equal as sets to the unsplit step's wherever the
    crude gap at rank top_c exceeds 1e-5 (``_crude_gap``), equal bit for
    bit, in order, to the top_c of the split step's own recorded crude
    scores (``_top_c``), those scores within SCORE_BOUND of the unsplit
    step's; the
    caches gathered from their blocks equal the unsplit step's."""
    rcfg, cfg = _icq_cfgs(name)
    mesh = _mesh(ICQ[name][0])
    kv_r, kv_p = ref_quant.ICQKVConfig(d_fast=8), ICQKVConfig(d_fast=8)
    params = build_model(cfg).init(0, device="cpu")
    np_params = port_opt.tree_map(lambda t: t.numpy(), params)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, ICQ_S),
                                             dtype=np.int32)
    logits, dense = build_model(cfg).prefill(params, {"tokens": toks},
                                             ICQ_LEN)
    tok0 = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    runs = []
    for m in (None, mesh):
        step, _ = serve_icq.build_icq_decode(cfg, kv_p, mesh=m)
        caches = icq_caches_from_prefill(kv_p, dense, ICQ_S, ICQ_LEN)
        tok, outs, recs = tok0, [], []
        for _ in range(STEPS):
            rec = []
            lg, caches = step(params, tok, caches, top_c=TOP_C, record=rec)
            outs.append(lg)
            recs.append(rec)
            tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        runs.append((outs, recs, caches))
    (plain, plain_recs, plain_caches), (got, recs, caches) = runs
    assert caches["layers"]["kq"].dim == (3 if name == "heads" else 2)
    k = dense["seg0"]["k"].numpy()[:, :, :ICQ_S]
    v = dense["seg0"]["v"].numpy()[:, :, :ICQ_S]
    per = [ref_quant.build_icq_kv_cache(kv_r, k[li], v[li], ICQ_LEN)
           for li in range(rcfg.num_layers)]
    rcaches = {"pos": jnp.asarray(ICQ_S, jnp.int32),
               "layers": jax.tree.map(lambda *a: jnp.stack(a), *per)}
    rstep = jax.jit(lambda p, t, c: ref_serve_icq.build_icq_decode(
        rcfg, kv_r)[0](p, t, c, top_c=TOP_C))
    rparams = jax.tree.map(jnp.asarray, np_params)
    tok = tok0.numpy()
    for i, (g, p) in enumerate(zip(got, plain)):
        rl, rcaches = rstep(rparams, tok, rcaches)
        _close(g, rl, REF_TOL, f"{name} step {i} vs reference")
        _close(g, p, PORT_TOL, f"{name} step {i} vs unsplit")
        tok = np.asarray(jnp.argmax(rl[:, -1], -1)).astype(np.int32)[:, None]
        assert np.array_equal(g[:, -1].argmax(-1).numpy(), tok[:, 0])
    compared = 0
    for rec, prec in zip(recs, plain_recs):
        assert len(rec) == len(prec) == cfg.num_layers
        for (cand, _, scores, _), (pcand, gap, pscores, mag) in zip(rec,
                                                                    prec):
            assert cand.shape == pcand.shape
            assert torch.equal(cand, kv_cache._top_c(scores, TOP_C)), name
            err = (scores - pscores).abs().amax(-1)
            assert bool((err <= SCORE_BOUND * mag).all()), (
                name, float((err / mag).max()))
            same = (torch.sort(cand, -1).values
                    == torch.sort(pcand, -1).values).all(-1)
            clear = gap > 1e-5
            assert bool((same | ~clear).all()), name
            compared += int(clear.sum())
    assert compared > 0
    whole = tp.view_whole(caches["layers"])
    _trees_close(whole, plain_caches["layers"], PORT_TOL, f"{name} caches")
