"""The port's LM training path held against the reference's, on the CPU
at ``smoke_config`` size: ``train_forward``'s loss and gradients, the
train step, Adafactor, ``TokenPipeline``, the gradient compression, the
two cross-entropy losses and ``launch/train.py --arch``.

The port draws each model's params (``init`` from seed 0: the trees of
both packages have the same structure); they cross over as numpy, and
the same numpy batch goes through ``jax.value_and_grad`` of the
reference's ``train_forward`` and through autograd of the port's.
Tolerances: the loss to 1e-5 relative; every gradient leaf (and, after
a train step, every param and moment leaf) within 1e-4 of that leaf's
largest magnitude in the reference: the f32 sums of a few layers of d_model-wide products run in
other orders in the two packages, and a backward compounds each
forward difference through the layers it crosses.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data.pipeline import TokenPipeline as RefTokenPipeline
from repro.launch.steps import build_train_step as ref_build_train_step
from repro.models import build_model as ref_build_model
from repro.models import nn as ref_nn
from repro.quant import grad_compress as ref_gc
from repro.quant.int8 import dequantize_int8 as ref_dequantize
from repro.train import optimizer as ref_opt
from repro_torch import configs
from repro_torch.data import TokenPipeline
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import build_train_step
from repro_torch.models import build_model
from repro_torch.models import nn as port_nn
from repro_torch.models.transformer import params_from_numpy
from repro_torch.quant import grad_compress as gc
from repro_torch.train import optimizer as port_opt

LOSS_RTOL = 1e-5
LEAF_TOL = 1e-4
B, S = 2, 16

# one smoke config of each kind (the hybrid's groups and whisper's
# layers recomputed under remat; the VLM's head over 4 sequence chunks),
# then the dense one under the other loss and remat paths: the head over
# 2 chunks (each checkpointed) with the two-level block remat
# (remat_block 1 of 2 layers), and the plain CE (ce_chunk 0) with
# per-layer remat
CASES = [
    ("tinyllama-1.1b", {}),
    ("moonshot-v1-16b-a3b", {}),
    ("deepseek-v2-236b", {}),
    ("mamba2-1.3b", {}),
    ("recurrentgemma-9b", {"remat": True}),
    ("whisper-large-v3", {"remat": True}),
    ("internvl2-76b", {"ce_chunk": 4}),
    ("tinyllama-1.1b", {"ce_chunk": 8, "remat": True, "remat_block": 1}),
    ("tinyllama-1.1b", {"ce_chunk": 0, "remat": True}),
]


def _cfgs(arch, **repl):
    return (dataclasses.replace(ref_configs.smoke_config(arch), **repl),
            dataclasses.replace(configs.smoke_config(arch), **repl))


def _batch(cfg, b=B, s=S, seed=0, lead=()):
    """A training batch drawn with numpy: tokens, labels (the VLM's text
    leaves room for its patches), patch or audio embeddings."""
    rng = np.random.default_rng(seed)
    text = s - (cfg.num_vision_tokens if cfg.frontend == "vision_stub"
                else 0)
    toks = rng.integers(0, cfg.vocab_size, lead + (b, text), dtype=np.int32)
    batch = {"tokens": toks, "labels": toks.copy()}
    if cfg.frontend == "vision_stub":
        batch["patch_emb"] = rng.standard_normal(
            lead + (b, cfg.num_vision_tokens, cfg.vision_dim)).astype(
                np.float32)
    if cfg.encdec:
        batch["audio_emb"] = rng.standard_normal(
            lead + (b, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return batch


def _leaves_np(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_np(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(jnp.asarray(tree).astype(jnp.float32)) \
            if not isinstance(tree, torch.Tensor) else tree.float().numpy()


def _trees_close(got, want, tol, what):
    got, want = dict(_leaves_np(got)), dict(_leaves_np(want))
    assert got.keys() == want.keys(), (what, got.keys() ^ want.keys())
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, (what, name, g.shape, w.shape)
        bound = tol * max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= bound, f"{what} {name}: max err {err} > {bound}"


@functools.lru_cache(maxsize=None)
def _params(arch, items):
    """(the reference's params as jnp arrays, the same as numpy), drawn
    by the port's ``init`` from seed 0."""
    _, cfg = _cfgs(arch, **dict(items))
    tree = build_model(cfg).init(0, device="cpu")
    nparams = port_opt.tree_map(lambda t: t.numpy(), tree)
    return jax.tree.map(jnp.asarray, nparams), nparams


@pytest.mark.parametrize(
    "arch,repl", CASES,
    ids=[f"{a}-{'-'.join(f'{k}{v}' for k, v in r.items())}"
         for a, r in CASES])
def test_train_forward_loss_and_grads_match_reference(arch, repl):
    rcfg, pcfg = _cfgs(arch, **repl)
    rparams, nparams = _params(arch, tuple(sorted(repl.items())))
    batch = _batch(rcfg)
    rmodel = ref_build_model(rcfg)
    (rloss, raux), rgrads = jax.jit(jax.value_and_grad(
        rmodel.train_forward, has_aux=True))(rparams, batch)

    pmodel = build_model(pcfg)
    pparams = params_from_numpy(nparams, device="cpu")
    leaves = port_opt.tree_leaves(pparams)
    for leaf in leaves:
        leaf.requires_grad_(True)
    ploss, paux = pmodel.train_forward(pparams, batch)
    pgrads = torch.autograd.grad(ploss, leaves, allow_unused=True)
    pgrads = port_opt.tree_unflatten(pparams, [
        torch.zeros_like(p) if g is None else g
        for g, p in zip(pgrads, leaves)])
    for name, got, want in (("loss", ploss, rloss),
                            ("ce", paux["ce"], raux["ce"]),
                            ("aux", paux["aux"], raux["aux"])):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=name)
    _trees_close(pgrads, rgrads, LEAF_TOL, f"{arch} {repl} grads")


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_matches_reference(n_micro):
    """One ``build_train_step`` step (tinyllama smoke, global batch 4,
    accumulation over n_micro microbatches, AdamW) from the same params
    and batch: loss and gnorm to 1e-5 relative, the params after the step
    and the AdamW moments within 1e-4 of each leaf's largest magnitude,
    the step count equal."""
    rcfg, pcfg = _cfgs("tinyllama-1.1b")
    rparams, nparams = _params("tinyllama-1.1b", ())
    batch = _batch(rcfg, b=4 // n_micro, lead=(n_micro,), seed=n_micro)
    rstep, _, _, rinit = ref_build_train_step(rcfg, n_micro=n_micro)
    rp, ro, rm = jax.jit(rstep)(rparams, rinit(rparams), batch)

    pstep, _, _, pinit = build_train_step(pcfg, n_micro=n_micro)
    pparams = params_from_numpy(nparams, device="cpu")
    pp, po, pm = pstep(pparams, pinit(pparams), batch)
    for name in ("loss", "gnorm"):
        np.testing.assert_allclose(float(pm[name]), float(rm[name]),
                                   rtol=LOSS_RTOL, err_msg=name)
    _trees_close(pp, rp, LEAF_TOL, "params after the step")
    _trees_close({"m": po["m"], "v": po["v"]},
                 {"m": ro["m"], "v": ro["v"]}, LEAF_TOL, "moments")
    assert int(po["step"]) == int(ro["step"]) == 1
    # the inputs are not modified
    _trees_close(pparams, rparams, 0.0, "params before the step")


def test_train_step_refuses_what_waits_for_sharding():
    """LM sharding (item 23) is ported: ``multi_pod`` gives the unsharded
    step bit for bit (one pod, no combine).  Tensor parallelism (item 31)
    is ported: over (1, 1, 2) a dense model's step runs split over the
    model axis, its loss to 1e-5 and its params, moments (gathered from
    their blocks) within 1e-4 of each leaf's largest, as against the
    reference; so does an SSM's (item 38)."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.distributed.sharding import make_mesh_auto
    tp_mesh = make_mesh_auto((1, 1, 2), ("pod", "data", "model"),
                             devices="cpu")
    for arch, tol in (("tinyllama-1.1b", LEAF_TOL),
                      ("mamba2-1.3b", LEAF_TOL)):
        _, pcfg = _cfgs(arch)
        _, nparams = _params(arch, ())
        batch = _batch(pcfg, b=2, lead=(1,), seed=5)
        outs = []
        for kw in ({}, {"multi_pod": True}, {"mesh": tp_mesh}):
            step, _, _, init = build_train_step(pcfg, n_micro=1, **kw)
            params = params_from_numpy(nparams, device="cpu")
            p, o, m = step(params, init(params), batch)
            if tp.is_placed(p):
                p, o = tp.gather(p), dict(o, m=tp.gather(o["m"]),
                                          v=tp.gather(o["v"]))
            outs.append((p, o, m))
        for (p, o, m), t in zip(outs[1:], (0.0, tol)):
            _trees_close(p, outs[0][0], t, f"{arch} params")
            _trees_close(o, outs[0][1], t, f"{arch} optimizer state")
            np.testing.assert_allclose(float(m["loss"]),
                                       float(outs[0][2]["loss"]),
                                       rtol=LOSS_RTOL if t else 0.0)
        assert build_model(pcfg, mesh=tp_mesh).split == (tol > 0)
    model = build_model(pcfg, mesh=make_mesh_auto((1,), ("data",),
                                                  devices="cpu"))
    assert model.cfg is pcfg


def test_adafactor_matches_reference():
    """Two Adafactor updates (a 3-d stacked leaf, a matrix, a vector;
    the clip active on the first) from the same params and gradients:
    params, factored moments and the pre-clip norm to 1e-6 relative."""
    rng = np.random.default_rng(5)
    params = {"w": rng.standard_normal((3, 8, 6)).astype(np.float32),
              "b": {"m": rng.standard_normal((5, 7)).astype(np.float32),
                    "v": rng.standard_normal((9,)).astype(np.float32)}}
    grads = [jax.tree.map(lambda a: (rng.standard_normal(a.shape) * sc)
                          .astype(np.float32), params) for sc in (3.0, 0.01)]
    lr = ref_opt.cosine_schedule(1e-2, warmup=1, total=10)
    ref = ref_opt.Adafactor(lr=lr)
    port = port_opt.Adafactor(lr=port_opt.cosine_schedule(1e-2, 1, 10))
    rp, rs = params, ref.init(params)
    pp = jax.tree.map(torch.from_numpy, params)
    ps = port.init(pp)
    ref_update = jax.jit(ref.update)
    for g in grads:
        rp, rs, rn = ref_update(g, rs, rp)
        pp, ps, pn = port.update(jax.tree.map(torch.from_numpy, g), ps, pp)
        np.testing.assert_allclose(float(pn), float(rn), rtol=1e-6)
        _trees_close(pp, rp, 1e-6, "adafactor params")
        _trees_close(ps["f"], rs["f"], 1e-6, "adafactor moments")
    assert int(ps["step"]) == int(rs["step"]) == 2


def test_make_optimizer_is_the_reference_adamw():
    _, pcfg = _cfgs("tinyllama-1.1b")
    rcfg, _ = _cfgs("tinyllama-1.1b")
    ropt, popt = (ref_opt.make_optimizer(rcfg, total_steps=50),
                  port_opt.make_optimizer(pcfg, total_steps=50))
    assert isinstance(popt, port_opt.AdamW)
    assert popt.moment_dtype == torch.float32
    for step in (1, 6, 7, 30, 50):
        np.testing.assert_allclose(float(popt.lr(step)),
                                   float(ropt.lr(step)), rtol=1e-6)


@pytest.mark.parametrize("num_hosts", [1, 2])
def test_token_pipeline_equals_reference(num_hosts):
    for host in range(num_hosts):
        kw = dict(vocab_size=97, seq_len=40, global_batch=4,
                  num_hosts=num_hosts, host_id=host, seed=3)
        ref, port = RefTokenPipeline(**kw), TokenPipeline(**kw)
        for step in (0, 1, 17):
            rb, pb = ref.batch(step), port.batch(step)
            assert rb.keys() == pb.keys()
            for k in rb:
                assert pb[k].dtype == rb[k].dtype
                np.testing.assert_array_equal(pb[k], rb[k])
        first = next(iter(port))
        np.testing.assert_array_equal(first["tokens"],
                                      ref.batch(0)["tokens"])


def test_grad_compression_matches_reference():
    """``ef_quantize`` equals the reference's bit for bit (codes, scales,
    residuals, over two error-feedback steps); the compressed pod mean
    equals the reference's ef_quantize, dequantize and mean composed in
    numpy, bit for bit, the new residuals too; the plain mean equals the
    numpy f32 mean."""
    rng = np.random.default_rng(9)
    pods = [{"w": rng.standard_normal((6, 10)).astype(np.float32),
             "b": {"v": rng.standard_normal((7,)).astype(np.float32)}}
            for _ in range(3)]
    res = gc.compress_state_init(jax.tree.map(torch.from_numpy, pods[0]))
    rres = ref_gc.compress_state_init(pods[0])
    assert all(float(t.abs().max()) == 0 and t.dtype == torch.float32
               for t in port_opt.tree_leaves(res))
    for _ in range(2):
        g = pods[0]["w"]
        q, s, r = gc.ef_quantize(torch.from_numpy(g), res["w"])
        rq, rs, rr = ref_gc.ef_quantize(g, rres["w"])
        for got, want in ((q, rq), (s, rs), (r, rr)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        res, rres = dict(res, w=r), dict(rres, w=rr)

    residuals = [gc.compress_state_init(jax.tree.map(torch.from_numpy, p))
                 for p in pods]
    residuals[1]["w"] += 0.003
    tpods = [jax.tree.map(torch.from_numpy, p) for p in pods]
    mean, new_res = gc.compressed_cross_pod_mean(tpods, residuals)
    for path in (("w",), ("b", "v")):
        def leaf(t):
            for k in path:
                t = t[k]
            return t
        deq, want_res = [], []
        for p, r in zip(pods, residuals):
            rq, rs, rr = ref_gc.ef_quantize(leaf(p), leaf(r).numpy())
            deq.append(np.asarray(ref_dequantize(rq, rs)))
            want_res.append(np.asarray(rr))
        np.testing.assert_array_equal(leaf(mean).numpy(),
                                      np.mean(np.stack(deq), axis=0))
        for got, want in zip(new_res, want_res):
            np.testing.assert_array_equal(leaf(got).numpy(), want)
        plain = gc.plain_cross_pod_mean(tpods)
        np.testing.assert_array_equal(
            leaf(plain).numpy(), np.mean(np.stack([leaf(p) for p in pods]),
                                         axis=0))


@pytest.mark.parametrize("chunk,s,vocab_real", [(4, 10, 50), (64, 12, 0)])
def test_cross_entropy_losses_match_reference(chunk, s, vocab_real):
    """``chunked_cross_entropy_head`` (value and its gradients in x and
    the head, with a mask; a chunk that does not divide s, cut to 2, with
    padded-vocab masking; a chunk longer than s) and ``cross_entropy``
    against the reference's."""
    rng = np.random.default_rng(chunk + s)
    b, d, V = 2, 8, 64
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    w = rng.standard_normal((d, V)).astype(np.float32)
    labels = rng.integers(0, vocab_real or V, (b, s)).astype(np.int32)
    mask = rng.random((b, s)) < 0.7

    def ref_loss(x_, w_):
        return ref_nn.chunked_cross_entropy_head(
            x_, w_, labels, mask, chunk=chunk, vocab_real=vocab_real)
    rv, (rgx, rgw) = jax.jit(jax.value_and_grad(ref_loss, argnums=(0, 1)))(
        x, w)
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    pv = port_nn.chunked_cross_entropy_head(
        tx, tw, torch.from_numpy(labels), torch.from_numpy(mask),
        chunk=chunk, vocab_real=vocab_real)
    pgx, pgw = torch.autograd.grad(pv, (tx, tw))
    np.testing.assert_allclose(float(pv.detach()), float(rv), rtol=1e-6)
    np.testing.assert_allclose(pgx.numpy(), np.asarray(rgx), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(pgw.numpy(), np.asarray(rgw), rtol=1e-5,
                               atol=1e-6)
    logits = x @ w
    np.testing.assert_allclose(
        float(port_nn.cross_entropy(torch.from_numpy(logits),
                                    torch.from_numpy(labels))),
        float(ref_nn.cross_entropy(logits, labels)), rtol=1e-6)


def _cli(tmp_path, name, steps, *extra):
    return train_cli.main([
        "--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu",
        "--seq-len", "32", "--global-batch", "4", "--steps", str(steps),
        "--save-every", "2", "--ckpt-dir", str(tmp_path / name), *extra])


def test_train_cli_arch_runs_and_resumes_bit_for_bit(tmp_path, capsys):
    """``launch/train.py --arch tinyllama-1.1b --smoke --device cpu``:
    4 steps with a checkpoint at step 2 and the last, then ``--resume
    --steps 6`` runs steps 4 and 5 with the losses of an uninterrupted 6
    step run, bit for bit, and the same final params; the reference's
    line formats; a directory with checkpoints and no --resume refused."""
    run = _cli(tmp_path, "a", 4)
    resumed = _cli(tmp_path, "a", 6, "--resume")
    whole = _cli(tmp_path, "b", 6)
    out = capsys.readouterr().out.splitlines()
    assert sorted(run["losses"]) == [0, 1, 2, 3]
    assert sorted(resumed["losses"]) == [4, 5]
    assert resumed["report"].resumed_from == 3
    assert run["losses"] == {i: whole["losses"][i] for i in range(4)}
    assert resumed["losses"] == {i: whole["losses"][i] for i in (4, 5)}
    assert all(np.isfinite(v) for v in whole["losses"].values())
    for a, b in zip(port_opt.tree_leaves(resumed["state"]["params"]),
                    port_opt.tree_leaves(whole["state"]["params"])):
        assert torch.equal(a, b)
    steps = [line for line in out if line.startswith("step ")]
    assert len(steps) == 12 and all(
        " loss=" in line and " gnorm=" in line and " dt=" in line
        for line in steps)
    assert out.count("done: final_step=5 restarts=0 resumed_from=3") == 1
    assert out.count("done: final_step=3 restarts=0 resumed_from=None") == 1
    with pytest.raises(SystemExit, match="--resume"):
        _cli(tmp_path, "a", 6)
