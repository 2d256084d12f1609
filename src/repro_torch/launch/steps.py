"""Step builders of the LM paths (twin of ``repro.launch.steps``): the
train step with gradient accumulation over microbatches, the batch
geometry, the serving functions and the cell plans of the dry run.

``build_train_step`` — microbatches in a loop (the reference's
``lax.scan``), each differentiated by autograd through
``train_forward`` (remat inside the model's layers), the gradients
accumulated in ``cfg.grad_accum_dtype``, then the optimizer update; all
of it with full-f32 matrix products on the card (no TF32).  Over a mesh
whose ``pod`` / ``data`` axes exceed 1, each microbatch's rows split
over the (pod, data) shards as ``batch_shardings`` splits them, each
shard differentiating its rows on its position's device from a whole
copy of the params; the gradients and the loss average over ``data`` in
f32, then across pods (``plain_cross_pod_mean``, or with ``icq_grad``
``compressed_cross_pod_mean`` with its error-feedback residuals, one
tree a pod, in ``opt_state["ef_residual"]``).  A ``model`` axis above 1
splits the layers of every kind (dense, MoE, MLA, VLM, SSM, hybrid,
encoder-decoder) Megatron-style (``distributed.tensor_parallel``):
params and AdamW moments are placed by ``tensor_parallel.shardings``
(the rule tables' ``model`` entries, the SSM's fused leaves in the
segment layout), each (pod, data) position runs its model group, the
means are taken block by block and AdamW updates each block
(``_split_train_step``).  Those paths hold the params whole over
``data`` / ``pod``; a params tree laid out by the full rule-table specs
(the FSDP entries too: ``distributed.fsdp.place``, or
``reshard_state``'s output) runs the FSDP step instead, as ``jit``'s
``in_shardings`` decide the reference's program (``_fsdp_train_step``):
each position gathers every layer from its FSDP group's blocks where the
model reads it, its backward reduce-scatters the gradient into the
owners' f32 accumulators, the means and AdamW run on each distinct block
where it lives, and the output keeps the layout (over (pod, data), or
over ``data`` alone with ``icq_grad`` on a multi-pod mesh, and beside a
``model`` axis).
``build_serve_fns`` — prefill and decode_step, split over ``model``
likewise.

Microbatching: batches come shaped (n_micro, micro_batch, seq);
``n_micro`` follows the arch's ``microbatch_size`` (rows a data shard):
n_micro = global_batch / (dp_size * microbatch_size).

Cell plans (``plan_cell``, ``plan_icq_kv_cell``) hold what the dry run
reads: the step, its arguments as meta tensors (``eval_shape``, the
twin of ``jax.eval_shape``), and the rule tables' shardings of every
argument.  ``lower_cell`` traces the step of one (pod, data) shard on
the meta device under a cost count (``launch.hlo_cost``); there is no
XLA lowering and no ``shard_map``, so the reference's
``wrap_pod_manual`` and ``pod_manual_spec`` (a region manual over
"pod") have no twin: the port's compressed combine is a loop over pods.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.distributed import fsdp
from repro_torch.distributed import sharding as shrules
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.index.base import full_f32_matmul
from repro_torch.models import build_model
from repro_torch.quant.grad_compress import (compressed_cross_pod_mean,
                                             plain_cross_pod_mean)
from repro_torch.quant.kv_cache import ICQKVConfig
from repro_torch.train.optimizer import (make_optimizer, tree_leaves,
                                         tree_map, tree_unflatten)


# ----------------------------------------------------------- geometry ----

def num_microbatches(cfg, shape, dp: int) -> int:
    per_shard = max(shape.global_batch // max(dp, 1), 1)
    n_micro = max(per_shard // max(cfg.microbatch_size, 1), 1)
    while shape.global_batch % n_micro:
        n_micro -= 1
    return max(n_micro, 1)


def batch_struct(cfg, shape, n_micro: int, *,
                 train: bool) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
    """{name: (shape, dtype)} of one input batch (microbatch-major for
    train): the reference's ``ShapeDtypeStruct`` stand-ins as plain
    shapes and torch dtypes."""
    B, S = shape.global_batch, shape.seq_len
    vis = cfg.frontend == "vision_stub"
    s_text = S - (cfg.num_vision_tokens if vis else 0)
    rows = B // n_micro if train else B

    def shp(*dims):
        return (n_micro,) + dims if train else dims

    specs = {"tokens": (shp(rows, s_text), torch.int32)}
    if train:
        specs["labels"] = specs["tokens"]
    if vis:
        specs["patch_emb"] = (shp(rows, cfg.num_vision_tokens,
                                  cfg.vision_dim), torch.bfloat16)
    if cfg.encdec:
        specs["audio_emb"] = (shp(rows, cfg.encoder_seq_len, cfg.d_model),
                              torch.bfloat16)
    return specs


def meta_batch(specs) -> Dict[str, torch.Tensor]:
    """``batch_struct``'s (shape, dtype) pairs as meta tensors."""
    return {k: torch.empty(s, dtype=dt, device="meta")
            for k, (s, dt) in specs.items()}


def batch_shardings(specs, mesh, *, train: bool):
    """Batch dim -> (pod, data); the train microbatch axis (leading) is
    looped, not sharded; everything else replicated.  ``specs`` holds
    leaves with ``.shape``."""
    ba = shrules.batch_axes(mesh)
    axis = ba if len(ba) > 1 else ba[0]
    batch_dim = 1 if train else 0

    def one(_, leaf):
        nd = len(leaf.shape)
        if nd <= batch_dim:
            return shrules.NamedSharding(mesh, shrules.P())
        spec = [None] * nd
        spec[batch_dim] = shrules.maybe(axis, leaf.shape[batch_dim], mesh)
        return shrules.NamedSharding(mesh, shrules.P(*spec))

    return shrules.tree_map_with_path(one, specs)


class _ToMeta(TorchDispatchMode):
    """A dispatch mode that runs every op on the meta device: factory
    calls get ``device="meta"`` and no generator, and any other tensor
    argument is replaced by an empty meta tensor of its shape."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if any(a.name == "device" for a in func._schema.arguments):
            kwargs["device"] = torch.device("meta")
        if "generator" in kwargs:
            kwargs["generator"] = None
        args = shrules.tree_map_with_path(
            lambda _, t: torch.empty_like(t, device="meta")
            if isinstance(t, torch.Tensor) and not t.is_meta else t, args)
        return func(*args, **kwargs)


def eval_shape(fn, *args, **kw):
    """The reference's ``jax.eval_shape``: ``fn`` run with every op on the
    meta device (no memory, no arithmetic; random draws skipped), its
    tensors returned as empty meta tensors of their shapes and types.
    The model inits skip their per-layer and per-expert draw loops on
    meta tensors, so a full-size init takes well under a second."""
    with _ToMeta():
        return fn(*args, **kw)


# -------------------------------------------------------------- train ----

def tree_zeros(tree, dtype):
    return tree_map(lambda x: torch.zeros(x.shape, dtype=dtype,
                                          device=x.device), tree)


def _shard_devices(mesh):
    """[[device of shard (p, d) for d in data] for p in pods]: the
    position with pod p, data d and every other axis at 0."""
    names = mesh.axis_names
    pods, data = (shrules.axis_size(mesh, a) for a in ("pod", "data"))
    out = []
    for p in range(pods):
        row = []
        for d in range(data):
            index = [0] * len(names)
            if "pod" in names:
                index[names.index("pod")] = p
            if "data" in names:
                index[names.index("data")] = d
            row.append(mesh.devices[tuple(index)])
        out.append(row)
    return out


def _rows_split(mesh, rows: int) -> bool:
    """Whether a microbatch of ``rows`` splits over the (pod, data)
    shards (``batch_pspec``'s divisibility guard); else every shard would
    hold all rows, which is the unsharded computation."""
    ba = shrules.batch_axes(mesh)
    return shrules.maybe(ba if len(ba) > 1 else ba[0], rows, mesh) \
        is not None


def _f32_mean(parts, dev):
    """Mean of equal-shaped tensors in f32 on ``dev``, summed in order."""
    acc = parts[0].float().to(dev)
    for part in parts[1:]:
        acc = acc + part.float().to(dev)
    return acc / len(parts)


def build_train_step(cfg, *, n_micro: int, multi_pod: bool = False,
                     icq_grad: bool = False, attn_impl: str = "chunked",
                     total_steps: int = 10000, mesh=None):
    """Returns (train_step, model, opt, init_opt_state).

    ``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "gnorm"})``: batch leaves (n_micro, micro_B, ...), numpy
    arrays or tensors; the loss the microbatches' mean; new param and
    optimizer tensors on the params' device (the inputs are not
    modified).  Gradients of every microbatch add in place into one
    accumulator in ``cfg.grad_accum_dtype`` (the reference's sum, in its
    order), which is then scaled in place by 1 / n_micro.

    With a ``mesh`` whose (pod, data) shards number more than one and
    whose size divides the microbatch rows, shard (p, d) takes block
    p * D + d of every microbatch's rows on its device (module
    docstring); the shards' gradients and losses average in f32 over
    ``data`` on each pod's first device, then across pods on the params'
    device.  With ``icq_grad`` and ``multi_pod`` the cross-pod mean is
    the compressed one and ``opt_state["ef_residual"]`` holds one
    residual tree a pod (on the pod's first device); without a mesh that
    is one pod.  A single-shard step computes exactly the unsharded
    step.  The MoE load-balance term is each shard's own (averaged), as
    in data parallelism.

    Over a mesh, params laid out by the full rule-table specs
    (``distributed.fsdp``) run ``_fsdp_train_step``, and
    ``init_opt_state`` of them gives moments laid out alike; whole or
    model-placed params run the steps above."""
    model = build_model(cfg, attn_impl=attn_impl, mesh=mesh)
    opt = make_optimizer(cfg, total_steps=total_steps)
    acc_dtype = getattr(torch, cfg.grad_accum_dtype)
    compress = icq_grad and multi_pod
    step, init = (_split_train_step if model.split else _train_step)(
        model, opt, mesh, n_micro=n_micro, compress=compress,
        acc_dtype=acc_dtype)
    if mesh is not None:
        fsdp_step, fsdp_init = _fsdp_train_step(
            model, opt, mesh, n_micro=n_micro, compress=compress,
            acc_dtype=acc_dtype)
        step, init = (_by_layout(step, fsdp_step),
                      _by_layout(init, fsdp_init))
    return step, model, opt, init


def _by_layout(plain, on_fsdp):
    """``plain(params, ...)``, or ``on_fsdp`` where ``params`` is laid
    out by the FSDP entries (``fsdp.is_fsdp``)."""
    def fn(params, *args):
        return (on_fsdp if fsdp.is_fsdp(params) else plain)(params, *args)
    return fn


def _train_step(model, opt, mesh, *, n_micro, compress, acc_dtype):
    """The unsplit step of ``build_train_step`` and its
    ``init_opt_state``: whole params, unsharded or over the mesh's (pod,
    data) shards."""
    sharded = mesh is not None and _dp(mesh) > 1
    shard_devs = _shard_devices(mesh) if sharded else None

    def grads_of(params, batch, rows=slice(None)):
        """One shard's (gradients scaled by 1 / n_micro, mean loss) over
        ``rows`` of every microbatch, where ``params`` are."""
        leaves = tree_leaves(params)
        gacc, lsum = None, None
        for i in range(n_micro):
            mb = {k: v[i][rows] for k, v in batch.items()}
            live = [p.detach().requires_grad_(True) for p in leaves]
            loss, _ = model.train_forward(tree_unflatten(params, live), mb)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for g, p in zip(grads, live)]
            if gacc is None:
                gacc = [g.to(acc_dtype) for g in grads]
                lsum = loss.detach()
            else:
                for a, g in zip(gacc, grads):
                    a.add_(g.to(acc_dtype))
                lsum = lsum + loss.detach()
            del grads, live, loss
        scale = 1.0 / n_micro
        for g in gacc:
            g.mul_(scale)
        return tree_unflatten(params, gacc), lsum * scale

    def sharded_grads(params, batch):
        """The shards' gradients and losses, averaged over data in f32
        on each pod's first device: ([one tree a pod], [one loss a
        pod]).  Unsharded, the one shard is the params' device."""
        rows = next(iter(batch.values())).shape[1]
        devs = shard_devs or [[tree_leaves(params)[0].device]]
        if not sharded or _rows_split(mesh, rows):
            block = rows // (len(devs) * len(devs[0]))
        else:       # replicated rows: every data shard would compute the
            devs = [[row[0]] for row in devs]    # same; one a pod does
            block = 0
        copies = {}
        pod_grads, pod_losses = [], []
        for p, row in enumerate(devs):
            grads, losses = [], []
            for d, dev in enumerate(row):
                if dev not in copies:
                    copies[dev] = tree_map(lambda t: t.to(dev), params)
                j = (p * len(row) + d) * block
                g, loss = grads_of(copies[dev], batch,
                                   slice(j, j + block) if block
                                   else slice(None))
                grads.append(g)
                losses.append(loss)
            lead = row[0]
            if len(row) == 1:
                pod_grads.append(grads[0])
                pod_losses.append(losses[0])
            else:
                pod_grads.append(tree_map(
                    lambda *gs: _f32_mean(gs, lead).to(acc_dtype), *grads))
                pod_losses.append(_f32_mean(losses, lead))
        return pod_grads, pod_losses

    def train_step(params, opt_state, batch):
        with full_f32_matmul():
            dev = tree_leaves(params)[0].device
            pod_grads, pod_losses = sharded_grads(params, batch)
            inner = {k: v for k, v in opt_state.items()
                     if k != "ef_residual"}
            if compress:
                grads, res = compressed_cross_pod_mean(
                    pod_grads, opt_state["ef_residual"], lead=dev)
            elif len(pod_grads) > 1:
                grads = plain_cross_pod_mean(pod_grads, lead=dev)
            else:
                grads = tree_map(lambda g: g.to(dev), pod_grads[0])
            loss = (_f32_mean(pod_losses, dev) if len(pod_losses) > 1
                    else pod_losses[0].to(dev))
            new_params, new_opt, gnorm = opt.update(grads, inner, params)
            if compress:
                new_opt = dict(new_opt, ef_residual=res)
        return new_params, new_opt, {"loss": loss, "gnorm": gnorm}

    def init_opt_state(params):
        st = opt.init(params)
        if compress:
            leads = ([row[0] for row in shard_devs] if shard_devs
                     else [tree_leaves(params)[0].device])
            st = dict(st, ef_residual=[
                tree_map(lambda p, d=d: torch.zeros(
                    p.shape, dtype=torch.float32, device=d), params)
                for d in leads])
        return st

    return train_step, init_opt_state


def _one_backward_thread():
    """The backward in the calling thread, every card's nodes in turn.
    With a layer split over cards, autograd would run each card's nodes
    in that card's thread, and two of them could start recomputing one
    checkpointed layer at once (``torch.utils.checkpoint``'s non-reentrant
    recompute is triggered by the first saved tensor a node unpacks):
    the recomputations then interleave and fail.  On one card it changes
    nothing."""
    return torch.autograd.set_multithreading_enabled(False)


def _dp(mesh) -> int:
    return shrules.axis_size(mesh, "data") * shrules.axis_size(mesh, "pod")


def _split_train_step(model, opt, mesh, *, n_micro, compress, acc_dtype):
    """``build_train_step`` over a mesh whose ``model`` axis splits the
    layers (``model.split``): params and the AdamW moments placed by the
    model-only specs (``tensor_parallel.place``; a whole tree is placed
    first).  Each (pod, data) position runs its model group on its rows
    (as the unsplit sharded step splits them), differentiating its
    group's blocks; the data and cross-pod means are taken block by
    block, on the blocks' devices of the position (p, 0) and (0, 0);
    AdamW updates each block of position (0, 0) on its device (the clip's
    global norm over every split block once and every replicated leaf
    once), and every position takes its block of the result."""
    pods, data = (shrules.axis_size(mesh, a) for a in ("pod", "data"))

    def view(placed, p=0, d=0):
        return tp.group_view(placed, mesh, {"pod": p, "data": d})

    def grads_of(v, batch, rows):
        """A model group's gradients scaled by 1 / n_micro, as a block
        tree (``to_blocks``) in ``acc_dtype``, and its mean loss."""
        gacc, lsum = None, None
        for i in range(n_micro):
            mb = {k: t[i][rows] for k, t in batch.items()}
            lv, leaves = tp.live(v)
            loss, _ = model.train_forward(lv, mb)
            with _one_backward_thread():
                gr = torch.autograd.grad(loss, leaves, allow_unused=True)
            g = tp.to_blocks(tp.grads_view(v, lv, leaves, gr))
            if gacc is None:
                gacc = tree_map(lambda t: t.to(acc_dtype), g)
                lsum = loss.detach()
            else:
                tree_map(lambda a, t: a.add_(t.to(acc_dtype)), gacc, g)
                lsum = lsum + loss.detach()
            del g, gr, lv, leaves, loss
        tree_map(lambda t: t.mul_(1.0 / n_micro), gacc)
        return gacc, lsum * (1.0 / n_micro)

    def train_step(params, opt_state, batch):
        with full_f32_matmul():
            placed = tp.place(params, mesh)
            v00 = view(placed)
            g00 = tp.group_of(v00)
            rows = next(iter(batch.values())).shape[1]
            if _rows_split(mesh, rows):
                block = rows // (pods * data)
                positions = [[(p, d) for d in range(data)]
                             for p in range(pods)]
            else:          # replicated rows: one shard a pod computes
                block = 0
                positions = [[(p, 0)] for p in range(pods)]
            pod_grads, pod_losses = [], []
            for p, row in enumerate(positions):
                gs, losses = [], []
                for (pp, d) in row:
                    j = (pp * data + d) * block
                    g, loss = grads_of(view(placed, pp, d), batch,
                                       slice(j, j + block) if block
                                       else slice(None))
                    gs.append(g)
                    losses.append(loss)
                if len(gs) == 1:
                    pod_grads.append(gs[0])
                    pod_losses.append(losses[0])
                else:        # f32 over data, onto position (p, 0)
                    pod_grads.append(tree_map(
                        lambda *t: _f32_mean(t, t[0].device).to(acc_dtype),
                        *gs))
                    pod_losses.append(_f32_mean(losses, losses[0].device))
            if compress:
                grads, res = compressed_cross_pod_mean(
                    pod_grads, opt_state["ef_residual"])
            elif len(pod_grads) > 1:
                grads = plain_cross_pod_mean(pod_grads)
            else:
                grads = pod_grads[0]
            loss = (_f32_mean(pod_losses, g00.lead) if len(pod_losses) > 1
                    else pod_losses[0].to(g00.lead))
            m, v = (tp.to_blocks(view(tp.place(opt_state[k], mesh)))
                    for k in ("m", "v"))
            new_p, new_opt, gnorm = opt.update(
                grads, {"m": m, "v": v, "step": opt_state["step"]},
                tp.to_blocks(v00))
            out_opt = {"step": new_opt["step"]}
            for k in ("m", "v"):
                out_opt[k] = tp.relayout(placed, tp.from_blocks(
                    v00, new_opt[k], g00))
            if compress:
                out_opt["ef_residual"] = res
        return (tp.relayout(placed, tp.from_blocks(v00, new_p, g00)),
                out_opt, {"loss": loss, "gnorm": gnorm})

    def init_opt_state(params):
        placed = tp.place(params, mesh)
        v00 = view(placed)
        g00 = tp.group_of(v00)
        st = opt.init(tp.to_blocks(v00))
        out = {"step": st["step"]}
        for k in ("m", "v"):
            out[k] = tp.relayout(placed, tp.from_blocks(v00, st[k], g00))
        if compress:
            out["ef_residual"] = [
                tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                               device=t.device),
                         tp.to_blocks(view(placed, p)))
                for p in range(pods)]
        return out

    return train_step, init_opt_state


def _fsdp_train_step(model, opt, mesh, *, n_micro, compress, acc_dtype):
    """``build_train_step`` for params laid out by the full rule-table
    specs (``distributed.fsdp``: FSDP over (pod, data), or over ``data``
    alone when the cross-pod mean is the compressed one; a tree placed
    by the same specs without the SSM's segment layout is laid out again
    first, any other layout raises).  The (pod, data) positions run in
    order, each on its rows (as the sharded step splits them) and each
    microbatch differentiated against the anchor its view's gathers
    hang from: the backward adds each block's slice of the gradient into
    its owner's f32 accumulator of the position's pod.  A pod's
    accumulators give its data mean (``Run.pod_mean``: scaled by 1 /
    n_micro, over the pod's positions, in ``acc_dtype``), then the
    cross-pod mean (plain, or compressed with each pod's residual blocks
    and a row's int8 scale over its FSDP shards), AdamW on each distinct
    block (the clip's norm over each once), and every position takes its
    block of the new params, moments and residuals.  At n_micro 1 the
    sums are the unsharded path's, in its order."""
    pods, data = (shrules.axis_size(mesh, a) for a in ("pod", "data"))
    over_pod = not compress

    def train_step(params, opt_state, batch):
        with full_f32_matmul():
            run = fsdp.Run(params, mesh, fsdp_over_pod=over_pod,
                           split=model.split)
            rows = next(iter(batch.values())).shape[1]
            if _rows_split(mesh, rows):
                block = rows // (pods * data)
                positions = [[(p, d) for d in range(data)]
                             for p in range(pods)]
            else:          # replicated rows: one shard a pod computes
                block = 0
                positions = [[(p, 0)] for p in range(pods)]
            pod_grads, pod_losses = [], []
            for p, row in enumerate(positions):
                sinks = run.sinks(p)
                losses = []
                for (pp, d) in row:
                    j = (pp * data + d) * block
                    at = slice(j, j + block) if block else slice(None)
                    lsum = None
                    for i in range(n_micro):
                        mb = {k: v[i][at] for k, v in batch.items()}
                        anchor = torch.zeros((), device=run.device(pp, d),
                                             requires_grad=True)
                        loss, _ = model.train_forward(
                            run.view(pp, d, sinks, anchor), mb)
                        with _one_backward_thread():
                            torch.autograd.grad(loss, anchor,
                                                allow_unused=True)
                        lsum = (loss.detach() if lsum is None
                                else lsum + loss.detach())
                        del loss
                    losses.append(lsum * (1.0 / n_micro))
                pod_grads.append(run.pod_mean(sinks, len(row), n_micro,
                                              acc_dtype))
                del sinks
                pod_losses.append(losses[0] if len(losses) == 1
                                  else _f32_mean(losses, losses[0].device))
            if compress:
                res = [run.rows(run.blocks_of(fsdp.conform(
                    r, mesh, over_pod), p))
                    for p, r in enumerate(opt_state["ef_residual"])]
                means, res = compressed_cross_pod_mean(
                    [run.rows(g) for g in pod_grads], res)
                grads = run.unrows(means)
                res = [run.laid_out(run.unrows(r)) for r in res]
            elif len(pod_grads) > 1:
                grads = plain_cross_pod_mean(pod_grads)
            else:
                grads = pod_grads[0]
            del pod_grads
            loss = (_f32_mean(pod_losses, mesh.lead) if len(pod_losses) > 1
                    else pod_losses[0].to(mesh.lead))
            m, v = (run.blocks_of(fsdp.conform(opt_state[k], mesh, over_pod))
                    for k in ("m", "v"))
            new_p, new_opt, gnorm = opt.update(
                grads, {"m": m, "v": v, "step": opt_state["step"]},
                run.blocks_of(run.params))
            out_opt = {"step": new_opt["step"],
                       "m": run.laid_out(new_opt["m"]),
                       "v": run.laid_out(new_opt["v"])}
            if compress:
                out_opt["ef_residual"] = res
        return run.laid_out(new_p), out_opt, {"loss": loss, "gnorm": gnorm}

    def init_opt_state(params):
        placed = fsdp.conform(params, mesh, over_pod)
        st = {"m": fsdp.zeros_like(placed, opt.moment_dtype),
              "v": fsdp.zeros_like(placed, opt.moment_dtype),
              "step": torch.zeros((), dtype=torch.int32, device=mesh.lead)}
        if compress:
            st["ef_residual"] = [fsdp.zeros_like(placed, torch.float32)
                                 for _ in range(pods)]
        return st

    return train_step, init_opt_state


# ---------------------------------------------------------------- serve ----

def build_serve_fns(cfg, *, attn_impl: str = "chunked", mesh=None):
    """(prefill_fn, decode_fn, model).  prefill(params, batch, max_len),
    ``batch`` the reference's dict: ``tokens``, and ``patch_emb`` (the
    VLM) or ``audio_emb`` (the encoder-decoder); decode(params, tokens,
    caches).  Over a ``mesh`` whose ``model`` axis exceeds 1 the layers
    of the split kinds run over the model group of the mesh's first
    position (``models.transformer.build_model``); the rows are not
    split over ``data``."""
    model = build_model(cfg, attn_impl=attn_impl, mesh=mesh)

    def prefill_fn(params, batch, max_len: int):
        return model.prefill(params, batch, max_len)

    def decode_fn(params, tokens, caches):
        return model.decode_step(params, tokens, caches)

    return prefill_fn, decode_fn, model


def scale_config(cfg):
    """Production dtype policy: bf16 params and bf16 compute (f32
    accumulation inside the products; norms and softmax in f32)."""
    return dataclasses.replace(cfg, param_dtype="bfloat16",
                               compute_dtype="bfloat16")


# ------------------------------------------------------------ the plans ----

@dataclasses.dataclass
class CellPlan:
    """Everything the dry run reads of one (arch x shape x mesh) cell.

    ``fn(*args)`` is the cell's step over the mesh and ``args`` its
    arguments as meta tensors, ``in_shardings`` / ``out_shardings`` the
    rule tables' ``NamedSharding``s of each (``None``: not placed).
    ``trace_fn(*trace_args)`` is the step of one (pod, data) shard (its
    rows of one microbatch for train), what ``lower_cell`` traces;
    ``update_fn(*update_args)`` the optimizer update alone (train), the
    part of the step outside the microbatch loop.  ``tp_fn(*tp_args)``
    is the same shard's step split over its model group (one microbatch
    and its backward for train), when the layers split over ``model``:
    what the dry run counts the tensor-parallel collectives of."""
    cfg: Any
    shape: Any
    mesh: Any
    kind: str                    # train | prefill | decode
    n_micro: int
    fn: Any
    args: Tuple
    in_shardings: Tuple
    out_shardings: Any
    donate: Tuple[int, ...]
    trace_fn: Any = None
    trace_args: Tuple = ()
    update_fn: Any = None
    update_args: Tuple = ()
    tp_fn: Any = None
    tp_args: Tuple = ()


def _shard_rows(mesh, rows: int) -> int:
    """A (pod, data) shard's rows of a ``rows``-row batch."""
    return rows // _dp(mesh) if _rows_split(mesh, rows) else rows


def _row_block(batch, rows: int, dim: int):
    return {k: v.narrow(dim, 0, rows) for k, v in batch.items()}


def _grads_trace(model, view, batch):
    """One microbatch's forward and backward over a model group's
    blocks."""
    lv, leaves = tp.live(view)
    loss, _ = model.train_forward(lv, batch)
    torch.autograd.grad(loss, leaves, allow_unused=True)


def _split_trace(model, mesh, params_sh, kind, batch, S=0):
    """(tp_fn, tp_args) of ``CellPlan`` for a split model (else (None,
    ())): the first model group's step on the meta device."""
    if not model.split:
        return None, ()
    view = tp.group_view(tp.place(params_sh, mesh), mesh)
    if kind == "train":
        return functools.partial(_grads_trace, model), (view, batch)
    if kind == "prefill":
        return functools.partial(model.prefill, max_len=S), (view, batch)
    tok = batch["tokens"]
    return model.decode_step, (view, tok, model.init_cache(
        tok.shape[0], S, torch.bfloat16))


def plan_cell(cfg, shape, mesh, *, icq_grad: bool = False,
              attn_impl: str = "chunked") -> CellPlan:
    multi_pod = "pod" in mesh.axis_names
    dp = _dp(mesh)
    cfg = scale_config(cfg)

    if shape.kind == "train":
        n_micro = num_microbatches(cfg, shape, dp)
        compress = icq_grad and multi_pod
        train_step, model, opt, init_opt = build_train_step(
            cfg, n_micro=n_micro, multi_pod=multi_pod, icq_grad=icq_grad,
            attn_impl=attn_impl, mesh=mesh)
        params_sh = eval_shape(model.init, 0, device="cpu")
        opt_sh = init_opt(params_sh)
        batch = meta_batch(batch_struct(cfg, shape, n_micro, train=True))
        # the compressed cross-pod exchange implies pure data parallelism
        # across pods (pods share int8 gradient payloads only, so params
        # are pod-replicated); otherwise FSDP spans the pod axis too
        p_shard = shrules.param_shardings(params_sh, mesh,
                                          fsdp_over_pod=not compress)
        o_shard = opt_shardings(opt_sh, params_sh, p_shard, mesh)
        b_shard = batch_shardings(batch, mesh, train=True)
        one_step = build_train_step(cfg, n_micro=1, attn_impl=attn_impl)[0]
        one_opt = opt.init(params_sh)
        rows = _shard_rows(mesh, batch["tokens"].shape[1])
        one_batch = _row_block({k: v[:1] for k, v in batch.items()}, rows,
                               1)
        tp_fn, tp_args = _split_trace(model, mesh, params_sh, "train",
                                      {k: v[0] for k, v in
                                       one_batch.items()})
        return CellPlan(
            cfg=cfg, shape=shape, mesh=mesh, kind="train", n_micro=n_micro,
            fn=train_step, args=(params_sh, opt_sh, batch),
            in_shardings=(p_shard, o_shard, b_shard),
            out_shardings=(p_shard, o_shard, None), donate=(0, 1),
            trace_fn=one_step, trace_args=(params_sh, one_opt, one_batch),
            update_fn=opt.update,
            update_args=(tree_map(lambda p: torch.empty_like(
                p, dtype=getattr(torch, cfg.grad_accum_dtype)), params_sh),
                one_opt, params_sh),
            tp_fn=tp_fn, tp_args=tp_args)

    # the traced step is the unsplit one (the flops divide over model)
    prefill_fn, decode_fn, model = build_serve_fns(cfg, attn_impl=attn_impl)
    split_model = build_model(cfg, attn_impl=attn_impl, mesh=mesh)
    params_sh = eval_shape(model.init, 0, device="cpu")
    p_shard = shrules.param_shardings(params_sh, mesh)
    B, S = shape.global_batch, shape.seq_len
    rows = _shard_rows(mesh, B)

    if shape.kind == "prefill":
        batch = meta_batch(batch_struct(cfg, shape, 1, train=False))
        b_shard = batch_shardings(batch, mesh, train=False)
        fn = functools.partial(prefill_fn, max_len=S)
        rows_batch = _row_block(batch, rows, 0)
        tp_fn, tp_args = _split_trace(split_model, mesh, params_sh,
                                      "prefill", rows_batch, S)
        return CellPlan(
            cfg=cfg, shape=shape, mesh=mesh, kind="prefill", n_micro=1,
            fn=fn, args=(params_sh, batch),
            in_shardings=(p_shard, b_shard), out_shardings=None, donate=(),
            trace_fn=fn, trace_args=(params_sh, rows_batch),
            tp_fn=tp_fn, tp_args=tp_args)

    # decode: one token against a seq_len cache
    cache_sh = model.init_cache(B, S, torch.bfloat16, device="meta")
    c_shard = shrules.cache_shardings(cache_sh, cfg, mesh)
    tok = torch.empty((B, 1), dtype=torch.int32, device="meta")
    t_shard = batch_shardings({"tokens": tok}, mesh, train=False)["tokens"]
    tp_fn, tp_args = _split_trace(split_model, mesh, params_sh, "decode",
                                  {"tokens": tok[:rows]}, S)
    return CellPlan(
        cfg=cfg, shape=shape, mesh=mesh, kind="decode", n_micro=1,
        fn=decode_fn, args=(params_sh, tok, cache_sh),
        in_shardings=(p_shard, t_shard, c_shard),
        out_shardings=(None, c_shard), donate=(2,),
        trace_fn=decode_fn, trace_args=(
            params_sh, tok[:rows],
            model.init_cache(rows, S, torch.bfloat16, device="meta")),
        tp_fn=tp_fn, tp_args=tp_args)


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    return None


def opt_shardings(opt_sh, params_sh, p_shard, mesh):
    """Optimizer moments mirror the param shardings; scalars replicated;
    each pod's error-feedback residual tree mirrors the params."""
    def fallback(tree):
        return shrules.tree_map_with_path(
            lambda *_: shrules.replicated(mesh), tree)

    def like_params(v):
        return p_shard if _structure(v) == _structure(p_shard) \
            else fallback(v)

    out = {}
    for k, v in opt_sh.items():
        if k == "ef_residual":
            out[k] = [like_params(r) for r in v]
        elif k in ("m", "v", "f"):
            out[k] = like_params(v)
        else:
            out[k] = fallback(v)
    return out


def plan_icq_kv_cell(cfg, shape, mesh, *, top_c_frac: float = 1 / 16,
                     d_fast_frac: float = 1 / 4) -> CellPlan:
    """Decode cell with the ICQ two-step quantized KV cache (the paper's
    technique as the serving hot path): the reference's variant
    'icq_kv'."""
    from repro_torch.quant.serve_icq import (build_icq_decode,
                                             icq_kv_cache_shardings,
                                             supports_icq_kv)
    cfg = scale_config(cfg)
    assert supports_icq_kv(cfg), cfg.name
    kv_cfg = ICQKVConfig(d_fast=max(int(cfg.head_dim * d_fast_frac), 16))
    model = build_model(cfg)
    # the traced step is the unsplit one (the flops divide over model)
    decode_fn, init_cache = build_icq_decode(cfg, kv_cfg)
    params_sh = eval_shape(model.init, 0, device="cpu")
    p_shard = shrules.param_shardings(params_sh, mesh)
    B, S = shape.global_batch, shape.seq_len
    cache_sh = init_cache(B, S, device="meta")
    c_shard = icq_kv_cache_shardings(cache_sh, cfg, mesh)
    tok = torch.empty((B, 1), dtype=torch.int32, device="meta")
    t_shard = batch_shardings({"tokens": tok}, mesh, train=False)["tokens"]
    top_c = max(int(S * top_c_frac), 128)
    fn = functools.partial(decode_fn, top_c=top_c)
    rows = _shard_rows(mesh, B)
    tp_fn, tp_args = None, ()
    if shrules.axis_size(mesh, "model") > 1:    # the split step's group
        split_fn, split_init = build_icq_decode(cfg, kv_cfg, mesh=mesh)
        tp_fn = functools.partial(split_fn, top_c=top_c)
        tp_args = (tp.group_view(tp.place(params_sh, mesh), mesh),
                   tok[:rows], split_init(rows, S, device="meta"))
    return CellPlan(
        cfg=cfg, shape=shape, mesh=mesh, kind="decode", n_micro=1,
        fn=fn, args=(params_sh, tok, cache_sh),
        in_shardings=(p_shard, t_shard, c_shard),
        out_shardings=(None, c_shard), donate=(2,),
        trace_fn=fn, trace_args=(params_sh, tok[:rows],
                                 init_cache(rows, S, device="meta")),
        tp_fn=tp_fn, tp_args=tp_args)


@dataclasses.dataclass
class LoweredCell:
    """A traced cell: ``cost`` the counted work of one device's step
    (``launch.hlo_cost.CellCost``), ``trace_s`` the host time."""
    plan: CellPlan
    cost: Any
    trace_s: float


def lower_cell(plan: CellPlan) -> LoweredCell:
    """Trace one (pod, data) shard's step on the meta device under a cost
    count: its products' flops and its ops' bytes, the microbatch traced
    once and counted ``n_micro`` times (the reference's trip-count
    rule), the optimizer update once; per device, the shard's work is
    split over the ``model`` axis and the update over every device
    (``hlo_cost.cell_cost``)."""
    import time
    from repro_torch.launch import hlo_cost
    t0 = time.perf_counter()
    cost = hlo_cost.cell_cost(plan)
    return LoweredCell(plan=plan, cost=cost,
                       trace_s=time.perf_counter() - t0)
