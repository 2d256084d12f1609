"""The epoch loop (twin of ``repro.trainer.epoch``).

The reference compiles an epoch into one ``lax.scan`` over a stack of
pre-permuted batches; the port runs the same steps as a plain loop over
the stack (``run_epoch``).  Each epoch starts from a fresh variance
state (Lambda tracks the current embedding distribution, not a stale
average), returns the last batch's metrics, and drops the
permutation's tail beyond ``nb * bs`` rows.

``fit(seed, xs, ys, cfg)`` draws everything from one CPU
``torch.Generator`` (``seed`` an int or a generator), in this order:
the init (``joint.init_train_state``), then one permutation per epoch.
The same seed gives the same model on one device.  With ``mesh=``
(a ``distributed.Mesh`` with a ``data`` axis) every step is
data-parallel over that axis (``joint.make_train_step(axis_name=
"data", mesh=mesh)``): each batch is cut into one equal slice per
shard, and the params and states stay on the mesh's first device.

With ``ckpt_dir`` the epoch loop runs under
``distributed.TrainSupervisor`` (one supervisor step is one epoch),
with the reference's rules.  The checkpointed state carries the shuffle
generator's state after the epoch (``Generator.get_state()``, a uint8
tensor) where the reference carries its post-epoch key, so a fit that
is killed and re-invoked with the same seed and data resumes from the
newest checkpoint and replays the uninterrupted shuffle chain.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch.core import variance
from repro_torch.index.base import as_generator, as_torch, resolve_device
from repro_torch.trainer import joint
from repro_torch.trainer.base import ICQModel


def epoch_batches(generator, xs, ys, batch_size: int):
    """Permute on the data's device and reshape into the epoch's batch
    stacks -> (xb (nb, bs, ...), yb (nb, bs)) with nb = n // bs (the
    permutation's tail beyond nb * bs is dropped for this epoch).  The
    permutation is drawn from ``generator`` on its own device."""
    gen = as_generator(generator)
    xs, ys = as_torch(xs), as_torch(ys)
    n = xs.shape[0]
    bs = max(min(batch_size, n), 1)
    nb = n // bs
    perm = torch.randperm(n, generator=gen,
                          device=gen.device)[: nb * bs].to(xs.device)
    return (xs[perm].reshape((nb, bs) + tuple(xs.shape[1:])),
            ys[perm].reshape((nb, bs)))


def run_epoch(step, params, opt_state, xb, yb):
    """One epoch of ``step`` (``joint.make_train_step``) over the batch
    stacks, from a fresh variance state -> (params, opt_state,
    var_state, the last batch's metrics)."""
    var_state = variance.init_state(params["C"].shape[-1],
                                    device=params["C"].device)
    mets = None
    for x, y in zip(xb, yb):
        params, opt_state, var_state, mets = step(params, opt_state,
                                                  var_state, (x, y))
    return params, opt_state, var_state, mets


def fit(seed, xs, ys, icq_cfg, *, embed_kind="linear", num_classes=10,
        img_hw=None, channels=None, mode="icq", epochs=5, batch_size=256,
        lr=1e-3, tau=1.0, verbose=False, mesh=None,
        encode_batch: int = 8192, encode_backend: str = "auto",
        ckpt_dir: Optional[str] = None, save_every: int = 1,
        max_restarts: int = 3, heartbeat=None, fault_hook=None,
        device=None) -> ICQModel:
    """Train over (xs, ys) (numpy or torch; moved to ``device``, the
    CUDA card unless named) and export -> fitted ``ICQModel``: init on
    the first min(n, 4096) rows, ``epochs`` epochs of ``run_epoch``,
    then ``joint.finalize`` over all of xs.  ``verbose`` prints each
    epoch's last-batch metrics.

    ckpt_dir: supervised training -- a checkpoint every ``save_every``
    epochs, a non-finite epoch quarantined, up to ``max_restarts``
    restore-and-replay restarts; a killed fit re-invoked with the same
    seed and data resumes and ends bit for bit where the uninterrupted
    fit ends.  ``heartbeat`` (a ``distributed.HeartbeatMonitor``) gets
    ``beat(0, epoch_seconds)`` per epoch; ``fault_hook(epoch)`` may
    raise to inject a fault.

    mesh: optional mesh with a ``data`` axis -- data-parallel training
    (the module docstring); ``batch_size`` must divide over the axis,
    and the data and state live on the mesh's first device unless
    ``device`` names one.  The model matches the single-device fit up
    to rounding, which training amplifies."""
    xs, ys = as_torch(xs), as_torch(ys)
    n = xs.shape[0]
    bs = max(min(batch_size, n), 1)
    axis = None
    if mesh is not None:
        if "data" not in mesh.axis_names:
            raise ValueError("epoch driver needs a mesh with a 'data' axis")
        if bs % mesh.shape["data"]:
            raise ValueError(
                f"batch_size={bs} must divide over the "
                f"{mesh.shape['data']}-way 'data' axis for the sharded "
                "epoch driver")
        axis = "data"
        if device is None:
            device = mesh.lead
    dev = resolve_device(device)
    gen = as_generator(seed)
    xs = xs.to(dev, torch.float32)
    ys = ys.to(dev)
    state = joint.init_train_state(
        gen, icq_cfg, embed_kind=embed_kind,
        d_raw=xs.shape[-1] if xs.ndim == 2 else None,
        num_classes=num_classes, img_hw=img_hw, channels=channels,
        mode=mode, lr=lr, sample_batch=(xs[:min(n, 4096)],
                                         ys[:min(n, 4096)]), device=dev)
    step = joint.make_train_step(icq_cfg, state["embed_apply"], state["opt"],
                                 mode, state["pq_mask"], tau,
                                 axis_name=axis, mesh=mesh)
    if ckpt_dir is not None:
        params, var_state = _supervised_loop(
            ckpt_dir, step, state, gen, xs, ys, batch_size, epochs,
            save_every=save_every, max_restarts=max_restarts,
            heartbeat=heartbeat, fault_hook=fault_hook, verbose=verbose)
    else:
        params, opt_state = state["params"], state["opt_state"]
        var_state = state["var_state"]
        for ep in range(epochs):
            xb, yb = epoch_batches(gen, xs, ys, batch_size)
            params, opt_state, var_state, mets = run_epoch(
                step, params, opt_state, xb, yb)
            if verbose:
                _print_epoch(ep, mets)
    return joint.finalize(params, state["embed_apply"], var_state, icq_cfg,
                          xs, mode=mode, encode_batch=encode_batch,
                          encode_backend=encode_backend)


def _print_epoch(ep, mets):
    print(f"  epoch {ep}: " + " ".join(
        f"{name}={float(v):.4f}" for name, v in mets.items()))


def _supervised_loop(ckpt_dir, step, state, gen, xs, ys, batch_size,
                     epochs, *, save_every, max_restarts, heartbeat,
                     fault_hook, verbose):
    """The epoch loop under ``TrainSupervisor`` (one supervisor step is
    one epoch).  Returns (params, var_state) after the final epoch:
    resumed or not, the state transitions are the plain loop's."""
    from repro_torch.distributed import CheckpointManager, TrainSupervisor

    sup = TrainSupervisor(CheckpointManager(ckpt_dir),
                          save_every=save_every,
                          max_restarts=max_restarts, async_save=False)

    def step_fn(s, ep):
        t0 = time.perf_counter()
        g = torch.Generator(device=gen.device)
        g.set_state(s["rng"])
        xb, yb = epoch_batches(g, xs, ys, batch_size)
        params, opt_state, var_state, mets = run_epoch(
            step, s["params"], s["opt_state"], xb, yb)
        if params["C"].is_cuda:
            torch.cuda.synchronize(params["C"].device)
        if heartbeat is not None:
            heartbeat.beat(0, time.perf_counter() - t0)
        if verbose:
            _print_epoch(ep, mets)
        # the supervisor's NaN quarantine reads 'loss'; the joint
        # trainer calls its total 'total'
        metrics = dict(mets)
        metrics["loss"] = metrics.get("total", 0.0)
        return ({"params": params, "opt_state": opt_state,
                 "var_state": var_state, "rng": g.get_state()}, metrics)

    state0 = {"params": state["params"], "opt_state": state["opt_state"],
              "var_state": state["var_state"], "rng": gen.get_state()}
    final, _report = sup.run(state0, step_fn, epochs,
                             fault_hook=fault_hook)
    return final["params"], final["var_state"]
