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
The same seed gives the same model on one device.  Data-parallel
training (``mesh=``) waits for ROADMAP.md queue 1 item 10, and the
checkpointed loop (``ckpt_dir=``) for item 9b.
"""
from __future__ import annotations

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
        ckpt_dir: Optional[str] = None, device=None) -> ICQModel:
    """Train over (xs, ys) (numpy or torch; moved to ``device``, the
    CUDA card unless named) and export -> fitted ``ICQModel``: init on
    the first min(n, 4096) rows, ``epochs`` epochs of ``run_epoch``,
    then ``joint.finalize`` over all of xs.  ``verbose`` prints each
    epoch's last-batch metrics."""
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel fit (mesh=) is not ported to the PyTorch "
            "package yet (ROADMAP.md, queue 1, item 10)")
    if ckpt_dir is not None:
        raise NotImplementedError(
            "the checkpointed fit (ckpt_dir=) is not ported to the PyTorch "
            "package yet (ROADMAP.md, queue 1, item 9b)")
    dev = resolve_device(device)
    gen = as_generator(seed)
    xs = as_torch(xs).to(dev, torch.float32)
    ys = as_torch(ys).to(dev)
    n = xs.shape[0]
    state = joint.init_train_state(
        gen, icq_cfg, embed_kind=embed_kind,
        d_raw=xs.shape[-1] if xs.ndim == 2 else None,
        num_classes=num_classes, img_hw=img_hw, channels=channels,
        mode=mode, lr=lr, sample_batch=(xs[:min(n, 4096)],
                                         ys[:min(n, 4096)]), device=dev)
    step = joint.make_train_step(icq_cfg, state["embed_apply"], state["opt"],
                                 mode, state["pq_mask"], tau)
    params, opt_state = state["params"], state["opt_state"]
    var_state = state["var_state"]
    for ep in range(epochs):
        xb, yb = epoch_batches(gen, xs, ys, batch_size)
        params, opt_state, var_state, mets = run_epoch(step, params,
                                                       opt_state, xb, yb)
        if verbose:
            print(f"  epoch {ep}: " + " ".join(
                f"{name}={float(v):.4f}" for name, v in mets.items()))
    return joint.finalize(params, state["embed_apply"], var_state, icq_cfg,
                          xs, mode=mode, encode_batch=encode_batch,
                          encode_backend=encode_backend)
