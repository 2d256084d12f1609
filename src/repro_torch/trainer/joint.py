"""Joint embedding + quantizer training (paper §3.1-3.3; twin of
``repro.trainer.joint``).

One trainer covers ICQ and the ablation/baseline modes by switching the
active loss terms (paper eq. 3 augmented):

    mode="icq":  L^E + L^C + gamma1 L^P + gamma2 L^ICQ (+ CQ penalty)
    mode="cq":   L^E + L^C + CQ penalty          (SQ = linear embed + cq)
    mode="pq":   L^E + L^C with codebooks hard-projected onto contiguous
                 subspaces after every step (PQ/PQN-style)

Gradient flow (as in the reference):
- Lambda is the online variance estimate (eq. 9, core.variance): its
  value is the running state's, its gradient flows through the current
  batch's sample variance (straight-through running stats).  The
  variance state that leaves a step is detached, so no step's autograd
  graph reaches into the next one.
- xi in L^ICQ is the prior's soft minor-mode responsibility, read at a
  detached Lambda, so the interleaving penalty is differentiable in
  Theta only.
- L^C uses the straight-through soft assignment (core.encode.st_decode).
- Theta's gradients are boosted 10x before the optimizer, so the global
  norm and its clip see the boosted gradients.

Data parallelism (``make_train_step(axis_name="data", mesh=mesh)``):
one process drives every shard.  The global batch is cut into equal
row slices, slice s runs forward on the mesh's ``data`` device s with
the params copied there (``.to()``, differentiable), Lambda reads the
global batch moments (``variance.global_batch_moments``), and the loss
is the mean over shards of each shard's batch-mean terms, gathered on
the first device, beside the terms of Lambda and the params alone
(L^P, L^ICQ), taken once.  One ``autograd.grad`` of that loss is the
mean of the shards' gradients (the reference's ``pmean``) and is the
single-device gradient of the same batch up to rounding; the metrics
are the same means.  The CQ penalty centres every shard's rows at the
global batch mean, as the single-device step centres them at its own
(the reference's pmean of shard-local penalties centres each shard at
its local mean and so trains another objective).

Params are a dict ``{"embed": {...}, "C", "theta": {...}}`` of leaf
tensors; gradients come from ``torch.autograd.grad``.  Every call of
this module that computes (``init_train_state``, the step,
``finalize``) runs inside ``index.base.full_f32_matmul``: matrix
products and cuDNN convolutions in full f32 on the card (no TF32), so
the card and the CPU agree to rounding; the caller's settings are
restored on return.  The cnn embedder's convolutions pin the same
precision themselves (``core/embed.py``), so ``ICQModel.embed`` is f32
wherever it is called.  The k-means of the init and the database encode
of ``finalize`` run the ``kmeans_assign`` and ICM kernels on the card.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import codebooks as cb
from repro_torch.core import embed as embed_mod
from repro_torch.core import icq as icq_mod
from repro_torch.core import losses
from repro_torch.core import prior as prior_mod
from repro_torch.core import variance
from repro_torch.index.base import (as_generator, as_torch, full_f32_matmul,
                                    resolve_device)
from repro_torch.train.optimizer import (AdamW, tree_leaves, tree_map,
                                         tree_unflatten)
from repro_torch.trainer.base import ICQModel

MODES = ("icq", "cq", "pq")


def _pq_support_mask(K: int, d: int, device=None):
    """(K, d) 0/1 contiguous-subspace masks (PQ)."""
    if d % K:
        raise ValueError(f"mode='pq' needs d divisible by K, got d={d}, "
                         f"K={K}")
    sub = d // K
    m = torch.zeros((K, d), device=device)
    for k in range(K):
        m[k, k * sub:(k + 1) * sub] = 1.0
    return m


def _check_mode(mode: str) -> str:
    if mode not in MODES:
        raise ValueError(f"unknown trainer mode {mode!r}; expected one of "
                         f"{MODES}")
    return mode


def init_train_state(generator, icq_cfg, *, embed_kind: str = "linear",
                     d_raw: Optional[int] = None, num_classes: int = 10,
                     img_hw: Optional[int] = None,
                     channels: Optional[int] = None, mode: str = "icq",
                     lr: float = 1e-3, sample_batch=None,
                     device=None) -> Dict:
    """Build params + optimizer + variance state on ``device`` (the CUDA
    card unless named).  ``sample_batch`` (x, y) seeds the codebooks
    from real embeddings (residual k-means, or per-subspace k-means in
    mode "pq") and Theta from their variances (numpy float64).

    ``generator`` (a ``torch.Generator`` or an int seed) is drawn in
    this order: the embedder's params (``core.embed``), then each
    codebook's initial k-means rows in codebook order, or the random C
    when no sample batch is given."""
    _check_mode(mode)
    dev = resolve_device(device)
    gen = as_generator(generator)
    d, K, m = icq_cfg.d, icq_cfg.num_codebooks, icq_cfg.codebook_size
    with full_f32_matmul(), torch.no_grad():
        embed_params, embed_apply = embed_mod.build_embedder(
            embed_kind, gen, d_raw=d_raw, d=d, num_classes=num_classes,
            img_hw=img_hw, channels=channels)
        embed_params = tree_map(lambda t: t.to(dev), embed_params)
        theta0 = prior_mod.init_theta()
        if sample_batch is not None:
            x0 = as_torch(sample_batch[0]).to(dev, torch.float32)
            emb0 = embed_apply(embed_params, x0)
            init = cb.init_pq if mode == "pq" else cb.init_residual
            C0 = init(gen, emb0, K, m)
            theta0 = prior_mod.init_theta_from_data(
                torch.var(emb0, dim=0, correction=0))
        else:
            C0 = torch.randn((K, m, d), generator=gen,
                             device=gen.device).to(dev) * 0.1
    params = {"embed": embed_params, "C": C0,
              "theta": tree_map(lambda t: t.to(dev), theta0)}
    opt = AdamW(lr=lambda step: lr, weight_decay=0.0, clip_norm=1.0)
    return {
        "params": params,
        "opt_state": opt.init(params),
        "var_state": variance.init_state(d, device=dev),
        "opt": opt,
        "embed_apply": embed_apply,
        "mode": mode,
        "pq_mask": _pq_support_mask(K, d, dev) if mode == "pq" else None,
    }


def train_state_from_numpy(params, var_state=None, opt_state=None, *,
                           device=None):
    """The reference's train state (its pytrees as nested dicts of numpy
    arrays) as the port's, key for key and dtype for dtype, on
    ``device`` (the CUDA card unless named).  Returns (params,
    var_state, opt_state), None where None was given."""
    dev = resolve_device(device)

    def conv(tree):
        if tree is None:
            return None
        return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev),
                        tree)
    return conv(params), conv(var_state), conv(opt_state)


def _soft_xi(lam, theta, icq_cfg):
    """Minor-mode posterior responsibility — the differentiable xi."""
    log_major, log_minor = prior_mod.mode_log_components(
        lam, theta, pi1=icq_cfg.pi1, pi2=icq_cfg.pi2, alpha2=icq_cfg.alpha2)
    return torch.sigmoid(log_minor - log_major)


def _shard_mean(values, lead):
    """The mean over shards of per-shard scalars (the reference's
    ``pmean``), on the first device; one shard's value as it is."""
    if len(values) == 1:
        return values[0]
    return sum(v.to(lead) for v in values) / len(values)


def make_train_step(icq_cfg, embed_apply, opt: AdamW, mode: str,
                    pq_mask=None, tau: float = 1.0,
                    axis_name: Optional[str] = None, mesh=None):
    """Returns step(params, opt_state, var_state, batch) -> (params,
    opt_state, var_state, metrics), every output a new detached tensor.
    ``batch`` is (x, y) on the params' device.  metrics: l_e, l_c,
    total, gnorm (the pre-clip global norm); l_cq in modes icq and cq;
    l_p, l_icq and psi_size (int32) in mode icq.

    ``axis_name`` (with ``mesh``, a ``distributed.Mesh``): the mesh axis
    the step is data-parallel over (module docstring).  The batch
    divides into one equal slice per device of that axis, the params
    and states live on the mesh's first device, and the outputs come
    back there."""
    _check_mode(mode)
    if axis_name is None:
        devices = None
    else:
        if mesh is None:
            raise ValueError(f"a data-parallel step over {axis_name!r} "
                             "needs the mesh that holds the axis (mesh=)")
        devices = mesh.axis_devices(axis_name)

    def slices(params, x, y):
        """(params, x, y) of every shard: the batch cut into equal row
        slices on the shards' devices, the params copied there."""
        if devices is None:
            return [(params, x, y)]
        D = len(devices)
        if x.shape[0] % D:
            raise ValueError(f"a batch of {x.shape[0]} rows does not "
                             f"divide over the {D}-way {axis_name!r} axis")
        copies = {}
        for d in devices:
            if d not in copies:
                copies[d] = tree_map(lambda t: t.to(d), params)
        return [(copies[d], xs.to(d), ys.to(d)) for d, xs, ys in
                zip(devices, torch.chunk(x, D), torch.chunk(y, D))]

    def loss_fn(params, var_state, x, y):
        lead = params["C"].device
        parts = slices(params, x, y)
        embs = [embed_apply(p["embed"], xs) for p, xs, _ in parts]
        # --- L^E ---
        l_e = _shard_mean([losses.classification_loss(
            embed_mod.classify(p["embed"], e), ys)
            for (p, _, ys), e in zip(parts, embs)], lead)
        # --- online variance with straight-through running value ---
        m_b, lam_batch = (variance.batch_moments(embs[0]) if devices is None
                          else variance.global_batch_moments(embs, mesh))
        new_var = variance.update_from_moments(var_state, m_b, lam_batch,
                                               x.shape[0])
        lam = ((variance.lambda_hat(new_var) - lam_batch).detach()
               + lam_batch)
        # --- L^C ---
        quant = [losses.quantization_loss(e, p["C"], tau)
                 for (p, _, _), e in zip(parts, embs)]
        l_c = _shard_mean([q[0] for q in quant], lead)
        total = l_e + l_c
        mets = {"l_e": l_e, "l_c": l_c}
        if mode in ("icq", "cq"):
            if devices is None:
                l_cq, _ = losses.cq_penalty(params["C"], quant[0][1])
            else:
                # every shard's rows around the global batch mean
                centre = _shard_mean([losses.cq_penalty(p["C"], q[1])[1]
                                      for (p, _, _), q in zip(parts, quant)],
                                     lead)
                l_cq = _shard_mean([losses.cq_penalty(
                    p["C"], q[1], eps_target=centre.to(p["C"].device))[0]
                    for (p, _, _), q in zip(parts, quant)], lead)
            total = total + icq_cfg.gamma_cq * l_cq
            mets["l_cq"] = l_cq
        if mode == "icq":
            l_p = prior_mod.nll(lam, params["theta"], pi1=icq_cfg.pi1,
                                pi2=icq_cfg.pi2, alpha2=icq_cfg.alpha2)
            xi_soft = _soft_xi(lam.detach(), params["theta"], icq_cfg)
            l_icq = losses.icq_loss(params["C"], xi_soft)
            total = (total + icq_cfg.gamma_p * l_p
                     + icq_cfg.gamma_icq * l_icq)
            mets.update(l_p=l_p, l_icq=l_icq,
                        psi_size=torch.sum(xi_soft > 0.5).to(torch.int32))
        mets["total"] = total
        return total, new_var, mets

    def step(params, opt_state, var_state, batch):
        x, y = batch
        with full_f32_matmul():
            with torch.enable_grad():
                live = [p.detach().requires_grad_(True)
                        for p in tree_leaves(params)]
                total, new_var, mets = loss_fn(
                    tree_unflatten(params, live), var_state, x, y)
                grads = torch.autograd.grad(total, live, allow_unused=True)
            # a leaf no term reads (Theta outside mode icq) gets zeros,
            # as jax.grad gives it
            grads = tree_unflatten(params, [
                torch.zeros_like(p) if g is None else g
                for p, g in zip(live, grads)])
            if mode == "icq":
                # Theta must track the moving variance distribution
                # faster than W reshapes it, or the mixture collapses to
                # one mode (§3.3)
                grads["theta"] = tree_map(lambda g: g * 10.0,
                                          grads["theta"])
            params, opt_state, gnorm = opt.update(grads, opt_state, params)
        if mode == "pq":                      # hard support projection
            params = dict(params, C=params["C"] * pq_mask[:, None, :])
        mets = {k: v.detach() for k, v in mets.items()}
        mets["gnorm"] = gnorm
        return (params, opt_state,
                {k: v.detach() for k, v in new_var.items()}, mets)

    return step


def finalize(params, embed_apply, var_state, icq_cfg, xs, *, mode="icq",
             encode_batch: int = 8192,
             encode_backend: str = "auto") -> ICQModel:
    """Export on the params' device: in mode icq build the structure
    (xi, fast set, sigma) and hard-project the codebooks; in modes cq
    and pq take xi as the top d // 2 variances, every codebook fast and
    sigma 0.  Then encode ``xs`` through ``encode_database`` (ICM with
    the PQ warm start, or the PQ assignment in mode pq) in chunks of
    ``encode_batch`` rows."""
    from repro_torch.trainer.encode import encode_database

    _check_mode(mode)
    lam = variance.lambda_hat(var_state)
    C = params["C"]
    with full_f32_matmul(), torch.no_grad():
        if mode == "icq":
            structure = icq_mod.build_structure(C, lam, params["theta"],
                                                icq_cfg)
            C = icq_mod.project_codebooks(C, structure.xi,
                                          structure.fast_mask)
        else:
            structure = icq_mod.ICQStructure(
                xi=prior_mod.psi_mask_topk(lam, max(1, icq_cfg.d // 2)),
                fast_mask=torch.ones((C.shape[0],), dtype=torch.bool,
                                     device=C.device),
                sigma=torch.zeros((), device=C.device))
        codes = encode_database(
            xs, C, embed_apply=embed_apply, embed_params=params["embed"],
            mode="pq" if mode == "pq" else "icm",
            icm_iters=icq_cfg.icm_iters, chunk=encode_batch,
            backend=encode_backend, device=C.device)
    return ICQModel(icq_cfg=icq_cfg, embed_params=params["embed"],
                    embed_apply=embed_apply, C=C, codes=codes,
                    structure=structure, lam=lam, mode=mode)
