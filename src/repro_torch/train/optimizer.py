"""AdamW with a folded global-norm clip, Adafactor, the cosine schedule,
``make_optimizer`` and the pytree helpers they need (twin of
``repro.train.optimizer``).

This is the reference's AdamW, not ``torch.optim.AdamW``: b2 = 0.95,
eps added outside ``sqrt(vhat)``, the bias correction taken at the step
as f32, decay only on leaves with ndim >= 2, and the clip folded into
the update as ``min(1, clip_norm / max(gnorm, 1e-9))`` with the
pre-clip global norm returned.  Params, gradients and moments are
nested dicts of tensors (the reference's pytrees); leaves are visited
in sorted-key order, as ``jax.tree.leaves`` visits a dict.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch


# ---------------------------------------------------------------- trees ----

def tree_leaves(tree) -> list:
    """The tensor leaves of a nested dict, in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_unflatten(tree, leaves) -> Any:
    """A nested dict shaped like ``tree`` holding ``leaves`` (in
    ``tree_leaves`` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(tree)


# ------------------------------------------------------------- schedule ----

def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1):
    """Linear warmup to ``base_lr``, then cosine decay to
    ``min_frac * base_lr`` at ``total``; ``lr(step)`` -> f32 tensor."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return lr


def global_norm(tree) -> torch.Tensor:
    """On the first leaf's device (leaves may lie on several: a tree of
    tensor-parallel or FSDP blocks, which holds each distinct block of a
    leaf once, not once a replica or a copy, so that each counts
    once)."""
    leaves = tree_leaves(tree)
    dev = leaves[0].device
    sums = [torch.sum(torch.square(x.to(torch.float32))).to(dev)
            for x in leaves]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled by ``min(1, max_norm / max(norm, 1e-9))``, norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return tree_map(lambda x: (x.to(torch.float32)
                               * scale.to(x.device)).to(x.dtype),
                    tree), norm


# ---------------------------------------------------------------- AdamW ----

@dataclasses.dataclass(frozen=True)
class AdamW:
    """``lr(step)`` gives the rate at the 1-based step (a tensor or a
    float).  ``init(params)`` -> {"m", "v", "step"}; ``update(grads,
    state, params)`` -> (params, state, pre-clip global norm), all new
    tensors (nothing is updated in place)."""
    lr: Callable[[Any], Any]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: torch.dtype = torch.float32

    def init(self, params):
        return {
            "m": tree_map(lambda p: torch.zeros_like(
                p, dtype=self.moment_dtype), params),
            "v": tree_map(lambda p: torch.zeros_like(
                p, dtype=self.moment_dtype), params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device),
        }

    @torch.no_grad()
    def update(self, grads, state, params):
        step = state["step"] + 1
        gnorm = global_norm(grads)
        # the clip is folded into the elementwise update, as in the
        # reference (no clipped copy of the gradients)
        scale = (torch.clamp(self.clip_norm / torch.clamp_min(gnorm, 1e-9),
                             max=1.0)
                 if self.clip_norm else torch.ones_like(gnorm))
        b1, b2 = self.b1, self.b2
        t = step.to(torch.float32)
        corr1 = 1 - torch.pow(b1, t)
        corr2 = 1 - torch.pow(b2, t)
        lr = torch.as_tensor(self.lr(step), dtype=torch.float32,
                             device=gnorm.device)

        def upd(g, m, v, p):
            # the step's scalars where the leaf lies (a no-op on one device)
            sc, c1, c2, rate = (t.to(p.device)
                                for t in (scale, corr1, corr2, lr))
            g32 = g.to(torch.float32) * sc
            m32 = m.to(torch.float32) * b1 + g32 * (1 - b1)
            v32 = v.to(torch.float32) * b2 + torch.square(g32) * (1 - b2)
            delta = (m32 / c1) / (torch.sqrt(v32 / c2) + self.eps)
            if self.weight_decay and p.ndim >= 2:   # decay matrices only
                delta = delta + self.weight_decay * p.to(torch.float32)
            newp = p.to(torch.float32) - rate * delta
            return (newp.to(p.dtype), m32.to(self.moment_dtype),
                    v32.to(self.moment_dtype))

        out = tree_map(upd, grads, state["m"], state["v"], params)
        return (_pick(out, 0), {"m": _pick(out, 1), "v": _pick(out, 2),
                                "step": step}, gnorm)


# ------------------------------------------------------------- Adafactor ----

@dataclasses.dataclass(frozen=True)
class Adafactor:
    """Factored second moments: a matrix leaf (ndim >= 2) keeps row and
    column means of g^2 + eps over its last two axes (``vr``, ``vc``), a
    vector leaf the full ``v``; ``beta = 1 - step ** -decay``.  The
    gradients are clipped to ``clip_norm`` first (a clipped copy, as the
    reference's ``clip_by_global_norm``), and the pre-clip global norm
    is returned.  ``init(params)`` -> {"f", "step"}; ``update(grads,
    state, params)`` -> (params, state, norm), all new tensors."""
    lr: Callable[[Any], Any]
    decay: float = 0.8
    eps: float = 1e-30
    clip_norm: float = 1.0

    def init(self, params):
        def mk(p):
            if p.ndim >= 2:
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32,
                                          device=p.device)}
            return {"v": torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)}
        return {"f": tree_map(mk, params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=tree_leaves(params)[0].device)}

    @torch.no_grad()
    def update(self, grads, state, params):
        step = state["step"] + 1
        if self.clip_norm:
            grads, gnorm = clip_by_global_norm(grads, self.clip_norm)
        else:
            gnorm = global_norm(grads)
        beta = 1.0 - torch.pow(step.to(torch.float32), -self.decay)
        lr = torch.as_tensor(self.lr(step), dtype=torch.float32,
                             device=gnorm.device)

        def upd(g, p, f):
            g32 = g.to(torch.float32)
            g2 = torch.square(g32) + self.eps
            if p.ndim >= 2:
                vr = f["vr"] * beta + g2.mean(-1) * (1 - beta)
                vc = f["vc"] * beta + g2.mean(-2) * (1 - beta)
                denom = (vr[..., None] / torch.clamp_min(
                    vr.mean(-1, keepdim=True)[..., None], self.eps)) \
                    * vc[..., None, :]
                delta = g32 / torch.sqrt(torch.clamp_min(denom, self.eps))
                nf = {"vr": vr, "vc": vc}
            else:
                v = f["v"] * beta + g2 * (1 - beta)
                delta = g32 / torch.sqrt(torch.clamp_min(v, self.eps))
                nf = {"v": v}
            newp = p.to(torch.float32) - lr * delta
            return newp.to(p.dtype), nf

        out = _map_leaves(upd, grads, params, state["f"])
        return (_pick(out, 0), {"f": _pick(out, 1), "step": step}, gnorm)


def _map_leaves(fn, grads, params, f):
    """``fn(g, p, f_leaf)`` over the param leaves, ``f``'s leaves being
    the per-param dicts of Adafactor's state."""
    if isinstance(params, dict):
        return {k: _map_leaves(fn, grads[k], params[k], f[k])
                for k in params}
    return fn(grads, params, f)


def make_optimizer(cfg, total_steps: int = 10000, base_lr: float = 3e-4):
    """The LM trainer's optimizer: AdamW over the cosine schedule
    (warmup ``min(2000, total_steps // 10 + 1)``), moments in
    ``cfg.optimizer_dtype``."""
    return AdamW(lr=cosine_schedule(base_lr,
                                    warmup=min(2000, total_steps // 10 + 1),
                                    total=total_steps),
                 moment_dtype=getattr(torch, cfg.optimizer_dtype))


def _pick(tree, i):
    """Field ``i`` of every (param, m, v) leaf tuple of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
