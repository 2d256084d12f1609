"""Cross-pod gradient-combine programs (twin of ``repro.launch.combine``;
the reference's perf variant 'icq_grad').

Deployment model: each pod runs its own train step; between steps the
pods exchange gradients over the cross-pod links.  Two variants over the
same flattened f32 gradient vector, laid out (rows, 256) and sharded
over every device of a pod (``P(("data", "model"), None)``), replicated
across pods:

  fp32:  the mean over "pod"                  (wire: 4 B an element)
  int8:  error-feedback quantize -> gather the int8 payloads and
         scales over "pod" -> dequantize and average
         (wire: 1 B an element + one f32 scale a 256-element row)

The reference lowers each as a fully manual ``shard_map`` program and
reads its collective bytes from the HLO.  The port is single-controller
(``quant.grad_compress``): ``run_combine`` takes each in-pod position's
block from every pod's device, combines them on pod 0's device of that
position, and ``lower_combine`` records the wire bytes a device receives
(``wire_bytes``) and the cost count of the combine traced on meta
blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.distributed import sharding as shrules
from repro_torch.launch import hlo_cost
from repro_torch.launch.steps import CellPlan
from repro_torch.quant.grad_compress import (compressed_cross_pod_mean,
                                             plain_cross_pod_mean)

BLOCK = 256                  # elements a row: one int8 scale a row


def _combine_int8(gs, rs, lead=None):
    """One block a pod (``gs``, in pod order, with their residuals
    ``rs``): (the mean of the pods' error-feedback int8 payloads,
    dequantized, on ``lead``; the new residuals)."""
    return compressed_cross_pod_mean(gs, rs, lead=lead)


def _combine_fp32(gs, rs, lead=None):
    """The f32 mean of one block a pod on ``lead``; residuals unchanged."""
    return plain_cross_pod_mean(gs, lead=lead), rs


class _Shape:                 # the reference's minimal ShapeSpec stand-in
    name = "grad_combine"
    kind = "train"
    seq_len = 0
    global_batch = 0


def plan_combine_cell(cfg, mesh, *, compressed: bool) -> CellPlan:
    """One (rows, 256) f32 gradient vector of ``cfg.param_count()``
    elements, its rows a multiple of a pod's devices, sharded over every
    device within a pod and replicated across pods; meta arguments."""
    n = cfg.param_count()
    n_dev_per_pod = (shrules.axis_size(mesh, "data")
                     * shrules.axis_size(mesh, "model"))
    rows = ((n // BLOCK + n_dev_per_pod - 1)
            // n_dev_per_pod) * n_dev_per_pod
    g = torch.empty((rows, BLOCK), dtype=torch.float32, device="meta")
    shard = shrules.NamedSharding(mesh, shrules.P(("data", "model"), None))
    return CellPlan(cfg=cfg, shape=_Shape(), mesh=mesh, kind="train",
                    n_micro=1,
                    fn=_combine_int8 if compressed else _combine_fp32,
                    args=(g, torch.empty_like(g)),
                    in_shardings=(shard, shard),
                    out_shardings=(shard, shard), donate=(1,))


def run_combine(plan: CellPlan, g, r):
    """The combine of ``plan`` over laid-out vectors: ``g`` and ``r``
    object arrays shaped like the mesh of each position's block (each
    pod's own), or ``ShardedTensor``s.  Returns (means, residuals): the
    mean an in-pod position on pod 0's device there, and the residuals
    as ``g``'s layout."""
    mesh = plan.mesh
    g = getattr(g, "shards", g)
    r = getattr(r, "shards", r)
    names = mesh.axis_names
    pods = shrules.axis_size(mesh, "pod")
    ax = names.index("pod") if "pod" in names else None
    means = np.empty(mesh.devices.shape, dtype=object)
    res = np.empty(mesh.devices.shape, dtype=object)
    for pos in np.ndindex(*mesh.devices.shape):
        if ax is not None and pos[ax]:
            continue
        at = [pos[:ax] + (p,) + pos[ax + 1:] for p in range(pods)] \
            if ax is not None else [pos]
        mean, new = plan.fn([g[a] for a in at], [r[a] for a in at],
                            lead=mesh.devices[pos])
        for a, rn in zip(at, new):
            means[a], res[a] = mean, rn
    return means, res


def wire_bytes(plan: CellPlan) -> float:
    """Bytes one device receives over the pod links in one combine: the
    f32 mean as a ring all-reduce, 2 (P - 1) / P of its block; the int8
    gather, (P - 1) payloads of 1 B an element and one f32 scale a
    row."""
    pods = shrules.axis_size(plan.mesh, "pod")
    rows, cols = plan.in_shardings[0].shard_shape(plan.args[0].shape)
    if plan.fn is _combine_fp32:
        return 2.0 * (pods - 1) / pods * rows * cols * 4
    return float((pods - 1) * (rows * cols + rows * 4))


@dataclasses.dataclass
class LoweredCombine:
    """``wire_bytes`` a device, and the cost count of one position's
    combine traced on meta blocks (``hlo_cost.Cost``)."""
    plan: Any
    wire_bytes: float
    cost: Any


def lower_combine(cfg, mesh, *, compressed: bool):
    plan = plan_combine_cell(cfg, mesh, compressed=compressed)
    pods = shrules.axis_size(mesh, "pod")
    block = plan.in_shardings[0].shard_shape(plan.args[0].shape)
    gs = [torch.empty(block, device="meta") for _ in range(pods)]
    cost = hlo_cost.count(plan.fn, gs, [torch.empty_like(t) for t in gs])
    return LoweredCombine(plan, wire_bytes(plan), cost), plan
