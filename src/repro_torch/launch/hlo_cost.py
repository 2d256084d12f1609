"""Cost count of a step traced on the meta device (the twin of
``repro.launch.hlo_cost``; the port has no HLO to parse).

The reference re-derives its roofline inputs from compiled HLO text
with loop trip counts folded in.  The port runs the step itself on meta
tensors (shapes only: no memory, no arithmetic) under a
``TorchDispatchMode`` that sees every aten op the step dispatches,
backward included:

  1. flops: 2 * M * N * K of every matrix product (``mm``, ``addmm``,
     ``bmm``, ``baddbmm``: what ``matmul``, ``linear`` and ``einsum``
     dispatch to), the reference's 2 * M * N * K of every ``dot``;
  2. bytes: every op's tensor inputs and outputs once, except views and
     empty allocations (no traffic), and gathers / slices / index
     copies, which read and write only the window (the reference's
     ``slice`` / ``gather`` / ``dynamic-update-slice`` rules);
  3. the flash kernel: on meta tensors ``ops.flash_attention`` runs
     ``flash_attention.flash_attention_meta``, whose two custom ops
     (forward, backward) this mode sees; each is counted as one op with
     the analytic count ``chip_smoke.py``'s bounds use (per visible
     (query, key) pair 2 (dqk + dv) operations forward, 2 (3 dqk + 2 dv)
     backward: S, dP, dV, dQ, dK; q, k, v read and the output written
     once), not through the plain version's per-head products.

Loops: a step traced once is counted once; ``cell_cost`` counts the
train step's microbatch ``n_micro`` times by tracing one microbatch and
the optimizer update apart (the reference's trip-count rule).
"""
from __future__ import annotations

import dataclasses
from contextlib import nullcontext
from typing import Dict

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.distributed import sharding as shrules
from repro_torch.kernels import flash_attention as fa

aten = torch.ops.aten

# products: flops from the operands' shapes
_MM = {aten.mm.default, aten.addmm.default, aten.bmm.default,
       aten.baddbmm.default}
# no data moves
_FREE = {aten.empty.memory_format, aten.empty_like.default,
         aten.new_empty.default, aten.empty_strided.default,
         aten.new_empty_strided.default, aten.detach.default,
         aten.alias.default, aten.lift_fresh.default}
# read and write only the window: 2 x the output
_WINDOW = {aten.index.Tensor, aten.gather.default,
           aten.index_select.default, aten.embedding.default}
# writes of a window: 2 x the written values (the argument at the index)
_UPDATE = {aten.index_put_.default: 2, aten.index_put.default: 2,
           aten.scatter_.src: 3, aten.scatter.src: 3,
           aten.slice_scatter.default: 1, aten.select_scatter.default: 1}
# the meta flash call's two custom ops (``flash_attention_meta``)
_FLASH = {torch.ops.repro_torch.flash_attention_meta.default: "forward",
          torch.ops.repro_torch.flash_attention_meta_bwd.default: "backward"}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _mm_flops(func, args) -> float:
    if func is aten.mm.default:
        (m, k), n = args[0].shape, args[1].shape[1]
        return 2.0 * m * n * k
    if func is aten.addmm.default:
        (m, k), n = args[1].shape, args[2].shape[1]
        return 2.0 * m * n * k
    a, b = (args[0], args[1]) if func is aten.bmm.default \
        else (args[1], args[2])
    bsz, m, k = a.shape
    return 2.0 * bsz * m * b.shape[2] * k


def visible_pairs(sq: int, sk: int, causal: bool, window: int = 0,
                  q_offset: int = 0) -> int:
    """(query, key) pairs the flash kernel's static masks leave visible,
    query row i at position i + ``q_offset`` (rows of ``kv_valid`` are
    counted whole; a mask operand is not read: its call is counted as
    the static masks leave it)."""
    i = np.arange(sq, dtype=np.int64) + q_offset
    last = np.minimum(i, sk - 1) if causal else np.full(sq, sk - 1)
    first = np.maximum(0, i - window + 1) if window else np.zeros(sq, int)
    return int(np.maximum(0, last - first + 1).sum())


def flash_work(part: str, shapes) -> tuple:
    """(flops, bytes) of one flash call: ``part`` "forward" or
    "backward", ``shapes`` ``flash_attention_meta``'s."""
    b, sq, sk, H, KVH, dqk, dv, causal, window, kv_valid, q_offset, item = \
        shapes
    pairs = visible_pairs(sq, kv_valid or sk, causal, window, q_offset)
    q_rows, kv_rows = b * sq * H, b * sk * KVH
    if part == "forward":
        return (2.0 * b * H * (dqk + dv) * pairs,
                item * (q_rows * (dqk + dv) + kv_rows * (dqk + dv)))
    stats = 4 * b * H * sq
    return (2.0 * b * H * (3 * dqk + 2 * dv) * pairs,
            item * (q_rows * (2 * dqk + 2 * dv) + 2 * kv_rows * (dqk + dv))
            + stats)


@dataclasses.dataclass
class Cost:
    """What a traced region did: ``flops`` (products and the flash
    kernel's), ``bytes``, ``flash_calls`` (forward and backward), and
    flops and bytes by op name."""
    flops: float = 0.0
    bytes: float = 0.0
    flash_calls: int = 0
    flops_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    bytes_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)

    def add(self, name: str, flops: float, nbytes: float):
        self.flops += flops
        self.bytes += nbytes
        if flops:
            self.flops_by_op[name] = self.flops_by_op.get(name, 0.0) + flops
        self.bytes_by_op[name] = self.bytes_by_op.get(name, 0.0) + nbytes

    def scaled(self, k: float) -> "Cost":
        return Cost(self.flops * k, self.bytes * k, int(self.flash_calls * k),
                    {n: f * k for n, f in self.flops_by_op.items()},
                    {n: b * k for n, b in self.bytes_by_op.items()})

    def __add__(self, other: "Cost") -> "Cost":
        def merged(a, b):
            out = dict(a)
            for n, f in b.items():
                out[n] = out.get(n, 0.0) + f
            return out
        return Cost(self.flops + other.flops, self.bytes + other.bytes,
                    self.flash_calls + other.flash_calls,
                    merged(self.flops_by_op, other.flops_by_op),
                    merged(self.bytes_by_op, other.bytes_by_op))

    def __sub__(self, other: "Cost") -> "Cost":
        return self + other.scaled(-1.0)


class CostCounter(TorchDispatchMode):
    """While entered, counts every dispatched aten op into ``cost``, and
    each meta flash call (``flash_attention_meta``'s custom ops) as one
    op with ``flash_work``'s count."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _FLASH:
            q, k, v, causal, window, kv_valid, q_offset, mask = args[-8:]
            shapes = fa._shapes(q, k, v, causal, window, kv_valid, q_offset,
                                mask) + (causal, window, kv_valid, q_offset,
                                         q.element_size())
            self.cost.add("flash_attention",
                          *flash_work(_FLASH[func], shapes))
            self.cost.flash_calls += 1
            return out
        if func in _FREE or func.is_view:
            return out
        name = func.overloadpacket.__name__
        if func in _MM:
            self.cost.add(name, _mm_flops(func, args),
                          _nbytes(args) + _nbytes(out))
        elif func in _WINDOW:
            self.cost.add(name, 0.0, 2 * _nbytes(out))
        elif func in _UPDATE:
            self.cost.add(name, 0.0, 2 * _nbytes(args[_UPDATE[func]]))
        else:
            self.cost.add(name, 0.0, _nbytes(args) + _nbytes(out))
        return out


def count(fn, *args, **kw) -> Cost:
    """The cost of ``fn(*args, **kw)`` on meta tensors."""
    with CostCounter() as counter:
        fn(*args, **kw)
    return counter.cost


@dataclasses.dataclass
class CellCost:
    """A cell's counted work: ``per_device`` (what one device's step
    does), ``shard`` (one (pod, data) shard's step, every microbatch),
    how it was divided, and ``tp_bytes``: the tensor-parallel
    collectives' bytes a device moves in the step, by tag
    (``tp_collectives``)."""
    per_device: Cost
    shard: Cost
    model_ways: int
    update_ways: int
    tp_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)


class _Dispatch(TorchDispatchMode):
    """Runs every op as dispatched: meta ops run at the aten level, ~3x
    faster than through torch's Python references (MLA's block-wise
    merge)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


def tp_collectives(plan) -> Dict[str, float]:
    """The bytes a device moves in the tensor-parallel collectives of
    ``plan``'s step, by tag: one model shard's split step
    (``plan.tp_fn`` under ``tensor_parallel.one_shard``) run on the meta
    device under ``tensor_parallel.counting``, a train step's
    microbatch counted ``n_micro`` times; empty when the layers do not
    split."""
    from repro_torch.distributed import tensor_parallel as tp
    if plan.tp_fn is None:
        return {}
    with torch.no_grad() if plan.kind != "train" else nullcontext(), \
            tp.counting() as counted, tp.one_shard(), _Dispatch():
        plan.tp_fn(*plan.tp_args)
    return {k: v * plan.n_micro for k, v in counted.items()}


def cell_cost(plan) -> CellCost:
    """One device's work in ``plan``'s step: its (pod, data) shard's
    traced step (the train step's microbatch ``n_micro`` times, its
    optimizer update once), the shard's work divided over the ``model``
    axis and the update over the devices its FSDP rules split it over
    (every device, or every device of a pod when params are
    pod-replicated)."""
    mesh = plan.mesh
    model_ways = shrules.axis_size(mesh, "model")
    with torch.no_grad() if plan.kind != "train" else nullcontext():
        step = count(plan.trace_fn, *plan.trace_args)
    tp_bytes = tp_collectives(plan)
    if plan.kind != "train":
        return CellCost(step.scaled(1.0 / model_ways), step, model_ways, 1,
                        tp_bytes)
    upd = count(plan.update_fn, *plan.update_args)
    micro = step - upd
    update_ways = mesh.size // (shrules.axis_size(mesh, "pod")
                                if _pod_replicated(plan) else 1)
    shard = micro.scaled(plan.n_micro) + upd
    per_dev = micro.scaled(plan.n_micro / model_ways) \
        + upd.scaled(1.0 / update_ways)
    return CellCost(per_dev, shard, model_ways, update_ways, tp_bytes)


def _pod_replicated(plan) -> bool:
    """Whether the plan's params are replicated across pods (the
    compressed cross-pod exchange's pure data parallelism): no param
    spec names "pod"."""
    return "pod" in plan.mesh.axis_names and not any(
        "pod" in shrules.entry_axes(entry)
        for (sh,) in shrules.zip_leaves(plan.in_shardings[0])
        for entry in sh.spec)
