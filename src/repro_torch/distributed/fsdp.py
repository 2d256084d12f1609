"""Fully sharded data parallelism (FSDP, ZeRO-3 style) over a mesh's
``data`` and ``pod`` axes, on a single controller.

Like ``tensor_parallel``, this module has no twin in the reference: it
stands for what GSPMD inserts there.  The reference's rule tables
(``sharding.param_pspec``) put each param's large dim that is not
tensor-parallel onto the FSDP axes (``sharding.fsdp_axes``: ``data``,
plus ``pod`` on the multi-pod mesh unless the cross-pod exchange is the
compressed one); ``plan_cell`` hands those shardings to ``jit``, and
GSPMD all-gathers each param before its use and reduce-scatters its
gradient.  The port executes the same from one process, as its
tensor-parallel step does:

* ``shardings`` are the full specs (``param_shardings``) with the
  tensor-parallel step's segment layout of the SSM's fused leaves on
  ``model`` (``tensor_parallel.shardings``); the FSDP dim is cut in
  contiguous blocks, and a dim that does not divide its axes stays
  whole (``maybe``).  ``place`` lays a tree out by them, each mesh
  position holding its block; ``gather`` gives the whole tree back bit
  for bit;
* ``Run`` is the train step's reading of a placed tree: ``Run.view``
  gives a (pod, data) position a tree of ``Sharded`` leaves, each
  holding, for every model shard of the position, the blocks of the
  leaf's FSDP group (the positions that differ from it along the leaf's
  FSDP axes) in shard order;
* the model gathers a leaf where it reads it (``use``; a stacked leaf
  one layer at a time, inside the layer's checkpoint, so that the
  gathered layer is freed after the layer and gathered again when the
  backward recomputes it).  The forward of the autograd function
  concatenates the group's blocks on the position's device (the
  all-gather); its backward is the reduce-scatter: each block's slice
  of the gradient is added in f32 into its owner's accumulator (a
  ``Sink``), so that no position holds a whole gradient tree;
* the accumulators are kept a pod: positions run in (pod, data) order,
  so an owner's accumulator of pod p sums the slices of the positions
  (p, 0), (p, 1), ... in that order, the sums the unsharded path's data
  mean takes.  ``Run.pod_mean`` takes that mean; the step then takes
  the cross-pod mean and AdamW block by block, each distinct block once
  on its pod-0 owner's device (``Run.blocks_of``), and copies the
  result to every other holder (``Run.laid_out``).

No ``torch.distributed`` is used.  Under ``tensor_parallel.counting``
the bytes are counted per device by the ring formulas: a gather of n
bytes from f blocks moves (f - 1) / f n into its device, the
reduce-scatter of its gradient (f - 1) / f of the gradient's bytes in
f32; every position of the mesh gathers, so each count is divided by
the mesh's device count.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.distributed import sharding as shrules
from repro_torch.distributed import tensor_parallel as tp

ALL_GATHER = "all-gather (fsdp)"
REDUCE_SCATTER = "reduce-scatter (fsdp)"
FSDP_AXES = ("pod", "data")


# -------------------------------------------------------------- layouts ----

def shardings(tree, mesh, fsdp_over_pod: bool = True):
    """The full rule-table shardings the FSDP step executes:
    ``param_shardings(tree, mesh, fsdp_over_pod)``, with the segment
    layout of ``tensor_parallel.shardings`` on the ``model`` dim."""
    full = shrules.param_shardings(tree, mesh, fsdp_over_pod)
    model = tp.shardings(tree, mesh)
    return tp._map2(lambda f, m: dataclasses.replace(f, segments=m.segments),
                    full, model)


def place(tree, mesh, fsdp_over_pod: bool = True):
    """``tree`` (whole tensors) laid out on ``mesh`` by ``shardings``: a
    tree of ``ShardedTensor``s, each position holding its block."""
    return tp._map2(lambda t, s: s.lay_out(t), tree,
                    shardings(tree, mesh, fsdp_over_pod))


def gather(placed, device=None):
    """The whole tree of a placed one, bit for bit what ``place`` took."""
    return tp.gather(placed, device)


def _fsdp_dim(spec):
    """(dim, axes) of a spec's entry over the FSDP axes, or (None, ())."""
    for i, e in enumerate(spec):
        axes = tuple(a for a in shrules.entry_axes(e) if a in FSDP_AXES)
        if axes:
            return i, axes
    return None, ()


def is_fsdp(tree) -> bool:
    """Whether ``tree`` is placed with a leaf split over ``data`` or
    ``pod``: the train step runs FSDP for such a tree."""
    return any(isinstance(t, shrules.ShardedTensor)
               and _fsdp_dim(t.sharding.spec)[0] is not None
               for (t,) in shrules.zip_leaves(tree))


def _same_mesh(a, b) -> bool:
    return a is b or (a.axis_names == b.axis_names
                      and a.devices.shape == b.devices.shape
                      and all(x == y for x, y in zip(a.devices.flat,
                                                     b.devices.flat)))


def conform(tree, mesh, fsdp_over_pod: bool = True):
    """``tree`` laid out by ``shardings`` for the step: a leaf placed by
    them is kept; whole tensors, and leaves placed by the same specs
    without the segment layout (``reshard_state``'s), are laid out again
    (the same values); a leaf placed by other specs or on another mesh
    raises."""
    want = shardings(tree, mesh, fsdp_over_pod)

    def one(path, t):
        sh = _at(want, path)
        if not isinstance(t, shrules.ShardedTensor):
            return sh.lay_out(t)
        got = t.sharding
        if not _same_mesh(got.mesh, mesh):
            raise ValueError(f"{'/'.join(map(str, path))} is laid out on "
                             f"{got.mesh}, the step runs over {mesh}")
        if tuple(got.spec) != tuple(sh.spec):
            raise ValueError(
                f"{'/'.join(map(str, path))} is laid out by {got.spec}; "
                f"the step executes {sh.spec} (fsdp_over_pod="
                f"{fsdp_over_pod}: under icq_grad on a multi-pod mesh the "
                "params stay whole across pods)")
        if got.segments != sh.segments:
            return sh.lay_out(t.gather())
        return t
    return shrules.tree_map_with_path(one, tree)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def zeros_like(placed, dtype):
    """A placed tree of zeros in ``dtype`` laid out like ``placed`` (one
    tensor wherever ``placed`` shares one)."""
    def one(st):
        made = {}
        shards = np.empty(st.shards.shape, dtype=object)
        for pos in np.ndindex(*st.shards.shape):
            b = st.shards[pos]
            if id(b) not in made:
                made[id(b)] = torch.zeros_like(b, dtype=dtype)
            shards[pos] = made[id(b)]
        return shrules.ShardedTensor(st.sharding, shards, st.shape, dtype)
    return tp._map(one, placed)


# ---------------------------------------------------------- the gather ----

class Sink:
    """An owner's f32 accumulator of one block's gradient for one pod, on
    ``device``: zeros at the first add."""

    def __init__(self, shape, device):
        self.shape, self.device, self.t = tuple(shape), device, None

    def add(self, g, index=()):
        if self.t is None:
            self.t = torch.zeros(self.shape, dtype=torch.float32,
                                 device=self.device)
        self.t[index].add_(g.to(self.device))


class Sharded:
    """One leaf of a (pod, data) position's view (``Run.view``).  For
    each model shard j of the position: ``parts[j]`` the blocks of the
    leaf's FSDP group in shard order (one block, the position's own, for
    a leaf whole over the FSDP axes), concatenated along ``fdim`` onto
    ``devices[j]`` where the model reads the leaf (``use``), and
    ``sinks[j]`` the accumulators that take each block's slice of the
    gradient (at ``index``: a layer of a stacked leaf).  With ``split``
    the gathered blocks are the position's model group's ``Split``
    (``mdim``, ``segments``).  ``anchor`` is the tensor the step
    differentiates against (the gathers' one input that requires grad);
    ``scale`` the counters' share (one over the mesh's devices)."""

    def __init__(self, parts, sinks, fdim, devices, mdim, segments, split,
                 anchor, scale, index=()):
        self.parts, self.sinks, self.fdim = parts, sinks, fdim
        self.devices, self.mdim, self.segments = devices, mdim, segments
        self.split, self.anchor, self.scale = split, anchor, scale
        self.index = index

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def at(self, li: int) -> "Sharded":
        """Layer ``li`` of a stacked leaf (its leading axis unsplit)."""
        if self.fdim == 0 or self.mdim == 0:
            raise ValueError("the layer axis is not split")

        def less(d):
            return None if d is None else d - 1
        return Sharded([[b[li] for b in row] for row in self.parts],
                       self.sinks, less(self.fdim), self.devices,
                       less(self.mdim), self.segments, self.split,
                       self.anchor, self.scale, self.index + (li,))


class _Gather(torch.autograd.Function):
    """(anchor, leaf, j) -> model shard j's block of a ``Sharded`` leaf on
    its device; the backward adds the gradient's slices into the
    owners' accumulators and returns none."""

    @staticmethod
    def forward(ctx, anchor, leaf, j):
        ctx.leaf, ctx.j = leaf, j
        blocks, dev = leaf.parts[j], leaf.devices[j]
        if len(blocks) == 1:
            b = blocks[0]
            return b.detach() if b.device == dev else b.to(dev)
        out = torch.cat([b.to(dev) for b in blocks], dim=leaf.fdim)
        f = len(blocks)
        tp.count(ALL_GATHER, (f - 1) / f * tp._nbytes(out) * leaf.scale)
        return out

    @staticmethod
    def backward(ctx, g):
        leaf, j = ctx.leaf, ctx.j
        sinks = leaf.sinks[j]
        if len(sinks) == 1:
            sinks[0].add(g, leaf.index)
        else:
            f = len(sinks)
            sizes = [b.shape[leaf.fdim] for b in leaf.parts[j]]
            for s, c in zip(sinks, torch.split(g, sizes, dim=leaf.fdim)):
                s.add(c, leaf.index)
            tp.count(REDUCE_SCATTER, (f - 1) / f * g.numel() * 4
                     * leaf.scale)
        return None, None, None


def use(x):
    """A ``Sharded`` leaf (or a dict of them) gathered where the model
    reads it: a tensor on the position's device, or with ``split`` the
    model group's ``Split`` (a leaf replicated over ``model`` gathered
    once a distinct device).  Anything else is returned as it is."""
    if isinstance(x, dict):
        return {k: use(v) for k, v in x.items()}
    if not isinstance(x, Sharded):
        return x
    if not x.split:
        return _Gather.apply(x.anchor, x, 0)
    if x.mdim is None:
        made = {}
        for j, d in enumerate(x.devices):
            if d not in made:
                made[d] = _Gather.apply(x.anchor, x, j)
        return tp.Split([made[d] for d in x.devices], None)
    return tp.Split([_Gather.apply(x.anchor, x, j)
                     for j in range(len(x.devices))], x.mdim, x.segments)


def is_view(tree) -> bool:
    return isinstance(tp._first(tree), Sharded)


def group_of(view) -> tp.ModelGroup:
    """The model group a view's leaves gather onto."""
    return tp.ModelGroup(tp._first(view).devices)


# ------------------------------------------------------------- the step ----

def _flatten(tree, path=()):
    """(path, leaf) pairs of nested dicts in sorted-key order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _flatten(tree[k],
                                                            path + (k,))]
    return [(path, tree)]


def _unflatten(template, values):
    """A nested dict shaped like ``template`` holding ``values`` in
    ``_flatten``'s order (no closure that refers to itself: a cycle
    would keep ``values`` alive until the garbage collector runs)."""
    return _build(template, iter(values))


def _build(t, it):
    if isinstance(t, dict):
        return {k: _build(t[k], it) for k in sorted(t)}
    return next(it)


def _block_key(j: int) -> str:
    return f"{j:03d}"


class _Leaf:
    """One placed leaf as the step reads it: its FSDP dim and axes, its
    model dim, and each distinct block (``keys``, by first holder in the
    mesh's order) with the positions that hold it."""

    def __init__(self, st, mesh):
        sh = st.sharding
        self.st, self.mesh = st, mesh
        self.fdim, self.faxes = _fsdp_dim(sh.spec)
        mdims = [i for i, e in enumerate(sh.spec)
                 if "model" in shrules.entry_axes(e)]
        self.mdim = mdims[0] if mdims else None
        self.segments = sh.segments
        self.block = sh.shard_shape(st.shape)
        self.key, self.holders = {}, {}
        for pos in np.ndindex(*mesh.devices.shape):
            k = tuple((s.start, s.stop) for s in sh._slices(pos, st.shape))
            self.key[pos] = k
            self.holders.setdefault(k, []).append(pos)
        self.keys = list(self.holders)
        self.index = {k: i for i, k in enumerate(self.keys)}

    def group(self, pos) -> List[tuple]:
        """The positions of ``pos``'s FSDP group, in shard order."""
        if self.fdim is None:
            return [pos]
        names = self.mesh.axis_names
        out = []
        for combo in np.ndindex(*(shrules.axis_size(self.mesh, a)
                                  for a in self.faxes)):
            q = list(pos)
            for a, c in zip(self.faxes, combo):
                q[names.index(a)] = c
            out.append(tuple(q))
        return out

    def slot(self, k, p: int, pod_ax: Optional[int]) -> tuple:
        """The position whose device keeps pod ``p``'s accumulator of
        block ``k``: its holder in pod p (the first), else its first
        holder."""
        hs = self.holders[k]
        if pod_ax is not None:
            for h in hs:
                if h[pod_ax] == p:
                    return h
        return hs[0]

    def rows(self) -> List[List[int]]:
        """The blocks (indices into ``keys``) that share each row of the
        last dim, in order along it: the FSDP group's shards of a row
        where the FSDP dim is the last, else one block a row."""
        if self.fdim is None or self.fdim != len(self.block) - 1:
            return [[i] for i in range(len(self.keys))]
        by_row = {}
        for i, k in enumerate(self.keys):
            by_row.setdefault(k[:-1], []).append(i)
        return [sorted(r, key=lambda i: self.keys[i][-1][0])
                for r in by_row.values()]


class Run:
    """One FSDP train step's reading of a params tree laid out by
    ``shardings`` (``conform``): the views, the accumulators and the
    block trees the step's means and AdamW run on (each leaf a dict of
    its distinct blocks, keys "000", "001", ... in ``_Leaf.keys`` order,
    as ``tensor_parallel.to_blocks`` gives a model group's)."""

    def __init__(self, params, mesh, *, fsdp_over_pod: bool, split: bool):
        self.mesh, self.split = mesh, split
        self.params = conform(params, mesh, fsdp_over_pod)
        flat = _flatten(self.params)
        self.paths = [path for path, _ in flat]
        self.leaves = [_Leaf(st, mesh) for _, st in flat]
        names = mesh.axis_names
        self.pod_ax = names.index("pod") if "pod" in names else None
        self.M = shrules.axis_size(mesh, "model")
        self.scale = 1.0 / mesh.size

    def position(self, p: int, d: int, j: int = 0) -> tuple:
        at = {"pod": p, "data": d, "model": j}
        return tuple(at.get(a, 0) for a in self.mesh.axis_names)

    def device(self, p: int, d: int) -> torch.device:
        return self.mesh.devices[self.position(p, d)]

    def sinks(self, p: int):
        """Pod ``p``'s accumulators: one a distinct block of each leaf."""
        return [[Sink(L.block, self.mesh.devices[L.slot(k, p, self.pod_ax)])
                 for k in L.keys] for L in self.leaves]

    def view(self, p: int, d: int, sinks, anchor):
        """Position (p, d)'s tree of ``Sharded`` leaves, adding into
        ``sinks`` (``Run.sinks`` of pod p)."""
        out = []
        for L, S in zip(self.leaves, sinks):
            parts, sks, devs = [], [], []
            for j in range(self.M):
                pos = self.position(p, d, j)
                grp = L.group(pos)
                parts.append([L.st.shards[q] for q in grp])
                sks.append([S[L.index[L.key[q]]] for q in grp])
                devs.append(self.mesh.devices[pos])
            out.append(Sharded(parts, sks, L.fdim, devs, L.mdim, L.segments,
                               self.split, anchor, self.scale))
        return _unflatten(self.params, out)

    def pod_mean(self, sinks, n: int, n_micro: int, dtype):
        """A pod's data mean as a block tree: each accumulator scaled by
        1 / ``n_micro`` and divided by the ``n`` positions that added
        into it (in place), cast to ``dtype``; zeros for a block no
        position's gradient reached."""
        vals = []
        for S in sinks:
            row = []
            for s in S:
                t = s.t if s.t is not None else torch.zeros(
                    s.shape, dtype=torch.float32, device=s.device)
                s.t = None
                if n_micro > 1:
                    t.mul_(1.0 / n_micro)
                row.append(t.div_(n).to(dtype))
            vals.append(row)
        return self._tree(vals)

    def _tree(self, vals):
        return _unflatten(self.params, [
            {_block_key(i): v for i, v in enumerate(row)} for row in vals])

    def _vals(self, blocks):
        return [[_at(blocks, path)[_block_key(i)] for i in range(len(L.keys))]
                for L, path in zip(self.leaves, self.paths)]

    def blocks_of(self, placed, p: int = 0):
        """The block tree of a tree placed like the params, each block
        read at the position that keeps pod ``p``'s accumulator of it."""
        return self._tree([[_at(placed, path).shards[L.slot(
            k, p, self.pod_ax)] for k in L.keys]
            for L, path in zip(self.leaves, self.paths)])

    def rows(self, blocks):
        """A block tree with each row's blocks (``_Leaf.rows``) as one
        list: what ``compressed_cross_pod_mean`` quantizes by row."""
        return _unflatten(self.params, [
            {_block_key(r): [vals[i] for i in row]
             for r, row in enumerate(L.rows())}
            for L, vals in zip(self.leaves, self._vals(blocks))])

    def unrows(self, rows):
        """The block tree of a ``rows`` tree."""
        vals = []
        for L, path in zip(self.leaves, self.paths):
            leaf = _at(rows, path)
            out = [None] * len(L.keys)
            for r, row in enumerate(L.rows()):
                for i, t in zip(row, leaf[_block_key(r)]):
                    out[i] = t
            vals.append(out)
        return self._tree(vals)

    def laid_out(self, blocks):
        """A placed tree like the params holding a block tree's blocks:
        every position takes its block, copied to its device where that
        differs (one copy a device)."""
        out = []
        for L, vals in zip(self.leaves, self._vals(blocks)):
            shards = np.empty(L.st.shards.shape, dtype=object)
            copies = {}
            for pos in np.ndindex(*shards.shape):
                i, dev = L.index[L.key[pos]], self.mesh.devices[pos]
                if (i, dev) not in copies:
                    b = vals[i]
                    copies[(i, dev)] = b if b.device == dev else b.to(dev)
                shards[pos] = copies[(i, dev)]
            out.append(shrules.ShardedTensor(L.st.sharding, shards,
                                             L.st.shape, vals[0].dtype))
        return _unflatten(self.params, out)
