"""Tensor-parallel execution over a mesh's ``model`` axis, on a single
controller.

This module has no twin in the reference: it stands for what GSPMD
inserts there.  The reference annotates each param with its rule-table
spec (``distributed.sharding.param_pspec``) and GSPMD splits every
product over ``model`` (Megatron style: column-parallel ``wq`` / ``wk``
/ ``wv``, ``w_gate`` / ``w_up``, MLA's ``w_uq`` / ``w_uk`` / ``w_uv``;
row-parallel ``wo`` and ``w_down``; the vocabulary of ``embed`` and
``head``; the experts over ``model``), inserting the collectives that
combine the activations.  The port executes the same split from one
process, as its (pod, data) step does (``launch.steps``):

* a mesh position's *model group* is its ``model`` devices in shard
  order (``model_group``); on one card they are all the same device, as
  ``make_mesh_auto`` lays them out;
* ``place`` lays a params (or cache) tree out by ``shardings`` (the
  model-only specs of ``sharding.model_shardings``, with the SSM's
  fused leaves in the segment layout and the cross cache by KV heads;
  ``NamedSharding.lay_out``): each position holds its block of every
  split leaf, a whole copy of every replicated one; ``gather`` gives
  the whole tree back bit for bit;
* ``group_view`` is what the model runs on: each leaf a ``Split``, the M
  blocks of one model group in shard order with the dim they split (None
  for a replicated leaf, whose "blocks" are the per-device copies);
* the collectives are plain tensor code: ``all_reduce`` sums the
  shards' partials in f32 in shard order on the group's first device
  and casts once to their type; ``all_gather`` concatenates slices in
  shard order there; ``broadcast`` puts a replicated value on each
  shard's device (a copy where the device differs).  Autograd carries
  the gradients back through them (``broadcast``'s backward is the
  gradients summed over the shards: the all-reduce of Megatron's
  "f" operator).

No ``torch.distributed`` is used.  ``counting`` records the bytes each
collective moves per device (an all-reduce of n bytes 2 (M - 1) / M n,
the ring's; an all-gather of an n-byte result (M - 1) / M n), by its
tag, forward and backward as executed (a recomputed layer counts its
forward again); the dry run reads it (``launch.dryrun``), counting one
model shard's step: under ``one_shard`` a group runs its first shard
only, and each collective gives the shape all M shards would give and
counts all M.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.distributed import sharding as shrules

ALL_REDUCE = "all-reduce (tp)"
ALL_GATHER = "all-gather (tp)"

_COUNTERS: List[Dict[str, float]] = []
_ONE_SHARD = [False]


@contextlib.contextmanager
def one_shard():
    """While entered, every model group runs its first shard only (the
    dry run's trace of one model shard's step on the meta device)."""
    _ONE_SHARD[0] = True
    try:
        yield
    finally:
        _ONE_SHARD[0] = False


@contextlib.contextmanager
def counting():
    """While entered, every collective adds its per-device bytes to the
    dict this yields, under its tag."""
    bytes_by_op: Dict[str, float] = {}
    _COUNTERS.append(bytes_by_op)
    try:
        yield bytes_by_op
    finally:
        _COUNTERS.remove(bytes_by_op)


def count(tag: str, nbytes: float):
    """Add ``nbytes`` (per device) under ``tag`` to every open counter."""
    for c in _COUNTERS:
        c[tag] = c.get(tag, 0.0) + float(nbytes)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class ModelGroup:
    """The ``model`` devices of one mesh position, in shard order."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    @property
    def shards(self) -> tuple:
        """The shards this process runs: all, or the first under
        ``one_shard``."""
        return (0,) if _ONE_SHARD[0] else tuple(range(self.size))

    def __repr__(self) -> str:
        return f"ModelGroup({[str(d) for d in self.devices]})"


def model_group(mesh) -> ModelGroup:
    """The model group of the mesh's first position."""
    return ModelGroup(mesh.axis_devices("model"))


def group_of(view) -> ModelGroup:
    """The model group a ``Split`` tree's blocks live on."""
    return ModelGroup([b.device for b in _first(view)])


def model_size(mesh) -> int:
    return shrules.axis_size(mesh, "model") if mesh is not None else 1


# -------------------------------------------------------------- layouts ----

class Split(list):
    """The blocks of one leaf over a model group, in shard order, each on
    its shard's device; ``dim`` the dim the leaf splits over ``model``
    (None: a replicated leaf, the blocks its per-device copies, one
    tensor wherever devices repeat); ``segments`` the segment layout's
    widths along ``dim`` (``shardings``), () for contiguous blocks."""

    def __init__(self, blocks, dim: Optional[int], segments=()):
        super().__init__(blocks)
        self.dim = dim
        self.segments = tuple(segments)

    def like(self, blocks) -> "Split":
        """``blocks`` with this leaf's layout."""
        return Split(blocks, self.dim, self.segments)

    @property
    def whole(self) -> torch.Tensor:
        """A replicated leaf's value (the first shard's copy)."""
        if self.dim is not None:
            raise ValueError("a split leaf has no whole copy in its group")
        return self[0]

    def at(self, li: int) -> "Split":
        """Layer ``li`` of a stacked leaf (its leading axis unsplit)."""
        if self.dim == 0:
            raise ValueError("the layer axis is not split")
        return Split([b[li] for b in self],
                     None if self.dim is None else self.dim - 1,
                     self.segments)


def _spec_dim(spec) -> Optional[int]:
    dims = [i for i, e in enumerate(spec) if e is not None]
    return dims[0] if dims else None


# ------------------------------------------------------- the split layout --

def _ssm_segments(d_in: int, n: int, nheads: int = 0):
    """The SSM's fused widths: ``w_in``'s columns [z | x | B | C | dt]
    (with ``nheads``), else the conv channels [x | B | C]."""
    return (d_in, d_in, n, n, nheads) if nheads else (d_in, n, n)


def shardings(tree, mesh, cfg=None):
    """The model-only shardings the split executes (a cache tree when
    ``cfg`` is given): ``sharding.model_shardings``'s, with two
    departures that keep each shard's bytes.

    * The segment layout of the SSM's fused leaves: the rule table
      splits ``w_in`` (d, [z d_in | x d_in | B n | C n | dt nheads]) and
      the conv's ``conv_dim`` channels ([x | B | C]: ``conv_w``,
      ``conv_b``, the conv cache) in contiguous blocks, which cut across
      the segments; here shard j holds the j-th slice of each segment
      (z, x and dt by heads, B and C by state columns), as many bytes.
      A segment that does not divide over ``model`` raises.
    * The cross cache ``ck`` / ``cv`` (b, Senc, kvh, dh) by KV heads,
      where ``cache_pspec`` splits ``dh`` (Senc kvh dh / M a shard
      either way): a ``dh`` split would leave each shard a partial of
      every score, summed across shards before the softmax, so no flash
      launch could serve the cross attention; by heads each shard
      attends over its own.  KV heads that do not divide stay whole.

    The params, checkpoints and ``reshard_state`` keep the reference's
    layout: ``place`` permutes, ``gather`` and ``view_whole`` invert."""
    sh = shrules.model_shardings(tree, mesh, cfg)
    M = model_size(mesh)

    def seg(s, widths):
        if _spec_dim(s.spec) is None:
            return s
        shrules.segment_perm(widths, M)          # raises if one is ragged
        return dataclasses.replace(s, segments=tuple(widths))

    def walk(t, s):
        if not isinstance(t, dict):
            return s
        out = {k: walk(t[k], s[k]) for k in t}
        if cfg is None and {"w_in", "A_log", "conv_w", "norm"} <= t.keys():
            d_in, nh = t["norm"].shape[-1], t["A_log"].shape[-1]
            n = (t["conv_b"].shape[-1] - d_in) // 2
            out["w_in"] = seg(s["w_in"], _ssm_segments(d_in, n, nh))
            for k in ("conv_w", "conv_b"):
                out[k] = seg(s[k], _ssm_segments(d_in, n))
        if cfg is not None and {"state", "conv"} <= t.keys():
            *_, h, p_, n = t["state"].shape
            out["conv"] = seg(s["conv"], _ssm_segments(h * p_, n))
        if cfg is not None:
            for k in ("ck", "cv"):
                if k in t:
                    shape = t[k].shape
                    spec = [None] * len(shape)
                    spec[-2] = shrules.maybe("model", shape[-2], mesh)
                    out[k] = shrules.NamedSharding(mesh, shrules.P(*spec))
        return out
    return walk(tree, sh)


def place(tree, mesh, cfg=None):
    """``tree`` (whole tensors) laid out on ``mesh`` by ``shardings``
    (a cache tree when ``cfg`` is given): a tree of ``ShardedTensor``s;
    an already placed tree is returned as it is."""
    sh = shardings(tree, mesh, cfg)

    def one(t, s):
        return t if isinstance(t, shrules.ShardedTensor) else s.lay_out(t)
    return _map2(one, tree, sh)


def gather(placed, device=None):
    """The whole tree of a placed one (on ``device``, the mesh's lead by
    default), bit for bit what ``place`` took."""
    return _map(lambda t: t.gather(device), placed)


def group_view(placed, mesh, index: Optional[Dict[str, int]] = None):
    """The ``Split`` tree of one model group of a placed tree."""
    names = mesh.axis_names
    pos = [(index or {}).get(a, 0) for a in names]
    ax = names.index("model") if "model" in names else None
    M = model_size(mesh)

    def one(st):
        blocks = []
        for j in range(M):
            if ax is not None:
                pos[ax] = j
            blocks.append(st.shards[tuple(pos)])
        return Split(blocks, _spec_dim(st.sharding.spec),
                     st.sharding.segments)
    return _map(one, placed)


def view_whole(view, device=None):
    """The whole tensors of a ``Split`` tree: blocks concatenated along
    their dim on ``device`` (the first shard's by default)."""
    def one(s):
        dev = device if device is not None else s[0].device
        if s.dim is None:
            return s[0].to(dev)
        out = torch.cat([b.to(dev) for b in s], dim=s.dim)
        if s.segments:
            perm = shrules.segment_perm(s.segments, len(s)).to(dev)
            out = torch.empty_like(out).index_copy_(s.dim, perm, out)
        return out
    return _map(one, view)


def relayout(placed, view):
    """A placed tree like ``placed`` holding ``view``'s blocks (one
    model group's ``Split`` tree, e.g. updated params): every position
    takes its model shard's block, copied to its device where that
    differs (one copy a device)."""
    def one(st, s):
        names = st.sharding.mesh.axis_names
        ax = names.index("model") if "model" in names else None
        shards = np.empty(st.shards.shape, dtype=object)
        copies = {}
        for pos in np.ndindex(*st.shards.shape):
            j = pos[ax] if ax is not None and s.dim is not None else 0
            dev = st.sharding.mesh.devices[pos]
            key = (j, dev)
            if key not in copies:
                copies[key] = s[j] if s[j].device == dev else s[j].to(dev)
            shards[pos] = copies[key]
        return shrules.ShardedTensor(st.sharding, shards, st.shape,
                                     s[0].dtype)
    return _map2(one, placed, view)


def is_placed(tree) -> bool:
    return isinstance(_first(tree), shrules.ShardedTensor)


def is_view(tree) -> bool:
    return isinstance(_first(tree), Split)


def shard(tree, j: int):
    """Shard ``j``'s blocks of a (sub)tree of ``Split``s (plain tensors
    are kept as they are)."""
    return _map(lambda s: s[j] if isinstance(s, Split) else s, tree)


# ----------------------------------------------------------- block trees --

def _key(j: int) -> str:
    return f"{j:03d}"


def to_blocks(view):
    """A ``Split`` tree as a plain tree of tensors: a split leaf becomes
    a dict of its blocks (keys "000", "001", ... in shard order), a
    replicated one its first copy.  The optimizer and the data and
    cross-pod means run on such trees block by block."""
    def one(s):
        if s.dim is None:
            return s[0]
        return {_key(j): b for j, b in enumerate(s)}
    return _map(one, view)


def from_blocks(view, blocks, group: ModelGroup):
    """The inverse of ``to_blocks`` against the template ``view``: a
    replicated leaf copied to each distinct device of ``group``."""
    def one(s, b):
        if s.dim is None:
            copies = {}
            for d in group.devices:
                if d not in copies:
                    copies[d] = b if b.device == d else b.to(d)
            return Split([copies[d] for d in group.devices], None)
        return s.like([b[_key(j)] for j in range(len(s))])
    return _map2(one, view, blocks)


def live(view):
    """``view`` with every distinct block a fresh leaf that requires
    grad (one leaf per tensor object: the copies of a replicated leaf on
    one device are one leaf, its gradient the sum over the shards that
    used it); returns (the live view, its leaves)."""
    made = {}

    def one(s):
        out = []
        for b in s:
            if id(b) not in made:
                made[id(b)] = b.detach().requires_grad_(True)
            out.append(made[id(b)])
        return s.like(out)
    v = _map(one, view)
    return v, list(made.values())


def grads_view(view, live_view, leaves, grads):
    """The gradients of a live view (``grads`` of its ``leaves``, None
    where unused) as a ``Split`` tree shaped like ``view``: a split
    leaf's block gradients; a replicated leaf's copies' gradients summed
    in f32 in shard order onto the first copy's device (each distinct
    copy once), cast to its type, and that sum on each shard (zeros
    where no shard used it)."""
    by_leaf = {id(leaf): g for leaf, g in zip(leaves, grads)
               if g is not None}

    def one(s, lv):
        gs = []
        for b, l in zip(s, lv):
            g = by_leaf.get(id(l))
            gs.append(torch.zeros_like(b) if g is None else g)
        if s.dim is not None:
            return s.like(gs)
        seen, acc = set(), None
        for l, g in zip(lv, gs):
            if id(l) in seen:
                continue
            seen.add(id(l))
            acc = g.float().to(gs[0].device) if acc is None \
                else acc + g.float().to(gs[0].device)
        total = acc.to(gs[0].dtype) if len(seen) > 1 else gs[0]
        return Split([total] * len(s), None)
    return _map2(one, view, live_view)


# ----------------------------------------------------------- collectives --

def broadcast(x, group: ModelGroup) -> List[torch.Tensor]:
    """A replicated value on the device of each shard the group runs
    (``group.shards``, in order; one tensor a distinct device).  Under
    autograd the shards' gradients sum back into ``x`` (Megatron's "f":
    counted as an all-reduce of the gradient)."""
    M = group.size
    if M > 1 and x.requires_grad and torch.is_grad_enabled():
        x = x.view_as(x)
        x.register_hook(lambda g: count(ALL_REDUCE,
                                        2 * (M - 1) / M * _nbytes(g)))
    copies = {}
    devs = [group.devices[j] for j in group.shards]
    for d in devs:
        if d not in copies:
            copies[d] = x if x.device == d else x.to(d)
    return [copies[d] for d in devs]


def all_reduce(parts, group: ModelGroup, tag: str = ALL_REDUCE):
    """The shards' partials (shard order, each on its device) summed in
    f32 in shard order on the group's first device, cast once to their
    type; ``broadcast`` puts the result on the shards that read it."""
    M = group.size
    lead = group.lead
    acc = parts[0].to(lead, torch.float32, copy=True)
    for p in parts[1:]:              # in f32, no f32 copy of each part
        acc.add_(p.to(lead))
    out = acc.to(parts[0].dtype)
    count(tag, 2 * (M - 1) / M * _nbytes(out))
    return out


def all_gather(parts, group: ModelGroup, dim: int = -1,
               tag: str = ALL_GATHER, size: Optional[int] = None):
    """The shards' slices (shard order) concatenated along ``dim`` on
    the group's first device.  Given one shard's slice under
    ``one_shard``: that slice M times, or an empty tensor of ``size``
    along ``dim`` (slices of unequal lengths)."""
    M = group.size
    if len(parts) < M and size is not None:
        shape = list(parts[0].shape)
        shape[dim] = size
        out = parts[0].new_empty(shape, device=group.lead)
    else:
        out = torch.cat([p.to(group.lead) for p in parts]
                        * (M // len(parts)), dim=dim)
    count(tag, (M - 1) / M * _nbytes(out))
    return out


# ---------------------------------------------------------------- trees ----

def _first(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _map2(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, other[k]) for k, v in tree.items()}
    return fn(tree, other)
