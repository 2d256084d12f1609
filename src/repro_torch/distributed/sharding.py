"""Device meshes of the port (twin of ``repro.distributed.sharding``,
mesh part): named axes over a grid of ``torch.device``s, driven by one
process.

The reference is single-controller: one process holds a ``jax.Mesh``
and places every shard with ``device_put``.  The port's twin is the same
design over PyTorch devices: a ``Mesh`` is a grid of ``torch.device``s
with named axes, shard s of a ``data``-sharded array lives on the
device at index s of the ``data`` axis, and its kernels launch there.
A device may repeat: D shards on one card are what the reference's
forced host device count gives it, and the same code serves D cards.
There is no process group: gathering a shard's result onto the mesh's
first device is a ``.to()``, as faiss's ``IndexShards`` serves several
GPUs from one process.

The LM rule tables (``param_pspec`` / ``param_shardings``,
``cache_pspec`` / ``cache_shardings``, ``batch_pspec`` /
``batch_shardings``) are the reference's, rule for rule, over a
``PartitionSpec`` twin: a tuple of per-dim entries, each None, an axis
name or a tuple of names.  Parameters are fully sharded: tensor-parallel
dims over "model" (column-parallel in, row-parallel out; experts over
"model") and the remaining large dim over the FSDP axes ("data", plus
"pod" on the multi-pod mesh).  Every rule is divisibility-guarded
(``maybe``): a dim that does not divide its axes is replicated.  KV
caches shard batch over "data" and heads over "model" when the head
count divides, else the sequence over "model".  A ``NamedSharding``
lays a tensor out on the mesh positions (``put`` / ``gather``) and
gives its shard shape; a mesh of ``"meta"`` devices (the dry run)
places nothing.

``shard_map_compat`` and ``abstract_mesh`` are JAX's own (a manual SPMD
region, an abstract mesh for tracing) and have no twin: a port function
loops over its shards instead, and a mesh over ``"meta"`` devices takes
the abstract mesh's place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Sequence, Tuple

import numpy as np
import torch


def _as_device(d) -> torch.device:
    """A ``torch.device`` with its CUDA index filled in; a CUDA device on
    a machine without one raises (a mesh never stands for the CPU)."""
    dev = torch.device(d)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"the mesh names {dev}, but no CUDA card is visible "
                "(torch.cuda.is_available() is False); build the mesh "
                "over devices='cpu' to run the plain PyTorch versions")
        index = torch.cuda.current_device() if dev.index is None \
            else dev.index
        if index >= torch.cuda.device_count():
            raise ValueError(f"the mesh names cuda:{index}, but only "
                             f"{torch.cuda.device_count()} CUDA devices "
                             "are visible")
        return torch.device("cuda", index)
    if dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported mesh device {dev}; the port runs "
                         "on cuda or cpu (meta: shapes only)")
    return dev


class Mesh:
    """Named axes over a grid of devices: ``devices`` an array-like of
    device specs with one dimension per name in ``axis_names`` (cuda,
    cpu, or meta for a dry run's mesh, which holds no data)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.asarray(devices, dtype=object)
        names = tuple(axis_names)
        if grid.ndim != len(names):
            raise ValueError(f"a mesh of {grid.ndim} dimensions needs as "
                             f"many axis names, got {names}")
        if len(set(names)) != len(names):
            raise ValueError(f"axis names repeat: {names}")
        out = np.empty(grid.shape, dtype=object)
        for pos, d in np.ndenumerate(grid):
            out[pos] = _as_device(d)
        self.devices = out
        self.axis_names = names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def lead(self) -> torch.device:
        """The first device: where replicated operands are built and
        shard results are gathered."""
        return self.devices.flat[0]

    def axis_devices(self, name: str = "data") -> List[torch.device]:
        """The devices along one axis, every other axis at index 0:
        shard s of an array sharded over ``name`` lives on entry s."""
        if name not in self.axis_names:
            raise ValueError(f"the mesh has no {name!r} axis (axes "
                             f"{self.axis_names})")
        ax = self.axis_names.index(name)
        index = [0] * len(self.axis_names)
        out = []
        for s in range(self.devices.shape[ax]):
            index[ax] = s
            out.append(self.devices[tuple(index)])
        return out

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


class MeshView:
    """A mesh facade hiding some axes from the rules that read it (the
    reference's view inside regions manual over those axes); ``base`` is
    the physical mesh."""

    def __init__(self, base, hidden=()):
        self.base = base
        self._hidden = set(hidden)

    @property
    def axis_names(self):
        return tuple(a for a in self.base.axis_names
                     if a not in self._hidden)

    @property
    def shape(self):
        return {k: v for k, v in self.base.shape.items()
                if k not in self._hidden}


def axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def visible_devices() -> List[torch.device]:
    """Every visible CUDA device; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is visible (torch.cuda.is_available() is False); "
            "pass devices='cpu' to lay the mesh out on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh_auto(sizes: Sequence[int], names: Sequence[str],
                   devices=None) -> Mesh:
    """A mesh of ``sizes`` over ``devices``: the visible CUDA devices by
    default, or a device spec or list of them (``"cpu"`` for the CPU).
    With more devices than the mesh holds the first ones are taken; with
    fewer, each is repeated over a block of consecutive positions (four
    shards on one card: ``make_mesh_auto((4,), ("data",))`` on a one-card
    machine)."""
    sizes = tuple(int(s) for s in sizes)
    total = int(np.prod(sizes)) if sizes else 1
    if devices is None:
        devices = visible_devices()
    elif isinstance(devices, (str, torch.device)):
        devices = [devices]
    devices = list(devices)[:total]
    if not devices or total % len(devices):
        raise ValueError(f"a mesh of {total} positions cannot be laid "
                         f"out over {len(devices)} devices")
    rep = total // len(devices)
    grid = np.empty(total, dtype=object)
    for i in range(total):
        grid[i] = devices[i // rep]
    return Mesh(grid.reshape(sizes), names)


def maybe(axis, dim: int, mesh):
    """Shard ``dim`` over ``axis`` only if it divides evenly."""
    if axis is None:
        return None
    total = 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        total *= axis_size(mesh, a)
    return axis if total > 1 and dim % total == 0 else None


def batch_axes(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def shard_rows(n: int, shards: int) -> List[Tuple[int, int]]:
    """Row ranges of ``n`` rows over ``shards`` shards: shard s owns
    ``[s * ns, min((s + 1) * ns, n))`` with ``ns = ceil(n / shards)``
    (the reference's padded layout without the pad rows; a trailing
    shard may be short or empty)."""
    ns = -(-n // shards) if shards else 0
    return [(min(s * ns, n), min((s + 1) * ns, n)) for s in range(shards)]


class PartitionSpec(tuple):
    """The reference's ``PartitionSpec``: one entry per tensor dim (None,
    an axis name, or a tuple of axis names whose sizes multiply; a
    one-name tuple is its name, as JAX normalizes it); trailing dims
    past the entries are not sharded."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass
class ShardedTensor:
    """A tensor laid out on a mesh: ``shards`` an object array shaped
    like the mesh, each position's block on that position's device
    (positions that hold the same block on the same device share one
    tensor)."""
    sharding: "NamedSharding"
    shards: Any
    shape: Tuple[int, ...]
    dtype: torch.dtype

    def gather(self, device=None) -> torch.Tensor:
        return self.sharding.gather(self, device)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where a tensor lives on a mesh: ``spec`` a ``PartitionSpec`` (or
    a tuple of its entries).  Dim i is split into as many equal blocks
    as the sizes of its entry's axes multiply; the mesh position whose
    indices along those axes count (row-major, in the entry's order) to
    j holds block j.

    ``segments`` (the tensor-parallel step's layout of a fused leaf,
    ``distributed.tensor_parallel.shardings``): the widths of the
    segments the dim split over "model" concatenates; block j is then
    the j-th slice of every segment, in segment order, instead of the
    j-th contiguous block (each segment must divide over the dim's
    axes).  A dim split over the FSDP axes beside it
    (``distributed.fsdp``) is cut in contiguous blocks.

    ``lay_out`` gives a ``ShardedTensor`` over every mesh position, the
    dims divisible by their axes (the rule tables guarantee it).  ``put``
    of a spec () or ("data",) keeps the data-shard layout the sharded
    engines read: one tensor per ``data`` shard, a replicated tensor
    copied once per distinct device, ("data",) the ``shard_rows`` blocks
    (a trailing block may be short); ``put`` of any other spec is
    ``lay_out``.  ``gather`` takes either back to the whole tensor."""
    mesh: Mesh
    spec: Tuple = ()
    segments: Tuple[int, ...] = ()

    def _data_layout(self) -> bool:
        return tuple(self.spec) in ((), ("data",)) and not self.segments

    def _ways(self, i: int) -> int:
        n = 1
        for a in entry_axes(self.spec[i]):
            n *= axis_size(self.mesh, a)
        return n

    def _segment_perm(self, shape):
        """(dim, perm) of a segment layout: the dim split over "model",
        and the index of the whole tensor's entry at each position of the
        blocks laid end to end; None without segments."""
        if not self.segments:
            return None
        dim = next(i for i, e in enumerate(self.spec)
                   if "model" in entry_axes(e))
        if sum(self.segments) != shape[dim]:
            raise ValueError(f"segments {self.segments} do not tile dim "
                             f"{dim} of {tuple(shape)}")
        return dim, segment_perm(self.segments, self._ways(dim))

    def shard_shape(self, global_shape) -> Tuple[int, ...]:
        """The block of ``global_shape`` that one position holds."""
        shape = list(global_shape)
        self._segment_perm(shape)                # checks the segments
        for i, entry in enumerate(self.spec):
            n = self._ways(i)
            if shape[i] % n:
                raise ValueError(f"dim {i} of {tuple(global_shape)} does "
                                 f"not divide over {entry!r} ({n} ways)")
            shape[i] //= n
        return tuple(shape)

    def _slices(self, pos, shape) -> Tuple[slice, ...]:
        """The block of position ``pos`` (an index into the mesh)."""
        names = self.mesh.axis_names
        block = self.shard_shape(shape)
        out = []
        for i, entry in enumerate(self.spec):
            j = 0
            for a in entry_axes(entry):
                if a in names:
                    j = j * axis_size(self.mesh, a) + pos[names.index(a)]
            out.append(slice(j * block[i], (j + 1) * block[i]))
        return tuple(out)

    def put(self, x: torch.Tensor):
        """Lay ``x`` out: the data-shard list for () and ("data",), a
        ``ShardedTensor`` for any other spec (class docstring).  Each
        block is a copy on its device, never a view of ``x``, except the
        data layout's, which keeps the engines' behaviour (a row block
        on its own device is a view)."""
        if self._data_layout():
            devs = self.mesh.axis_devices("data")
            if self.spec == ():
                copies = {}
                for d in devs:
                    if d not in copies:
                        copies[d] = x.to(d)
                return [copies[d] for d in devs]
            return [x[a:b].to(d).contiguous()
                    for (a, b), d in zip(shard_rows(x.shape[0], len(devs)),
                                         devs)]
        return self.lay_out(x)

    def lay_out(self, x: torch.Tensor) -> ShardedTensor:
        """``x`` over every mesh position, each block a copy on its
        position's device (one a distinct block and device)."""
        blocks = {}
        shards = np.empty(self.mesh.devices.shape, dtype=object)
        seg = self._segment_perm(x.shape)
        if seg is not None:                # blocks of the permuted tensor
            x = x.index_select(seg[0], seg[1].to(x.device))
        for pos in np.ndindex(*self.mesh.devices.shape):
            dev = self.mesh.devices[pos]
            sl = self._slices(pos, x.shape)
            key = (dev, tuple((s.start, s.stop) for s in sl))
            if key not in blocks:
                blocks[key] = x[sl].to(dev, copy=True).contiguous()
            shards[pos] = blocks[key]
        return ShardedTensor(self, shards, tuple(x.shape), x.dtype)

    def gather(self, placed, device=None) -> torch.Tensor:
        """The whole tensor from what ``put`` returned, on ``device``
        (the mesh's lead device by default), bit for bit ``x``."""
        dev = torch.device(device) if device is not None else self.mesh.lead
        if not isinstance(placed, ShardedTensor):
            if self.spec == ():
                return placed[0].to(dev)
            return torch.cat([t.to(dev) for t in placed])
        out = torch.empty(placed.shape, dtype=placed.dtype, device=dev)
        done = set()
        for pos in np.ndindex(*self.mesh.devices.shape):
            sl = self._slices(pos, placed.shape)
            key = tuple((s.start, s.stop) for s in sl)
            if key not in done:
                out[sl] = placed.shards[pos].to(dev)
                done.add(key)
        seg = self._segment_perm(placed.shape)
        if seg is not None:
            out = torch.empty_like(out).index_copy_(seg[0],
                                                    seg[1].to(dev), out)
        return out


def segment_perm(segments, ways: int) -> torch.Tensor:
    """The segment layout's order of a dim concatenating ``segments``
    split ``ways`` ways: block j takes slice j of each segment in turn
    (int64 indices into the whole dim).  Raises when a segment does not
    divide."""
    bad = [w for w in segments if w % ways]
    if bad:
        raise ValueError(f"segments {tuple(segments)} do not each split "
                         f"{ways} ways ({bad})")
    starts = np.cumsum((0,) + tuple(segments))[:-1]
    idx = [np.arange(o + j * (w // ways), o + (j + 1) * (w // ways))
           for j in range(ways) for o, w in zip(starts, segments)]
    return torch.from_numpy(np.concatenate(idx).astype(np.int64))


def replicated(mesh) -> NamedSharding:
    """Every shard holds the whole tensor."""
    return NamedSharding(mesh, ())


# ------------------------------------------------------------ pytrees ----

def _path_str(path) -> str:
    """The reference's "a/b/0" form of a leaf's path of keys."""
    return "/".join(str(p) for p in path)


def tree_map_with_path(fn: Callable, tree, path=()):
    """``fn(path, leaf)`` over nested dicts (and lists / tuples), path
    the tuple of keys from the root (the reference's
    ``tree_map_with_path`` over the same trees)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


# ------------------------------------------------------------------ params

def fsdp_axes(mesh, fsdp_over_pod: bool = True):
    """The FSDP axis set: in-pod "data", plus "pod" when present (the
    parameters and optimizer state shard over every data-parallel
    device).  ``fsdp_over_pod=False`` keeps params replicated across
    pods (pure cross-pod data parallelism): the compressed gradient
    exchange needs it, pods sharing only int8 gradient payloads."""
    if "pod" in mesh.axis_names and fsdp_over_pod:
        return ("pod", "data")
    return "data"


def param_pspec(path, leaf, mesh, fsdp_over_pod: bool = True) -> P:
    """The reference's rule table, keyed on the trailing param name;
    specs cover trailing dims and are left-padded with None (stacked
    layer axes unsharded).  "data" in the table means the FSDP axis set
    (pod + data on the multi-pod mesh)."""
    name = _path_str(path)
    last = name.rsplit("/", 1)[-1]
    shape = tuple(leaf.shape)
    nd = len(shape)
    fsdp = fsdp_axes(mesh, fsdp_over_pod)

    def spec(*trailing):
        trailing = [fsdp if t == "data" else t for t in trailing]
        assert len(trailing) <= nd, (name, shape, trailing)
        full = [None] * (nd - len(trailing)) + trailing
        return P(*[maybe(a, shape[i], mesh) for i, a in enumerate(full)])

    if nd == 0 or last in ("A_log", "dt_bias", "lambda"):
        return P()
    # embeddings / heads
    if last == "embed":
        return spec("model", "data")                 # (V, d)
    if last == "head":
        return spec("data", "model")                 # (d, V)
    if last in ("enc_pos", "dec_pos"):
        return spec(None, "data")
    if last == "vis_proj":
        return spec(None, "model")
    # attention
    if last in ("wq", "wk", "wv"):
        return spec("data", "model")
    if last == "wo":
        return spec("model", "data")
    # MLA
    if last in ("w_dq", "w_dkv"):
        return spec("data", None)
    if last in ("w_uq", "w_uk", "w_uv"):
        return spec("data", "model")
    # MoE experts (E, d, f) / (E, f, d); the router replicated
    if last == "router":
        return P(*([None] * nd))
    if last in ("we_gate", "we_up"):
        return spec("model", "data", None)           # E -> model (EP)
    if last == "we_down":
        return spec("model", None, "data")
    if last in ("w_gate", "w_up"):
        return spec("data", "model")
    if last == "w_down":
        return spec("model", "data")
    # SSM
    if last == "w_in":
        return spec("data", "model")
    if last == "conv_w":
        return spec(None, "model")
    if last in ("conv_b", "D"):
        return spec("model")
    if last == "w_out":
        return spec("model", "data")
    # RG-LRU
    if last in ("w_x", "w_gate_branch"):
        return spec("data", "model")
    if last == "w" and ("rg" in name or "ig" in name):
        return spec("model", None, None)             # (nb, bw, bw)
    if last == "b" and ("rg" in name or "ig" in name):
        return spec("model", None)
    # plain MLP biases
    if last == "b_up":
        return spec("model")
    if last == "b_down":
        return spec("data")
    # norms / everything small: replicated
    return P(*([None] * nd))


def param_shardings(params_shape, mesh, fsdp_over_pod: bool = True):
    """A ``NamedSharding`` per leaf of a params tree (tensors, meta
    tensors or anything with ``.shape``)."""
    return tree_map_with_path(
        lambda p, l: NamedSharding(mesh, param_pspec(p, l, mesh,
                                                     fsdp_over_pod)),
        params_shape)


# ------------------------------------------------------------------ caches

def cache_pspec(path, leaf, cfg, mesh) -> P:
    name = _path_str(path)
    last = name.rsplit("/", 1)[-1]
    shape = tuple(leaf.shape)
    nd = len(shape)
    msize = axis_size(mesh, "model")
    heads = (cfg.num_kv_heads % max(msize, 1) == 0
             and cfg.num_kv_heads >= msize)

    def pad(*trailing):
        full = [None] * (nd - len(trailing)) + list(trailing)
        return P(*[maybe(a, shape[i], mesh) for i, a in enumerate(full)])

    if last == "pos" or nd == 0:
        return P()
    if last in ("k", "v"):                           # (..., b, S, kvh, dh)
        if heads:
            return pad("data", None, "model", None)
        return pad("data", "model", None, None)      # context-parallel S
    if last == "k_pos":                              # (..., b, S)
        return pad("data", None) if heads else pad("data", "model")
    if last in ("ck", "cv"):                         # (..., b, Senc, kvh, dh)
        return pad("data", None, None, "model")      # dh -> model
    if last in ("latent", "k_rope"):                 # (..., b, S, r)
        return pad("data", "model", None)
    if last == "state":                              # ssm (..., b, h, p, n)
        return pad("data", "model", None, None)
    if last == "h":                                  # rglru (..., b, w)
        return pad("data", "model")
    if last == "conv":                               # (..., b, w-1, c)
        return pad("data", None, "model")
    return P(*([None] * nd))


def cache_shardings(cache_shape, cfg, mesh):
    return tree_map_with_path(
        lambda p, l: NamedSharding(mesh, cache_pspec(p, l, cfg, mesh)),
        cache_shape)


# ------------------------------------------------------- the model axis

def model_pspec(path, leaf, mesh, cfg=None) -> P:
    """The ``model`` entries of a leaf's rule-table spec, the ``data``
    and ``pod`` entries dropped: ``param_pspec``'s, or ``cache_pspec``'s
    when ``cfg`` is given (a cache leaf).  What the tensor-parallel step
    executes (``distributed.tensor_parallel``) for a tree placed by these
    specs: params whole over ``data`` / ``pod``.  A params tree placed
    by the full specs (``param_shardings``; ``distributed.fsdp``) runs
    the FSDP step, which gathers each leaf's model block from its
    ``data`` / ``pod`` blocks where the model reads it."""
    spec = (cache_pspec(path, leaf, cfg, mesh) if cfg is not None
            else param_pspec(path, leaf, mesh))
    return P(*["model" if "model" in entry_axes(e) else None for e in spec])


def model_shardings(tree, mesh, cfg=None):
    """A ``NamedSharding`` of ``model_pspec`` per leaf of a params tree
    (a cache tree when ``cfg`` is given)."""
    return tree_map_with_path(
        lambda p, l: NamedSharding(mesh, model_pspec(p, l, mesh, cfg)), tree)


# ------------------------------------------------------------------ batch

def batch_pspec(leaf, mesh) -> P:
    shape = tuple(leaf.shape)
    if len(shape) == 0:
        return P()
    ba = batch_axes(mesh)
    first = maybe(ba if len(ba) > 1 else ba[0], shape[0], mesh)
    return P(first, *([None] * (len(shape) - 1)))


def batch_shardings(batch_shape, mesh):
    return tree_map_with_path(
        lambda _, l: NamedSharding(mesh, batch_pspec(l, mesh)), batch_shape)


def zip_leaves(tree, *others):
    """The leaves of ``tree`` (nested dicts, lists and tuples), each
    with the leaves at the same place in ``others`` (trees of the same
    structure): tuples (leaf, *other leaves)."""
    if isinstance(tree, dict):
        for k in tree:
            yield from zip_leaves(tree[k], *(o[k] for o in others))
    elif isinstance(tree, (list, tuple)) and not isinstance(
            tree, PartitionSpec):
        for i, t in enumerate(tree):
            yield from zip_leaves(t, *(o[i] for o in others))
    else:
        yield (tree,) + others


def shard_bytes(tree, shardings) -> int:
    """Bytes one mesh position holds of ``tree`` (leaves with ``.shape``
    and ``.dtype``) under ``shardings`` (a matching tree), each leaf's
    shard shape times its item size."""
    total = 0
    for leaf, sh in zip_leaves(tree, shardings):
        n = 1
        for d in sh.shard_shape(leaf.shape):
            n *= d
        total += n * leaf.dtype.itemsize
    return total
