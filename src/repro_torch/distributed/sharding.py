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

``shard_map_compat`` and ``abstract_mesh`` are JAX's own (a manual SPMD
region, an abstract mesh for tracing) and have no twin: a port function
loops over its shards instead.  The LM parameter, cache and batch rule
tables (``param_pspec``/``param_shardings``, ``cache_pspec``/
``cache_shardings``, ``batch_pspec``/``batch_shardings``) are keyed on
transformer parameter paths and come with LM sharding (ROADMAP item
23).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

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
    if dev.type != "cpu":
        raise ValueError(f"unsupported mesh device {dev}; the port runs "
                         "on cuda or cpu")
    return dev


class Mesh:
    """Named axes over a grid of devices: ``devices`` an array-like of
    device specs with one dimension per name in ``axis_names``."""

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


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where a tensor lives on a mesh: ``spec`` () replicates it on every
    device of the ``data`` axis, ``("data",)`` splits its leading axis
    into the ``shard_rows`` blocks, block s on device s."""
    mesh: Mesh
    spec: Tuple = ()

    def put(self, x: torch.Tensor) -> List[torch.Tensor]:
        """One tensor per ``data`` shard.  A replicated tensor is copied
        once per distinct device, so shards on one device read the same
        tensor; a row block on its own device is a view, not a copy."""
        devs = self.mesh.axis_devices("data")
        if self.spec == ():
            copies = {}
            for d in devs:
                if d not in copies:
                    copies[d] = x.to(d)
            return [copies[d] for d in devs]
        if tuple(self.spec) != ("data",):
            raise ValueError(f"unsupported spec {self.spec!r}; the port "
                             "places () or ('data',)")
        return [x[a:b].to(d).contiguous()
                for (a, b), d in zip(shard_rows(x.shape[0], len(devs)),
                                     devs)]


def replicated(mesh) -> NamedSharding:
    """Every shard holds the whole tensor."""
    return NamedSharding(mesh, ())
