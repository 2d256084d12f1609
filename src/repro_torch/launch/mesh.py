"""Meshes of the launchers (twin of ``repro.launch.mesh``) over the
port's ``distributed.sharding.Mesh``.

Single pod: 16 x 16 = 256 devices, axes (data, model).  Multi-pod: 2 x
16 x 16 = 512 devices, axes (pod, data, model): "pod" carries cross-pod
data parallelism, "data" in-pod FSDP / data parallelism, "model" tensor
and expert parallelism.  The dry run lays them over ``"meta"`` devices;
over fewer real devices each repeats over a block of positions, as
``make_mesh_auto`` lays any mesh out.
"""
from __future__ import annotations

from repro_torch.distributed.sharding import Mesh, make_mesh_auto
from repro_torch.index.base import resolve_device


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """The production mesh over ``devices`` (the visible CUDA devices by
    default; ``"meta"`` for the dry run)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_auto(shape, axes, devices=devices)


def make_host_mesh(device=None) -> Mesh:
    """Degenerate 1 x 1 ("data", "model") mesh over one device (the card
    unless the caller names another): the launchers' smoke runs."""
    return Mesh([[resolve_device(device)]], ("data", "model"))


def dp_size(mesh) -> int:
    """Data-parallel ways: the ``data`` axis times ``pod`` when present."""
    n = mesh.shape["data"]
    if "pod" in mesh.axis_names:
        n *= mesh.shape["pod"]
    return n
