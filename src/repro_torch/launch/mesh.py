"""Meshes of the launchers (twin of ``repro.launch.mesh``): the host
mesh of a one-device run and the data-parallel size of a mesh, over the
port's ``distributed.sharding.Mesh``.  The production meshes
(``make_production_mesh``: 16 x 16 and 2 x 16 x 16 chips) come with LM
sharding, ROADMAP item 23."""
from __future__ import annotations

from repro_torch.distributed.sharding import Mesh
from repro_torch.index.base import resolve_device


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
