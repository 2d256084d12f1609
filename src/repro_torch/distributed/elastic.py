"""Elastic re-meshing (twin of ``repro.distributed.elastic``): the mesh
shape for the devices that survive.

Policy: keep the ``model`` axis at the largest size that still divides
the tensor-parallel dims (heads and d_ff must divide it), absorb the
remaining devices into ``data`` (data parallelism shrinks safely), and
drop stragglers to a power-of-two fleet so collectives stay balanced.
``reshard_state`` moves a params / optimizer tree onto the new mesh
under the same logical rules: on the single controller every leaf is
gathered whole and laid out again by the new mesh's param shardings (a
real fleet restores from the checkpoint instead, under the same specs).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from repro_torch.distributed.sharding import (Mesh, ShardedTensor,
                                              param_shardings,
                                              tree_map_with_path,
                                              visible_devices)


def _pow2_floor(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def plan_mesh_shape(num_devices: int, *, model_divisors: Sequence[int],
                    max_model: int = 16) -> Tuple[int, int]:
    """(data, model) for the surviving fleet.

    ``model_divisors``: dims that the model axis must divide (num_kv_heads,
    d_ff tiling, expert count ...).  Picks the largest power-of-two model
    size <= max_model dividing all of them and the device count.
    """
    usable = _pow2_floor(num_devices)
    model = _pow2_floor(max_model)
    while model > 1:
        if usable % model == 0 and all(d % model == 0 for d in model_divisors
                                       if d > 0):
            break
        model //= 2
    return usable // model, model


def make_elastic_mesh(devices=None, *, model_divisors: Sequence[int] = (),
                      max_model: int = 16) -> Mesh:
    """A (data, model) mesh over ``devices`` (the visible CUDA devices by
    default) shaped by ``plan_mesh_shape``; the stragglers past the
    power-of-two fleet are left out."""
    devices = list(devices) if devices is not None else visible_devices()
    data, model = plan_mesh_shape(len(devices), model_divisors=model_divisors,
                                  max_model=max_model)
    grid = np.empty(data * model, dtype=object)
    for i in range(data * model):
        grid[i] = devices[i]
    return Mesh(grid.reshape(data, model), ("data", "model"))


def reshard_state(state, old_mesh: Mesh, new_mesh: Mesh, cfg=None):
    """``state`` (a tree of tensors, or of ``ShardedTensor``s laid out on
    ``old_mesh``) laid out on ``new_mesh`` under its param rules
    (``param_shardings``): a tree of ``ShardedTensor``s.  Each leaf is
    gathered on ``old_mesh``'s lead device first; the values move bit
    for bit.
    ``cfg`` is the reference's unused argument."""
    def whole(_, leaf):
        if isinstance(leaf, ShardedTensor):
            return leaf.gather(old_mesh.lead)
        return leaf
    flat = tree_map_with_path(whole, state)
    shardings = param_shardings(flat, new_mesh)

    return tree_map_with_path(
        lambda path, leaf: _at(shardings, path).lay_out(leaf), flat)


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree
