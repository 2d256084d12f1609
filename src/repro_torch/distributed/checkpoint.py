"""Checkpointing (twin of ``repro.distributed.checkpoint``): npz-based,
atomic, retention-managed, async-capable, in the reference's on-disk
layout, so a checkpoint written by either package restores in the
other.

  - a state tree (nested dicts, lists and tuples of tensors, numpy
    arrays or scalars; ``None`` is an empty subtree, as in JAX) is
    flattened to path-keyed host arrays (``a/b/0/c``, dict keys in
    sorted order) and written as one ``arrays.npz`` per step beside a
    ``manifest.json`` (step, wall time, array count and bytes);
  - writes go to ``step_XXXXXXXX.tmp/`` and are renamed into place, so a
    crash mid-write never corrupts the newest checkpoint;
  - ``restore_latest`` walks the steps newest first and skips one that
    fails to read (a node dying during a save must not poison restart);
  - retention keeps the newest ``keep`` checkpoints plus every
    ``keep_period``-th step;
  - ``save_async`` copies the tensors to host numpy at once and writes
    on a background thread;
  - a leaf laid out on a mesh (a ``ShardedTensor``: the tensor-parallel
    or FSDP step's state) is saved whole, in the reference's layout, and
    restored laid out by the template leaf's sharding.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import ShardedTensor


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, ShardedTensor):
        leaf = leaf.gather("cpu")
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _leaves_with_paths(tree, prefix=()):
    """(path, leaf) pairs in JAX's flattening order: dict keys sorted,
    list and tuple items by position, ``None`` skipped."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _host_tree(tree):
    """A copy of ``tree`` with every leaf on the host (numpy)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_tree(v) for v in tree)
    return _host(tree)


def flatten_pytree(tree) -> Dict[str, np.ndarray]:
    """Flatten a state tree to path-keyed host arrays (``a/b/0/c``
    keys): the on-disk layout of checkpoints and of ``repro_torch.api``
    artifacts."""
    return {key: _host(leaf) for key, leaf in _leaves_with_paths(tree)}


def unflatten_pytree(template, flat: Dict[str, np.ndarray]):
    """Inverse of ``flatten_pytree`` against a structural ``template``:
    each leaf takes the template leaf's dtype and shape, and a tensor
    leaf its device (a numpy leaf stays numpy; a ``ShardedTensor`` leaf
    is laid out by its sharding)."""
    def build(t, prefix):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v, prefix + (str(i),))
                           for i, v in enumerate(t))
        key = "/".join(prefix)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        if isinstance(t, ShardedTensor):
            a = np.ascontiguousarray(flat[key]).reshape(tuple(t.shape))
            return t.sharding.lay_out(torch.from_numpy(a.copy()).to(t.dtype))
        if isinstance(t, torch.Tensor):
            a = np.ascontiguousarray(flat[key]).reshape(tuple(t.shape))
            return torch.from_numpy(a.copy()).to(t.device, t.dtype)
        leaf = np.asarray(t)
        return flat[key].astype(leaf.dtype).reshape(leaf.shape)
    return build(template, ())


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, keep_period: int = 0):
        self.dir = directory
        self.keep = keep
        self.keep_period = keep_period
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ paths --
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.dir):
            full = os.path.join(self.dir, name)
            if (name.startswith("step_") and not name.endswith(".tmp")
                    and os.path.exists(os.path.join(full, "manifest.json"))):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(steps)

    # ------------------------------------------------------------- save --
    def save(self, step: int, state: Any, *, extra: Optional[Dict] = None):
        """Blocking atomic save of a state tree at ``step``."""
        self._write(step, _host_tree(state), extra or {})

    def save_async(self, step: int, state: Any, *,
                   extra: Optional[Dict] = None):
        """Device -> host copy now; the disk write on a background
        thread."""
        self.wait()                       # one in-flight save at a time
        host_state = _host_tree(state)
        self._thread = threading.Thread(
            target=self._write, args=(step, host_state, extra or {}),
            daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_state, extra: Dict):
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        flat = flatten_pytree(host_state)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": step,
            "time": time.time(),
            "num_arrays": len(flat),
            "bytes": int(sum(a.nbytes for a in flat.values())),
            **extra,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)             # atomic commit
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        doomed = steps[:-self.keep] if self.keep else []
        for s in doomed:
            if self.keep_period and s % self.keep_period == 0:
                continue
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ---------------------------------------------------------- restore --
    def restore(self, step: int, template: Any) -> Any:
        path = self._step_dir(step)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        return unflatten_pytree(template, flat)

    def restore_latest(self, template: Any) -> Tuple[Optional[int], Any]:
        """(step, state) of the newest checkpoint that restores, or
        (None, template): a truncated or corrupt newest checkpoint falls
        through to the one before it."""
        for step in reversed(self.all_steps()):
            try:
                return step, self.restore(step, template)
            except Exception:   # any read or decode failure: try older
                continue
        return None, template
