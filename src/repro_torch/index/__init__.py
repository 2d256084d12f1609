"""The flat index layer of the port (twin of ``repro.index``):
``make_index`` builds a ``FlatADC`` or ``TwoStep`` by name on one
device.  The IVF index is still to be ported (ROADMAP.md, queue 1,
item 5) and raises by name."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.icq import ICQStructure
from repro_torch.index.base import (SearchResult, build_lut, lut_sum,
                                    resolve_backend, resolve_device)

INDEX_KINDS = ("flat", "two-step")


def _tensor(x) -> torch.Tensor:
    """A tensor of ``x`` (numpy arrays are copied: arrays handed over
    from other frameworks may be read-only)."""
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.array(x))


def make_index(kind: str, codes, C, structure=None, *, device=None,
               **opts):
    """Build an index by name ("flat" | "two-step") with its arrays
    (numpy or torch) moved to ``device`` — the CUDA card unless the
    caller names another device (``index.base.resolve_device``)."""
    if kind == "ivf":
        raise NotImplementedError("index kind 'ivf' is not ported to the "
                                  "PyTorch package yet (ROADMAP.md, "
                                  "queue 1, item 5)")
    # flat.py builds on kernels/stages.py, which imports index.base: a
    # module-level import here would cycle
    from repro_torch.index.flat import FlatADC, TwoStep

    if kind not in INDEX_KINDS:
        raise ValueError(f"unknown index kind {kind!r}; expected one of "
                         f"{list(INDEX_KINDS) + ['ivf']}")
    cls = FlatADC if kind == "flat" else TwoStep
    dev = resolve_device(device)
    codes = _tensor(codes)
    if codes.dtype not in (torch.uint8, torch.int32):
        codes = codes.to(torch.int32)     # uint16 codes (m > 256) widen
    codes = codes.to(dev).contiguous()
    C = _tensor(C).to(dev, torch.float32).contiguous()
    if structure is not None:
        structure = ICQStructure(*(_tensor(t).to(dev) for t in structure))
    resolve_backend(opts.get("backend", "auto"), dev)
    return cls.build(codes, C, structure, **opts)


__all__ = ["INDEX_KINDS", "SearchResult",
           "make_index", "build_lut", "lut_sum", "resolve_device"]
