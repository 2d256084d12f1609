"""The index layer of the port (twin of ``repro.index``): ``make_index``
builds a ``FlatADC``, ``TwoStep`` or ``IVFTwoStep`` by name on one
device."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.icq import ICQStructure
from repro_torch.index.base import (SearchResult, build_lut, lut_sum,
                                    resolve_backend, resolve_device)

INDEX_KINDS = ("flat", "two-step", "ivf")


def _tensor(x) -> torch.Tensor:
    """A tensor of ``x`` (numpy arrays are copied: arrays handed over
    from other frameworks may be read-only)."""
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.array(x))


def make_index(kind: str, codes, C, structure=None, *, device=None,
               **opts):
    """Build an index by name ("flat" | "two-step" | "ivf") with its
    arrays (numpy or torch) moved to ``device`` — the CUDA card unless
    the caller names another device (``index.base.resolve_device``).

    "ivf" takes ``emb_db`` (the (n, d) embeddings the codes encode),
    ``n_lists``, ``n_probe``, ``kmeans_iters`` and ``generator`` (a
    ``torch.Generator`` or an int seed) and fits its coarse k-means on
    the device; or ``ivf``, a stored ``IVFIndex`` partition."""
    # flat.py and ivf.py build on kernels/stages.py, which imports
    # index.base: a module-level import here would cycle
    from repro_torch.index.flat import FlatADC, TwoStep
    from repro_torch.index.ivf import IVFIndex, IVFTwoStep

    if kind not in INDEX_KINDS:
        raise ValueError(f"unknown index kind {kind!r}; expected one of "
                         f"{list(INDEX_KINDS)}")
    cls = {"flat": FlatADC, "two-step": TwoStep, "ivf": IVFTwoStep}[kind]
    dev = resolve_device(device)
    codes = _tensor(codes)
    if codes.dtype not in (torch.uint8, torch.int32):
        codes = codes.to(torch.int32)     # uint16 codes (m > 256) widen
    codes = codes.to(dev).contiguous()
    C = _tensor(C).to(dev, torch.float32).contiguous()
    if structure is not None:
        structure = ICQStructure(*(_tensor(t).to(dev) for t in structure))
    resolve_backend(opts.get("backend", "auto"), dev)
    if opts.get("emb_db") is not None:
        opts["emb_db"] = _tensor(opts["emb_db"]).to(dev, torch.float32)
    if opts.get("ivf") is not None:
        ivf = opts["ivf"]
        opts["ivf"] = IVFIndex(
            centroids=_tensor(ivf.centroids).to(dev, torch.float32),
            lists=_tensor(ivf.lists).to(dev, torch.int32),
            list_lens=_tensor(ivf.list_lens).to(dev, torch.int32),
            imbalance=float(ivf.imbalance))
    return cls.build(codes, C, structure, **opts)


__all__ = ["INDEX_KINDS", "SearchResult",
           "make_index", "build_lut", "lut_sum", "resolve_device"]
