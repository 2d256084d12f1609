"""The index layer of the port (twin of ``repro.index``): one ``Index``
protocol, three implementations (``FlatADC``, ``TwoStep``,
``IVFTwoStep``), one backend dispatch, on one device, and their
sharded serving clones.

    from repro_torch.index import make_index
    idx = make_index("ivf", codes, C, structure, emb_db=emb,
                     n_lists=256, n_probe=8)
    result = idx.search(queries)          # SearchResult
    idx = idx.shard(mesh)                 # optional: sharded serving

``core.search`` and ``core.ivf`` re-export these names.
"""
from __future__ import annotations

import functools
import importlib

import torch

from repro_torch.core.icq import ICQStructure
from repro_torch.index.base import (CODE_BITS, LUT_DTYPES, Index,
                                    QuantizedLUT, SearchResult, as_torch,
                                    build_lut, chunked_over_queries,
                                    exact_search, fastscan_kernel_operands,
                                    lut_sum, mean_average_precision,
                                    nibble_lut_sum, pad_luts_even,
                                    quantize_lut, recall_at,
                                    resolve_backend, resolve_code_bits,
                                    resolve_device, resolve_lut_dtype)
# flat.py, ivf.py and pipelined.py build on kernels/stages.py, which
# imports index.base: importing them here eagerly would cycle, so their
# names (and INDEX_KINDS) resolve on first access (PEP 562)
_EXPORTS = {name: "repro_torch.index.flat" for name in (
    "FlatADC", "TwoStep", "adc_search", "two_step_search",
    "two_step_search_compact")}
_EXPORTS.update({name: "repro_torch.index.ivf" for name in (
    "IVFIndex", "IVFTwoStep", "build_ivf", "ivf_assign", "ivf_extend",
    "ivf_list_codes", "ivf_two_step_search")})
_EXPORTS.update({name: "repro_torch.index.sharded" for name in (
    "ShardedFlatADC", "ShardedTwoStep", "ShardedIVFTwoStep")})
_EXPORTS.update({name: "repro_torch.index.pipelined" for name in (
    "PIPELINE_MODES", "PipelinedSearch", "maybe_pipelined",
    "resolve_pipeline", "resolve_tile")})


@functools.cache
def _index_kinds():
    from repro_torch.index.flat import FlatADC, TwoStep
    from repro_torch.index.ivf import IVFTwoStep
    return {"flat": FlatADC, "two-step": TwoStep, "ivf": IVFTwoStep}


def __getattr__(name: str):
    if name == "INDEX_KINDS":
        return _index_kinds()
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module 'repro_torch.index' has no attribute {name!r}")
    return getattr(importlib.import_module(module), name)


def __dir__():
    return sorted(set(globals()) | set(__all__))


def make_index(kind: str, codes, C, structure=None, *, device=None,
               **opts):
    """Build an index by name ("flat" | "two-step" | "ivf") with its
    arrays (numpy or torch) moved to ``device`` — the CUDA card unless
    the caller names another device (``index.base.resolve_device``).

    "ivf" takes ``emb_db`` (the (n, d) embeddings the codes encode),
    ``n_lists``, ``n_probe``, ``kmeans_iters`` and ``generator`` (a
    ``torch.Generator`` or an int seed) and fits its coarse k-means on
    the device; or ``ivf``, a stored ``IVFIndex`` partition."""
    from repro_torch.index.ivf import IVFIndex

    try:
        cls = _index_kinds()[kind]
    except KeyError:
        raise ValueError(f"unknown index kind {kind!r}; "
                         f"expected one of {sorted(_index_kinds())}") from None
    dev = resolve_device(device)
    codes = as_torch(codes)
    if codes.dtype not in (torch.uint8, torch.int32):
        codes = codes.to(torch.int32)     # uint16 codes (m > 256) widen
    codes = codes.to(dev).contiguous()
    C = as_torch(C).to(dev, torch.float32).contiguous()
    if structure is not None:
        structure = ICQStructure(*(as_torch(t).to(dev) for t in structure))
    resolve_backend(opts.get("backend", "auto"), dev)
    if opts.get("emb_db") is not None:
        opts["emb_db"] = as_torch(opts["emb_db"]).to(
            dev, torch.float32).contiguous()
    if opts.get("ivf") is not None:
        ivf = opts["ivf"]
        opts["ivf"] = IVFIndex(
            centroids=as_torch(ivf.centroids).to(dev, torch.float32),
            lists=as_torch(ivf.lists).to(dev, torch.int32),
            list_lens=as_torch(ivf.list_lens).to(dev, torch.int32),
            imbalance=float(ivf.imbalance))
    return cls.build(codes, C, structure, **opts)


__all__ = [
    "Index", "SearchResult", "FlatADC", "TwoStep", "IVFTwoStep",
    "IVFIndex", "INDEX_KINDS", "CODE_BITS", "LUT_DTYPES", "QuantizedLUT",
    "make_index",
    "adc_search", "two_step_search", "two_step_search_compact",
    "ivf_two_step_search", "build_ivf", "ivf_assign", "ivf_extend",
    "ivf_list_codes", "build_lut",
    "lut_sum", "nibble_lut_sum", "pad_luts_even",
    "fastscan_kernel_operands", "quantize_lut", "exact_search",
    "chunked_over_queries", "resolve_backend", "resolve_code_bits",
    "resolve_lut_dtype", "mean_average_precision", "recall_at",
    "PIPELINE_MODES", "PipelinedSearch", "maybe_pipelined",
    "resolve_pipeline", "resolve_tile", "resolve_device",
    "ShardedFlatADC", "ShardedTwoStep", "ShardedIVFTwoStep",
]
