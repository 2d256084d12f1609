"""PyTorch and CUDA port of the ICQ system (the JAX package ``repro``
is its reference).  It trains, encodes and serves the paper's two-step
search on an NVIDIA H100 through hand-written CUDA kernels
(``kernels/csrc``); each kernel has a plain PyTorch version, which runs
for tensors on the CPU.  See README.md, "PyTorch / H100 port".

This root lazily re-exports the front-door surface (PEP 562), as the
reference's does, so ``from repro_torch import icq_session`` works
without importing the subsystems at startup:

  - ``repro_torch.api``      config tree, ``icq_session``, ``Artifacts``,
                             serving engines
  - ``repro_torch.index``    ``FlatADC`` / ``TwoStep`` / ``IVFTwoStep``
  - ``repro_torch.trainer``  ``fit``, the ``Quantizer`` protocol, the
                             tiled encoder
"""
from __future__ import annotations

import importlib

# name -> providing module, resolved on first attribute access
_EXPORTS = {
    name: "repro_torch.api" for name in (
        "ICQConfig", "TrainConfig", "EncodeConfig", "IndexConfig",
        "ServeConfig", "ConfigError", "icq_session", "ICQSession",
        "Searcher", "Artifacts", "ArtifactError", "save_artifacts",
        "load_artifacts", "AnnEngine", "build_ann_engine",
        "load_ann_engine")
}
_EXPORTS.update({name: "repro_torch.index" for name in (
    "make_index", "SearchResult", "FlatADC", "TwoStep", "IVFTwoStep",
    "exact_search", "recall_at", "mean_average_precision")})
_EXPORTS.update({name: "repro_torch.trainer" for name in (
    "fit", "make_quantizer", "encode_database", "ICQModel", "Quantizer")})

__all__ = sorted(_EXPORTS) + ["api", "index", "trainer"]


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        if name in ("api", "index", "trainer"):
            return importlib.import_module(f"repro_torch.{name}")
        raise AttributeError(
            f"module 'repro_torch' has no attribute {name!r}")
    return getattr(importlib.import_module(module), name)


def __dir__():
    return sorted(set(globals()) | set(__all__))
