"""ICQ core of the port (twin of ``repro.core``): the prior, variance,
codebooks, encoders, losses, structure and embedders, plus the
re-exports of the trainer layer (``core/train.py``), the index layer
(``core/search.py``) and the baselines (``core/baselines``).

The re-exported names resolve on first access (PEP 562): the index and
trainer layers import ``core`` modules themselves, so importing them
here eagerly would cycle."""
from __future__ import annotations

import importlib

from repro_torch.core.icq import ICQStructure, build_structure

_EXPORTS = {name: "repro_torch.core.train"
            for name in ("ICQModel", "fit", "finalize")}
_EXPORTS.update({name: "repro_torch.core.search" for name in (
    "SearchResult", "adc_search", "exact_search", "two_step_search",
    "two_step_search_compact", "mean_average_precision", "recall_at")})

__all__ = [
    "ICQModel", "fit", "finalize", "ICQStructure", "build_structure",
    "SearchResult", "adc_search", "exact_search", "two_step_search",
    "two_step_search_compact", "mean_average_precision", "recall_at",
]


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module 'repro_torch.core' has no attribute {name!r}")
    return getattr(importlib.import_module(module), name)


def __dir__():
    return sorted(set(globals()) | set(__all__))
