"""Two-step similarity search: a re-export of the index layer (twin of
``repro.core.search``).  New code should import from
``repro_torch.index``."""
from __future__ import annotations

from repro_torch.index.base import (QuantizedLUT, SearchResult,  # noqa: F401
                                    build_lut, chunked_over_queries,
                                    exact_search, lut_sum,
                                    mean_average_precision, quantize_lut,
                                    recall_at, resolve_backend,
                                    resolve_lut_dtype)
from repro_torch.index.flat import (adc_search,  # noqa: F401
                                    two_step_search,
                                    two_step_search_compact)

__all__ = [
    "QuantizedLUT", "SearchResult", "build_lut", "lut_sum", "quantize_lut",
    "adc_search", "exact_search", "two_step_search",
    "two_step_search_compact", "mean_average_precision", "recall_at",
    "resolve_backend", "resolve_lut_dtype", "chunked_over_queries",
]
