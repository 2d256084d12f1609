"""IVF x ICQ composition: a re-export of ``repro_torch.index.ivf`` (twin
of ``repro.core.ivf``)."""
from __future__ import annotations

from repro_torch.index.ivf import (IVFIndex, IVFTwoStep,  # noqa: F401
                                   build_ivf, ivf_two_step_search)

__all__ = ["IVFIndex", "IVFTwoStep", "build_ivf", "ivf_two_step_search"]
