"""Optimized Product Quantization (Ge et al. 2013): PQ in a learned
rotation, R = U V^T from SVD(X^T Xbar), folded into the embedding; a
re-export of ``repro_torch.trainer.quantizers`` (twin of
``repro.core.baselines.opq``)."""
from __future__ import annotations

from repro_torch.core.train import ICQModel
from repro_torch.trainer.quantizers import OPQQuantizer, fit_opq

__all__ = ["ICQModel", "OPQQuantizer", "fit_opq"]
