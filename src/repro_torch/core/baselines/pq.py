"""Product Quantization (Jegou, Douze, Schmid 2010): k-means per
contiguous subspace, independent encoding per codebook; a re-export of
``repro_torch.trainer.quantizers`` (twin of
``repro.core.baselines.pq``)."""
from __future__ import annotations

from repro_torch.core.train import ICQModel
from repro_torch.trainer.quantizers import PQQuantizer, fit_pq

__all__ = ["ICQModel", "PQQuantizer", "fit_pq"]
