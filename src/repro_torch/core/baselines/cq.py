"""Composite Quantization (Zhang, Du, Wang 2014): additive codebooks
with the constant-inner-product penalty, gradient steps on C and ICM
re-encoding; a re-export of
``repro_torch.trainer.quantizers`` (twin of
``repro.core.baselines.cq``)."""
from __future__ import annotations

from repro_torch.core.train import ICQModel
from repro_torch.trainer.quantizers import CQQuantizer, fit_cq

__all__ = ["ICQModel", "CQQuantizer", "fit_cq"]
