"""Supervised Quantization (Wang et al. 2016; twin of
``repro.core.baselines.sq``): a learned linear embedding jointly with CQ
codebooks, the joint trainer in mode "cq" with the ICQ terms (L^P,
L^ICQ) off."""
from __future__ import annotations

from repro_torch.core.train import ICQModel, fit


def fit_sq(seed, xs, ys, icq_cfg, *, num_classes: int = 10,
           epochs: int = 5, batch_size: int = 256, lr: float = 1e-3,
           device=None) -> ICQModel:
    return fit(seed, xs, ys, icq_cfg, embed_kind="linear",
               num_classes=num_classes, mode="cq", epochs=epochs,
               batch_size=batch_size, lr=lr, device=device)
