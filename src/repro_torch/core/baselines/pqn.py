"""Product Quantization Network-style baseline (Yu et al. 2018; twin of
``repro.core.baselines.pqn``): a CNN embedding trained end to end with
soft-assign PQ (straight-through hard codes), the joint trainer in
mode "pq" with the CNN embedder; the linear embedder for flat
(non-image) inputs."""
from __future__ import annotations

from repro_torch.core.train import ICQModel, fit


def fit_pqn(seed, xs, ys, icq_cfg, *, num_classes: int = 10, img_hw=None,
            channels=None, epochs: int = 5, batch_size: int = 256,
            lr: float = 1e-3, device=None) -> ICQModel:
    if img_hw is not None:
        return fit(seed, xs, ys, icq_cfg, embed_kind="cnn",
                   num_classes=num_classes, img_hw=img_hw,
                   channels=channels, mode="pq", epochs=epochs,
                   batch_size=batch_size, lr=lr, device=device)
    return fit(seed, xs, ys, icq_cfg, embed_kind="linear",
               num_classes=num_classes, mode="pq", epochs=epochs,
               batch_size=batch_size, lr=lr, device=device)
