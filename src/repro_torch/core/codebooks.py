"""Codebook geometry and k-means (twin of ``repro.core.codebooks``)."""
from __future__ import annotations

from typing import Optional

import torch


# --------------------------------------------------------------- k-means ----

def kmeans_assign(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid ids.  x (n, d) f32, cent (m, d) f32 -> (n,)
    int32, the first index of each minimum of ``||c||^2 - 2 x.c``
    (through ``kernels.ops.kmeans_assign``: the CUDA kernel on the card,
    its plain version on the CPU)."""
    from repro_torch.kernels import ops
    return ops.kmeans_assign(x, cent)[0]


def kmeans_update(x: torch.Tensor, ids: torch.Tensor, m: int):
    """Mean of the points assigned to each centroid -> (means (m, d),
    counts (m,) f32); an empty centroid's mean is 0 (the caller
    re-seeds it).

    Deterministic on the card: the sums are segment sums over the
    points stable-sorted by id, each segment added in ascending point
    order from 0.0 (the reference's scatter-add order), where a
    scatter-add with atomics would change from run to run."""
    order = torch.argsort(ids, stable=True)
    lens = torch.bincount(ids, minlength=m)
    sums = torch.segment_reduce(x[order].to(torch.float32), "sum",
                                lengths=lens, axis=0)
    cnts = lens.to(torch.float32)
    return sums / torch.clamp_min(cnts, 1.0)[:, None], cnts


def kmeans(x: torch.Tensor, m: int, iters: int = 25, *,
           generator: Optional[torch.Generator] = None,
           init_ids: Optional[torch.Tensor] = None):
    """Lloyd's k-means.  Returns (centroids (m, d), ids (n,) int32).

    The initial centroids are the points ``init_ids`` ((m,) distinct
    row indices) or, when None, m distinct rows drawn with
    ``generator`` (a ``torch.Generator``; ``torch.randperm`` runs on the
    generator's device).  Empty clusters are re-seeded to the points
    currently farthest from their centroid, taken in a stable order."""
    n = x.shape[0]
    x = x.to(torch.float32)
    if init_ids is None:
        gen_device = generator.device if generator is not None else "cpu"
        init_ids = torch.randperm(n, generator=generator,
                                  device=gen_device)[:m]
    init_ids = torch.as_tensor(init_ids).to(x.device, torch.long)
    if init_ids.shape != (m,):
        raise ValueError(f"init_ids must hold {m} row indices, got shape "
                         f"{tuple(init_ids.shape)}")
    cent = x[init_ids]
    for _ in range(iters):
        ids = kmeans_assign(x, cent)
        new, cnts = kmeans_update(x, ids, m)
        d2 = torch.sum(torch.square(x - cent[ids.long()]), dim=-1)
        far = torch.argsort(-d2, stable=True)[:m]
        cent = torch.where((cnts > 0)[:, None], new, x[far])
    return cent, kmeans_assign(x, cent)


# ------------------------------------------------------------ geometry ----

def codeword_sq_norms(C: torch.Tensor) -> torch.Tensor:
    """||c||^2 per codeword.  C: (K, m, d) -> (K, m)."""
    return torch.sum(torch.square(C), dim=-1)


def decode(C: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Decode codes (n, K) against C (K, m, d) -> (n, d)."""
    codes = codes.long()
    out = C[0][codes[:, 0]]
    for k in range(1, C.shape[0]):
        out = out + C[k][codes[:, k]]
    return out
