"""The ICQ hyper-parameter record (twin of ``repro.configs.base``;
``ShapeSpec`` and ``ArchConfig`` wait for item 11)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ICQConfig:
    """Hyper-parameters of Interleaved Composite Quantization (paper §3).

    K codebooks of m codewords over a d-dimensional embedding space; the
    fast group |K_fast| quantizes the learned high-variance subspace psi.
    """
    d: int = 16                  # embedding dim (paper fixes d=16 for synthetic)
    num_codebooks: int = 8       # K
    codebook_size: int = 256     # m  (paper: C_k = 256 -> 8-bit codes)
    num_fast: int = 2            # |K_fast| codebooks for crude comparisons
    # Prior P(Lambda) = pi1*N(0,s1) + pi2*SN(mu2,s2,alpha2)   (paper eq. 4)
    pi1: float = 0.9
    pi2: float = 0.1
    alpha2: float = -10.0        # fixed negative skew (paper §3.3)
    # Loss weights (paper's gamma_1, gamma_2) + CQ inner-product penalty
    gamma_p: float = 0.2         # weight of L^P
    gamma_icq: float = 2.0       # weight of L^ICQ
    gamma_cq: float = 0.1        # weight of the CQ constant-inner-product term
    # Search
    margin_scale: float = 1.0    # scales sigma = sum_{i in psi_bar} lambda_i (eq. 11)
    # Training
    icm_iters: int = 3           # iterated conditional modes rounds for encoding
    learn_embedding: bool = True
