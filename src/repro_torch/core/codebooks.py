"""Codebook geometry (twin of ``repro.core.codebooks``)."""
from __future__ import annotations

import torch


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
