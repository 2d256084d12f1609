"""The ICQ structure the serving path reads: which dimensions form the
psi subspace, which codebooks form the fast group, and the eq. 2 margin
sigma (twin of ``repro.core.icq.ICQStructure``)."""
from __future__ import annotations

from typing import NamedTuple

import torch


class ICQStructure(NamedTuple):
    xi: torch.Tensor          # (d,) bool — psi membership per dimension
    fast_mask: torch.Tensor   # (K,) bool — codebook in the fast group
    sigma: torch.Tensor       # () f32 margin (eq. 11)
