"""ICQ structural logic (twin of ``repro.core.icq``): the psi subspace,
the fast-set selection (paper eqs. 5, 7, 8), the serving-time hard
projection and the eq. 11 margin.

During training the interleaving constraint is soft (L^ICQ); before
serving, (a) the fast set K_fast is decided by eq. 8 (a codebook is
fast iff every codeword has more energy inside psi than outside) and
(b) the codebooks are hard-projected onto their side of the split, so
the crude distance over the fast group is exactly the distance in psi.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import prior as prior_mod


class ICQStructure(NamedTuple):
    xi: torch.Tensor          # (d,) bool — psi membership per dimension
    fast_mask: torch.Tensor   # (K,) bool — codebook in the fast group
    sigma: torch.Tensor       # () f32 margin (eq. 11)


def compute_xi(lam, theta, icq_cfg, *, min_dims: int = 1):
    """xi from the learned prior (eq. 5/7), replaced by the top-min_dims
    variances when |psi| < min_dims or |psi| = d (a degenerate split
    would disable the two-step search)."""
    xi = prior_mod.psi_mask(lam, theta, pi1=icq_cfg.pi1, pi2=icq_cfg.pi2,
                            alpha2=icq_cfg.alpha2)
    size = torch.sum(xi)
    fallback = prior_mod.psi_mask_topk(lam, min_dims)
    return torch.where((size < min_dims) | (size >= lam.shape[-1]),
                       fallback, xi)


def codebook_energies(C, xi):
    """Per-codebook energy inside/outside psi -> (in_e, out_e): (K, m)."""
    xi = xi.to(C.dtype)
    sq = torch.square(C)
    in_e = torch.sum(sq * xi[None, None, :], dim=-1)
    out_e = torch.sum(sq * (1.0 - xi)[None, None, :], dim=-1)
    return in_e, out_e


def fast_set(C, xi):
    """Eq. 8: codebook k is fast iff every codeword has out-energy <
    in-energy.  -> (K,) bool."""
    in_e, out_e = codebook_energies(C, xi)
    return torch.all(out_e < in_e, dim=-1)


def fast_set_topk(C, xi, num_fast: int):
    """The num_fast codebooks with the largest in-psi energy fraction
    (a stable sort: the lower index wins a tie)."""
    in_e, out_e = codebook_energies(C, xi)
    frac = torch.sum(in_e, dim=-1) / (torch.sum(in_e + out_e, dim=-1)
                                      + 1e-12)
    order = torch.argsort(-frac, stable=True)
    mask = torch.zeros((C.shape[0],), dtype=torch.bool, device=C.device)
    mask[order[:num_fast]] = True
    return mask


def project_codebooks(C, xi, fast_mask):
    """Hard interleave: zero fast codebooks outside psi and slow
    codebooks inside psi."""
    xi = xi.to(C.dtype)
    keep = torch.where(fast_mask[:, None], xi[None, :], (1.0 - xi)[None, :])
    return C * keep[:, None, :]


def margin_sigma(lam, xi, scale: float = 1.0):
    """Eq. 11: sigma = scale * the variance mass outside psi."""
    return scale * torch.sum(lam * (1.0 - xi.to(lam.dtype)))


def build_structure(C, lam, theta, icq_cfg) -> ICQStructure:
    """xi from the prior (at least max(1, d // K) dimensions), the fast
    set (eq. 8, or the top-num_fast fallback when eq. 8 does not pick
    exactly num_fast) and the margin sigma (eq. 11)."""
    xi = compute_xi(lam, theta, icq_cfg,
                    min_dims=max(1, icq_cfg.d // icq_cfg.num_codebooks))
    mask = fast_set(C, xi)
    want = icq_cfg.num_fast
    mask = torch.where(torch.sum(mask) == want, mask,
                       fast_set_topk(C, xi, want))
    return ICQStructure(xi=xi, fast_mask=mask,
                        sigma=margin_sigma(lam, xi, icq_cfg.margin_scale))
