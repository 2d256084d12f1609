"""Bimodal variance prior P(Lambda) = pi1*N(0,s1) + pi2*SN(mu2,s2,alpha2)
(twin of ``repro.core.prior``).

Paper §3.1 (eq. 4) + robustified loss (§3.3, eq. 10).  The prior is a
product over dimensions; minimizing its negative log-likelihood drives
most per-dimension variances toward the zero-centered major mode and a
few toward the negative-skew minor mode located near max(Lambda), which
concentrates the dataset's variance into the small subspace psi used
for crude distance comparisons.

Trainable parameters Theta = {raw_sigma1, raw_sigma2, mu2} are 0-d f32
tensors; the raw values go through softplus for positivity.  alpha2,
pi1 and pi2 are fixed per §3.3.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

_LOG_2PI = 1.8378770664093453  # log(2*pi)


def _inv_softplus(y: float) -> float:
    # inverse of softplus for y > 0 (numerically fine for y in [1e-4, 1e4])
    return float(math.log(math.expm1(y))) if y < 30 else float(y)


def init_theta(sigma1: float = 0.1, sigma2: float = 0.5,
               mu2: float = 1.0) -> Dict:
    """Unconstrained Theta (raw_* go through softplus; mu2 is free), as
    0-d f32 tensors on the CPU."""
    f32 = dict(dtype=torch.float32)
    return {
        "raw_sigma1": torch.tensor(_inv_softplus(sigma1), **f32),
        "raw_sigma2": torch.tensor(_inv_softplus(sigma2), **f32),
        "mu2": torch.tensor(mu2, **f32),
    }


def init_theta_from_data(lam) -> Dict:
    """Data-driven Theta init, computed in numpy float64 as the
    reference does: the major mode must cover the bulk of the current
    variances and the minor mode sit at the top of the distribution,
    otherwise the mixture collapses to one mode before the embedding
    reshapes Lambda (§3.3 degeneracy).

    sigma1 ~ RMS of the lower half, mu2 ~ max(Lambda), sigma2 ~ spread of
    the upper quartile.
    """
    if isinstance(lam, torch.Tensor):
        lam = lam.detach().cpu().numpy()
    lam = np.asarray(lam, np.float64)
    lo = np.sort(lam)[: max(len(lam) // 2, 1)]
    hi = np.sort(lam)[-max(len(lam) // 4, 1):]
    sigma1 = float(max(np.sqrt(np.mean(lo ** 2)), 1e-2))
    mu2 = float(max(lam.max(), sigma1 * 3))
    sigma2 = float(max(hi.std(), 0.25 * mu2, 1e-2))
    return init_theta(sigma1=sigma1, sigma2=sigma2, mu2=mu2)


def theta_values(theta: Dict):
    """(sigma1, sigma2, mu2) with positivity constraints applied."""
    return (F.softplus(theta["raw_sigma1"]) + 1e-4,
            F.softplus(theta["raw_sigma2"]) + 1e-4,
            theta["mu2"])


def _log(v):
    return torch.log(v) if isinstance(v, torch.Tensor) else math.log(v)


def normal_logpdf(x, mu, sigma):
    z = (x - mu) / sigma
    return -0.5 * (z * z + _LOG_2PI) - _log(sigma)


def normal_logcdf(x):
    """log Phi(x): ``torch.special.log_ndtr`` is tail-stable and has a
    finite gradient in the deep left tail (erfc-based forms give 0/0 =
    NaN there, which would poison the joint training step)."""
    return torch.special.log_ndtr(x)


def skewnormal_logpdf(x, mu, sigma, alpha):
    """log SN(x; mu, sigma, alpha) = log2 + logphi(z) - log(sigma) +
    logPhi(alpha z)."""
    z = (x - mu) / sigma
    return (math.log(2.0) + normal_logpdf(z, 0.0, 1.0) - _log(sigma)
            + normal_logcdf(alpha * z))


def mode_log_components(lam, theta, *, pi1: float, pi2: float,
                        alpha2: float):
    """Per-dimension log(pi1*N) and log(pi2*SN).  lam: (d,) nonneg."""
    s1, s2, mu2 = theta_values(theta)
    log_major = math.log(pi1) + normal_logpdf(lam, 0.0, s1)
    log_minor = math.log(pi2) + skewnormal_logpdf(lam, mu2, s2, alpha2)
    return log_major, log_minor


def nll(lam, theta, *, pi1: float, pi2: float, alpha2: float):
    """Robustified negative log-likelihood L^P (paper eq. 4 + eq. 10).

    eq. 4:  -log prod_i [pi1 N(lam_i) + pi2 SN(lam_i)]
    eq. 10: additionally  -log sum_i pi2 SN(lam_i)  so the minor mode is
            never emptied out (keeps psi non-degenerate).
    Mean-reduced over d so gamma_p is dimension-independent.
    """
    log_major, log_minor = mode_log_components(
        lam, theta, pi1=pi1, pi2=pi2, alpha2=alpha2)
    log_mix = torch.logaddexp(log_major, log_minor)
    nll_mix = -torch.mean(log_mix)
    # robustness term: -log P(SN) = -log sum_i pi2 SN(lam_i)
    nll_minor = -torch.logsumexp(log_minor, dim=-1)
    return nll_mix + nll_minor / lam.shape[-1]


def psi_mask(lam, theta, *, pi1: float, pi2: float, alpha2: float):
    """xi in {0,1}^d (paper eq. 5/7): dim i in psi iff the minor mode is
    more likely, i.e. pi2*SN(lam_i) > pi1*N(lam_i)."""
    log_major, log_minor = mode_log_components(
        lam, theta, pi1=pi1, pi2=pi2, alpha2=alpha2)
    return log_minor > log_major


def psi_mask_topk(lam, k: int):
    """Fallback xi when the prior is untrained or degenerate: the top-k
    variances (every dimension tied with the k-th largest included).
    Guarantees |psi| >= 1 at serving time."""
    d = lam.shape[-1]
    thresh = torch.sort(lam).values[d - k]
    return lam >= thresh
