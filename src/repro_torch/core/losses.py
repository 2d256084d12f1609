"""The four loss terms of the ICQ objective (paper §3.1; twin of
``repro.core.losses``):

    min_{W,C,Theta}  L^E + L^C + gamma1 * L^P + gamma2 * L^ICQ

L^E  — embedding accuracy (classification CE or triplet);
L^C  — quantization error (straight-through additive reconstruction),
       plus the CQ constant-inner-product penalty when requested;
L^P  — prior NLL over the variance vector (see core.prior);
L^ICQ— the interleaving penalty (eq. 6): per codeword, the product of its
       energy inside psi and outside psi must vanish.
"""
from __future__ import annotations

import torch

from repro_torch.core import codebooks as cb
from repro_torch.core import encode as enc


def classification_loss(logits, labels):
    """Softmax cross-entropy in f32.  logits (n, classes), labels (n,)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, 1, labels.long()[:, None])[:, 0]
    return torch.mean(lse - ll)


def triplet_loss(anchor, positive, negative, margin: float = 1.0):
    """PQN-style triplet loss on embeddings (n, d)."""
    d_ap = torch.sum(torch.square(anchor - positive), dim=-1)
    d_an = torch.sum(torch.square(anchor - negative), dim=-1)
    return torch.mean(torch.clamp_min(d_ap - d_an + margin, 0.0))


def quantization_loss(x, C, tau: float = 1.0):
    """L^C: mean ||x - xbar||^2 with the straight-through decode;
    gradients reach both the embeddings and the codebooks.  Returns
    (loss, hard codes)."""
    xbar, codes = enc.st_decode(x, C, tau)
    return torch.mean(torch.sum(torch.square(x - xbar), dim=-1)), codes


def cq_penalty(C, codes, eps_target=None):
    """Composite-Quantization constraint (Zhang et al. 2014): the batch
    variance of  s_i = sum_{j != k} <c_j,b_ij, c_k,b_ik>  around its mean
    (or ``eps_target``); returns (penalty, batch mean)."""
    sel = cb.selected_codewords(C, codes)                    # (n,K,d)
    tot = torch.sum(sel, dim=1)                              # (n,d)
    sq_sum = torch.sum(torch.square(sel), dim=(1, 2))        # sum_k ||c_k||^2
    cross = torch.sum(torch.square(tot), dim=-1) - sq_sum    # (n,)
    mean = torch.mean(cross) if eps_target is None else eps_target
    return torch.mean(torch.square(cross - mean)), torch.mean(cross)


def icq_loss(C, xi):
    """L^ICQ (eq. 6): mean over codewords of ||c o xi|| * ||c o (1-xi)||
    / ||c||^2.  xi: (d,) in [0, 1] (soft during training)."""
    xi = xi.to(torch.float32)
    sq = torch.square(C)
    in_e = torch.sqrt(torch.sum(sq * xi[None, None, :], dim=-1) + 1e-12)
    out_e = torch.sqrt(torch.sum(sq * (1.0 - xi)[None, None, :], dim=-1)
                       + 1e-12)
    norm = torch.sum(sq, dim=-1) + 1e-12
    return torch.mean(in_e * out_e / norm)
