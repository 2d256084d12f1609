"""Codebook geometry, k-means and the codebook initializers (twin of
``repro.core.codebooks``).

A quantizer is a tensor C of shape (K, m, d): K codebooks of m
codewords in R^d.  ``init_pq`` runs k-means per contiguous d/K slice;
``init_residual`` fits each codebook on the residual of the previous
ones (the CQ/ICQ warm start).  Every k-means assignment goes through
``kernels.ops.kmeans_assign``: the CUDA kernel on the card."""
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


# --------------------------------------------------------- initializers ----

def init_pq(generator, x: torch.Tensor, num_codebooks: int, m: int,
            iters: int = 25) -> torch.Tensor:
    """PQ init: k-means per contiguous subspace, embedded back into R^d.
    Codebook k's initial rows are drawn from ``generator`` in codebook
    order (the reference folds its key with k).

    Returns C: (K, m, d) with codebook k nonzero only on its slice."""
    n, d = x.shape
    K = num_codebooks
    if d % K:
        raise ValueError(f"init_pq needs d divisible by K, got d={d}, K={K}")
    sub = d // K
    cbs = []
    for k in range(K):
        xs = x[:, k * sub:(k + 1) * sub].contiguous()
        cent, _ = kmeans(xs, m, iters, generator=generator)
        full = torch.zeros((m, d), dtype=torch.float32, device=x.device)
        full[:, k * sub:(k + 1) * sub] = cent
        cbs.append(full)
    return torch.stack(cbs)


def init_residual(generator, x: torch.Tensor, num_codebooks: int, m: int,
                  iters: int = 25, mask=None) -> torch.Tensor:
    """Residual k-means init for additive codebooks (CQ/ICQ warm start).

    ``mask``: optional (K, d) 0/1 support constraint per codebook.  Each
    codebook is fit on the (masked) residual of the previous ones; its
    initial rows are drawn from ``generator`` in codebook order (the
    reference folds its key with 101 + k)."""
    res = x.to(torch.float32)
    cbs = []
    for k in range(num_codebooks):
        tgt = res * mask[k][None, :] if mask is not None else res
        cent, ids = kmeans(tgt.contiguous(), m, iters, generator=generator)
        if mask is not None:
            cent = cent * mask[k][None, :]
        cbs.append(cent)
        res = res - cent[ids.long()]
    return torch.stack(cbs)


# ------------------------------------------------------------ geometry ----

def codeword_sq_norms(C: torch.Tensor) -> torch.Tensor:
    """||c||^2 per codeword.  C: (K, m, d) -> (K, m)."""
    return torch.sum(torch.square(C), dim=-1)


class _GatherRows(torch.autograd.Function):
    """``table[idx]`` whose gradient is summed per row of ``table`` in
    ascending position of ``idx`` (flattened) from 0.0 -- a stable sort,
    then segment sums, as ``kmeans_update`` sums -- so it is the same on
    every run and device.  The gradient of plain indexing scatters with
    an accumulating ``index_put_``, whose float sums change from run to
    run on the CPU's threads.  No step waits on the device: the segment
    lengths are an integer scatter of ones."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        flat = idx.reshape(-1)
        order = torch.argsort(flat, stable=True)
        lens = torch.zeros((ctx.rows,), dtype=torch.int64,
                           device=flat.device).scatter_add_(
                               0, flat, torch.ones_like(flat))
        rows = grad.reshape((flat.shape[0],) + grad.shape[idx.dim():])
        sums = torch.segment_reduce(rows[order], "sum", lengths=lens,
                                    axis=0, unsafe=True, initial=0.0)
        return sums, None


def selected_codewords(C: torch.Tensor, codes: torch.Tensor):
    """The codewords the codes select: C (K, m, d), codes (n, K) ->
    (n, K, d), one gather over the flattened codebooks, with a
    deterministic gradient (``_GatherRows``: one sort) when C needs
    one."""
    K, m, d = C.shape
    idx = codes.long() + torch.arange(K, device=codes.device) * m
    table = C.reshape(K * m, d)
    if torch.is_grad_enabled() and C.requires_grad:
        return _GatherRows.apply(table, idx)
    return table[idx]


def decode(C: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Decode codes (n, K) against C (K, m, d) -> (n, d), the selected
    codewords added in codebook order (with a deterministic gradient in
    C: ``selected_codewords``)."""
    if torch.is_grad_enabled() and C.requires_grad:
        sel = selected_codewords(C, codes).unbind(1)
        out = sel[0]
        for k in range(1, C.shape[0]):
            out = out + sel[k]
        return out
    codes = codes.long()
    out = C[0][codes[:, 0]]
    for k in range(1, C.shape[0]):
        out = out + C[k][codes[:, k]]
    return out


def cross_gram(C: torch.Tensor) -> torch.Tensor:
    """Pairwise codeword inner products between codebooks: C (K, m, d)
    -> G (K, K, m, m) with G[j, k] = C_j @ C_k^T."""
    from repro_torch.index.base import full_f32_matmul
    with full_f32_matmul():
        return torch.einsum("jmd,knd->jkmn", C, C)


def quantization_mse(x: torch.Tensor, C: torch.Tensor,
                     codes: torch.Tensor) -> torch.Tensor:
    """Mean squared quantization error ||x - decode(codes)||^2 / n."""
    return torch.mean(torch.sum(torch.square(x - decode(C, codes)), dim=-1))
