"""k-means assignment, the nearest centroid of every point (twin of
``repro.kernels.kmeans``): the CUDA kernel of ``csrc/kmeans.cu`` beside
its plain PyTorch version.

Both return ``(ids (n,) int32, dist (n,) f32)`` with ``scores =
||c||^2 - 2 x.c``, ``ids`` the first index of each row's minimum and
``dist = min + ||x||^2``.  The kernel sums its dot products in its own
order, so it equals the plain version to rounding, not bit for bit:
ids agree wherever the two nearest scores are further apart than that
rounding.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.index.base import full_f32_matmul
from repro_torch.kernels import build


def _centroid_sq_norms(cent: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(cent), dim=-1)


def kmeans_assign_torch(x: torch.Tensor, cent: torch.Tensor):
    """Plain version.  x (n, d) f32, cent (L, d) f32 -> (ids (n,) int32,
    dist (n,) f32).  The (n, L) score matrix is one full-f32 matmul."""
    with full_f32_matmul():
        scores = _centroid_sq_norms(cent)[None] - 2.0 * (x @ cent.T)
    ids = torch.argmin(scores, dim=1)          # first index of the minimum
    best = scores.gather(1, ids[:, None])[:, 0]
    return ids.to(torch.int32), best + torch.sum(torch.square(x), dim=-1)


def _check_matrix(t: torch.Tensor, name: str, d=None):
    if not (t.is_cuda and t.dtype == torch.float32 and t.ndim == 2
            and t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous 2-D float32 CUDA "
                         f"tensor, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    if d is not None and t.shape[1] != d:
        raise ValueError(f"{name} has {t.shape[1]} columns, expected {d}")


def kmeans_assign_cuda(x: torch.Tensor, cent: torch.Tensor):
    """Launch the assignment kernel; same operands and outputs as
    ``kmeans_assign_torch``."""
    _check_matrix(x, "x")
    _check_matrix(cent, "cent", x.shape[1])
    if cent.device != x.device:
        raise ValueError(f"cent must lie on {x.device}")
    n, d = x.shape
    L = cent.shape[0]
    if n < 1 or L < 1 or d < 1:
        raise ValueError(f"empty operand: x {tuple(x.shape)}, "
                         f"cent {tuple(cent.shape)}")
    lib = build.library("kmeans")
    csq = _centroid_sq_norms(cent).contiguous()
    ids = torch.empty((n,), dtype=torch.int32, device=x.device)
    dist = torch.empty((n,), dtype=torch.float32, device=x.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    err = lib.icq_kmeans_assign(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(cent.data_ptr()),
        ctypes.c_void_p(csq.data_ptr()), ctypes.c_void_p(ids.data_ptr()),
        ctypes.c_void_p(dist.data_ptr()), n, L, d, stream)
    if err:
        raise RuntimeError("kmeans_assign kernel launch failed: "
                           f"{lib.icq_error_string(err).decode()}")
    build.LAUNCHES["kmeans_assign"] += 1
    return ids, dist
