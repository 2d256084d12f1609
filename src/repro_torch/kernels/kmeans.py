"""k-means assignment, the nearest centroid of every point (twin of
``repro.kernels.kmeans``): the CUDA kernel of ``csrc/kmeans.cu`` beside
its plain PyTorch version.

Both take f32 or bf16 points and centroids; bf16 is widened to f32,
exactly, so it is the same math as the reference's bf16 dot with f32
accumulation.  Both return ``(ids (n,) int32, dist (n,) f32)`` with
``scores = ||c||^2 - 2 x.c``, ``ids`` the first index of each row's
minimum and ``dist = min + ||x||^2``.  The kernel sums its dot products
in its own order, so it equals the plain version to rounding, not bit
for bit: ids agree wherever the two nearest scores are further apart
than that rounding.

Where the kernel's 128-point tiles alone would not fill the card, it
splits the centroid axis into slices and a second launch reduces them
(``plan``, which the CUDA source decides); a score does not depend on
the tiling, so the split output equals the unsplit one bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.index.base import full_f32_matmul
from repro_torch.kernels import build


def _centroid_sq_norms(cent: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(cent), dim=-1)


def _widen(t: torch.Tensor) -> torch.Tensor:
    return t.float() if t.dtype == torch.bfloat16 else t


def kmeans_assign_torch(x: torch.Tensor, cent: torch.Tensor):
    """Plain version.  x (n, d), cent (L, d), f32 or bf16 -> (ids (n,)
    int32, dist (n,) f32).  The (n, L) score matrix is one full-f32
    matmul."""
    x, cent = _widen(x), _widen(cent)
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


def plan(n: int, L: int, d: int, split: int = 0):
    """The kernel's tiling of one call, as ``csrc/kmeans.cu`` decides
    it: ``(Lp, dp, S)``, L and d padded to its tiles and S centroid
    slices.  ``split`` >= 1 asks for that many slices (lowered so that
    none is empty); 0 lets the kernel choose for the current device."""
    lib = build.library("kmeans")
    out = (ctypes.c_int * 3)()
    err = lib.icq_kmeans_plan(n, L, d, split, out)
    if err:
        raise ValueError(f"no kmeans_assign plan for n={n} L={L} d={d} "
                         f"split={split} (split lies in [0, ceil(L / "
                         f"128)]): {lib.icq_error_string(err).decode()}")
    return tuple(out)


def kmeans_assign_cuda(x: torch.Tensor, cent: torch.Tensor, *,
                       _split: int = None):
    """Launch the assignment kernel; same operands and outputs as
    ``kmeans_assign_torch``.  ``_split`` forces the number of centroid
    slices (tests hold split against unsplit launches); by default
    the kernel chooses it from n (``plan``)."""
    x, cent = _widen(x), _widen(cent)
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
    Lp, dp, split = plan(n, L, d, 0 if _split is None else _split)

    def scratch(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=x.device)

    # ||c||^2 is the plain version's own sum, so that scores (and the
    # k-means built on them) do not depend on which side computed it
    csq = _centroid_sq_norms(cent).contiguous()
    cent_t = scratch((dp, Lp))
    parts = ((scratch((split, n)), scratch((split, n), torch.int32),
              scratch((n,))) if split > 1 else (None, None, None))
    ids, dist = scratch((n,), torch.int32), scratch((n,))
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    ptr = [ctypes.c_void_p(None if t is None else t.data_ptr())
           for t in (x, cent, csq, cent_t, *parts, ids, dist)]
    err = lib.icq_kmeans_assign(*ptr, n, L, d, split, stream)
    if err:
        raise RuntimeError("kmeans_assign kernel launch failed: "
                           f"{lib.icq_error_string(err).decode()}")
    build.LAUNCHES["kmeans_assign"] += 1
    return ids, dist
