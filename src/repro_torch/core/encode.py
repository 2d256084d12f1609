"""Encoding against the codebooks and the stored code formats (twin of
``repro.core.encode``).

``encode_pq`` assigns each codebook independently (exact for
orthogonal supports).  ``icm_encode`` is the encoding engine for
additive codes: a PQ warm start, then Iterated Conditional Modes in
the residual form,

    argmin_j  ||c_{k,j}||^2 - 2 <x - r_k, c_{k,j}>,
    r_k = recon - c_{k, b_k}   (the others-only partial sum),

one codebook at a time, ``iters`` sweeps.  Both go through
``kernels.ops``: on the card the warm start runs the ``kmeans_assign``
kernel once per codebook (no (K, n, m) score tensor is ever built) and
the sweeps run the ICM kernel; on the CPU their plain versions.

``soft_assign`` and ``st_decode`` are the differentiable relaxation the
joint trainer uses: softmax assignments with straight-through hard
codes in the forward pass (plain ``torch`` products; the caller pins
f32 precision, ``trainer/joint.py``).

The packing half stores byte codes in the narrowest unsigned dtype and
the ``code_bits=4`` nibble layout, two codes per byte.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.codebooks import codeword_sq_norms, decode


def encode_pq(x: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Independent per-codebook nearest codeword.  x (n, d), C (K, m, d)
    -> (n, K) int32, the first index of each minimum of ``||c||^2 - 2
    x.c`` (``ops.kmeans_assign`` against each C[k])."""
    from repro_torch.kernels import ops
    x = x.to(torch.float32).contiguous()
    return torch.stack([ops.kmeans_assign(x, C[k].contiguous())[0]
                        for k in range(C.shape[0])], dim=1)


def _icm_block(x: torch.Tensor, C: torch.Tensor, codes0, iters: int):
    """ICM sweeps over one point block from its warm start (the PQ
    assignment when ``codes0`` is None): the ICM kernel on the card, its
    plain version (``kernels/icm_encode.py::icm_encode_torch``, the
    reference's ``_icm_block_jnp`` recurrence) on the CPU."""
    from repro_torch.kernels import ops
    if codes0 is None:
        codes0 = encode_pq(x, C)
    return ops.icm_encode(x, codes0.contiguous(), C, iters=iters)


def icm_encode(x: torch.Tensor, C: torch.Tensor, iters: int = 3,
               init_codes: Optional[torch.Tensor] = None, *,
               backend: str = "auto",
               point_chunk: Optional[int] = None) -> torch.Tensor:
    """ICM encoding for additive codebooks.  x (n, d), C (K, m, d) ->
    codes (n, K) int32, warm-started from ``encode_pq`` unless
    ``init_codes`` is given.

    backend:      "auto" | "pallas" run the ICM kernel on a CUDA device;
                  "jnp" names the plain version and is refused on one
                  (``index.base.resolve_encode_backend``).  On the CPU
                  every backend runs the plain version.
    point_chunk:  working-set bound: points are encoded in blocks of
                  this size, the last zero-padded and its pad rows sliced
                  off.  Encoding is per-point independent, so chunking
                  never changes a point's codes.
    """
    from repro_torch.index.base import resolve_encode_backend
    resolve_encode_backend(backend, x.device)
    if x.ndim != 2 or C.ndim != 3 or x.shape[1] != C.shape[2]:
        raise ValueError(f"icm_encode needs x (n, d) and C (K, m, d) of "
                         f"one d, got {tuple(x.shape)} and {tuple(C.shape)}")
    x = x.to(torch.float32).contiguous()
    C = C.to(torch.float32).contiguous()
    n = x.shape[0]
    init = None if init_codes is None else init_codes.to(x.device,
                                                         torch.int32)
    if point_chunk is None or n <= point_chunk:
        return _icm_block(x, C, init, iters)
    pad = (-n) % point_chunk
    xp = F.pad(x, (0, 0, 0, pad))
    cp = None if init is None else F.pad(init, (0, 0, 0, pad))
    parts = [_icm_block(xp[s:s + point_chunk], C,
                        None if cp is None else cp[s:s + point_chunk], iters)
             for s in range(0, n + pad, point_chunk)]
    return torch.cat(parts)[:n]


def soft_assign(x: torch.Tensor, C: torch.Tensor, tau: float = 1.0):
    """Differentiable assignment: softmax(-dist / tau) per codebook.
    x (n, d), C (K, m, d) -> (probs (K, n, m), hard codes (n, K) int32,
    the first index of each minimum of ``||c||^2 - 2 x.c``).  The
    straight-through reconstruction is built in ``st_decode``."""
    sq = codeword_sq_norms(C)
    scores = -2.0 * torch.einsum("nd,kmd->knm", x, C) + sq[:, None, :]
    probs = torch.softmax(-scores / tau, dim=-1)
    hard = torch.argmin(scores, dim=-1).T.to(torch.int32)
    return probs, hard


def st_decode(x: torch.Tensor, C: torch.Tensor, tau: float = 1.0):
    """Straight-through decode: forward = the hard reconstruction,
    backward = the soft one (differentiable in x and C).  Returns
    (xbar (n, d), codes (n, K))."""
    probs, hard = soft_assign(x, C, tau)
    soft_rec = torch.einsum("knm,kmd->nd", probs, C)
    hard_rec = decode(C, hard)
    return soft_rec + (hard_rec - soft_rec).detach(), hard


def pack_codes(codes: torch.Tensor, m: int) -> torch.Tensor:
    """Narrowest stored dtype for m codewords: uint8 for m <= 256, else
    int32.  The reference stores m <= 65536 as uint16; PyTorch's uint16
    covers few ops, so the port widens such codes to int32 (the CUDA
    search kernels take uint8 and int32 rows)."""
    return codes.to(torch.uint8 if m <= 256 else torch.int32)


def unpack_codes(codes: torch.Tensor) -> torch.Tensor:
    return codes.to(torch.int32)


def pack_nibbles(codes: torch.Tensor, K: int) -> torch.Tensor:
    """(..., K) codes, every value < 16 -> (..., ceil(K/2)) uint8: byte
    kp holds codebook 2kp in its low nibble and 2kp+1 in its high
    nibble; odd K gets a sentinel column 0 in the last high nibble."""
    if K != codes.shape[-1]:
        raise ValueError(f"pack_nibbles: codes have {codes.shape[-1]} "
                         f"codebooks, got K={K}")
    c = codes.to(torch.int32)
    if K % 2:
        c = F.pad(c, (0, 1))                      # sentinel column = 0
    return (c[..., 0::2] | (c[..., 1::2] << 4)).to(torch.uint8)


def unpack_nibbles(packed: torch.Tensor, K: int) -> torch.Tensor:
    """Inverse of ``pack_nibbles``: (..., ceil(K/2)) uint8 -> (..., K)
    int32, the odd-K sentinel column dropped."""
    p = packed.to(torch.int32)
    codes = torch.stack([p & 0xF, (p >> 4) & 0xF], dim=-1)
    return codes.reshape(*p.shape[:-1], 2 * p.shape[-1])[..., :K]
