"""ICM sweeps over point tiles (twin of ``repro.kernels.icm_encode``):
the CUDA kernel of ``csrc/icm_encode.cu`` beside its plain PyTorch
version.

Both take x (n, d) f32, the warm-start codes (n, K) int32 and C (K, m,
d) f32, and run ``iters`` sweeps of the residual recurrence: for each
codebook k in order, ``r = recon - c_{k,b_k}``, ``scores = ||c_kj||^2 -
2 <x - r, c_kj>``, ``b_k`` = the first index of the minimum, ``recon =
r + c_{k,b_k}``.  They return the codes (n, K) int32.

The kernel computes the recon chain in the plain version's order, so
only its dot products round differently: codes agree wherever the two
best scores of every step are further apart than that rounding, and a
flip at a near tie changes the later steps of that point only.  Any d
is encoded: above 256 dimensions the kernel keeps the recon and target
tiles in a scratch that the wrapper allocates.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.codebooks import codeword_sq_norms, decode
from repro_torch.index.base import full_f32_matmul
from repro_torch.kernels import build


def icm_encode_torch(x: torch.Tensor, init_codes: torch.Tensor,
                     C: torch.Tensor, *, iters: int) -> torch.Tensor:
    """Plain version (the reference's ``_icm_block_jnp`` recurrence, one
    full-f32 (n, d) x (d, m) matmul per codebook step)."""
    sq = codeword_sq_norms(C)
    codes = init_codes.to(torch.int32).clone()
    recon = decode(C, codes)
    with full_f32_matmul():
        for _ in range(iters):
            for k in range(C.shape[0]):
                Ck = C[k]
                r = recon - Ck[codes[:, k].long()]
                scores = sq[k][None, :] - 2.0 * (x - r) @ Ck.T
                new = torch.argmin(scores, dim=1)   # first index of the min
                codes[:, k] = new.to(torch.int32)
                recon = r + Ck[new]
    return codes


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if not (t.is_cuda and t.dtype == dtype and t.is_contiguous()
            and tuple(t.shape) == tuple(shape) and t.device == device):
        raise ValueError(f"{name} must be a contiguous {dtype} CUDA tensor "
                         f"of shape {tuple(shape)} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def plan(n: int, K: int, m: int, d: int, iters: int):
    """The kernel's launch shape on the current device (``icq_icm_plan``):
    {grid, mpad, dpad, staged, BM}, the scratch sizes that
    ``icm_encode_cuda`` allocates."""
    lib = build.library("icm_encode")
    out = (ctypes.c_int * 5)()
    err = lib.icq_icm_plan(n, K, m, d, iters, out)
    if err:
        raise RuntimeError(f"icm_encode plan failed (n={n}, K={K}, m={m}, "
                           f"d={d}): {lib.icq_error_string(err).decode()}")
    return dict(zip(("grid", "mpad", "dpad", "staged", "BM"), out))


def icm_encode_cuda(x: torch.Tensor, init_codes: torch.Tensor,
                    C: torch.Tensor, *, iters: int) -> torch.Tensor:
    """Launch the ICM kernel; same operands and output as
    ``icm_encode_torch``."""
    if not (x.is_cuda and x.ndim == 2 and C.ndim == 3):
        raise ValueError(f"x must be (n, d) and C (K, m, d) on a CUDA "
                         f"device, got {tuple(x.shape)} on {x.device} and "
                         f"{tuple(C.shape)}")
    n, d = x.shape
    K, m, _ = C.shape
    _check(x, "x", torch.float32, (n, d), x.device)
    _check(C, "C", torch.float32, (K, m, d), x.device)
    _check(init_codes, "init_codes", torch.int32, (n, K), x.device)
    if n < 1 or K < 1 or m < 1 or d < 1 or iters < 0:
        raise ValueError(f"empty operand or negative iters: x "
                         f"{tuple(x.shape)}, C {tuple(C.shape)}, "
                         f"iters={iters}")
    shape = plan(n, K, m, d, iters)
    lib = build.library("icm_encode")
    sq = codeword_sq_norms(C).contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    CT = torch.empty((K, shape["dpad"], shape["mpad"]), **f32)
    scratch = shape["grid"] * shape["BM"] * d if shape["staged"] else 0
    tg = torch.empty((scratch,), **f32) if scratch else None
    rg = torch.empty((scratch,), **f32) if scratch else None
    out = torch.empty((n, K), dtype=torch.int32, device=x.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)

    def ptr(t):
        return None if t is None else ctypes.c_void_p(t.data_ptr())

    err = lib.icq_icm_encode(
        ptr(x), ptr(init_codes), ptr(C), ptr(sq), ptr(CT), ptr(tg), ptr(rg),
        ptr(out), n, K, m, d, int(iters), shape["grid"], stream)
    if err:
        raise RuntimeError(
            f"icm_encode kernel launch failed (n={n}, K={K}, m={m}, d={d}): "
            f"{lib.icq_error_string(err).decode()}")
    build.LAUNCHES["icm_encode"] += 1
    return out
