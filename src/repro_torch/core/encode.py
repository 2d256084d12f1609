"""Stored code formats (twin of the packing half of
``repro.core.encode``): byte codes in the narrowest unsigned dtype and
the ``code_bits=4`` nibble layout, two codes per byte."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def pack_codes(codes: torch.Tensor, m: int) -> torch.Tensor:
    """Narrowest stored dtype for m codewords: uint8 for m <= 256, else
    int32.  The reference stores m <= 65536 as uint16; PyTorch's uint16
    covers few ops, so the port widens such codes to int32 (the CUDA
    kernels take uint8 rows only)."""
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
