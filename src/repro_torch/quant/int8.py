"""Symmetric int8 quantization with per-slice scales (twin of
``repro.quant.int8``).

Scales are computed over the trailing axis (one scale per row, token or
head slice).  The codes round half to even, as the reference's, so they
are equal to its codes, not merely close.
"""
from __future__ import annotations

import torch

from repro_torch.models.nn import as_dtype


def quantize_int8(x, axis: int = -1):
    """x -> (q int8, scale f32 with ``axis`` reduced to size 1)."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q, scale, dtype=torch.float32):
    return (q.float() * scale).to(as_dtype(dtype))
