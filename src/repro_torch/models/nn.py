"""Parameter initializers (twin of ``repro.models.nn``: ``dense_init``
and ``bias_init``; the rest of that module waits for item 11).

Params are nested dicts of tensors.  Random draws come from a
``torch.Generator``; the reference's JAX keys have no counterpart, so
the same seed gives other values than the reference's (tests carry the
reference's params across as numpy instead)."""
from __future__ import annotations

import math
from typing import Optional

import torch


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               dtype=torch.float32, scale: Optional[float] = None):
    """Lecun-normal dense kernel (no bias); shape (in, out), drawn on
    the generator's device."""
    s = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = torch.randn((in_dim, out_dim), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return (w * s).to(dtype)


def bias_init(out_dim: int, dtype=torch.float32):
    return torch.zeros((out_dim,), dtype=dtype)
