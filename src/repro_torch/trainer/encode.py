"""Database encoding (twin of ``repro.trainer.encode``): embed and
encode in fixed-size chunks, pack to the stored format.

Every chunk has the same shape: the ragged last one is zero-padded up
to ``chunk`` rows and its pad rows are dropped from the codes.  Both
encoders (the PQ argmin and the ICM recurrence) are per-point
independent, so padding never changes a real row's codes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.encode import (encode_pq, icm_encode, pack_codes,
                                     pack_nibbles)
from repro_torch.index.base import (as_torch, resolve_code_bits,
                                    resolve_device, resolve_encode_backend)

MODES = ("icm", "pq")


def encode_database(xs, C, *, embed_apply=None, embed_params=None,
                    mode: str = "icm", icm_iters: int = 3,
                    chunk: int = 8192, backend: str = "auto",
                    pack: bool = True, code_bits: int = 8, device=None):
    """Encode a database against codebooks ``C`` -> (n, K) packed codes
    ((n, ceil(K/2)) nibble-packed under ``code_bits=4``) on ``device``
    (the CUDA card unless named).

    xs:           (n, ...) raw inputs (numpy or torch), moved to the
                  device one chunk at a time; embedded per chunk with
                  ``embed_apply(embed_params, chunk)`` (any callable on
                  tensors) when given, else taken as embeddings.
    C:            (K, m, d) codebooks (numpy or torch).
    mode:         "icm" (the ICM engine, PQ warm start) | "pq"
                  (independent per-codebook assignment).
    chunk:        rows per encode call; the last chunk is zero-padded.
    backend:      "auto" | "pallas" (the kernels on the card) | "jnp"
                  (the plain versions, refused on a CUDA device).
    pack:         pack to the narrowest dtype that fits m
                  (``pack_codes``); False returns int32.
    code_bits:    8, or 4 for two codes per byte (``pack_nibbles``;
                  needs m <= 16 and pack=True).
    """
    code_bits = resolve_code_bits(code_bits)
    if mode not in MODES:
        raise ValueError(f"unknown encode mode {mode!r}; expected one of "
                         f"{MODES}")
    dev = resolve_device(device)
    resolve_encode_backend(backend, dev)
    C = as_torch(C).to(dev, torch.float32).contiguous()
    n = xs.shape[0]
    K, m = C.shape[0], C.shape[1]
    if code_bits == 4:
        if not pack:
            raise ValueError("code_bits=4 requires pack=True (nibble "
                             "packing is the 4-bit storage format)")
        if m > 16:
            raise ValueError(f"code_bits=4 requires codebook_size <= 16 "
                             f"codewords (4-bit codes), got m={m}")
    chunk = max(min(chunk, n), 1)
    parts = []
    for s in range(0, n, chunk):
        xc = as_torch(xs[s:s + chunk]).to(dev)
        rows = xc.shape[0]
        if rows < chunk:                    # pad the ragged last chunk
            xc = F.pad(xc, (0, 0) * (xc.ndim - 1) + (0, chunk - rows))
        emb = embed_apply(embed_params, xc) if embed_apply is not None \
            else xc
        emb = emb.to(torch.float32)
        codes = encode_pq(emb, C) if mode == "pq" else icm_encode(
            emb, C, icm_iters, backend=backend)
        parts.append(codes[:rows])          # drop the pad rows
    codes = torch.cat(parts)
    if code_bits == 4:
        return pack_nibbles(codes, K)
    return pack_codes(codes, m) if pack else codes
