"""Index-layer foundations (twin of ``repro.index.base``): the
``SearchResult`` record, the ADC LUT primitives, int8 LUT calibration,
the nibble LUT sum, device and backend resolution, the row filter of a
filtered search, query chunking, the brute-force ground truth
(``exact_search``) and the paper's metrics (``mean_average_precision``,
``recall_at``).

LUTs: ``T[k, j] = ||c_{k,j}||^2 - 2 <q, c_{k,j}>``; ranking by their
masked sums is ranking by L2 distance after ICQ's hard projection.
Every LUT sum here accumulates the K gathered entries in codebook order
starting from 0.0, the reference scan's order, so a sum over the same
table is bitwise equal to the reference's and to the CUDA kernels'.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Protocol, runtime_checkable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import codebooks as cb
from repro_torch.core.encode import unpack_nibbles

LUT_DTYPES = ("f32", "int8")
CODE_BITS = (8, 4)
BACKENDS = ("auto", "jnp", "pallas")


class SearchResult(NamedTuple):
    indices: torch.Tensor     # (nq, topk) int32 database ids, nearest first
    distances: torch.Tensor   # (nq, topk) f32 LUT-sum distances
    avg_ops: torch.Tensor     # () f32 average LUT adds per database point
    pass_rate: torch.Tensor   # () f32 fraction refined (phase-2 survivors)
    meta: Optional[object] = None   # resilience.budget.ResultMeta


@runtime_checkable
class Index(Protocol):
    """The index protocol (twin of ``repro.index.base.Index``): a frozen
    index serves ``search`` and grows by ``add`` (new vectors encoded
    and appended without retraining; a new index is returned);
    ``shard`` returns its sharded serving clone over a mesh."""

    def search(self, queries, topk: Optional[int] = None) -> SearchResult:
        ...

    def add(self, new_vectors, *, icm_iters: int = 3) -> "Index":
        ...

    def shard(self, mesh) -> "Index":
        ...


# --------------------------------------------------------------- device ----

def as_torch(x) -> torch.Tensor:
    """A tensor of ``x`` (numpy arrays are copied: arrays handed over
    from other frameworks may be read-only)."""
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.array(x))


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the
    caller names another device.  With no card and no explicit device
    this raises; it never carries on on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA card is visible (torch.cuda.is_available() is "
                "False); the port serves on an NVIDIA GPU — pass "
                "device='cpu' to run the plain PyTorch versions instead")
        return torch.device("cuda")
    return torch.device(device)


def as_generator(generator) -> torch.Generator:
    """A ``torch.Generator`` from a generator, an int seed or None
    (seed 0, the reference's default ``PRNGKey(0)`` role); a seed makes
    a CPU generator, so the draws do not depend on the device."""
    if isinstance(generator, torch.Generator):
        return generator
    return torch.Generator().manual_seed(0 if generator is None
                                         else int(generator))


def resolve_backend(backend: str, device: torch.device) -> str:
    """Map the config's ``serve.backend`` onto what runs.  On a CUDA
    device the hand-written kernels always run: auto | pallas resolve
    to "cuda", the reference's fused engine (``filter`` and
    ``refine_cap`` refused, no capped rung), and jnp to "cuda-jnp", the
    kernels with the reference's jnp-engine options (``filter``,
    ``refine_cap``, the capped rung).  On the CPU every backend resolves
    to "torch": the kernels' plain versions, with the jnp-engine
    options."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown search backend {backend!r}; expected "
                         f"one of {BACKENDS}")
    if device.type == "cuda":
        return "cuda-jnp" if backend == "jnp" else "cuda"
    if device.type != "cpu":
        raise ValueError(f"unsupported device {device}; the port runs on "
                         "cuda or cpu")
    return "torch"


def resolve_encode_backend(backend: str, device: torch.device) -> str:
    """Map ``encode.backend`` onto what runs: "cuda" (the ICM kernel) on
    a CUDA device for auto | pallas, "torch" (its plain version) on the
    CPU.  "jnp" names the plain version, which never runs on a CUDA
    device (the encoder has no jnp-engine options to serve)."""
    if backend == "jnp" and device.type == "cuda":
        raise ValueError(
            "encode.backend='jnp' selects the plain PyTorch ICM sweep, "
            "which never runs on a CUDA device; use backend='auto' to "
            "encode through the CUDA kernel")
    return "torch" if resolve_backend(backend, device) == "torch" \
        else "cuda"


def resolve_lut_dtype(lut_dtype: str) -> str:
    """Validate the ``lut_dtype`` engine option ("f32" | "int8")."""
    if lut_dtype not in LUT_DTYPES:
        raise ValueError(f"unknown lut_dtype {lut_dtype!r}; "
                         f"expected one of {LUT_DTYPES}")
    return lut_dtype


def resolve_code_bits(code_bits) -> int:
    """Validate the ``code_bits`` storage option (8 | 4)."""
    if code_bits not in CODE_BITS:
        raise ValueError(f"unknown code_bits {code_bits!r}; "
                         f"expected one of {CODE_BITS}")
    return code_bits


# ----------------------------------------------------------------- LUTs ----

class QuantizedLUT(NamedTuple):
    """Per-query affine int8 tables: an entry dequantizes as ``scale *
    q + bias``, and a sum over S entries as ``scale * sum_q + S * bias``
    (see ``repro.index.base.QuantizedLUT``)."""
    q: torch.Tensor       # int8, shape of the source LUT
    scale: torch.Tensor   # (nq,) or () f32
    bias: torch.Tensor    # (nq,) or () f32


def quantize_lut(lut: torch.Tensor, cb_mask=None) -> QuantizedLUT:
    """Per-query affine int8 calibration of (nq, K, m) or (K, m) f32
    tables over the codebooks in ``cb_mask`` (all when None); entries of
    masked-out codebooks are zeroed.  ``torch.round`` rounds half to
    even, as ``jnp.round`` does."""
    red = (-2, -1)
    if cb_mask is None:
        lo = torch.amin(lut, dim=red)
        hi = torch.amax(lut, dim=red)
    else:
        keep = cb_mask[:, None]
        inf = torch.tensor(float("inf"), dtype=lut.dtype, device=lut.device)
        lo = torch.amin(torch.where(keep, lut, inf), dim=red)
        hi = torch.amax(torch.where(keep, lut, -inf), dim=red)
    scale = torch.clamp_min((hi - lo) / 255.0, 1e-12)
    q = torch.clamp(torch.round((lut - lo[..., None, None])
                                / scale[..., None, None]) - 128.0,
                    -128.0, 127.0).to(torch.int8)
    if cb_mask is not None:
        q = q * cb_mask[:, None].to(torch.int8)
    return QuantizedLUT(q=q, scale=scale, bias=lo + 128.0 * scale)


def _bias_count(K: int, cb_mask, device) -> torch.Tensor:
    """Number of codebooks entering a quantized sum (the ``S`` of the
    bias correction ``S * bias``)."""
    if cb_mask is None:
        return torch.tensor(float(K), dtype=torch.float32, device=device)
    return torch.sum(cb_mask.to(torch.float32))


def dequantize_acc(qlut: QuantizedLUT, acc: torch.Tensor, cb_mask=None):
    """Integer LUT-sum accumulator -> true-distance f32, as ``scale *
    acc + count * bias`` in that order (two separate roundings, no
    fused multiply-add), the reference's and the kernels' expression."""
    offset = _bias_count(qlut.q.shape[-2], cb_mask, acc.device) * qlut.bias
    return (qlut.scale[..., None] * acc.to(torch.float32)
            + offset[..., None])


def quantized_kernel_operands(luts: torch.Tensor, cb_mask=None):
    """(nq, K, m) f32 tables -> the int8 crude kernel's operands
    ``(q_flat (nq, K*m) int8, scale (nq,), offset (nq,))`` with
    ``offset = count * bias``."""
    qlut = quantize_lut(luts, cb_mask)
    nq, K, m = qlut.q.shape
    return (qlut.q.reshape(nq, K * m), qlut.scale,
            _bias_count(K, cb_mask, luts.device) * qlut.bias)


def _int_acc_dtype(K: int) -> torch.dtype:
    # |q| <= 128 per entry, so a K-codebook sum fits int16 whenever
    # K * 128 <= int16 max; either width gives the same exact sum
    return torch.int16 if K * 128 <= torch.iinfo(torch.int16).max \
        else torch.int32


@contextlib.contextmanager
def full_f32_matmul():
    """Run the enclosed matrix products and convolutions in full f32 on
    the card: TF32 would move distances by about 1e-3 relative and so
    change rankings (cuDNN convolutions default to TF32 in PyTorch).
    The caller's two ``allow_tf32`` settings are restored on exit."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


def build_lut(q: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Per-query ADC tables ``T[k, j] = ||c_{k,j}||^2 - 2 <q, c_{k,j}>``.
    q (d,) or (nq, d) f32, C (K, m, d) -> (K, m) or (nq, K, m) f32."""
    sq = cb.codeword_sq_norms(C)
    with full_f32_matmul():
        if q.ndim == 1:
            return sq - 2.0 * torch.einsum("d,kmd->km", q, C)
        return sq[None] - 2.0 * torch.einsum("qd,kmd->qkm", q, C)


def _gather_k(table: torch.Tensor, codes: torch.Tensor, k: int):
    """Entries of codebook k for every code row:
    table (K, m) with codes (n, K) -> (n,);
    table (nq, K, m) with shared codes (n, K) -> (nq, n);
    table (nq, K, m) with per-query codes (nq, t, K) -> (nq, t)."""
    idx = codes[..., k].long()
    if table.ndim == 2:
        return table[k][idx]
    if codes.ndim == 2:
        return torch.index_select(table[:, k], 1, idx)
    return torch.gather(table[:, k], 1, idx)


def lut_sum(lut, codes: torch.Tensor, cb_mask=None) -> torch.Tensor:
    """Sum the selected LUT entries of every code row, codebook by
    codebook from 0.0 (the reference scan).  Shapes as in
    ``_gather_k``.  A ``QuantizedLUT`` accumulates its int8 entries
    exactly and rescales once (``dequantize_acc``)."""
    if isinstance(lut, QuantizedLUT):
        return _lut_sum_quantized(lut, codes, cb_mask)
    if cb_mask is not None:
        lut = lut * cb_mask[:, None].to(lut.dtype)
    acc = None
    for k in range(codes.shape[-1]):
        part = _gather_k(lut, codes, k)
        acc = torch.zeros_like(part) + part if acc is None else acc + part
    return acc


def _lut_sum_quantized(qlut: QuantizedLUT, codes: torch.Tensor,
                       cb_mask=None) -> torch.Tensor:
    """Integer-accumulating ``lut_sum``: masked-out codebooks are zero
    in ``qlut.q``, so all K entries are summed; ``cb_mask`` only sets
    the bias count."""
    acc_dt = _int_acc_dtype(qlut.q.shape[-2])
    acc = None
    for k in range(codes.shape[-1]):
        part = _gather_k(qlut.q, codes, k).to(acc_dt)
        acc = part if acc is None else acc + part
    return dequantize_acc(qlut, acc, cb_mask)


def pad_luts_even(luts: torch.Tensor) -> torch.Tensor:
    """Zero-pad the codebook axis of (..., K, m) tables to even K: the
    all-zero sentinel codebook of the nibble format."""
    if luts.shape[-2] % 2 == 0:
        return luts
    return F.pad(luts, (0, 0, 0, 1))


def fastscan_kernel_operands(luts: torch.Tensor, cb_mask=None):
    """``quantized_kernel_operands`` over even-padded K for the 4-bit
    crude kernel: ``(q_flat (nq, Keven*m) int8, scale, offset)``; the
    sentinel never enters the bias count."""
    qlut = quantize_lut(luts, cb_mask)
    nq, K, _ = qlut.q.shape
    return (pad_luts_even(qlut.q).reshape(nq, -1), qlut.scale,
            _bias_count(K, cb_mask, luts.device) * qlut.bias)


def nibble_lut_sum(lut, packed: torch.Tensor, K: int, cb_mask=None):
    """``lut_sum`` over nibble-packed codes (n, ceil(K/2)) or
    (nq, t, ceil(K/2)) uint8.  f32 tables unpack and defer to
    ``lut_sum``.  A ``QuantizedLUT`` with shared codes sums through a
    per-query paired-byte table ``pair[kp, b] = q[2kp, b & 15] +
    q[2kp+1, b >> 4]`` (exact in int16), one gather per byte."""
    if not isinstance(lut, QuantizedLUT):
        return lut_sum(lut, unpack_nibbles(packed, K), cb_mask)
    q = lut.q
    if q.ndim != 3 or packed.ndim != 2:
        return _lut_sum_quantized(lut, unpack_nibbles(packed, K), cb_mask)
    nq, Kq, m = q.shape
    if Kq != K:
        raise ValueError(f"nibble_lut_sum: table has {Kq} codebooks, "
                         f"got K={K}")
    if m > 16:
        raise ValueError(f"nibble_lut_sum needs m <= 16 codewords "
                         f"(4-bit codes), got m={m}")
    q_pad = F.pad(pad_luts_even(q), (0, 16 - m))          # (nq, Kp, 16)
    lo_q = q_pad[:, 0::2, :].to(torch.int16)
    hi_q = q_pad[:, 1::2, :].to(torch.int16)
    pair = (hi_q[:, :, :, None] + lo_q[:, :, None, :]).reshape(nq, -1, 256)
    acc_dt = _int_acc_dtype(K)
    acc = None
    for kp in range(packed.shape[-1]):
        part = torch.index_select(pair[:, kp], 1,
                                  packed[:, kp].long()).to(acc_dt)
        acc = part if acc is None else acc + part
    return dequantize_acc(lut, acc, cb_mask)


# ------------------------------------------------------------ filtering ----

def as_filter(filter, n: int, device) -> torch.Tensor:
    """Validate a per-row metadata predicate: a length-``n`` boolean
    vector (True = row eligible), numpy or torch, moved to ``device``
    and cast to bool; wrong shapes raise by name."""
    f = as_torch(filter)
    if f.ndim != 1 or f.shape[0] != n:
        raise ValueError(f"filter must be a ({n},) boolean predicate "
                         f"(one entry per database row), got shape "
                         f"{tuple(f.shape)}")
    return f.to(device=device, dtype=torch.bool)


def mask_filtered_ids(ids: torch.Tensor, dist: torch.Tensor):
    """Post-filter result convention: slots whose distance is +inf (no
    eligible row left to fill them) report id ``-1``.  Applied only on
    filtered searches, so unfiltered results stay bitwise unchanged."""
    return torch.where(torch.isinf(dist), torch.full_like(ids, -1), ids)


# ------------------------------------------------------------- chunking ----

def chunked_over_queries(fn, queries: torch.Tensor,
                         query_chunk: Optional[int]):
    """Apply ``fn`` to query blocks of ``query_chunk`` rows (a working-set
    bound on the dense (chunk, n) crude matrix); None = one block.  The
    last block is zero-padded to full size, and every output is sliced
    back to the true ``nq`` rows."""
    if query_chunk is None or queries.shape[0] <= query_chunk:
        return fn(queries)
    nq = queries.shape[0]
    padded = F.pad(queries, (0, 0, 0, (-nq) % query_chunk))
    outs = [fn(block) for block in torch.split(padded, query_chunk)]
    return tuple(torch.cat(parts)[:nq] for parts in zip(*outs))


# ---------------------------------------------------------- ground truth ----

def exact_search(queries: torch.Tensor, X: torch.Tensor, topk: int, *,
                 query_chunk: Optional[int] = None, filter=None):
    """Brute-force L2 ground truth.  queries (nq, d), X (n, d) f32 on one
    device -> (ids (nq, topk) int32, squared distances (nq, topk) f32).

    The distance matrix ``||q||^2 - 2 q.x + ||x||^2`` is one full-f32
    matrix product (``full_f32_matmul``: no TF32 on the card), bounded
    to (``query_chunk``, n) blocks; the top-k is the two-key order,
    lowest index first among ties, as ``lax.top_k``.  ``filter``: an
    optional (n,) bool row predicate; excluded rows rank +inf, and when
    fewer than ``topk`` rows pass, the tail slots report id -1 at
    distance +inf."""
    from repro_torch.kernels.stages import topk_two_key

    xsq = torch.sum(torch.square(X), -1)[None, :]
    pred = None if filter is None else as_filter(filter, X.shape[0],
                                                 X.device)

    def one_block(qs):
        with full_f32_matmul():
            d2 = torch.sum(torch.square(qs), -1)[:, None] - 2.0 * qs @ X.T \
                + xsq
        if pred is not None:
            d2 = torch.where(pred[None, :], d2,
                             torch.full_like(d2, float("inf")))
        dist, idx = topk_two_key(d2, topk)
        if pred is not None:
            idx = mask_filtered_ids(idx, dist)
        return idx, dist

    return chunked_over_queries(one_block, queries, query_chunk)


# --------------------------------------------------------------- metrics ----

def mean_average_precision(retrieved_ids, db_labels, query_labels):
    """Label-based MAP (the paper's metric): a retrieved point is
    relevant iff it shares the query's class.  retrieved_ids (nq, R)
    tensors on one device -> () f32."""
    rel = (db_labels[retrieved_ids.long()]
           == query_labels[:, None]).to(torch.float32)
    ranks = torch.arange(1, rel.shape[1] + 1, dtype=torch.float32,
                         device=rel.device)[None, :]
    prec_at = torch.cumsum(rel, dim=1) / ranks
    denom = torch.clamp_min(torch.sum(rel, dim=1), 1.0)
    return torch.mean(torch.sum(prec_at * rel, dim=1) / denom)


def recall_at(retrieved_ids, true_ids):
    """Fraction of true nearest neighbors recovered.  Both (nq, R)."""
    hits = (retrieved_ids[:, :, None] == true_ids[:, None, :]).any(dim=1)
    return torch.mean(hits.to(torch.float32))
