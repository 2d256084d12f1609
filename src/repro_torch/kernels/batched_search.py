"""The batched two-step search kernels (twin of
``repro.kernels.batched_search``): each CUDA kernel of
``csrc/batched_search.cu`` (flat) and ``csrc/ivf_search.cu`` (IVF slab)
beside its plain PyTorch version.

  crude_topk       flat phase 1: the fast-masked LUT sum of every
                   (query, point) pair, an optional dense (nq, n) crude
                   matrix, and the crude top-k.  int8 LUTs dequantize as
                   ``scale * acc + offset`` per query; ``code_bits=4``
                   unpacks nibbles.
  refine_topk      flat phase 2: the margin test ``crude < thr``, the
                   slow-masked f32 LUT sum of survivors, ``full = crude
                   + slow``, and the top-k of survivors; pruned points
                   rank +inf.
  ivf_crude_topk   IVF phase 1 over each query's own candidate slab
                   (nq, nc, Kc) with its id slab (nq, nc), -1 = invalid:
                   the dense (nq, nc) crude matrix with invalid columns
                   +inf, and the top-k of slab positions.
  ivf_refine_topk  IVF phase 2 over the slab: the flat refine's
                   arithmetic, top-k of slab positions.
  select_topk      the ``refine_cap`` survivor selection (flat or slab
                   crude alike): per query the ``cap`` best-crude rows
                   that pass ``crude < thr``, pruned rows ranking +inf
                   after them (the refine kernel's SELECT instance).
  rerank_topk      their re-rank by one full-table f32 sum: the slab
                   refine kernel over the survivors' gathered code rows
                   with every codebook as its table, a zero crude
                   operand at the valid survivors (+inf at the others)
                   and a +inf threshold, so a survivor's distance is
                   ``0.0 + sum`` in codebook order.

``crude_topk`` takes an optional ``pred`` (an (n,) bool filter, the
jnp engine's ``filter=``): a filtered row is +inf in the dense crude
matrix and in the ranking, never summed, so the candidate list is the
two-key top-k of the masked crude matrix, its +inf slots the lowest
filtered rows (the kernel's row-predicate instance, counted as
``crude_topk_pred``).

Every top-k is in ascending (distance, column) order, the reference's
two-key order, where the column is the global index (flat) or the slab
position (IVF).  Any ``1 <= topk <= n`` (flat) or ``<= nc`` (slab) is
served, on the card as on the CPU, and so are code rows of uint8 (m <=
256) and int32 (wider codes, as the index stores them); the CUDA scan
kernels compile one instance per row type.  ``*_torch`` are the plain
versions:
the same sums in the same order (codebooks in order from 0.0, dequant
as two roundings), so on the same inputs kernel and plain version agree
bit for bit.
``*_cuda`` check their operands, allocate the outputs, launch on the
current stream without synchronising, count the launch in
``build.LAUNCHES`` and raise if the launch failed.  The two crude
passes take an optional ``out=`` for their dense crude matrix (the
pipelined executor's preallocated crude carry); the plain versions copy
into it.  Each kernel writes
one sorted candidate list per query and block, each block keeping a
running top-k over its chunks; ``_merge_lists`` merges them two by two
down to the top-k.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.stages import (check_quantized_args,
                                        resolve_kernel_code_bits,
                                        topk_two_key, unpack_nibble_tile)

# ------------------------------------------------------- plain versions ----

def _code_columns(codes: torch.Tensor, code_bits: int) -> torch.Tensor:
    """(n, Kc) stored rows -> (n, K) int64 codebook columns (nibble rows
    keep the odd-K sentinel column, whose LUT column is zero)."""
    return unpack_nibble_tile(codes) if code_bits == 4 else codes.long()


def _flat_lut_sum(codes: torch.Tensor, lut_flat: torch.Tensor, K: int,
                  m: int, acc_dtype: torch.dtype) -> torch.Tensor:
    """(nq, n) sums of the (nq, K*m) flattened LUT over the (n, K) code
    columns, codebook by codebook from zero."""
    lut = lut_flat.reshape(lut_flat.shape[0], K, m)
    acc = torch.zeros((lut.shape[0], codes.shape[0]), dtype=acc_dtype,
                      device=lut.device)
    for k in range(K):
        acc = acc + torch.index_select(lut[:, k], 1, codes[:, k]).to(
            acc_dtype)
    return acc


def _slab_lut_sum(cols: torch.Tensor, lut_flat: torch.Tensor, K: int,
                  m: int, acc_dtype: torch.dtype) -> torch.Tensor:
    """(nq, nc) sums of each query's (K*m) flattened LUT over its own
    (nq, nc, K) slab code columns, codebook by codebook from zero."""
    lut = lut_flat.reshape(lut_flat.shape[0], K, m)
    acc = torch.zeros(cols.shape[:2], dtype=acc_dtype, device=lut.device)
    for k in range(K):
        acc = acc + torch.gather(lut[:, k], 1, cols[:, :, k]).to(acc_dtype)
    return acc


def _check_slab_topk(nc: int, topk: int):
    _check(1 <= topk <= nc,
           f"topk={topk} must be in [1, nc={nc}]; gather_candidates pads "
           "the slab to >= topk columns")


def _into(out, crude: torch.Tensor) -> torch.Tensor:
    """The dense crude matrix, copied into ``out`` when one is given."""
    return crude if out is None else out.copy_(crude)


def _check_out(out, want_crude: bool):
    _check(out is None or want_crude,
           "out= holds the dense crude matrix; it needs want_crude=True")


def _masked(crude: torch.Tensor, pred) -> torch.Tensor:
    """Rows a filter ``pred`` (n,) excludes are +inf."""
    return crude if pred is None else torch.where(
        pred[None, :], crude, torch.full_like(crude, float("inf")))


def crude_topk_torch(codes, lut_flat, topk: int, lut_scale=None,
                     lut_offset=None, *, want_crude: bool = True,
                     code_bits: int = 8, out=None, pred=None):
    """Plain version of the crude kernel.  codes (n, Kc) uint8 (or
    wider for m > 256), lut_flat (nq, K*m) f32 or int8 with
    ``lut_scale``/``lut_offset`` (nq,) f32 -> (crude (nq, n) f32 | None,
    vals (nq, topk) f32, idx (nq, topk) int32).  ``out`` (nq, n) f32
    receives the crude matrix; ``pred`` (n,) bool, optional, makes the
    rows it excludes +inf."""
    _check_out(out, want_crude)
    quantized = check_quantized_args(lut_flat, lut_scale, lut_offset)
    K, m = resolve_kernel_code_bits(code_bits, codes.shape[1],
                                    lut_flat.shape[1])
    cols = _code_columns(codes, code_bits)
    if quantized:
        acc = _flat_lut_sum(cols, lut_flat, K, m, torch.int32)
        crude = (lut_scale[:, None] * acc.to(torch.float32)
                 + lut_offset[:, None])
    else:
        crude = _flat_lut_sum(cols, lut_flat, K, m, torch.float32)
    crude = _masked(crude, pred)
    vals, idx = topk_two_key(crude, topk)
    return (_into(out, crude) if want_crude else None), vals, idx


def refine_topk_torch(codes, lut_flat, crude, thresholds, topk: int, *,
                      code_bits: int = 8):
    """Plain version of the refine kernel.  codes as in
    ``crude_topk_torch``, lut_flat (nq, K*m) f32 slow-masked, crude
    (nq, n) f32, thresholds (nq,) f32 -> (dist (nq, topk) f32,
    idx (nq, topk) int32)."""
    K, m = resolve_kernel_code_bits(code_bits, codes.shape[1],
                                    lut_flat.shape[1])
    slow = _flat_lut_sum(_code_columns(codes, code_bits), lut_flat, K, m,
                         torch.float32)
    passed = crude < thresholds[:, None]
    ranked = torch.where(passed, crude + slow,
                         torch.full_like(crude, float("inf")))
    return topk_two_key(ranked, topk)


def ivf_crude_topk_torch(cand_codes, cand_ids, lut_flat, topk: int,
                         lut_scale=None, lut_offset=None, *,
                         code_bits: int = 8, out=None):
    """Plain version of the slab crude kernel.  cand_codes (nq, nc, Kc)
    uint8 stored rows (or wider for m > 256), cand_ids (nq, nc) int32
    (-1 = invalid), lut_flat (nq, K*m) f32 or int8 with
    ``lut_scale``/``lut_offset`` (nq,) f32 -> (crude (nq, nc) f32 with
    invalid columns +inf, vals (nq, topk) f32, pos (nq, topk) int32
    slab positions).  ``out`` (nq, nc) f32 receives the crude matrix."""
    quantized = check_quantized_args(lut_flat, lut_scale, lut_offset)
    nq, nc, Kc = cand_codes.shape
    _check_slab_topk(nc, topk)
    K, m = resolve_kernel_code_bits(code_bits, Kc, lut_flat.shape[1])
    cols = _code_columns(cand_codes, code_bits)
    if quantized:
        acc = _slab_lut_sum(cols, lut_flat, K, m, torch.int32)
        crude = (lut_scale[:, None] * acc.to(torch.float32)
                 + lut_offset[:, None])
    else:
        crude = _slab_lut_sum(cols, lut_flat, K, m, torch.float32)
    crude = torch.where(cand_ids >= 0, crude,
                        torch.full_like(crude, float("inf")))
    vals, pos = topk_two_key(crude, topk)
    return _into(out, crude), vals, pos


def ivf_refine_topk_torch(cand_codes, lut_flat, crude, thresholds,
                          topk: int, *, code_bits: int = 8):
    """Plain version of the slab refine kernel.  cand_codes as in
    ``ivf_crude_topk_torch``, lut_flat (nq, K*m) f32 slow-masked, crude
    (nq, nc) f32 (invalid columns +inf), thresholds (nq,) f32 ->
    (dist (nq, topk) f32, pos (nq, topk) int32 slab positions)."""
    nq, nc, Kc = cand_codes.shape
    _check_slab_topk(nc, topk)
    K, m = resolve_kernel_code_bits(code_bits, Kc, lut_flat.shape[1])
    slow = _slab_lut_sum(_code_columns(cand_codes, code_bits), lut_flat,
                         K, m, torch.float32)
    passed = crude < thresholds[:, None]
    ranked = torch.where(passed, crude + slow,
                         torch.full_like(crude, float("inf")))
    return topk_two_key(ranked, topk)


def select_topk_torch(crude, thresholds, cap: int):
    """Plain version of the survivor selection.  crude (nq, n) f32,
    thresholds (nq,) f32 -> (vals (nq, cap) f32: the crude values of the
    survivors, +inf past them; idx (nq, cap) int32 columns)."""
    passed = crude < thresholds[:, None]
    return topk_two_key(torch.where(passed, crude,
                                    torch.full_like(crude, float("inf"))),
                        cap)


def _rerank_operands(valid: torch.Tensor):
    """The slab refine's crude operand and thresholds for a re-rank:
    0.0 at the valid survivors, +inf at the others (which the margin
    test then prunes), and +inf thresholds (every valid survivor
    passes)."""
    crude = torch.where(valid, torch.zeros((), device=valid.device),
                        torch.full((), float("inf"), device=valid.device))
    thr = torch.full((valid.shape[0],), float("inf"), device=valid.device)
    return crude.to(torch.float32).contiguous(), thr


def rerank_topk_torch(cand_codes, lut_flat, valid, topk: int, *,
                      code_bits: int = 8):
    """Plain version of the re-rank.  cand_codes (nq, c, Kc) the
    survivors' stored rows, lut_flat (nq, K*m) f32 full tables, valid
    (nq, c) bool -> (dist (nq, topk) f32, pos (nq, topk) int32 survivor
    positions; +inf after the valid survivors)."""
    crude, thr = _rerank_operands(valid)
    return ivf_refine_topk_torch(cand_codes, lut_flat, crude, thr, topk,
                                 code_bits=code_bits)


# -------------------------------------------------------- CUDA kernels ----

def _check(cond: bool, what: str):
    if not cond:
        raise ValueError(what)


def _check_codes(codes: torch.Tensor, ndim: int, code_bits: int) -> int:
    """Checks the stored code rows; returns their bytes per code (1 for
    uint8 rows, 4 for the int32 rows of codes wider than a byte)."""
    _check(codes.is_cuda, "codes must lie on the CUDA device")
    _check(codes.dtype in (torch.uint8, torch.int32),
           f"the CUDA search kernels take uint8 or int32 code rows, got "
           f"{codes.dtype}")
    _check(code_bits == 8 or codes.dtype == torch.uint8,
           "nibble codes (code_bits=4) come in uint8 rows")
    _check(codes.ndim == ndim and codes.is_contiguous(),
           f"codes must be a contiguous {ndim}-d tensor")
    return codes.element_size()


def _check_flat_topk(n: int, topk: int):
    _check(1 <= topk <= n, f"topk={topk} must be in [1, n={n}]")


def _check_operand(t: torch.Tensor, name: str, shape, dtype, device):
    _check(t.device == device, f"{name} must lie on {device}")
    _check(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
    _check(tuple(t.shape) == tuple(shape),
           f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    _check(t.is_contiguous(), f"{name} must be contiguous")


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _raise_on(err: int, lib, what: str):
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.icq_error_string(err).decode()}")


def _launch_env(device: torch.device, name: str = "batched_search"):
    lib = build.library(name)
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    return lib, stream


def _merge_lists(vals, idx, w: int, topk: int, stream):
    """Merge each query's sorted candidate lists ((nq, L * w): L lists
    of w pairs, ascending on (distance, column)) two by two down to the
    (nq, topk) top-k: ``icq_merge_lists`` levels (one thread per output
    pair) while the lists are too many for one block's shared memory,
    then ``icq_merge_block`` (the remaining levels in one launch, one
    block per query).  The flat and the slab kernels share it.  The
    lists hold at least topk real pairs in all, so the result is topk
    wide."""
    lib = build.library("batched_search")
    nq = vals.shape[0]
    L = vals.shape[1] // w
    dev = vals.device
    while L > 1 and not lib.icq_merge_block_fits(L, w, topk):
        wo, Lo = min(topk, 2 * w), -(-L // 2)
        out_v = torch.empty((nq, Lo * wo), dtype=torch.float32, device=dev)
        out_i = torch.empty((nq, Lo * wo), dtype=torch.int32, device=dev)
        _raise_on(lib.icq_merge_lists(_ptr(vals), _ptr(idx), _ptr(out_v),
                                      _ptr(out_i), nq, L, w, topk, stream),
                  lib, "merge_lists")
        vals, idx, L, w = out_v, out_i, Lo, wo
    if L == 1:
        return vals, idx
    out_v = torch.empty((nq, topk), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, topk), dtype=torch.int32, device=dev)
    _raise_on(lib.icq_merge_block(_ptr(vals), _ptr(idx), _ptr(out_v),
                                  _ptr(out_i), nq, L, w, topk, stream),
              lib, "merge_block")
    return out_v, out_i


def _lists(nq: int, size: int, device):
    """Empty (nq, size) candidate lists: values and columns."""
    return (torch.empty((nq, size), dtype=torch.float32, device=device),
            torch.empty((nq, size), dtype=torch.int32, device=device))


_CUDA_ERROR_INVALID_VALUE = 1


def _plan(lib, name: str, *args) -> int:
    """Blocks along the points (or slab columns) of one launch of a
    running-list kernel, from its C plan ``name`` (one wave on the
    current device); each block writes one list of topk per query.
    Raises ValueError for a shape that no block layout serves."""
    out = (ctypes.c_int * 1)()
    err = getattr(lib, name)(*args, out)
    if err == _CUDA_ERROR_INVALID_VALUE:
        raise ValueError(
            f"{name}{args}: no block layout serves this shape: one query's "
            f"LUT beside a staged 1024-row chunk of codes exceeds a block's "
            f"227 KB of shared memory (1024 * row bytes + Km * LUT bytes <= "
            f"~224,000; the widest K served, with f32 LUTs (both refine "
            f"passes, the f32 crude passes) / int8 crude LUTs: uint8 rows at "
            f"m = 256: 109 / 175; int32 rows at m = 512: 36 / 48, at "
            f"m = 1024: 27 / 43), or the query tiles exceed 65535")
    _raise_on(err, lib, name)
    return out[0]


def crude_topk_cuda(codes, lut_flat, topk: int, lut_scale=None,
                    lut_offset=None, *, want_crude: bool = True,
                    code_bits: int = 8, out=None, pred=None):
    """Launch the crude kernel (its row-predicate instance when
    ``pred`` is given); same operands and outputs as
    ``crude_topk_torch`` (the kernel writes every entry of ``out``)."""
    _check_out(out, want_crude)
    quantized = check_quantized_args(lut_flat, lut_scale, lut_offset)
    code_bytes = _check_codes(codes, 2, code_bits)
    n, Kc = codes.shape
    _check_flat_topk(n, topk)
    nq, Km = lut_flat.shape
    K, m = resolve_kernel_code_bits(code_bits, Kc, Km)
    dev = codes.device
    _check_operand(lut_flat, "lut_flat", (nq, Km),
                   torch.int8 if quantized else torch.float32, dev)
    if quantized:
        _check_operand(lut_scale, "lut_scale", (nq,), torch.float32, dev)
        _check_operand(lut_offset, "lut_offset", (nq,), torch.float32, dev)
    if out is not None:
        _check_operand(out, "out", (nq, n), torch.float32, dev)
    if pred is not None:
        _check_operand(pred, "pred", (n,), torch.bool, dev)
        pred = pred.view(torch.uint8)       # one byte a row, 0 filtered
    lib, stream = _launch_env(dev)
    grid = _plan(lib, "icq_crude_plan", n, Kc, nq, Km, int(quantized),
                 int(code_bits == 4), code_bytes, topk, int(pred is not None))
    crude = out
    if crude is None and want_crude:
        crude = torch.empty((nq, n), dtype=torch.float32, device=dev)
    cand_v, cand_i = _lists(nq, grid * topk, dev)
    _raise_on(lib.icq_crude_topk(
        _ptr(codes), _ptr(pred), _ptr(lut_flat), _ptr(lut_scale),
        _ptr(lut_offset), _ptr(crude), _ptr(cand_v), _ptr(cand_i), n, Kc, nq,
        Km, m, int(quantized), int(code_bits == 4), code_bytes, topk, grid,
        stream),
        lib, "crude_topk")
    build.LAUNCHES["crude_topk" if pred is None else "crude_topk_pred"] += 1
    vals, idx = _merge_lists(cand_v, cand_i, topk, topk, stream)
    return crude, vals, idx


def refine_topk_cuda(codes, lut_flat, crude, thresholds, topk: int, *,
                     code_bits: int = 8):
    """Launch the refine kernel; same operands and outputs as
    ``refine_topk_torch``."""
    code_bytes = _check_codes(codes, 2, code_bits)
    n, Kc = codes.shape
    _check_flat_topk(n, topk)
    nq, Km = lut_flat.shape
    K, m = resolve_kernel_code_bits(code_bits, Kc, Km)
    dev = codes.device
    _check_operand(lut_flat, "lut_flat", (nq, Km), torch.float32, dev)
    _check_operand(crude, "crude", (nq, n), torch.float32, dev)
    _check_operand(thresholds, "thresholds", (nq,), torch.float32, dev)
    lib, stream = _launch_env(dev)
    grid = _plan(lib, "icq_refine_plan", n, Kc, nq, Km, int(code_bits == 4),
                 code_bytes, topk)
    cand_v, cand_i = _lists(nq, grid * topk, dev)
    _raise_on(lib.icq_refine_topk(
        _ptr(codes), _ptr(lut_flat), _ptr(crude), _ptr(thresholds),
        _ptr(cand_v), _ptr(cand_i), n, Kc, nq, Km, m,
        int(code_bits == 4), code_bytes, topk, grid, stream),
        lib, "refine_topk")
    build.LAUNCHES["refine_topk"] += 1
    return _merge_lists(cand_v, cand_i, topk, topk, stream)


def ivf_crude_topk_cuda(cand_codes, cand_ids, lut_flat, topk: int,
                        lut_scale=None, lut_offset=None, *,
                        code_bits: int = 8, out=None):
    """Launch the slab crude kernel; same operands and outputs as
    ``ivf_crude_topk_torch`` (the kernel writes every entry of
    ``out``)."""
    quantized = check_quantized_args(lut_flat, lut_scale, lut_offset)
    code_bytes = _check_codes(cand_codes, 3, code_bits)
    nq, nc, Kc = cand_codes.shape
    _check_slab_topk(nc, topk)
    Km = lut_flat.shape[1]
    K, m = resolve_kernel_code_bits(code_bits, Kc, Km)
    dev = cand_codes.device
    _check_operand(cand_ids, "cand_ids", (nq, nc), torch.int32, dev)
    _check_operand(lut_flat, "lut_flat", (nq, Km),
                   torch.int8 if quantized else torch.float32, dev)
    if quantized:
        _check_operand(lut_scale, "lut_scale", (nq,), torch.float32, dev)
        _check_operand(lut_offset, "lut_offset", (nq,), torch.float32, dev)
    if out is not None:
        _check_operand(out, "out", (nq, nc), torch.float32, dev)
    lib, stream = _launch_env(dev, "ivf_search")
    grid = _plan(lib, "icq_ivf_crude_plan", nq, nc, Kc, Km, int(quantized),
                 int(code_bits == 4), code_bytes, topk)
    crude = out if out is not None else torch.empty(
        (nq, nc), dtype=torch.float32, device=dev)
    cand_v, cand_i = _lists(nq, grid * topk, dev)
    _raise_on(lib.icq_ivf_crude_topk(
        _ptr(cand_codes), _ptr(cand_ids), _ptr(lut_flat), _ptr(lut_scale),
        _ptr(lut_offset), _ptr(crude), _ptr(cand_v), _ptr(cand_i), nq, nc,
        Kc, Km, m, int(quantized), int(code_bits == 4), code_bytes, topk,
        grid, stream),
        lib, "ivf_crude_topk")
    build.LAUNCHES["ivf_crude_topk"] += 1
    vals, pos = _merge_lists(cand_v, cand_i, topk, topk, stream)
    return crude, vals, pos


def ivf_refine_topk_cuda(cand_codes, lut_flat, crude, thresholds,
                         topk: int, *, code_bits: int = 8):
    """Launch the slab refine kernel; same operands and outputs as
    ``ivf_refine_topk_torch``."""
    out = _ivf_refine_launch(cand_codes, lut_flat, crude, thresholds, topk,
                             code_bits)
    build.LAUNCHES["ivf_refine_topk"] += 1
    return out


def rerank_topk_cuda(cand_codes, lut_flat, valid, topk: int, *,
                     code_bits: int = 8):
    """Launch the slab refine kernel as the re-rank; same operands and
    outputs as ``rerank_topk_torch``."""
    _check(valid.device == cand_codes.device
           and tuple(valid.shape) == tuple(cand_codes.shape[:2]),
           "valid must be an (nq, c) mask beside cand_codes")
    crude, thr = _rerank_operands(valid)
    out = _ivf_refine_launch(cand_codes, lut_flat, crude, thr, topk,
                             code_bits)
    build.LAUNCHES["rerank_topk"] += 1
    return out


def _ivf_refine_launch(cand_codes, lut_flat, crude, thresholds, topk: int,
                       code_bits: int):
    code_bytes = _check_codes(cand_codes, 3, code_bits)
    nq, nc, Kc = cand_codes.shape
    _check_slab_topk(nc, topk)
    Km = lut_flat.shape[1]
    K, m = resolve_kernel_code_bits(code_bits, Kc, Km)
    dev = cand_codes.device
    _check_operand(lut_flat, "lut_flat", (nq, Km), torch.float32, dev)
    _check_operand(crude, "crude", (nq, nc), torch.float32, dev)
    _check_operand(thresholds, "thresholds", (nq,), torch.float32, dev)
    lib, stream = _launch_env(dev, "ivf_search")
    grid = _plan(lib, "icq_ivf_refine_plan", nq, nc, Kc, Km,
                 int(code_bits == 4), code_bytes, topk)
    cand_v, cand_i = _lists(nq, grid * topk, dev)
    _raise_on(lib.icq_ivf_refine_topk(
        _ptr(cand_codes), _ptr(lut_flat), _ptr(crude), _ptr(thresholds),
        _ptr(cand_v), _ptr(cand_i), nq, nc, Kc, Km, m,
        int(code_bits == 4), code_bytes, topk, grid, stream),
        lib, "ivf_refine_topk")
    return _merge_lists(cand_v, cand_i, topk, topk, stream)


def select_topk_cuda(crude, thresholds, cap: int):
    """Launch the survivor selection (the refine kernel's SELECT
    instance); same operands and outputs as ``select_topk_torch``."""
    _check(crude.is_cuda and crude.ndim == 2,
           "crude must be an (nq, n) tensor on the CUDA device")
    nq, n = crude.shape
    _check_flat_topk(n, cap)
    dev = crude.device
    _check_operand(crude, "crude", (nq, n), torch.float32, dev)
    _check_operand(thresholds, "thresholds", (nq,), torch.float32, dev)
    lib, stream = _launch_env(dev)
    grid = _plan(lib, "icq_select_plan", n, nq, cap)
    cand_v, cand_i = _lists(nq, grid * cap, dev)
    _raise_on(lib.icq_select_topk(
        _ptr(crude), _ptr(thresholds), _ptr(cand_v), _ptr(cand_i), n, nq,
        cap, grid, stream), lib, "select_topk")
    build.LAUNCHES["select_topk"] += 1
    return _merge_lists(cand_v, cand_i, cap, cap, stream)
