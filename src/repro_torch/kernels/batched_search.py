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

Every top-k is in ascending (distance, column) order, the reference's
two-key order, where the column is the global index (flat) or the slab
position (IVF).  ``*_torch`` are the plain versions: the same sums in
the same order (codebooks in order from 0.0, dequant as two roundings),
so on the same inputs kernel and plain version agree bit for bit.
``*_cuda`` check their operands, allocate the outputs, launch on the
current stream without synchronising, count the launch in
``build.LAUNCHES`` and raise if the launch failed.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.stages import (check_quantized_args,
                                        resolve_kernel_code_bits,
                                        topk_two_key, unpack_nibble_tile)

# each merge level cuts a query's candidate list from L to about
# L * topk / chunk (chunk = 1024 points per block), so topk is bounded
# well below the chunk
MAX_TOPK = 256


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
    _check(1 <= topk <= min(MAX_TOPK, nc),
           f"topk={topk} must be in [1, min({MAX_TOPK}, nc={nc})]; "
           "gather_candidates pads the slab to >= topk columns")


def crude_topk_torch(codes, lut_flat, topk: int, lut_scale=None,
                     lut_offset=None, *, want_crude: bool = True,
                     code_bits: int = 8):
    """Plain version of the crude kernel.  codes (n, Kc) uint8 (or
    wider for m > 256), lut_flat (nq, K*m) f32 or int8 with
    ``lut_scale``/``lut_offset`` (nq,) f32 -> (crude (nq, n) f32 | None,
    vals (nq, topk) f32, idx (nq, topk) int32)."""
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
    vals, idx = topk_two_key(crude, topk)
    return (crude if want_crude else None), vals, idx


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
                         code_bits: int = 8):
    """Plain version of the slab crude kernel.  cand_codes (nq, nc, Kc)
    uint8 stored rows (or wider for m > 256), cand_ids (nq, nc) int32
    (-1 = invalid), lut_flat (nq, K*m) f32 or int8 with
    ``lut_scale``/``lut_offset`` (nq,) f32 -> (crude (nq, nc) f32 with
    invalid columns +inf, vals (nq, topk) f32, pos (nq, topk) int32
    slab positions)."""
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
    return crude, vals, pos


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


# -------------------------------------------------------- CUDA kernels ----

def _check(cond: bool, what: str):
    if not cond:
        raise ValueError(what)


def _check_codes(codes: torch.Tensor, ndim: int):
    _check(codes.is_cuda, "codes must lie on the CUDA device")
    _check(codes.dtype == torch.uint8,
           f"the CUDA search kernels take uint8 code rows, got "
           f"{codes.dtype}; wider codes (m > 256) are still to be ported "
           "(ROADMAP.md, queue 1)")
    _check(codes.ndim == ndim and codes.is_contiguous(),
           f"codes must be a contiguous {ndim}-d tensor")


def _check_flat_topk(n: int, topk: int):
    _check(1 <= topk <= min(MAX_TOPK, n),
           f"topk={topk} must be in [1, min({MAX_TOPK}, n={n})]")


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
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    return lib, sms, stream


def _merge_lists(vals, idx, topk: int, stream):
    """Reduce per-chunk (nq, L) candidate lists to the (nq, topk) top-k,
    one select launch of ``batched_search.cu`` per level (the flat and
    the slab kernels share it)."""
    lib = build.library("batched_search")
    nq = vals.shape[0]
    chunk = lib.icq_chunk_points()
    while vals.shape[1] > topk:
        L = vals.shape[1]
        nch = -(-L // chunk)
        out_v = torch.empty((nq, nch * topk), dtype=torch.float32,
                            device=vals.device)
        out_i = torch.empty((nq, nch * topk), dtype=torch.int32,
                            device=vals.device)
        _raise_on(lib.icq_select_topk(_ptr(vals), _ptr(idx), _ptr(out_v),
                                      _ptr(out_i), nq, L, topk, stream),
                  lib, "select_topk")
        vals, idx = out_v, out_i
    return vals, idx


def crude_topk_cuda(codes, lut_flat, topk: int, lut_scale=None,
                    lut_offset=None, *, want_crude: bool = True,
                    code_bits: int = 8):
    """Launch the crude kernel; same operands and outputs as
    ``crude_topk_torch``."""
    quantized = check_quantized_args(lut_flat, lut_scale, lut_offset)
    _check_codes(codes, 2)
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
    lib, sms, stream = _launch_env(dev)
    nch = -(-n // lib.icq_chunk_points())
    crude = (torch.empty((nq, n), dtype=torch.float32, device=dev)
             if want_crude else None)
    cand_v = torch.empty((nq, nch * topk), dtype=torch.float32, device=dev)
    cand_i = torch.empty((nq, nch * topk), dtype=torch.int32, device=dev)
    _raise_on(lib.icq_crude_topk(
        _ptr(codes), _ptr(lut_flat), _ptr(lut_scale), _ptr(lut_offset),
        _ptr(crude), _ptr(cand_v), _ptr(cand_i), n, Kc, nq, Km, m,
        int(quantized), int(code_bits == 4), topk, sms, stream),
        lib, "crude_topk")
    build.LAUNCHES["crude_topk"] += 1
    vals, idx = _merge_lists(cand_v, cand_i, topk, stream)
    return crude, vals, idx


def refine_topk_cuda(codes, lut_flat, crude, thresholds, topk: int, *,
                     code_bits: int = 8):
    """Launch the refine kernel; same operands and outputs as
    ``refine_topk_torch``."""
    _check_codes(codes, 2)
    n, Kc = codes.shape
    _check_flat_topk(n, topk)
    nq, Km = lut_flat.shape
    K, m = resolve_kernel_code_bits(code_bits, Kc, Km)
    dev = codes.device
    _check_operand(lut_flat, "lut_flat", (nq, Km), torch.float32, dev)
    _check_operand(crude, "crude", (nq, n), torch.float32, dev)
    _check_operand(thresholds, "thresholds", (nq,), torch.float32, dev)
    lib, sms, stream = _launch_env(dev)
    nch = -(-n // lib.icq_chunk_points())
    cand_v = torch.empty((nq, nch * topk), dtype=torch.float32, device=dev)
    cand_i = torch.empty((nq, nch * topk), dtype=torch.int32, device=dev)
    _raise_on(lib.icq_refine_topk(
        _ptr(codes), _ptr(lut_flat), _ptr(crude), _ptr(thresholds),
        _ptr(cand_v), _ptr(cand_i), n, Kc, nq, Km, m,
        int(code_bits == 4), topk, sms, stream),
        lib, "refine_topk")
    build.LAUNCHES["refine_topk"] += 1
    return _merge_lists(cand_v, cand_i, topk, stream)


def ivf_crude_topk_cuda(cand_codes, cand_ids, lut_flat, topk: int,
                        lut_scale=None, lut_offset=None, *,
                        code_bits: int = 8):
    """Launch the slab crude kernel; same operands and outputs as
    ``ivf_crude_topk_torch``."""
    quantized = check_quantized_args(lut_flat, lut_scale, lut_offset)
    _check_codes(cand_codes, 3)
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
    lib, sms, stream = _launch_env(dev, "ivf_search")
    nch = -(-nc // lib.icq_chunk_points())
    crude = torch.empty((nq, nc), dtype=torch.float32, device=dev)
    cand_v = torch.empty((nq, nch * topk), dtype=torch.float32, device=dev)
    cand_i = torch.empty((nq, nch * topk), dtype=torch.int32, device=dev)
    _raise_on(lib.icq_ivf_crude_topk(
        _ptr(cand_codes), _ptr(cand_ids), _ptr(lut_flat), _ptr(lut_scale),
        _ptr(lut_offset), _ptr(crude), _ptr(cand_v), _ptr(cand_i), nq, nc,
        Kc, Km, m, int(quantized), int(code_bits == 4), topk, sms, stream),
        lib, "ivf_crude_topk")
    build.LAUNCHES["ivf_crude_topk"] += 1
    vals, pos = _merge_lists(cand_v, cand_i, topk, stream)
    return crude, vals, pos


def ivf_refine_topk_cuda(cand_codes, lut_flat, crude, thresholds,
                         topk: int, *, code_bits: int = 8):
    """Launch the slab refine kernel; same operands and outputs as
    ``ivf_refine_topk_torch``."""
    _check_codes(cand_codes, 3)
    nq, nc, Kc = cand_codes.shape
    _check_slab_topk(nc, topk)
    Km = lut_flat.shape[1]
    K, m = resolve_kernel_code_bits(code_bits, Kc, Km)
    dev = cand_codes.device
    _check_operand(lut_flat, "lut_flat", (nq, Km), torch.float32, dev)
    _check_operand(crude, "crude", (nq, nc), torch.float32, dev)
    _check_operand(thresholds, "thresholds", (nq,), torch.float32, dev)
    lib, sms, stream = _launch_env(dev, "ivf_search")
    nch = -(-nc // lib.icq_chunk_points())
    cand_v = torch.empty((nq, nch * topk), dtype=torch.float32, device=dev)
    cand_i = torch.empty((nq, nch * topk), dtype=torch.int32, device=dev)
    _raise_on(lib.icq_ivf_refine_topk(
        _ptr(cand_codes), _ptr(lut_flat), _ptr(crude), _ptr(thresholds),
        _ptr(cand_v), _ptr(cand_i), nq, nc, Kc, Km, m,
        int(code_bits == 4), topk, sms, stream),
        lib, "ivf_refine_topk")
    build.LAUNCHES["ivf_refine_topk"] += 1
    return _merge_lists(cand_v, cand_i, topk, stream)
