"""The batched two-step search kernels (twin of
``repro.kernels.batched_search`` for the flat path): each CUDA kernel of
``csrc/batched_search.cu`` beside its plain PyTorch version.

  crude_topk   phase 1: the fast-masked LUT sum of every (query, point)
               pair, an optional dense (nq, n) crude matrix, and the
               crude top-k.  int8 LUTs dequantize as ``scale * acc +
               offset`` per query; ``code_bits=4`` unpacks nibbles.
  refine_topk  phase 2: the margin test ``crude < thr``, the slow-masked
               f32 LUT sum of survivors, ``full = crude + slow``, and
               the top-k of survivors; pruned points rank +inf.

Both return their top-k in ascending (distance, global index) order,
the reference's two-key order.  ``*_torch`` are the plain versions: the
same sums in the same order (codebooks in order from 0.0, dequant as
two roundings), so on the same inputs kernel and plain version agree
bit for bit.  ``*_cuda`` check their operands, allocate the outputs,
launch on the current stream without synchronising, count the launch
in ``LAUNCHES`` and raise if the launch failed.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.stages import (check_quantized_args,
                                        resolve_kernel_code_bits,
                                        topk_two_key, unpack_nibble_tile)

# launches of each kernel wrapper (a plain count: a run can show that
# its main path went through the kernels)
LAUNCHES = {"crude_topk": 0, "refine_topk": 0}

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


# -------------------------------------------------------- CUDA kernels ----

def _check(cond: bool, what: str):
    if not cond:
        raise ValueError(what)


def _check_codes(codes: torch.Tensor, topk: int):
    _check(codes.is_cuda, "codes must lie on the CUDA device")
    _check(codes.dtype == torch.uint8,
           f"the CUDA search kernels take uint8 code rows, got "
           f"{codes.dtype}; wider codes (m > 256) are still to be ported "
           "(ROADMAP.md, queue 1)")
    _check(codes.ndim == 2 and codes.is_contiguous(),
           "codes must be a contiguous (n, Kc) tensor")
    _check(1 <= topk <= min(MAX_TOPK, codes.shape[0]),
           f"topk={topk} must be in [1, min({MAX_TOPK}, n={codes.shape[0]})]")


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


def _launch_env(device: torch.device):
    lib = build.library("batched_search")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    return lib, sms, stream


def _merge_lists(lib, vals, idx, topk: int, stream):
    """Reduce per-chunk (nq, L) candidate lists to the (nq, topk) top-k,
    one select launch per level."""
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
    _check_codes(codes, topk)
    n, Kc = codes.shape
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
    LAUNCHES["crude_topk"] += 1
    vals, idx = _merge_lists(lib, cand_v, cand_i, topk, stream)
    return crude, vals, idx


def refine_topk_cuda(codes, lut_flat, crude, thresholds, topk: int, *,
                     code_bits: int = 8):
    """Launch the refine kernel; same operands and outputs as
    ``refine_topk_torch``."""
    _check_codes(codes, topk)
    n, Kc = codes.shape
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
    LAUNCHES["refine_topk"] += 1
    return _merge_lists(lib, cand_v, cand_i, topk, stream)
