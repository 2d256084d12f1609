"""Fused two-step phase 1 over one LUT (twin of
``repro.kernels.two_step``): the CUDA kernel of ``csrc/adc.cu`` beside
its plain PyTorch version.

Both fold the (K,) fast mask into the LUT as the reference does (``lut *
fast_mask``, an f32 multiply by 0 or 1), sum all K codebooks of the
masked LUT in order (``adc``) and return ``(crude (n,) f32, passed (n,)
int32)`` with ``passed = crude < f32(threshold)``; kernel and plain
version agree bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.adc import adc_torch, kernel_operands, raise_on


def _threshold(threshold, device) -> torch.Tensor:
    thr = torch.as_tensor(threshold, dtype=torch.float32, device=device)
    if thr.numel() != 1:
        raise ValueError(f"threshold must be a scalar, got shape "
                         f"{tuple(thr.shape)}")
    return thr.reshape(1)


def two_step_torch(codes: torch.Tensor, lut: torch.Tensor,
                   fast_mask: torch.Tensor, threshold):
    """Plain version: codes (n, K) integer, lut (K, m) f32, fast_mask
    (K,) bool, threshold a scalar -> (crude (n,) f32, passed (n,)
    int32)."""
    crude = adc_torch(codes, lut * fast_mask[:, None].to(lut.dtype))
    passed = crude < _threshold(threshold, crude.device)
    return crude, passed.to(torch.int32)


def two_step_cuda(codes: torch.Tensor, lut: torch.Tensor,
                  fast_mask: torch.Tensor, threshold):
    """Launch the two-step kernel; same operands and outputs as
    ``two_step_torch``.  The threshold may be a Python number or a
    one-element tensor; a CUDA tensor is read by the kernel, with no
    synchronisation."""
    width, lut = kernel_operands(codes, lut)
    n, K = codes.shape
    dev = codes.device
    if not (fast_mask.dtype == torch.bool and tuple(fast_mask.shape) == (K,)
            and fast_mask.device == dev):
        raise ValueError(f"fast_mask must be a ({K},) bool tensor on {dev}, "
                         f"got {fast_mask.dtype} {tuple(fast_mask.shape)} "
                         f"on {fast_mask.device}")
    mask = fast_mask.contiguous()
    thr = _threshold(threshold, dev)
    crude = torch.empty((n,), dtype=torch.float32, device=dev)
    passed = torch.empty((n,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    raise_on(build.library("adc").icq_two_step(
        ctypes.c_void_p(codes.data_ptr()), width,
        ctypes.c_void_p(lut.data_ptr()), ctypes.c_void_p(mask.data_ptr()),
        ctypes.c_void_p(thr.data_ptr()), ctypes.c_void_p(crude.data_ptr()),
        ctypes.c_void_p(passed.data_ptr()), n, K, lut.shape[1],
        ctypes.c_void_p(stream)), "two_step")
    build.LAUNCHES["two_step"] += 1
    return crude, passed
