"""Single-LUT ADC, ``dist_i = sum_k T[k, codes[i, k]]`` (twin of
``repro.kernels.adc``): the CUDA kernel of ``csrc/adc.cu`` beside its
plain PyTorch version.

Both take codes (n, K), uint8 stored rows or int32 with every code in
[0, m) as the reference requires, and one LUT (K, m) f32, and return
(n,) f32 summed in codebook order from 0.0, so kernel and plain version
agree bit for bit.  The reference's body is a one-hot x LUT matmul, a
trick for the TPU's matrix unit; here it is the gather it stands for.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# code widths the kernel reads: the index's uint8 rows and the
# reference's int32 contract
CODE_BYTES = {torch.uint8: 1, torch.int32: 4}


def check_lut(codes: torch.Tensor, lut: torch.Tensor):
    if lut.dtype != torch.float32 or lut.ndim != 2:
        raise ValueError(f"lut must be a (K, m) float32 tensor, got "
                         f"{lut.dtype} {tuple(lut.shape)}")
    if codes.ndim != 2 or codes.shape[1] != lut.shape[0]:
        raise ValueError(f"codes must be (n, K={lut.shape[0]}), got "
                         f"{tuple(codes.shape)}")


def adc_torch(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Plain version: codes (n, K) integer, lut (K, m) f32 -> (n,) f32."""
    check_lut(codes, lut)
    acc = torch.zeros((codes.shape[0],), dtype=torch.float32,
                      device=lut.device)
    for k in range(lut.shape[0]):
        acc = acc + lut[k][codes[:, k].long()]
    return acc


def kernel_operands(codes: torch.Tensor, lut: torch.Tensor):
    """Check the operands of the ADC kernels; returns (code width in
    bytes, the LUT made contiguous)."""
    check_lut(codes, lut)
    if not codes.is_cuda or codes.dtype not in CODE_BYTES \
            or not codes.is_contiguous():
        raise ValueError(f"codes must be a contiguous uint8 or int32 CUDA "
                         f"tensor, got {codes.dtype} on {codes.device}")
    if lut.device != codes.device:
        raise ValueError(f"lut must lie on {codes.device}")
    n, K = codes.shape
    m = lut.shape[1]
    if n < 1 or K < 1 or m < 1:
        raise ValueError(f"empty operand: codes {tuple(codes.shape)}, lut "
                         f"{tuple(lut.shape)}")
    lib = build.library("adc")
    if K * m * 4 > lib.icq_adc_max_lut_bytes():
        raise ValueError(f"the (K={K}, m={m}) LUT takes {K * m * 4} bytes; "
                         "a block stages at most "
                         f"{lib.icq_adc_max_lut_bytes()} in shared memory")
    return CODE_BYTES[codes.dtype], lut.contiguous()


def raise_on(err: int, what: str):
    if err:
        lib = build.library("adc")
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.icq_error_string(err).decode()}")


def adc_cuda(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Launch the ADC kernel; same operands and output as
    ``adc_torch``."""
    width, lut = kernel_operands(codes, lut)
    n, K = codes.shape
    out = torch.empty((n,), dtype=torch.float32, device=codes.device)
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    raise_on(build.library("adc").icq_adc(
        ctypes.c_void_p(codes.data_ptr()), width,
        ctypes.c_void_p(lut.data_ptr()), ctypes.c_void_p(out.data_ptr()), n,
        K, lut.shape[1], ctypes.c_void_p(stream)), "adc")
    build.LAUNCHES["adc"] += 1
    return out
