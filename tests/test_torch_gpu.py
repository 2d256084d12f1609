"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips where no CUDA card is visible.  The
machine with the card has no JAX, so this file imports only torch,
numpy and the port, and runs without the conftest (which imports JAX):

    PYTHONPATH=src python -m pytest -m gpu --noconftest tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.encode import pack_nibbles
from repro_torch.index.base import build_lut
from repro_torch.kernels import batched_search as bs
from repro_torch.kernels import stages

CASES = [(lut, bits) for lut in ("f32", "int8") for bits in (8, 4)]


def _problem(seed, n, nq, K, m, d=16, num_fast=2):
    """Codes with duplicated rows (exact ties), LUTs and fast mask, on
    the card."""
    rng = np.random.default_rng(seed)
    C = torch.from_numpy((rng.standard_normal((K, m, d))
                          / np.sqrt(K)).astype(np.float32)).cuda()
    codes = rng.integers(0, m, size=(n, K)).astype(np.uint8)
    codes[n // 2:n // 2 + 7] = codes[3]
    codes[-5:] = codes[1]
    q = torch.from_numpy(rng.standard_normal((nq, d)).astype(
        np.float32)).cuda()
    fast = torch.zeros((K,), dtype=torch.bool, device="cuda")
    fast[:num_fast] = True
    return torch.from_numpy(codes).cuda(), build_lut(q, C), fast


@pytest.mark.gpu
@pytest.mark.parametrize("lut_dtype,code_bits", CASES)
def test_cuda_kernels_match_plain_versions(lut_dtype, code_bits):
    """Each CUDA kernel equals its plain version bit for bit (dense
    crude, ids and distances), on ragged shapes with forced ties."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    K, m = (7, 16) if code_bits == 4 else (8, 256)
    codes, luts, fast = _problem(31, 5003, 13, K, m)
    stored = pack_nibbles(codes, K) if code_bits == 4 else codes
    lut_flat, scale, offset = stages.crude_lut_operands(
        luts, fast, quantized=lut_dtype == "int8", code_bits=code_bits)
    for want_crude in (True, False):
        got = bs.crude_topk_cuda(stored, lut_flat, 20, scale, offset,
                                 want_crude=want_crude, code_bits=code_bits)
        want = bs.crude_topk_torch(stored, lut_flat, 20, scale, offset,
                                   want_crude=want_crude,
                                   code_bits=code_bits)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert (g is None and w is None) or torch.equal(g, w)
    crude = want[0] if want[0] is not None else bs.crude_topk_torch(
        stored, lut_flat, 20, scale, offset, code_bits=code_bits)[0]
    lut_slow = stages.slow_lut_operand(luts, fast, code_bits=code_bits)
    for rank in (400, 7):      # many survivors; fewer than topk
        thr = torch.sort(crude, dim=1).values[:, rank].contiguous()
        got = bs.refine_topk_cuda(stored, lut_slow, crude, thr, 20,
                                  code_bits=code_bits)
        want = bs.refine_topk_torch(stored, lut_slow, crude, thr, 20,
                                    code_bits=code_bits)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
