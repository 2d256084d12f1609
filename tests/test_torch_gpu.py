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


def _slab(seed, nq, nc, K, m, d=16, num_fast=2):
    """A ragged candidate slab on the card: duplicated code rows, -1
    holes in every row, one row with fewer than 20 valid columns."""
    rng = np.random.default_rng(seed)
    C = torch.from_numpy((rng.standard_normal((K, m, d))
                          / np.sqrt(K)).astype(np.float32)).cuda()
    codes = rng.integers(0, m, size=(nq, nc, K)).astype(np.uint8)
    codes[:, 100:107] = codes[:, 3:4]
    ids = rng.integers(0, 50 * nc, size=(nq, nc)).astype(np.int32)
    ids[rng.random((nq, nc)) < 0.2] = -1
    ids[1, 10:] = -1
    q = torch.from_numpy(rng.standard_normal((nq, d)).astype(
        np.float32)).cuda()
    fast = torch.zeros((K,), dtype=torch.bool, device="cuda")
    fast[:num_fast] = True
    return (torch.from_numpy(codes).cuda(), torch.from_numpy(ids).cuda(),
            build_lut(q, C), fast)


@pytest.mark.gpu
@pytest.mark.parametrize("lut_dtype,code_bits", CASES)
def test_cuda_slab_kernels_match_plain_versions(lut_dtype, code_bits):
    """The IVF slab kernels equal their plain versions bit for bit
    (dense crude with +inf holes, positions and distances), on a slab
    ragged against the 1024-row chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    K, m = (7, 16) if code_bits == 4 else (8, 256)
    codes, ids, luts, fast = _slab(41, 9, 2500, K, m)
    stored = (pack_nibbles(codes, K) if code_bits == 4 else codes) \
        .contiguous()
    lut_flat, scale, offset = stages.crude_lut_operands(
        luts, fast, quantized=lut_dtype == "int8", code_bits=code_bits)
    got = bs.ivf_crude_topk_cuda(stored, ids, lut_flat, 20, scale, offset,
                                 code_bits=code_bits)
    want = bs.ivf_crude_topk_torch(stored, ids, lut_flat, 20, scale, offset,
                                   code_bits=code_bits)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    crude = want[0]
    lut_slow = stages.slow_lut_operand(luts, fast, code_bits=code_bits)
    for rank in (600, 7):      # many survivors; fewer than topk
        thr = torch.sort(crude, dim=1).values[:, rank].contiguous()
        got = bs.ivf_refine_topk_cuda(stored, lut_slow, crude, thr, 20,
                                      code_bits=code_bits)
        want = bs.ivf_refine_topk_torch(stored, lut_slow, crude, thr, 20,
                                        code_bits=code_bits)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.gpu
def test_cuda_kmeans_assign_matches_plain_version():
    """Ids equal wherever the two nearest scores are apart by more than
    1e-5 of the terms' size (an exact tie, a duplicated centroid, goes
    to the first index); distances to rtol 1e-5 plus an atol of 1e-6
    times that size, since the kernel sums its dot products in its own
    order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import kmeans as km
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((20011, 40)).astype(
        np.float32)).cuda()
    cent = torch.from_numpy(rng.standard_normal((301, 40)).astype(
        np.float32)).cuda()
    cent[250] = cent[17]
    got_i, got_d = km.kmeans_assign_cuda(x, cent)
    want_i, want_d = km.kmeans_assign_torch(x, cent)
    torch.cuda.synchronize()
    size = float(x.square().sum(1).max() + cent.square().sum(1).max())
    scores = cent.square().sum(1)[None] - 2.0 * (x @ cent.T)
    two = torch.topk(scores, 2, dim=1, largest=False).values
    clear = (two[:, 1] - two[:, 0]) > 1e-5 * size
    assert bool((got_i[clear] == want_i[clear]).all())
    assert not bool((got_i == 250).any())
    torch.testing.assert_close(got_d, want_d, rtol=1e-5, atol=1e-6 * size)


@pytest.mark.gpu
def test_cuda_icm_encode_matches_plain_version():
    """The ICM kernel against its plain version on a ragged n, an m that
    is not a multiple of the 64-codeword tile and a d that is not one of
    the 32-dimension step: codes equal on at least 99.9% of rows (the
    kernel's dot products round in their own order, and a flip at a near
    tie changes that point's later steps), reconstruction MSE to rtol
    1e-5; with every codeword duplicated the first index always wins;
    encoding the rows in another order gives each row the same codes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core.codebooks import decode
    from repro_torch.core.encode import encode_pq
    from repro_torch.kernels import icm_encode as icm
    rng = np.random.default_rng(4)
    n, K, m, d = 20_011, 8, 100, 40
    C = torch.from_numpy((rng.standard_normal((K, m, d))
                          / np.sqrt(K)).astype(np.float32)).cuda()
    true = torch.from_numpy(rng.integers(0, m, size=(n, K))).cuda()
    x = decode(C, true) + 0.1 * torch.from_numpy(
        rng.standard_normal((n, d)).astype(np.float32)).cuda()
    init = encode_pq(x, C)
    for iters in (1, 3):
        got = icm.icm_encode_cuda(x, init, C, iters=iters)
        want = icm.icm_encode_torch(x, init, C, iters=iters)
        torch.cuda.synchronize()
        assert float((got == want).all(1).float().mean()) >= 0.999
        mse = [float(torch.mean(torch.sum(torch.square(x - decode(C, c)), 1)))
               for c in (got, want)]
        assert mse[0] == pytest.approx(mse[1], rel=1e-5)
    perm = torch.from_numpy(rng.permutation(n)).cuda()
    assert torch.equal(icm.icm_encode_cuda(x[perm], init[perm].contiguous(),
                                           C, iters=3), got[perm])
    dup = C.clone()
    dup[:, m // 2:] = dup[:, :m // 2]
    wild = torch.from_numpy(rng.integers(0, m, size=(n, K)).astype(
        np.int32)).cuda()
    codes = icm.icm_encode_cuda(x, wild, dup, iters=1)
    assert int(codes.max()) < m // 2
