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
    the card; uint8 rows up to m = 256, int32 rows (as the index stores
    wider codes) past it."""
    rng = np.random.default_rng(seed)
    C = torch.from_numpy((rng.standard_normal((K, m, d))
                          / np.sqrt(K)).astype(np.float32)).cuda()
    codes = rng.integers(0, m, size=(n, K)).astype(
        np.uint8 if m <= 256 else np.int32)
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
    codes = rng.integers(0, m, size=(nq, nc, K)).astype(
        np.uint8 if m <= 256 else np.int32)
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


@pytest.mark.gpu
@pytest.mark.parametrize("K,m", [(2, 16), (8, 256), (16, 16), (16, 256)])
def test_cuda_adc_and_two_step_match_plain_versions(K, m):
    """The ADC and two-step kernels equal their plain versions bit for
    bit on uint8 and int32 rows, n ragged against the block, duplicated
    rows, and thresholds that pass none, some and all points."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import adc, two_step
    rng = np.random.default_rng(K * m)
    n = 20_011
    codes = rng.integers(0, m, size=(n, K))
    codes[n // 2:n // 2 + 9] = codes[3]
    lut = torch.from_numpy(rng.standard_normal((K, m)).astype(
        np.float32)).cuda()
    fast = torch.zeros((K,), dtype=torch.bool, device="cuda")
    fast[:max(1, K // 4)] = True
    for dtype in (torch.uint8, torch.int32):
        c = torch.from_numpy(codes).to(dtype).cuda()
        got = adc.adc_cuda(c, lut)
        torch.cuda.synchronize()
        assert torch.equal(got, adc.adc_torch(c, lut))
        crude = two_step.two_step_torch(c, lut, fast, 0.0)[0]
        lo, hi = float(crude.min()), float(crude.max())
        for thr in (lo, float(crude.median()), hi + 1.0):
            got = two_step.two_step_cuda(c, lut, fast, thr)
            want = two_step.two_step_torch(c, lut, fast, thr)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
        assert int(got[1].sum()) == n


FLASH_CASES = [
    (1, 64, 64, 4, 4, 32, True),
    (2, 128, 128, 8, 2, 64, True),
    (1, 64, 256, 4, 1, 32, False),      # cross-length, MQA
    (2, 256, 256, 8, 8, 128, True),
    (1, 200, 330, 4, 2, 64, True),      # ragged, sq < sk, GQA
    (1, 330, 200, 4, 1, 128, True),     # ragged, sq > sk, MQA
    (2, 100, 77, 6, 3, 128, False),
    (1, 300, 300, 2, 1, 256, True),     # dh 256
    # bf16 runs the tensor-core body (64-key tiles, 32 at dh 256): key
    # lengths off the tile, causal with sq > sk, MQA, at every head width
    (1, 257, 100, 4, 1, 32, True),      # causal, sq > sk, MQA
    (1, 96, 161, 8, 1, 64, False),      # MQA, sk off the tile
    (1, 1000, 1000, 8, 8, 64, True),    # many causal tiles, ragged
    (1, 80, 1000, 4, 1, 128, False),    # many key tiles, MQA
    (1, 130, 77, 4, 2, 256, True),      # causal, sq > sk, GQA
    (2, 64, 97, 4, 1, 256, False),      # MQA, sk off the 32-key tile
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,kvh,dh,causal", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_matches_plain_version(b, sq, sk, h, kvh, dh,
                                                    causal, dtype):
    """The flash kernel against its plain version in the working type,
    at 2e-5 (f32) and 2e-2 (bf16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(sq + sk + h)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dtype).cuda()
        for s in ((b, sq, h, dh), (b, sk, kvh, dh), (b, sk, kvh, dh)))
    got = fa.flash_attention_cuda(q, k, v, causal=causal)
    want = fa.flash_attention_torch(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# (b, sq, sk, H, KVH, causal) at MLA's widths: q/k 192 = 128 + 64, v 128
MLA_FLASH_CASES = [
    (1, 257, 257, 8, 8, True),          # ragged against the tile, MHA
    (2, 64, 200, 4, 1, False),          # cross-length, MQA
    (1, 130, 77, 4, 2, True),           # causal, sq > sk, GQA
    (1, 1000, 1000, 2, 2, True),        # many causal tiles
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,kvh,causal", MLA_FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_mla_widths_match_plain_version(
        b, sq, sk, h, kvh, causal, dtype):
    """The (192, 128) instance (v narrower than q and k) against its
    plain version, at phase 7's tolerances; an uncompiled pair raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(sq + sk + h + 1)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dtype).cuda()
        for s in ((b, sq, h, 192), (b, sk, kvh, 192), (b, sk, kvh, 128)))
    got = fa.flash_attention_cuda(q, k, v, causal=causal)
    want = fa.flash_attention_torch(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, sq, h, 128)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    with pytest.raises(ValueError, match="not compiled"):
        fa.flash_attention_cuda(q, k, v[..., :64].contiguous())
    assert fa.kernel_attributes(dtype, 192, 128)["path"] == fa.PATHS[dtype]


@pytest.mark.gpu
def test_cuda_kmeans_assign_takes_bf16():
    """bf16 operands run the f32 kernel on their exact f32 values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import kmeans as km
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((5003, 64), generator=g, device="cuda").bfloat16()
    cent = torch.randn((97, 64), generator=g, device="cuda").bfloat16()
    got = km.kmeans_assign_cuda(x, cent)
    want = km.kmeans_assign_cuda(x.float(), cent.float())
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("n,L", [(8192, 256), (10007, 1024)])
def test_cuda_kmeans_assign_split_equals_unsplit(n, L):
    """Split-L launches (the centroid axis in S slices, reduced by a
    second launch) equal the unsplit launch bit for bit, at the PQ warm
    start's 8192 x 256 and at a ragged n, for every S; with a centroid
    duplicated across slices, the first index wins in every split."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import kmeans as km
    rng = np.random.default_rng(n + L)
    x = torch.from_numpy(rng.standard_normal((n, 128)).astype(
        np.float32)).cuda()
    cent = torch.from_numpy(rng.standard_normal((L, 128)).astype(
        np.float32)).cuda()
    dup = L - 24                         # in the last 128-centroid tile
    cent[dup] = cent[5]
    x[:9] = cent[5]                      # exact ties between 5 and dup
    want = km.kmeans_assign_cuda(x, cent, _split=1)
    torch.cuda.synchronize()
    assert bool((want[0][:9] == 5).all())
    assert not bool((want[0] == dup).any())
    n_ct = -(-L // 128)
    for split in [None, *range(2, n_ct + 1)]:
        got = km.kmeans_assign_cuda(x, cent, _split=split)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]), split
        assert torch.equal(got[1], want[1]), split


LARGE_TOPK = [257, 512, 1000, 2048]


@pytest.mark.gpu
@pytest.mark.parametrize("topk", LARGE_TOPK)
@pytest.mark.parametrize("lut_dtype,code_bits", CASES)
def test_cuda_search_kernels_serve_large_topk(lut_dtype, code_bits, topk):
    """Past the 1024-point chunk and past a block's points: the flat
    crude (dense crude on and off) and refine kernels and the slab pair
    equal their plain versions bit for bit at topk in {257, 512, 1000,
    2048}, on ragged shapes with forced ties."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    K, m = (7, 16) if code_bits == 4 else (8, 256)
    codes, luts, fast = _problem(37, 9001, 11, K, m)
    stored = pack_nibbles(codes, K) if code_bits == 4 else codes
    lut_flat, scale, offset = stages.crude_lut_operands(
        luts, fast, quantized=lut_dtype == "int8", code_bits=code_bits)
    for want_crude in (True, False):
        got = bs.crude_topk_cuda(stored, lut_flat, topk, scale, offset,
                                 want_crude=want_crude, code_bits=code_bits)
        want = bs.crude_topk_torch(stored, lut_flat, topk, scale, offset,
                                   want_crude=want_crude,
                                   code_bits=code_bits)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert (g is None and w is None) or torch.equal(g, w)
    crude = bs.crude_topk_torch(stored, lut_flat, topk, scale, offset,
                                code_bits=code_bits)[0]
    lut_slow = stages.slow_lut_operand(luts, fast, code_bits=code_bits)
    for rank in (3000, 7):     # many survivors; fewer than topk
        thr = torch.sort(crude, dim=1).values[:, rank].contiguous()
        got = bs.refine_topk_cuda(stored, lut_slow, crude, thr, topk,
                                  code_bits=code_bits)
        want = bs.refine_topk_torch(stored, lut_slow, crude, thr, topk,
                                    code_bits=code_bits)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    scodes, ids, sluts, sfast = _slab(43, 5, 2500, K, m)
    sstored = (pack_nibbles(scodes, K) if code_bits == 4 else scodes) \
        .contiguous()
    slut, sscale, soffset = stages.crude_lut_operands(
        sluts, sfast, quantized=lut_dtype == "int8", code_bits=code_bits)
    got = bs.ivf_crude_topk_cuda(sstored, ids, slut, topk, sscale, soffset,
                                 code_bits=code_bits)
    want = bs.ivf_crude_topk_torch(sstored, ids, slut, topk, sscale,
                                   soffset, code_bits=code_bits)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    scrude = want[0]
    sslow = stages.slow_lut_operand(sluts, sfast, code_bits=code_bits)
    thr = torch.sort(scrude, dim=1).values[:, 1500].contiguous()
    got = bs.ivf_refine_topk_cuda(sstored, sslow, scrude, thr, topk,
                                  code_bits=code_bits)
    want = bs.ivf_refine_topk_torch(sstored, sslow, scrude, thr, topk,
                                    code_bits=code_bits)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _ordered_problem(order, n, nq, lut_dtype, code_bits):
    """Codes and one LUT per query whose crude distance of point i is a
    chosen function of i: rising with i (the running bar never prunes),
    falling (every point enters), or equal for all.  f32 LUTs give the
    rank itself (exact integers); int8 LUTs a coarse, non-decreasing
    step of it (long runs of exact ties)."""
    r = np.arange(n)
    if order == "falling":
        r = n - 1 - r
    elif order == "equal":
        r = np.full(n, 12345)
    if code_bits == 8:
        K, m = 2, 256
        codes = np.stack([r // 256 % 256, r % 256], 1).astype(np.uint8)
        if lut_dtype == "f32":
            lut = np.stack([256.0 * np.arange(m), np.arange(m)])
        else:
            lut = np.stack([np.arange(m) // 2 - 64, np.zeros(m)])
    else:
        K, m = 4, 16
        codes = np.stack([r >> (4 * k) & 15 for k in range(K)], 1)
        lut = np.stack([16.0 ** k * np.arange(m) for k in range(K)])
        if lut_dtype == "int8":
            lut = np.stack([np.zeros(m)] * 3 + [np.arange(m)])
        codes = pack_nibbles(torch.from_numpy(codes.astype(np.uint8)),
                             K).numpy()
    flat = np.tile(lut.reshape(1, K * m), (nq, 1))
    codes = torch.from_numpy(np.ascontiguousarray(codes)).cuda()
    if lut_dtype == "f32":
        return codes, torch.from_numpy(flat.astype(np.float32)).cuda(), \
            None, None
    scale = torch.full((nq,), 0.5, device="cuda")
    offset = torch.linspace(-1.0, 1.0, nq, device="cuda")
    return (codes, torch.from_numpy(flat.astype(np.int8)).cuda(), scale,
            offset)


@pytest.mark.gpu
@pytest.mark.parametrize("order", ["rising", "falling", "equal"])
@pytest.mark.parametrize("lut_dtype,code_bits", CASES)
def test_cuda_crude_topk_adversarial_orders(lut_dtype, code_bits, order):
    """The running-list crude kernel against its plain version bit for
    bit where its bar is least use: distances rising with the index,
    falling with it, all equal; n ragged against the 1024-point chunk,
    and topk up to more points than a block sees."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = 50_001
    codes, lut, scale, offset = _ordered_problem(order, n, 3, lut_dtype,
                                                 code_bits)
    for topk in (1, 100, 2048, 5000):
        got = bs.crude_topk_cuda(codes, lut, topk, scale, offset,
                                 code_bits=code_bits)
        want = bs.crude_topk_torch(codes, lut, topk, scale, offset,
                                   code_bits=code_bits)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), topk


@pytest.mark.gpu
def test_cuda_crude_topk_lists_in_global_memory():
    """A topk whose running lists do not fit beside the LUTs in shared
    memory (the lists then live in the block's output rows): still
    equal to the plain version bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    codes, luts, fast = _problem(47, 70_001, 3, 8, 256)
    lut_flat, _, _ = stages.crude_lut_operands(luts, fast, quantized=False)
    got = bs.crude_topk_cuda(codes, lut_flat, 40_000)
    want = bs.crude_topk_torch(codes, lut_flat, 40_000)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _refine_regime(crude, regime):
    """(crude, thresholds) of one refine regime: no point passes, every
    point passes (thr = +inf), fewer survivors than topk spread over
    every block, or survivors only in the first or only in the last
    1024-column chunk (every other column's crude raised far above the
    threshold)."""
    nq, n = crude.shape
    inf = float("inf")
    if regime == "none":
        return crude, torch.full((nq,), -inf, device=crude.device)
    if regime == "all":
        return crude, torch.full((nq,), inf, device=crude.device)
    if regime == "fewer_than_topk":
        return crude, torch.sort(crude, dim=1).values[:, 7].contiguous()
    col = torch.arange(n, device=crude.device)
    keep = (col < 1024 if regime == "first_chunk"
            else col >= (n - 1) // 1024 * 1024)
    cr = torch.where(keep, crude, crude.abs() + 1e6).contiguous()
    rank = min(int(keep.sum()) - 1, 150)
    return cr, torch.sort(cr, dim=1).values[:, rank].contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("regime", ["none", "all", "fewer_than_topk",
                                    "first_chunk", "last_chunk"])
@pytest.mark.parametrize("code_bits", [8, 4])
def test_cuda_refine_kernels_adversarial_thresholds(code_bits, regime):
    """The running-list refine kernels, flat and slab, against their
    plain versions bit for bit where the bar and the +inf tail decide:
    n and nc ragged against the 1024-row chunk, slab columns -1 and a
    slab row thinner than topk, topk from 1 past the chunk.  With no
    survivor the top-k is (+inf, 0..topk-1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    K, m = (7, 16) if code_bits == 4 else (8, 256)
    codes, luts, fast = _problem(53, 9001, 11, K, m)
    stored = pack_nibbles(codes, K) if code_bits == 4 else codes
    lut_fast, _, _ = stages.crude_lut_operands(luts, fast, quantized=False,
                                               code_bits=code_bits)
    lut_slow = stages.slow_lut_operand(luts, fast, code_bits=code_bits)
    crude = bs.crude_topk_torch(stored, lut_fast, 20,
                                code_bits=code_bits)[0]
    cr, thr = _refine_regime(crude, regime)
    for topk in (1, 20, *LARGE_TOPK):
        got = bs.refine_topk_cuda(stored, lut_slow, cr, thr, topk,
                                  code_bits=code_bits)
        want = bs.refine_topk_torch(stored, lut_slow, cr, thr, topk,
                                    code_bits=code_bits)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), topk
        if regime == "none":
            assert bool(torch.isinf(got[0]).all())
            assert bool((got[1] == torch.arange(topk, device="cuda")).all())
    scodes, ids, sluts, sfast = _slab(59, 5, 2500, K, m)
    sstored = (pack_nibbles(scodes, K) if code_bits == 4 else scodes) \
        .contiguous()
    slut, _, _ = stages.crude_lut_operands(sluts, sfast, quantized=False,
                                           code_bits=code_bits)
    sslow = stages.slow_lut_operand(sluts, sfast, code_bits=code_bits)
    scrude = bs.ivf_crude_topk_torch(sstored, ids, slut, 20,
                                     code_bits=code_bits)[0]
    cr, thr = _refine_regime(scrude, regime)
    for topk in (1, 20, *LARGE_TOPK):
        got = bs.ivf_refine_topk_cuda(sstored, sslow, cr, thr, topk,
                                      code_bits=code_bits)
        want = bs.ivf_refine_topk_torch(sstored, sslow, cr, thr, topk,
                                        code_bits=code_bits)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), topk


@pytest.mark.gpu
@pytest.mark.parametrize("order", ["rising", "falling", "equal"])
def test_cuda_refine_kernels_adversarial_orders(order):
    """The refine kernels, flat and slab, where a block's pending buffer
    is least use: crude rising with the index (its bar never prunes),
    falling (every later chunk lands below a stale bar and the buffer
    overflows) and all equal, with thr = +inf and a threshold that
    passes half the points; n ragged against the 1024-point chunk, topk
    up to more points than a block sees."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n, nq = 50_001, 3
    col = torch.arange(n, dtype=torch.float32, device="cuda")
    crude = {"rising": col, "falling": n - col,
             "equal": torch.full_like(col, 7.0)}[order]
    crude = crude[None].repeat(nq, 1).contiguous()
    codes = torch.zeros((n, 8), dtype=torch.uint8, device="cuda")
    slow = torch.zeros((nq, 8 * 256), device="cuda")
    slab = codes[None].expand(nq, -1, -1).contiguous()
    for thr_v in (float("inf"), n / 2):
        thr = torch.full((nq,), thr_v, device="cuda")
        for topk in (1, 100, 2048, 5000):
            got = bs.refine_topk_cuda(codes, slow, crude, thr, topk)
            want = bs.refine_topk_torch(codes, slow, crude, thr, topk)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w), (thr_v, topk)
            got = bs.ivf_refine_topk_cuda(slab, slow, crude, thr, topk)
            want = bs.ivf_refine_topk_torch(slab, slow, crude, thr, topk)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w), (thr_v, topk)


@pytest.mark.gpu
@pytest.mark.parametrize("rank", [50, 28_000])
def test_cuda_refine_lists_in_global_memory(rank):
    """A topk whose running lists do not fit in shared memory (they then
    live in the block's output rows), flat and slab, with fewer and with
    more survivors than topk: equal to the plain versions bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    codes, luts, fast = _problem(61, 30_011, 3, 8, 256)
    lut_fast, _, _ = stages.crude_lut_operands(luts, fast, quantized=False)
    lut_slow = stages.slow_lut_operand(luts, fast)
    crude = bs.crude_topk_torch(codes, lut_fast, 20)[0]
    thr = torch.sort(crude, dim=1).values[:, rank].contiguous()
    got = bs.refine_topk_cuda(codes, lut_slow, crude, thr, 26_000)
    want = bs.refine_topk_torch(codes, lut_slow, crude, thr, 26_000)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    slab = codes[None].expand(3, -1, -1).contiguous()
    got = bs.ivf_refine_topk_cuda(slab, lut_slow, crude, thr, 26_000)
    want = bs.ivf_refine_topk_torch(slab, lut_slow, crude, thr, 26_000)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("order", ["rising", "falling", "equal"])
@pytest.mark.parametrize("lut_dtype,code_bits", CASES)
def test_cuda_slab_crude_adversarial(lut_dtype, code_bits, order):
    """The running-list slab crude kernel against its plain version bit
    for bit on adversarial slabs: distances rising, falling and equal
    along the slab; a row whose ids are all -1 (its top-k is (+inf,
    0..topk-1)), a row with 700 invalid columns before its first valid
    one, a row with 20% holes and a row with none; slabs of exactly one
    chunk, of 1025 columns and of 5000; topk 1, 100 and 2048 (or nc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    nq = 4
    for nc in (1024, 1025, 5000):
        codes, lut, scale, offset = _ordered_problem(order, nc, nq,
                                                     lut_dtype, code_bits)
        slab = codes[None].expand(nq, -1, -1).contiguous()
        rng = np.random.default_rng(nc)
        ids = rng.integers(0, 1 << 30, size=(nq, nc)).astype(np.int32)
        ids[0] = -1
        ids[1, :700] = -1
        ids[2, rng.random(nc) < 0.2] = -1
        ids = torch.from_numpy(ids).cuda()
        for topk in (1, 100, min(2048, nc)):
            got = bs.ivf_crude_topk_cuda(slab, ids, lut, topk, scale, offset,
                                         code_bits=code_bits)
            want = bs.ivf_crude_topk_torch(slab, ids, lut, topk, scale,
                                           offset, code_bits=code_bits)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w), (nc, topk)
            assert bool(torch.isinf(got[1][0]).all())
            assert bool((got[2][0] == torch.arange(topk,
                                                   device="cuda")).all())


@pytest.mark.gpu
@pytest.mark.parametrize("lut_dtype,K", [("f32", 109), ("int8", 175)])
def test_cuda_slab_crude_wide_codes(lut_dtype, K):
    """The slab crude kernel at the widest codes one block's shared
    memory serves at m = 256: f32 LUTs to K = 109 (the running lists in
    shared memory), int8 LUTs to K = 175 (the lists in global memory);
    equal to the plain version bit for bit.  One codebook more raises a
    ValueError."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    nq, nc, m = 3, 2500, 256
    quantized = lut_dtype == "int8"
    codes, ids, luts, fast = _slab(71 + K, nq, nc, K, m)
    lut_flat, scale, offset = stages.crude_lut_operands(
        luts, fast, quantized=quantized)
    for topk in (20, 2048):
        got = bs.ivf_crude_topk_cuda(codes, ids, lut_flat, topk, scale,
                                     offset)
        want = bs.ivf_crude_topk_torch(codes, ids, lut_flat, topk, scale,
                                       offset)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), topk
    wide = torch.zeros((nq, nc, K + 1), dtype=torch.uint8, device="cuda")
    lut = torch.zeros((nq, (K + 1) * m), device="cuda",
                      dtype=torch.int8 if quantized else torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        bs.ivf_crude_topk_cuda(wide, ids, lut, 20, scale, offset)


@pytest.mark.gpu
@pytest.mark.parametrize("K", [72, 107, 109])
def test_cuda_refine_kernels_wide_codes(K):
    """Codes too wide for two staging buffers at m = 256 (K > 70: the
    refine blocks then stage each chunk's code rows after the last and
    read the crude values from global memory), up to the widest that one
    block's shared memory serves (K = 109), flat and slab, with the
    lists in shared and in global memory: equal to the plain versions
    bit for bit.  K = 110 raises a ValueError in both."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n, nq, m = 5003, 3, 256
    codes, luts, fast = _problem(67 + K, n, nq, K, m)
    lut_fast, _, _ = stages.crude_lut_operands(luts, fast, quantized=False)
    lut_slow = stages.slow_lut_operand(luts, fast)
    crude = bs.crude_topk_torch(codes, lut_fast, 20)[0]
    slab = codes[None].expand(nq, -1, -1).contiguous()
    for rank in (7, 400):
        thr = torch.sort(crude, dim=1).values[:, rank].contiguous()
        for topk in (20, 2048):
            got = bs.refine_topk_cuda(codes, lut_slow, crude, thr, topk)
            want = bs.refine_topk_torch(codes, lut_slow, crude, thr, topk)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w), (rank, topk)
            got = bs.ivf_refine_topk_cuda(slab, lut_slow, crude, thr, topk)
            want = bs.ivf_refine_topk_torch(slab, lut_slow, crude, thr, topk)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w), (rank, topk)
    wide = torch.zeros((n, 110), dtype=torch.uint8, device="cuda")
    slow = torch.zeros((nq, 110 * m), device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        bs.refine_topk_cuda(wide, slow, crude, thr, 20)
    with pytest.raises(ValueError, match="shared memory"):
        bs.ivf_refine_topk_cuda(wide[None].expand(nq, -1, -1).contiguous(),
                                slow, crude, thr, 20)


def _icm_problem(seed, n, K, m, d):
    from repro_torch.core.codebooks import decode
    from repro_torch.core.encode import encode_pq
    rng = np.random.default_rng(seed)
    C = torch.from_numpy((rng.standard_normal((K, m, d))
                          / np.sqrt(K)).astype(np.float32)).cuda()
    true = torch.from_numpy(rng.integers(0, m, size=(n, K))).cuda()
    x = decode(C, true) + 0.1 * torch.from_numpy(
        rng.standard_normal((n, d)).astype(np.float32)).cuda()
    return x, C, encode_pq(x, C), rng


@pytest.mark.gpu
@pytest.mark.parametrize("d", [512, 960])
def test_cuda_icm_encode_wide_d(d):
    """Past 256 dimensions (recon and target in the wrapper's scratch,
    the target staged in 256-dimension parts): codes equal to the plain
    version on at least 99.9% of rows, reconstruction MSE to rtol 1e-5;
    encoding in chunks, or the rows in another order, gives each row the
    same codes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core.codebooks import decode
    from repro_torch.kernels import icm_encode as icm
    n, K, m = 6_007, 8, 256
    x, C, init, rng = _icm_problem(d, n, K, m, d)
    got = icm.icm_encode_cuda(x, init, C, iters=3)
    want = icm.icm_encode_torch(x, init, C, iters=3)
    torch.cuda.synchronize()
    assert float((got == want).all(1).float().mean()) >= 0.999
    mse = [float(torch.mean(torch.sum(torch.square(x - decode(C, c)), 1)))
           for c in (got, want)]
    assert mse[0] == pytest.approx(mse[1], rel=1e-5)
    parts = torch.cat([icm.icm_encode_cuda(x[s:s + 1000], init[s:s + 1000],
                                           C, iters=3)
                       for s in range(0, n, 1000)])
    assert torch.equal(parts, got)
    perm = torch.from_numpy(rng.permutation(n)).cuda()
    assert torch.equal(icm.icm_encode_cuda(x[perm], init[perm].contiguous(),
                                           C, iters=3), got[perm])


# codes wider than a byte (m > 256): the int32 rows the index stores,
# and the widest K one block's shared memory serves there, with f32 LUTs
# (all four passes) and with int8 crude LUTs (the two crude passes)
WIDE_M = [(512, 36, 48), (1024, 27, 43)]


def _refine_thresholds(crude):
    """Margins of the refine checks: many survivors, fewer than topk,
    none and all."""
    ranked = torch.sort(crude, dim=1).values
    nq = crude.shape[0]
    inf = float("inf")
    return [ranked[:, 600].contiguous(), ranked[:, 7].contiguous(),
            torch.full((nq,), -inf, device="cuda"),
            torch.full((nq,), inf, device="cuda")]


@pytest.mark.gpu
@pytest.mark.parametrize("m", [512, 1024])
@pytest.mark.parametrize("lut_dtype", ["f32", "int8"])
def test_cuda_search_kernels_int32_rows(m, lut_dtype):
    """The four search passes over int32 code rows at K = 8 equal their
    plain versions bit for bit: ragged shapes, duplicated rows (exact
    ties), topk 1, 100 and 2048, the dense crude on and off, the refine
    with many survivors, fewer than topk, none and all, the slab with
    -1 holes and one row thinner than topk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    K = 8
    quantized = lut_dtype == "int8"
    codes, luts, fast = _problem(90 + m, 10_003, 13, K, m)
    assert codes.dtype == torch.int32
    lf, sc, of = stages.crude_lut_operands(luts, fast, quantized=quantized)
    lut_slow = stages.slow_lut_operand(luts, fast)
    for topk in (1, 100, 2048):
        for want_crude in (True, False):
            got = bs.crude_topk_cuda(codes, lf, topk, sc, of,
                                     want_crude=want_crude)
            want = bs.crude_topk_torch(codes, lf, topk, sc, of,
                                       want_crude=want_crude)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert (g is None and w is None) or torch.equal(g, w)
    crude = bs.crude_topk_torch(codes, lf, 100, sc, of)[0]
    for thr in _refine_thresholds(crude):
        for topk in (1, 100, 2048):
            got = bs.refine_topk_cuda(codes, lut_slow, crude, thr, topk)
            want = bs.refine_topk_torch(codes, lut_slow, crude, thr, topk)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w), topk
    slab, ids, sluts, sfast = _slab(91 + m, 5, 5003, K, m)
    lf, sc, of = stages.crude_lut_operands(sluts, sfast, quantized=quantized)
    for topk in (1, 100, 2048):
        got = bs.ivf_crude_topk_cuda(slab, ids, lf, topk, sc, of)
        want = bs.ivf_crude_topk_torch(slab, ids, lf, topk, sc, of)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), topk
    crude = want[0]
    slow = stages.slow_lut_operand(sluts, sfast)
    for thr in _refine_thresholds(crude):
        for topk in (1, 100, 2048):
            got = bs.ivf_refine_topk_cuda(slab, slow, crude, thr, topk)
            want = bs.ivf_refine_topk_torch(slab, slow, crude, thr, topk)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w), topk


@pytest.mark.gpu
@pytest.mark.parametrize("m,k_f32,k_int8", WIDE_M)
def test_cuda_search_kernels_widest_int32_codes(m, k_f32, k_int8):
    """The widest int32 codes one block's shared memory serves: every
    pass at K = k_f32 with f32 LUTs and both crude passes at K = k_int8
    with int8 LUTs equal their plain versions bit for bit (topk 100 and
    2048); one codebook more raises a ValueError naming shared memory
    in each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n, nq, nc = 3001, 3, 2500
    for K, quantized in ((k_f32, False), (k_int8, True)):
        codes, luts, fast = _problem(95 + K, n, nq, K, m)
        slab, ids, sluts, sfast = _slab(96 + K, nq, nc, K, m)
        lf, sc, of = stages.crude_lut_operands(luts, fast,
                                               quantized=quantized)
        slf, ssc, sof = stages.crude_lut_operands(sluts, sfast,
                                                  quantized=quantized)
        for topk in (100, 2048):
            for got, want in (
                    (bs.crude_topk_cuda(codes, lf, topk, sc, of),
                     bs.crude_topk_torch(codes, lf, topk, sc, of)),
                    (bs.ivf_crude_topk_cuda(slab, ids, slf, topk, ssc, sof),
                     bs.ivf_crude_topk_torch(slab, ids, slf, topk, ssc,
                                             sof))):
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (K, topk)
        if not quantized:
            crude = bs.crude_topk_torch(codes, lf, 100)[0]
            scrude = bs.ivf_crude_topk_torch(slab, ids, slf, 100)[0]
            thr = torch.sort(crude, dim=1).values[:, 300].contiguous()
            sthr = torch.sort(scrude, dim=1).values[:, 300].contiguous()
            slow = stages.slow_lut_operand(luts, fast)
            sslow = stages.slow_lut_operand(sluts, sfast)
            for topk in (100, 2048):
                for got, want in (
                        (bs.refine_topk_cuda(codes, slow, crude, thr, topk),
                         bs.refine_topk_torch(codes, slow, crude, thr,
                                              topk)),
                        (bs.ivf_refine_topk_cuda(slab, sslow, scrude, sthr,
                                                 topk),
                         bs.ivf_refine_topk_torch(slab, sslow, scrude, sthr,
                                                  topk))):
                    torch.cuda.synchronize()
                    for g, w in zip(got, want):
                        assert torch.equal(g, w), (K, topk)
        wide = torch.zeros((n, K + 1), dtype=torch.int32, device="cuda")
        wslab = torch.zeros((nq, nc, K + 1), dtype=torch.int32,
                            device="cuda")
        lut = torch.zeros((nq, (K + 1) * m), device="cuda",
                          dtype=torch.int8 if quantized else torch.float32)
        with pytest.raises(ValueError, match="shared memory"):
            bs.crude_topk_cuda(wide, lut, 20, sc, of)
        with pytest.raises(ValueError, match="shared memory"):
            bs.ivf_crude_topk_cuda(wslab, ids, lut, 20, sc, of)
        if not quantized:
            cr = torch.zeros((nq, n), device="cuda")
            scr = torch.zeros((nq, nc), device="cuda")
            t = torch.zeros((nq,), device="cuda")
            with pytest.raises(ValueError, match="shared memory"):
                bs.refine_topk_cuda(wide, lut, cr, t, 20)
            with pytest.raises(ValueError, match="shared memory"):
                bs.ivf_refine_topk_cuda(wslab, lut, scr, t, 20)


@pytest.mark.gpu
@pytest.mark.parametrize("order", ["rising", "falling", "equal"])
@pytest.mark.parametrize("lut_dtype", ["f32", "int8"])
def test_cuda_slab_crude_adversarial_int32_rows(lut_dtype, order):
    """The slab crude over int32 rows at m = 1024 on the adversarial
    slabs of ``test_cuda_slab_crude_adversarial`` (a row all -1, a
    700-column invalid prefix, 20% holes; nc 1024, 1025 and 5000; topk
    1, 100 and 2048 or nc): equal to its plain version bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    nq, m = 4, 1024
    for nc in (1024, 1025, 5000):
        r = np.arange(nc)
        if order == "falling":
            r = nc - 1 - r
        elif order == "equal":
            r = np.full(nc, 12345)
        codes = np.stack([r // m % m, r % m], 1).astype(np.int32)
        lut = (np.stack([float(m) * np.arange(m), np.arange(m)])
               if lut_dtype == "f32"
               else np.stack([np.arange(m) // 8 - 64, np.zeros(m)]))
        slab = torch.from_numpy(np.ascontiguousarray(
            np.broadcast_to(codes, (nq, nc, 2)))).cuda()
        flat = np.tile(lut.reshape(1, 2 * m), (nq, 1))
        if lut_dtype == "f32":
            lf, sc, of = torch.from_numpy(flat.astype(np.float32)).cuda(), \
                None, None
        else:
            lf = torch.from_numpy(flat.astype(np.int8)).cuda()
            sc = torch.full((nq,), 0.5, device="cuda")
            of = torch.linspace(-1.0, 1.0, nq, device="cuda")
        rng = np.random.default_rng(nc)
        ids = rng.integers(0, 1 << 30, size=(nq, nc)).astype(np.int32)
        ids[0] = -1
        ids[1, :700] = -1
        ids[2, rng.random(nc) < 0.2] = -1
        ids = torch.from_numpy(ids).cuda()
        for topk in (1, 100, min(2048, nc)):
            got = bs.ivf_crude_topk_cuda(slab, ids, lf, topk, sc, of)
            want = bs.ivf_crude_topk_torch(slab, ids, lf, topk, sc, of)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w), (nc, topk)
            assert bool(torch.isinf(got[1][0]).all())


def _card_engine(kind, m=256):
    """A small index of ``kind`` built on the card from a numpy seed,
    served with no retries, and a query batch."""
    from repro_torch.api import AnnEngine, ResilienceConfig
    from repro_torch.index import make_index
    rng = np.random.default_rng(11)
    n, d, K = 6000, 16, 8
    codes = rng.integers(0, m, size=(n, K)).astype(
        np.uint8 if m <= 256 else np.int32)
    C = (rng.standard_normal((K, m, d)) / np.sqrt(K)).astype(np.float32)
    structure = (np.ones(d, bool), np.arange(K) < 2, np.float32(2.0))
    opts = dict(device="cuda", topk=20)
    if kind == "ivf":
        emb = C[np.arange(K)[None, :], codes.astype(np.int64)].sum(axis=1)
        opts.update(emb_db=emb, n_lists=16, n_probe=4, generator=0)
    index = make_index(kind, codes, C, structure, **opts)
    q = torch.from_numpy(rng.standard_normal((13, d)).astype(
        np.float32)).cuda()
    return AnnEngine(index, resilience=ResilienceConfig(max_retries=0)), q


@pytest.mark.gpu
@pytest.mark.parametrize("m", [256, 1024])
@pytest.mark.parametrize("kind", ["flat", "two-step", "ivf"])
def test_cuda_crude_rung_equals_full_path_candidates(kind, m):
    """The crude rung on the card launches the crude kernel once (no
    dense crude matrix, no refine) and serves bit for bit the crude top-k
    that the plain versions compute on the same CUDA tensors: the
    candidates the full path bootstraps its threshold from (ids through
    the slab for IVF; FlatADC's crude rung is its full search)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.index.ivf import coarse_probe, gather_candidates
    from repro_torch.kernels import build
    from repro_torch.resilience import SearchBudget
    engine, q = _card_engine(kind, m)
    index = engine.index
    engine.warm(13, budget=SearchBudget(allow_refine=False))
    before = dict(build.LAUNCHES)
    r = engine.search(q, budget=SearchBudget(allow_refine=False))
    launched = {k: v - before[k] for k, v in build.LAUNCHES.items()
                if v != before[k]}
    assert r.meta.level_name == "crude" and r.meta.backend == "cuda"
    assert launched == ({"ivf_crude_topk": 1} if kind == "ivf"
                        else {"crude_topk": 1})
    luts = build_lut(q, index.C)
    fast = None if kind == "flat" else index.structure.fast_mask
    lf, _, _ = stages.crude_lut_operands(luts, fast, quantized=False)
    if kind == "ivf":
        probes = coarse_probe(q, index.ivf.centroids, index.n_probe)
        cand_ids, cand_codes = gather_candidates(
            probes, index.ivf.lists, index.list_codes, 20)
        _, vals, pos = bs.ivf_crude_topk_torch(cand_codes, cand_ids, lf, 20)
        safe = torch.where(cand_ids >= 0, cand_ids,
                           torch.zeros_like(cand_ids))
        ids = safe.gather(1, pos.long())
    else:
        _, vals, ids = bs.crude_topk_torch(index.codes, lf, 20,
                                           want_crude=False)
    assert torch.equal(r.indices, ids) and torch.equal(r.distances, vals)
    assert engine.stats["retries"] == 0 and engine.stats["failovers"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["flat", "two-step", "ivf"])
def test_cuda_filter_and_refine_cap_raise(kind):
    """On the card ``filter`` and ``refine_cap`` raise the reference's
    ``ValueError`` (the kernels cannot mask rows by predicate or compact
    survivors), and the capped rung is not served."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses
    from repro_torch.resilience import SearchBudget
    engine, q = _card_engine(kind)
    pred = torch.ones(engine.n, dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError, match="filtered search requires "
                                         "backend='jnp'"):
        engine.search(q, filter=pred)
    with pytest.raises(ValueError, match="filtered search requires "
                                         "backend='jnp'"):
        engine.index.search(q, filter=pred)
    if kind != "flat":
        with pytest.raises(ValueError, match="filtered search requires"):
            engine.index.search_crude(q, filter=pred)
        with pytest.raises(ValueError, match="refine_cap compaction "
                                             "requires backend='jnp'"):
            dataclasses.replace(engine.index, refine_cap=64).search(q)
    with pytest.raises(ValueError, match="not servable"):
        engine.search(q, budget=SearchBudget(force_level="capped"))
    assert "capped" not in engine._levels()


def _assert_same_result(got, want):
    for field in ("indices", "distances", "pass_rate", "avg_ops"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field


@pytest.mark.gpu
@pytest.mark.parametrize("nq", [1, 8, 9, 37, 64])
@pytest.mark.parametrize("kind", ["flat", "two-step", "ivf"])
def test_cuda_pipelined_equals_sequential(kind, nq):
    """The pipelined executor on the card (two-phase plans on a crude
    and a refine stream) equals the sequential search over the same
    tiles bit for bit (ids, distances, pass_rate, avg_ops), over ragged
    tile counts, at the full and the crude rung; the crude and refine
    launch counts equal the sequential path's.  A batch shorter than a
    tile runs zero-padded to the tile, so its ids and distances are
    those of the sequential search of the padded tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses
    from repro_torch.index.pipelined import plan_for
    from repro_torch.kernels import build
    engine, _ = _card_engine(kind)
    piped = dataclasses.replace(engine.index, pipeline="tiles",
                                pipeline_tile=8)
    seq = dataclasses.replace(engine.index, query_chunk=8)
    q = torch.from_numpy(np.random.default_rng(nq).standard_normal(
        (nq, 16)).astype(np.float32)).cuda()
    padded = stages.pad_to(q, max(nq, 8))
    for rung in ("search", "search_crude"):
        launches = []
        for index, rows in ((piped, q), (seq, padded)):
            before = dict(build.LAUNCHES)
            res = getattr(index, rung)(rows)
            torch.cuda.synchronize()
            launches.append({k: v - before[k]
                             for k, v in build.LAUNCHES.items()})
            if index is piped:
                got = res
        if nq >= 8:
            _assert_same_result(got, res)
        assert torch.equal(got.indices, res.indices[:nq])
        assert torch.equal(got.distances, res.distances[:nq])
        assert launches[0] == launches[1]
    plan = plan_for(piped, piped.topk)
    if kind != "flat":
        crude_s, refine_s = plan.streams(q.device)
        assert crude_s != refine_s
        assert torch.cuda.current_stream() not in (crude_s, refine_s)


@pytest.mark.gpu
def test_cuda_pipelined_crude_slot_not_overwritten_early():
    """Tile 1 over 9 queries with wildly different per-tile work (zero
    queries refine most of the database, far queries almost nothing):
    the crude(t+2) write into slot t % 2 must wait for refine(t), so the
    pipelined result equals the sequential one, tile for tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses
    from repro_torch.index import make_index
    rng = np.random.default_rng(5)
    n, d, K, m = 200_000, 16, 8, 256
    codes = rng.integers(0, m, size=(n, K)).astype(np.uint8)
    C = (rng.standard_normal((K, m, d)) / np.sqrt(K)).astype(np.float32)
    structure = (np.ones(d, bool), np.arange(K) < 2, np.float32(3.0))
    index = make_index("two-step", codes, C, structure, device="cuda",
                       topk=50)
    q = rng.standard_normal((9, d)).astype(np.float32)
    q[0::2] = 0.0                               # heavy refine
    q[1::2] *= 50.0                             # light refine
    q = torch.from_numpy(q).cuda()
    piped = dataclasses.replace(index, pipeline="tiles", pipeline_tile=1)
    seq = dataclasses.replace(index, query_chunk=1)
    for _ in range(3):
        got = piped.search(q)
        want = seq.search(q)
        torch.cuda.synchronize()
        _assert_same_result(got, want)
    assert float(got.pass_rate) > 0


@pytest.mark.gpu
def test_cuda_serving_loop_parity():
    """Two tenants on the card behind one coalescing loop: every
    response equals the tenant engine's direct call on the request's
    rows, bit for bit, and no engine retries or fails over."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.serve import ServingLoop, Tenant
    tenants = [Tenant(name=kind, engine=_card_engine(kind)[0])
               for kind in ("two-step", "ivf")]
    rng = np.random.default_rng(7)
    reqs = [(kind, rng.standard_normal((nq, 16)).astype(np.float32))
            for nq in (1, 2, 4, 5, 3, 1, 8) for kind in ("two-step", "ivf")]
    with ServingLoop(tenants, window_ms=1.0, tile=8) as loop:
        for t in tenants:
            loop.warm(t.name)
        futs = [loop.submit(q, tenant=kind) for kind, q in reqs]
        results = [f.result(timeout=120) for f in futs]
    engines = {t.name: t.engine for t in tenants}
    for (kind, q), res in zip(reqs, results):
        direct = engines[kind].search(q)
        assert np.array_equal(res.indices, direct.indices.cpu().numpy())
        assert np.array_equal(res.distances,
                              direct.distances.cpu().numpy())
        assert res.meta.backend == "cuda" and res.meta.batch_fill > 0
    for e in engines.values():
        assert e.stats["retries"] == 0 and e.stats["failovers"] == 0


@pytest.mark.gpu
def test_cuda_ground_truth_matches_cpu():
    """``exact_search`` on the card (full f32, no TF32) against the CPU:
    ids equal wherever the k-th and (k+1)-th distances are apart."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch import eval as ev
    rng = np.random.default_rng(3)
    db = rng.standard_normal((50_000, 64)).astype(np.float32)
    q = rng.standard_normal((16, 64)).astype(np.float32)
    got_i, got_d = ev.ground_truth(db, q, 11)
    want_i, want_d = ev.ground_truth(db, q, 11, device="cpu")
    gap = np.abs(np.diff(want_d, axis=1)) > 1e-5 * np.abs(want_d[:, 1:])
    clear = gap[:, :10].copy()
    clear[:, 1:] &= gap[:, :9]
    assert clear.mean() > 0.9
    assert np.array_equal(got_i[:, :10][clear], want_i[:, :10][clear])
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,embed", [("icq", "linear"), ("cq", "linear"),
                                        ("pq", "linear"), ("icq", "cnn")])
def test_cuda_train_step_equals_cpu(mode, embed):
    """One joint step on the card (f32 matmuls and convolutions, no
    TF32) from the same state and batch as the CPU's: loss terms to rtol
    1e-4 and psi_size equal; with the linear embedder the updated params
    and optimizer / variance state to rtol 1e-4 with an atol of 1e-5 of
    each leaf's magnitude; with the cnn the embeddings to rtol 1e-5 (its
    first AdamW step divides conv-weight gradients near eps by
    themselves, where rounding moves the update far more); and the
    init's k-means through the kmeans_assign kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs import ICQConfig
    from repro_torch.kernels import build
    from repro_torch.train.optimizer import tree_leaves, tree_map
    from repro_torch.trainer import init_train_state, make_train_step
    rng = np.random.default_rng(12)
    shape = (512, 24) if embed == "linear" else (512, 8, 8, 2)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, 512).astype(np.int32))
    cfg = ICQConfig(d=8, num_codebooks=4, codebook_size=32, num_fast=1)
    before = build.LAUNCHES["kmeans_assign"]
    st = init_train_state(3, cfg, embed_kind=embed, d_raw=24, img_hw=8,
                          channels=2, mode=mode,
                          sample_batch=(x.cuda(), y.cuda()))
    assert build.LAUNCHES["kmeans_assign"] - before == 4 * 26
    step = make_train_step(cfg, st["embed_apply"], st["opt"], mode,
                           st["pq_mask"])
    state = (st["params"], st["opt_state"], st["var_state"])
    got = step(*state, (x[:128].cuda(), y[:128].cuda()))
    cpu = tree_map(lambda t: t.cpu(),
                   {"p": state[0], "o": state[1], "v": state[2]})
    mask = None if st["pq_mask"] is None else st["pq_mask"].cpu()
    want = make_train_step(cfg, st["embed_apply"], st["opt"], mode, mask)(
        cpu["p"], cpu["o"], cpu["v"], (x[:128], y[:128]))
    for k, w in want[3].items():
        g = float(got[3][k])
        assert (g == float(w) if k == "psi_size"
                else np.isclose(g, float(w), rtol=1e-4, atol=0.0)), k
    if embed == "cnn":
        emb = st["embed_apply"](state[0]["embed"], x.cuda())
        want_emb = st["embed_apply"](cpu["p"]["embed"], x)
        torch.testing.assert_close(emb.cpu(), want_emb, rtol=1e-5,
                                   atol=1e-6 * float(want_emb.abs().max()))
        return
    for g, w in zip(tree_leaves({"p": got[0], "o": got[1], "v": got[2]}),
                    tree_leaves({"p": want[0], "o": want[1], "v": want[2]})):
        scale = float(w.abs().max())
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["flat", "two-step", "ivf"])
@pytest.mark.parametrize("quantizer", ["icq", "pq", "opq", "cq"])
def test_cuda_session_round_trip(tmp_path, quantizer, kind):
    """The session on the card: fit -> index -> search -> save, then
    ``load_ann_engine`` fed ``from_artifacts``'s embeddings serves the
    in-process result bit for bit (an OPQ reload raises
    ``ArtifactError``; its index alone serves the searcher's
    embeddings)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.api import (ArtifactError, ICQConfig, ICQSession,
                                 icq_session, load_ann_engine)
    from repro_torch.data import make_table1_dataset
    xtr, ytr, xte, _ = make_table1_dataset("dataset2")
    joint = quantizer == "icq"
    cfg = ICQConfig().with_overrides({
        "train.quantizer": quantizer, "train.d": 16 if joint else 64,
        "train.num_codebooks": 4, "train.codebook_size": 16,
        "train.num_fast": 1, "train.epochs": 2, "index.kind": kind,
        "index.n_lists": 8, "index.n_probe": 4, "serve.topk": 10})
    session = icq_session(cfg)
    session.fit(xtr[:600], ytr[:600], seed=0)
    searcher = session.index()
    # contiguous rows, as Searcher.embed makes them: on the card a
    # product's rounding depends on its operands' strides
    q = torch.from_numpy(np.ascontiguousarray(xte[:16])).cuda()
    r0 = searcher.search(q)
    assert r0.indices.is_cuda and r0.meta.backend == "cuda"
    path = searcher.save(str(tmp_path / "art"))
    engine = load_ann_engine(path)
    if quantizer == "opq":
        with pytest.raises(ArtifactError, match="OPQ rotation"):
            ICQSession.from_artifacts(path)
        embed = searcher.embed
    else:
        embed = ICQSession.from_artifacts(path).model.embed
    r1 = engine(embed(q))
    assert torch.equal(r0.indices, r1.indices)
    assert torch.equal(r0.distances, r1.distances)


@pytest.mark.gpu
def test_cuda_codeword_gather_gradient_is_deterministic():
    """CQ's 50 AdamW steps on C run twice on the card from one state
    give the same C bit for bit (the gather's gradient is a sorted
    segment sum); each of 5 updates from the card's inputs agrees with
    the CPU's update from the same inputs to rtol 1e-4 with an atol of
    1e-5 of C's magnitude (free-running, the devices' rounding
    compounds through AdamW: one entry of 8192 ends 4.5e-4 apart after
    50)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs import ICQConfig
    from repro_torch.trainer import make_quantizer
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((20000, 32)).astype(
        np.float32))
    cfg = ICQConfig(d=32, num_codebooks=4, codebook_size=64, num_fast=1)
    q = make_quantizer("cq", cfg)
    s0 = q.init(0, x)
    xc = x.cuda()
    a = q.c_steps(s0["C"], s0["codes"], s0["opt_state"], xc)
    b = q.c_steps(s0["C"], s0["codes"], s0["opt_state"], xc)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1]["v"]["C"],
                                                   b[1]["v"]["C"])
    qc = make_quantizer("cq", cfg, device="cpu")
    C, opt = s0["C"], s0["opt_state"]
    for _ in range(5):
        got = q.c_step(C, s0["codes"], opt, xc)
        want = qc.c_step(C.cpu(), s0["codes"].cpu(),
                         {"m": {"C": opt["m"]["C"].cpu()},
                          "v": {"C": opt["v"]["C"].cpu()},
                          "step": opt["step"].cpu()}, x)
        scale = float(want[0].abs().max())
        torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-4,
                                   atol=1e-5 * scale)
        C, opt = got


@pytest.mark.gpu
def test_cuda_fit_resumed_equals_uninterrupted(tmp_path):
    """``fit(ckpt_dir=)`` on the card, killed at epoch 2 and re-invoked
    with the same seed, ends bit for bit where the uninterrupted fit
    ends."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs import ICQConfig
    from repro_torch.data import guyon_dataset
    from repro_torch.trainer import fit
    xs, ys = guyon_dataset(2048, 32, 12, 10, seed=5)
    cfg = ICQConfig(d=8, num_codebooks=4, codebook_size=16, num_fast=1)
    kw = dict(epochs=4, batch_size=256)
    want = fit(7, xs, ys, cfg, **kw)

    def kill(epoch):
        if epoch == 2:
            raise RuntimeError("killed")
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(RuntimeError, match="killed"):
        fit(7, xs, ys, cfg, ckpt_dir=ckpt, max_restarts=0, fault_hook=kill,
            **kw)
    got = fit(7, xs, ys, cfg, ckpt_dir=ckpt, **kw)
    assert torch.equal(got.C, want.C) and torch.equal(got.codes, want.codes)
    for a, b in zip(got.structure, want.structure):
        assert torch.equal(a, b)


def _card_mesh(D):
    from repro_torch.distributed import make_mesh_auto
    return make_mesh_auto((D,), ("data",), devices=["cuda"])


@pytest.mark.gpu
@pytest.mark.parametrize("lut_dtype", ["f32", "int8"])
@pytest.mark.parametrize("kind", ["flat", "two-step", "ivf"])
def test_cuda_sharded_equals_unsharded(kind, lut_dtype):
    """Four shards on the card launch the scan kernels once each a pass
    and answer the unsharded index's ids, distances, pass_rate and
    avg_ops bit for bit; a dead shard launches nothing; filter and
    refine_cap raise as on the unsharded index."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses
    from repro_torch.kernels import build
    engine, q = _card_engine(kind)
    index = dataclasses.replace(engine.index, lut_dtype=lut_dtype)
    want = index.search(q)
    view = index.shard(_card_mesh(4))
    before = dict(build.LAUNCHES)
    got = view.search(q)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in build.LAUNCHES.items()
                if v != before[k]}
    _assert_same_result(got, want)
    pair = (("ivf_crude_topk", "ivf_refine_topk") if kind == "ivf"
            else ("crude_topk",) if kind == "flat"
            else ("crude_topk", "refine_topk"))
    assert launched == {k: 4 for k in pair}
    view.mark_shard_dead(1)
    before = dict(build.LAUNCHES)
    view.search(q)
    assert all(build.LAUNCHES[k] - before[k] == 3 for k in pair)
    pred = torch.ones(index.codes.shape[0], dtype=torch.bool,
                      device="cuda")
    with pytest.raises(ValueError, match="filtered search requires"):
        view.search(q, filter=pred)
    if kind != "flat":
        with pytest.raises(ValueError, match="refine_cap compaction"):
            dataclasses.replace(index, refine_cap=64).shard(
                _card_mesh(2)).search(q)


@pytest.mark.gpu
def test_cuda_dp_step_equals_single_device_step():
    """A data-parallel step over 4 shards on the card from the same
    state and batch as the card's single-device step: loss terms to rtol
    1e-4, params and states to rtol 1e-4 with an atol of 1e-5 of each
    leaf's magnitude."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs import ICQConfig
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.trainer import init_train_state, make_train_step
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((512, 24)).astype(
        np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, 10, 512).astype(np.int32)).cuda()
    cfg = ICQConfig(d=8, num_codebooks=4, codebook_size=32, num_fast=1)
    st = init_train_state(3, cfg, d_raw=24, sample_batch=(x, y))
    state = (st["params"], st["opt_state"], st["var_state"])
    one = make_train_step(cfg, st["embed_apply"], st["opt"], "icq")(
        *state, (x[:128], y[:128]))
    dp = make_train_step(cfg, st["embed_apply"], st["opt"], "icq",
                         axis_name="data", mesh=_card_mesh(4))(
        *state, (x[:128], y[:128]))
    for k, w in one[3].items():
        g = float(dp[3][k])
        assert (g == float(w) if k == "psi_size"
                else np.isclose(g, float(w), rtol=1e-4, atol=0.0)), k
    for g, w in zip(tree_leaves(dict(zip("pov", dp[:3]))),
                    tree_leaves(dict(zip("pov", one[:3])))):
        scale = float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5 * scale)


def _dense_lm(arch, bf16, attn_chunk=1024):
    import dataclasses
    from repro_torch.configs import smoke_config
    from repro_torch.launch.steps import scale_config
    cfg = dataclasses.replace(smoke_config(arch), attn_chunk=attn_chunk,
                              head_dim=32)
    return scale_config(cfg) if bf16 else cfg


@pytest.mark.gpu
@pytest.mark.parametrize("arch,bf16,attn_chunk", [
    ("tinyllama-1.1b", False, 1024), ("gemma-7b", True, 1024),
    ("llama3-405b", False, 8), ("granite-3-8b", True, 8)])
def test_cuda_dense_prefill_decode_equals_cpu(arch, bf16, attn_chunk):
    """The dense LM's prefill (the flash kernel in every layer, one
    launch each) and 3 decode steps on the card against the CPU from the
    same params: f32 within 1e-5, bf16 within 2^-5 of the largest
    logit; greedy tokens equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    cfg = _dense_lm(arch, bf16, attn_chunk)
    model = build_model(cfg)
    cpu = model.init(0, device="cpu")
    card = _to(cpu, "cuda")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16),
                                             dtype=np.int32)
    tol = 2.0 ** -5 if bf16 else 1e-5
    ops.LAUNCHES["flash_attention"] = 0
    lg, cg = model.prefill(card, {"tokens": toks}, 24)
    assert ops.LAUNCHES["flash_attention"] == cfg.num_layers
    lc, cc = model.prefill(cpu, {"tokens": toks}, 24)
    for step in range(4):
        want = lc.float()
        bound = tol * max(1.0, float(want.abs().max()))
        assert float((lg.float().cpu() - want).abs().max()) <= bound, step
        tok = want[:, -1].argmax(-1).to(torch.int32)[:, None]
        assert torch.equal(lg[:, -1].float().argmax(-1).cpu(), tok[:, 0])
        if step < 3:
            lg, cg = model.decode_step(card, tok.cuda(), cg)
            lc, cc = model.decode_step(cpu, tok, cc)
    assert ops.LAUNCHES["flash_attention"] == cfg.num_layers


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.gpu
def test_cuda_prefill_refuses_an_uncompiled_head_width():
    """dh 16 (smoke_config's) is not one of the kernel's compiled widths:
    the card raises, naming them, and runs no plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model
    from repro_torch.models import attention as attn
    cfg = smoke_config("tinyllama-1.1b")
    model = build_model(cfg)
    params = model.init(0)
    toks = np.zeros((1, 8), np.int32)
    with pytest.raises(ValueError, match=r"\(32, 64, 128, 256\)"):
        model.prefill(params, {"tokens": toks}, 8)
    q = torch.zeros((1, 8, 4, 32), device="cuda")
    k = torch.zeros((1, 8, 2, 32), device="cuda")
    with pytest.raises(NotImplementedError, match="item 20"):
        attn.full_attention(q, k, k, causal=True, window=4)
    with pytest.raises(NotImplementedError, match="item 21"):
        attn.chunked_attention(q, k, k, causal=False, chunk=4)


def _moe_mla_lm(arch, bf16):
    """A smoke config of a MoE / MLA arch whose attention widths the
    flash kernel compiles: moonshot with heads of 32; deepseek with
    MLA's own head widths (q/k 128 + 64, v 128) at d_model 64."""
    import dataclasses
    from repro_torch.configs import smoke_config
    from repro_torch.launch.steps import scale_config
    repl = (dict(qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128)
            if arch == "deepseek-v2-236b" else dict(head_dim=32))
    cfg = dataclasses.replace(smoke_config(arch), **repl)
    return scale_config(cfg) if bf16 else cfg


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "deepseek-v2-236b"])
@pytest.mark.parametrize("bf16,attn_chunk", [(False, 1024), (True, 1024),
                                             (False, 8)])
def test_cuda_moe_mla_prefill_decode_equals_cpu(arch, bf16, attn_chunk):
    """The MoE / MLA LM's prefill (one flash launch a layer: MHA at 32,
    MLA at (192, 128) also past attn_chunk, where the CPU decompresses
    per block) and 3 decode steps (no flash launch) on the card against
    the CPU from the same params: f32 within 1e-5, bf16 within 2^-5 of
    the largest logit; greedy tokens equal wherever the CPU's top-2 gap
    exceeds that bound (bf16 logits of a 128-token vocab do tie within
    it); both fed the CPU's greedy tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    cfg = dataclasses.replace(_moe_mla_lm(arch, bf16), attn_chunk=attn_chunk)
    model = build_model(cfg)
    cpu = model.init(0, device="cpu")
    card = _to(cpu, "cuda")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16),
                                             dtype=np.int32)
    tol = 2.0 ** -5 if bf16 else 1e-5
    ops.LAUNCHES["flash_attention"] = 0
    lg, cg = model.prefill(card, {"tokens": toks}, 24)
    assert ops.LAUNCHES["flash_attention"] == cfg.num_layers
    lc, cc = model.prefill(cpu, {"tokens": toks}, 24)
    for step in range(4):
        want = lc.float()
        bound = tol * max(1.0, float(want.abs().max()))
        assert float((lg.float().cpu() - want).abs().max()) <= bound, step
        tok = want[:, -1].argmax(-1).to(torch.int32)[:, None]
        top2 = want[:, -1].topk(2, dim=-1).values
        same = lg[:, -1].float().argmax(-1).cpu() == tok[:, 0]
        assert bool((same | (top2[:, 0] - top2[:, 1] <= bound)).all()), step
        if step < 3:
            lg, cg = model.decode_step(card, tok.cuda(), cg)
            lc, cc = model.decode_step(cpu, tok, cc)
    assert ops.LAUNCHES["flash_attention"] == cfg.num_layers
    for seg in (k for k in cc if k != "pos"):
        for name, buf in cc[seg].items():
            b = tol * max(1.0, float(buf.float().abs().max()))
            assert float((cg[seg][name].float().cpu() - buf.float()).abs()
                         .max()) <= b, (seg, name)


@pytest.mark.gpu
def test_cuda_moe_combine_is_deterministic():
    """Two bf16 prefills of the MoE LM from the same inputs give bit for
    bit equal logits and caches, and so do two decode steps from equal
    caches (the combine sums each token's slots in a fixed order, no
    atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.models import build_model
    cfg = _moe_mla_lm("moonshot-v1-16b-a3b", True)
    model = build_model(cfg)
    params = model.init(0)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 64),
                                             dtype=np.int32)
    (l1, c1), (l2, c2) = (model.prefill(params, {"tokens": toks}, 72)
                          for _ in range(2))
    assert torch.equal(l1, l2)
    for seg in ("seg0", "seg1"):
        for name in ("k", "v"):
            assert torch.equal(c1[seg][name], c2[seg][name])
    tok = l1[:, -1].argmax(-1).to(torch.int32)[:, None]
    (d1, _), (d2, _) = (model.decode_step(params, tok, c)
                        for c in (c1, c2))
    assert torch.equal(d1, d2)


@pytest.mark.gpu
def test_cuda_mla_refuses_uncompiled_widths():
    """smoke_config's MLA widths (q/k 16 + 8, v 16) are not a compiled
    pair: the card's prefill raises the kernel's ValueError and runs no
    plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model
    model = build_model(smoke_config("deepseek-v2-236b"))
    params = model.init(0)
    with pytest.raises(ValueError, match=r"\(dqk=24, dv=16\) are not "
                                         r"compiled"):
        model.prefill(params, {"tokens": np.zeros((1, 8), np.int32)}, 8)
