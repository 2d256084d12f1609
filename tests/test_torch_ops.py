"""The port's kernel ops held against the reference's ``repro.kernels.ops``.

Both packages get the same numpy operands.  The reference runs its
Pallas kernels in interpret mode and its oracles (``repro.kernels.ref``);
on the CPU the port's ops run the kernels' plain PyTorch versions.

- ADC and two-step: f32 sums to rtol 1e-6 plus an atol of 1e-6 times
  the largest K-term |LUT| sum (interpret mode sums a one-hot dot in
  XLA's order, the oracle a ``jnp.sum``); the port's sum is bitwise a
  sequential float32 numpy sum in codebook order, and the pass mask is
  exact.
- Flash attention: 2e-5 (f32) and 2e-2 (bf16), the reference's own
  tolerances, and 2e-4 against the model's chunked attention.
- k-means in bf16: the reference test's 5e-2 on distances and >= 98% of
  ids equal.
The CUDA kernels are held against the plain versions on the card
(``tests/test_torch_gpu.py`` and ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref
from repro_torch.kernels import adc, flash_attention, ops, two_step

RTOL = 1e-6


def _atol(lut):
    return RTOL * lut.shape[0] * float(np.abs(lut).max())


def _sequential_sum(codes, lut):
    acc = np.zeros((codes.shape[0],), np.float32)
    for k in range(lut.shape[0]):
        acc = acc + lut[k, codes[:, k]]
    return acc


def _adc_problem(seed, n, K, m):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, m, size=(n, K))
    codes[n // 2:n // 2 + 5] = codes[1]          # duplicated rows
    lut = rng.standard_normal((K, m)).astype(np.float32)
    return codes, lut


@pytest.mark.parametrize("n,K,m", [(64, 2, 16), (512, 8, 64),
                                   (1000, 16, 256), (4096, 4, 256)])
def test_adc_matches_reference(n, K, m):
    codes, lut = _adc_problem(n + K, n, K, m)
    got = {dt: ops.adc(torch.from_numpy(codes).to(dt), torch.from_numpy(lut))
           for dt in (torch.uint8, torch.int32)}
    assert torch.equal(got[torch.uint8], got[torch.int32])
    got = got[torch.uint8].numpy()
    np.testing.assert_array_equal(got, _sequential_sum(codes, lut))
    jc, jl = jnp.asarray(codes, jnp.int32), jnp.asarray(lut)
    for want in (ref_ops.adc(jc, jl, interpret=True), ref.adc_ref(jc, jl)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                   atol=_atol(lut))


@pytest.mark.parametrize("n,K,m,kf", [(256, 8, 32, 2), (999, 16, 64, 4)])
def test_two_step_matches_reference(n, K, m, kf):
    codes, lut = _adc_problem(n + kf, n, K, m)
    fast = np.zeros((K,), bool)
    fast[:kf] = True
    thr = 0.3
    crude, passed = ops.two_step(torch.from_numpy(codes).to(torch.uint8),
                                 torch.from_numpy(lut),
                                 torch.from_numpy(fast), thr)
    crude, passed = crude.numpy(), passed.numpy()
    assert passed.dtype == np.int32 and 0 < passed.sum() < n
    # no crude value so close to the threshold that the tolerance could
    # move it across
    assert np.abs(crude - np.float32(thr)).min() > 10 * _atol(lut)
    np.testing.assert_array_equal(
        crude, _sequential_sum(codes, lut * fast[:, None]))
    jargs = (jnp.asarray(codes, jnp.int32), jnp.asarray(lut),
             jnp.asarray(fast), thr)
    for c0, p0 in (ref_ops.two_step(*jargs, interpret=True),
                   ref.two_step_ref(*jargs)):
        np.testing.assert_allclose(crude, np.asarray(c0), rtol=RTOL,
                                   atol=_atol(lut))
        np.testing.assert_array_equal(passed, np.asarray(p0))
    # the test is strict: a point whose crude value is the threshold fails
    at = ops.two_step(torch.from_numpy(codes).to(torch.uint8),
                      torch.from_numpy(lut), torch.from_numpy(fast),
                      float(crude[0]))[1].numpy()
    assert at[0] == 0 and at.sum() == (crude < crude[0]).sum()


def _attention_inputs(seed, b, sq, sk, h, kvh, dh):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, dh), (b, sk, kvh, dh), (b, sk, kvh, dh))]


@pytest.mark.parametrize("b,sq,sk,h,kvh,dh,causal", [
    (1, 64, 64, 4, 4, 32, True),
    (2, 128, 128, 8, 2, 64, True),
    (1, 64, 256, 4, 1, 32, False),     # cross-length, MQA
    (2, 256, 256, 8, 8, 128, True),
    (1, 64, 192, 4, 2, 64, True),      # causal, sq < sk: top-left aligned
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_reference(b, sq, sk, h, kvh, dh, causal,
                                           dtype):
    arrays = _attention_inputs(sq + h + dh, b, sq, sk, h, kvh, dh)
    tdt = getattr(torch, dtype)
    got = ops.flash_attention(*(torch.from_numpy(a).to(tdt) for a in arrays),
                              causal=causal)
    assert got.dtype == tdt and tuple(got.shape) == (b, sq, h, dh)
    got = got.float().numpy()
    q, k, v = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays)
    pallas = ref_ops.flash_attention(q, k, v, causal=causal, blk_q=64,
                                     blk_k=64, interpret=True)
    g = h // kvh
    flat = [t.transpose(0, 2, 1, 3).reshape(b * h, t.shape[1], dh)
            for t in (q, jnp.repeat(k, g, axis=2), jnp.repeat(v, g, axis=2))]
    oracle = ref.flash_attention_ref(*flat, causal=causal)
    oracle = oracle.reshape(b, h, sq, dh).transpose(0, 2, 1, 3)
    tol = 2e-5 if dtype == "float32" else 2e-2
    for want in (pallas, oracle):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def test_flash_attention_matches_model_chunked_attention():
    from repro.models.attention import chunked_attention
    arrays = _attention_inputs(5, 2, 256, 256, 8, 2, 64)
    got = ops.flash_attention(*(torch.from_numpy(a) for a in arrays),
                              causal=True)
    want = chunked_attention(*(jnp.asarray(a) for a in arrays), causal=True,
                             chunk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("n,d,m", [(128, 8, 4), (3000, 48, 96),
                                   (1024, 128, 256)])
def test_kmeans_assign_bf16_matches_reference(n, d, m):
    rng = np.random.default_rng(n + d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    cent = rng.standard_normal((m, d)).astype(np.float32)
    ids, dist = ops.kmeans_assign(torch.from_numpy(x).to(torch.bfloat16),
                                  torch.from_numpy(cent).to(torch.bfloat16))
    assert ids.dtype == torch.int32 and dist.dtype == torch.float32
    jx, jc = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, cent))
    for ids0, dist0 in (ref_ops.kmeans_assign(jx, jc, interpret=True),
                        ref.kmeans_assign_ref(jx, jc)):
        np.testing.assert_allclose(dist.numpy(), np.asarray(dist0),
                                   rtol=5e-2, atol=5e-2)
        assert np.mean(ids.numpy() == np.asarray(ids0)) > 0.98


@pytest.mark.parametrize("K", [7, 16])
def test_fastscan_crude_topk_matches_reference(K):
    """The 4-bit wrapper equals ``batched_crude_topk(code_bits=4)`` bit
    for bit, and the reference's fast-scan pass (interpret mode) to the
    ADC tolerance with ids exact."""
    from repro.index import base as ref_base
    rng = np.random.default_rng(K)
    n, nq, m, d = 777, 5, 16, 12
    codes = rng.integers(0, m, size=(n, K))
    codes[400:405] = codes[2]
    C = (rng.standard_normal((K, m, d)) / np.sqrt(K)).astype(np.float32)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    lut_flat = np.array(ref_base.pad_luts_even(
        ref_base.build_lut(jnp.asarray(q), jnp.asarray(C)))).reshape(nq, -1)
    packed = ops.pack_nibbles(torch.from_numpy(codes), K)
    got = ops.fastscan_crude_topk(packed, torch.from_numpy(lut_flat), 20)
    same = ops.batched_crude_topk(packed, torch.from_numpy(lut_flat), 20,
                                  code_bits=4)
    for g, s in zip(got, same):
        assert torch.equal(g, s)
    want = ref_ops.fastscan_crude_topk(
        jnp.asarray(packed.numpy()), jnp.asarray(lut_flat), 20,
        interpret=True)
    atol = RTOL * K * float(np.abs(lut_flat).max())
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL, atol=atol)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=RTOL, atol=atol)


@pytest.mark.parametrize("K", [5, 8])
def test_nibble_reexports_match_reference(K):
    codes = np.random.default_rng(K).integers(0, 16, size=(33, K))
    packed = ops.pack_nibbles(torch.from_numpy(codes), K)
    np.testing.assert_array_equal(
        packed.numpy(),
        np.asarray(ref_ops.pack_nibbles(jnp.asarray(codes), K)))
    np.testing.assert_array_equal(ops.unpack_nibbles(packed, K).numpy(),
                                  codes)


def test_cpu_ops_launch_no_kernel():
    before = dict(ops.LAUNCHES)
    codes, lut = _adc_problem(0, 300, 4, 16)
    c, lt = torch.from_numpy(codes).to(torch.uint8), torch.from_numpy(lut)
    ops.adc(c, lt)
    ops.two_step(c, lt, torch.tensor([True, False, True, False]), 0.0)
    ops.flash_attention(*(torch.from_numpy(a) for a in
                          _attention_inputs(0, 1, 64, 64, 2, 1, 32)))
    ops.kmeans_assign(torch.from_numpy(lut), torch.from_numpy(lut[:2]))
    assert dict(ops.LAUNCHES) == before


def test_cuda_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never computes on the CPU: it raises before it
    builds or launches anything."""
    codes, lut = _adc_problem(1, 100, 4, 16)
    c, lt = torch.from_numpy(codes).to(torch.uint8), torch.from_numpy(lut)
    with pytest.raises(ValueError, match="CUDA"):
        adc.adc_cuda(c, lt)
    with pytest.raises(ValueError, match="CUDA"):
        two_step.two_step_cuda(c, lt, torch.ones(4, dtype=torch.bool), 0.0)
    qkv = [torch.from_numpy(a) for a in
           _attention_inputs(1, 1, 64, 64, 2, 1, 32)]
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention_cuda(*qkv)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.adc(c.to("meta"), lt.to("meta"))


@pytest.mark.parametrize("n,L", [
    (8192, 256),              # the PQ warm start's chunk
    (10_007, 1024),
    (20_011, 301),
    (5003, 97),               # one 128-centroid tile
    (1000, 1024),
    (8960, 640),
    (129, 129),               # one past a tile on both axes
    (1, 130),
])
def test_kmeans_assign_matches_reference_across_tiles(n, L):
    """``ops.kmeans_assign`` on CPU tensors (the plain version) against
    the reference's jnp assignment at shapes on and off the CUDA
    kernel's 128 x 128 tiles: ids equal wherever the two nearest scores
    are apart by more than 1e-5 of the terms' size, distances to rtol
    1e-5 plus an atol of 1e-6 of it.  The first centroid is duplicated
    as the last and is the first point: that tie is not clear, because
    the CPU's matmul may round two equal columns apart (it does at n =
    1), so only its distance is checked."""
    rng = np.random.default_rng(n + L)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    cent = rng.standard_normal((L, 16)).astype(np.float32)
    cent[-1] = cent[0]
    x[:1] = cent[0]
    ids, dist = ops.kmeans_assign(torch.from_numpy(x),
                                  torch.from_numpy(cent))
    want_i, want_d = (np.asarray(a) for a in ref.kmeans_assign_ref(
        jnp.asarray(x), jnp.asarray(cent)))
    size = float((x ** 2).sum(1).max() + (cent ** 2).sum(1).max())
    scores = (cent ** 2).sum(1)[None] - 2.0 * x.astype(np.float64) @ cent.T
    two = np.sort(scores, axis=1)[:, :2]
    clear = two[:, 1] - two[:, 0] > 1e-5 * size
    assert ids.dtype == torch.int32 and dist.dtype == torch.float32
    np.testing.assert_array_equal(ids.numpy()[clear], want_i[clear])
    np.testing.assert_allclose(dist.numpy(), want_d, rtol=1e-5,
                               atol=1e-6 * size)
