"""The port's search kernels held against the reference's Pallas kernels.

On the CPU the port's wrappers run the kernels' plain PyTorch versions
(``crude_topk_torch`` / ``refine_topk_torch``); they are fed the same
numpy operands as the reference's ``crude_topk_pallas`` /
``refine_topk_pallas`` in interpret mode (LUTs built by the reference).
Ids must match exactly.  f32 distances match to rtol 1e-6 plus an atol
of 1e-6 times the largest magnitude a K-term LUT sum can reach: interpret
mode sums through a one-hot dot whose order is XLA's, and fuses the int8
dequant into one multiply-add, so a value near zero can differ by a few
ulps of its terms.  The same values are bitwise equal to the reference's
jnp stages, which add the K entries in the port's order.
The CUDA kernels themselves are held against the plain versions on the
card (``tests/test_torch_gpu.py`` and ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.index import base as ref_base
from repro.kernels import batched_search as ref_bs
from repro.kernels import stages as ref_stages
from repro_torch.kernels import ops
from repro_torch.kernels import stages

RTOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _problem(seed, n, nq, K, m, d=16, num_fast=2, dup=True):
    """Queries, stored codes (some rows duplicated: exact ties), the
    reference's LUTs and the fast mask, as numpy."""
    rng = np.random.default_rng(seed)
    C = (rng.standard_normal((K, m, d)) / np.sqrt(K)).astype(np.float32)
    codes = rng.integers(0, m, size=(n, K)).astype(np.uint8)
    if dup:
        codes[n // 2:n // 2 + 7] = codes[3]
        codes[-5:] = codes[1]
    q = rng.standard_normal((nq, d), dtype=np.float32)
    fast = np.zeros((K,), bool)
    fast[:num_fast] = True
    luts = np.asarray(ref_base.build_lut(jnp.asarray(q), jnp.asarray(C)))
    return codes, luts, fast


def _stored(codes, K, code_bits):
    if code_bits == 4:
        from repro.core.encode import pack_nibbles
        return np.asarray(pack_nibbles(jnp.asarray(codes), K))
    return codes


def _atol(luts):
    return RTOL * luts.shape[1] * float(np.abs(luts).max())


def _assert_topk(got_v, got_i, want_v, want_i, atol):
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=RTOL,
                               atol=atol)


CRUDE_CASES = [(lut, bits, want)
               for lut in ("f32", "int8") for bits in (8, 4)
               for want in (True, False)]


@pytest.mark.parametrize("lut_dtype,code_bits,want_crude", CRUDE_CASES)
def test_crude_plain_matches_pallas(lut_dtype, code_bits, want_crude):
    """Non-divisible n and nq, odd K under the nibble format, duplicated
    code rows (exact ties: the lowest index must win)."""
    K, m = (7, 16) if code_bits == 4 else (8, 256)
    codes, luts, fast = _problem(11 + code_bits, 1037, 13, K, m)
    stored = _stored(codes, K, code_bits)
    lut_flat, scale, offset = ref_stages.crude_lut_operands(
        jnp.asarray(luts), jnp.asarray(fast),
        quantized=lut_dtype == "int8", code_bits=code_bits)
    want = ref_bs.crude_topk_pallas(
        jnp.asarray(stored), lut_flat, scale, offset, topk=20,
        interpret=True, want_crude=want_crude, code_bits=code_bits)
    got = ops.batched_crude_topk(
        _t(stored), _t(lut_flat), 20, want_crude=want_crude,
        lut_scale=None if scale is None else _t(scale),
        lut_offset=None if offset is None else _t(offset),
        code_bits=code_bits)
    if want_crude:
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=RTOL, atol=_atol(luts))
        jnp_stage = ref_stages.CrudeStage(
            backend="jnp", quantized=lut_dtype == "int8", code_bits=code_bits)
        jnp_crude = jnp_stage(jnp.asarray(stored), jnp.asarray(luts),
                              jnp.asarray(fast)).crude
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(jnp_crude))
    else:
        assert got[0] is None and want[0] is None
    _assert_topk(got[1], got[2], want[1], want[2], _atol(luts))


def _survivors(crude, survivors):
    """(crude, thresholds) of one refine regime: many survivors, fewer
    than topk, none, all (thr = +inf), or a few only in the last
    1024-point chunk of a ragged n (the other points' crude raised far
    above the threshold, so the +inf tail holds the lowest of them)."""
    nq = crude.shape[0]
    if survivors == "none":
        return crude, np.full((nq,), -np.inf, np.float32)
    if survivors == "all":
        return crude, np.full((nq,), np.inf, np.float32)
    if survivors == "last_chunk":
        crude = crude.copy()
        crude[:, :1024] = np.abs(crude[:, :1024]) + 1e6
    rank = {"many": 300, "fewer_than_topk": 6, "last_chunk": 10}[survivors]
    return crude, np.sort(crude, axis=1)[:, rank].astype(np.float32)


@pytest.mark.parametrize("code_bits", [8, 4])
@pytest.mark.parametrize("survivors", ["many", "fewer_than_topk", "none",
                                       "all", "last_chunk"])
def test_refine_plain_matches_pallas(code_bits, survivors):
    """The margin test, slow sum and top-k of survivors; with fewer
    survivors than topk the +inf tail carries the lowest pruned ids,
    with none the top-k is (+inf, 0..topk-1)."""
    K, m = (7, 16) if code_bits == 4 else (8, 256)
    codes, luts, fast = _problem(21 + code_bits, 1100, 11, K, m)
    stored = _stored(codes, K, code_bits)
    lut_flat, _, _ = ref_stages.crude_lut_operands(
        jnp.asarray(luts), jnp.asarray(fast), quantized=False,
        code_bits=code_bits)
    crude, _, _ = ref_bs.crude_topk_pallas(
        jnp.asarray(stored), lut_flat, topk=20, interpret=True,
        code_bits=code_bits)
    crude, thr = _survivors(np.asarray(crude), survivors)
    lut_slow = ref_stages.slow_lut_operand(jnp.asarray(luts),
                                           jnp.asarray(fast),
                                           code_bits=code_bits)
    want_v, want_i = ref_bs.refine_topk_pallas(
        jnp.asarray(stored), lut_slow, jnp.asarray(crude), jnp.asarray(thr),
        topk=20, interpret=True, code_bits=code_bits)
    got_v, got_i = ops.batched_refine_topk(
        _t(stored), _t(lut_slow), _t(crude), _t(thr), 20,
        code_bits=code_bits)
    _assert_topk(got_v, got_i, want_v, want_i, _atol(luts))
    jnp_i, jnp_v, _ = ref_stages.RefineStage(backend="jnp", topk=20,
                                             code_bits=code_bits)(
        jnp.asarray(stored), jnp.asarray(luts), jnp.asarray(crude),
        jnp.asarray(thr), jnp.asarray(fast))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(jnp_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(jnp_v))
    tail = {"fewer_than_topk": 6, "last_chunk": 10, "none": 0}
    if survivors in tail:
        assert np.isinf(got_v.numpy()[:, tail[survivors]:]).all()
    if survivors == "last_chunk":
        assert (got_i.numpy()[:, :10] >= 1024).all()
        np.testing.assert_array_equal(got_i.numpy()[:, 10:],
                                      np.tile(np.arange(10), (11, 1)))
    if survivors == "none":
        np.testing.assert_array_equal(got_i.numpy(),
                                      np.tile(np.arange(20), (11, 1)))
    if survivors == "all":
        assert np.isfinite(got_v.numpy()).all()


def test_topk_two_key_tie_order():
    """Equal distances rank by ascending index, and the +inf tail holds
    the lowest indices among the +inf columns."""
    inf = float("inf")
    ranked = torch.tensor([[3.0, inf, 1.0, 3.0, inf, 1.0, inf]])
    vals, idx = stages.topk_two_key(ranked, 6)
    assert idx.tolist() == [[2, 5, 0, 3, 1, 4]]
    assert vals.tolist() == [[1.0, 1.0, 3.0, 3.0, inf, inf]]
    want_v, want_i = jax.lax.top_k(-jnp.asarray(ranked.numpy()), 6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("quantized", [False, True])
def test_threshold_bootstrap_matches_reference(quantized):
    """``from_candidates`` and ``from_dense`` against the reference's on
    the same LUTs and crude top-k."""
    K, m = 8, 256
    codes, luts, fast = _problem(5, 900, 9, K, m)
    sigma = np.float32(0.5)
    lut_flat, scale, offset = ref_stages.crude_lut_operands(
        jnp.asarray(luts), jnp.asarray(fast), quantized=quantized)
    crude, vals, idx = ref_bs.crude_topk_pallas(
        jnp.asarray(codes), lut_flat, scale, offset, topk=12,
        interpret=True)
    ref_t = ref_stages.ThresholdStage(topk=12, quantized=quantized)
    port_t = stages.ThresholdStage(topk=12, quantized=quantized)
    want = ref_t.from_candidates(jnp.asarray(luts), jnp.asarray(codes),
                                 vals, idx, jnp.asarray(fast), sigma)
    got = port_t.from_candidates(_t(luts), _t(codes), _t(vals), _t(idx),
                                 _t(fast), _t(sigma))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=_atol(luts))
    want = ref_t.from_dense(jnp.asarray(luts), jnp.asarray(codes),
                            crude, jnp.asarray(fast), sigma)
    got = port_t.from_dense(_t(luts), _t(codes), _t(crude), _t(fast),
                            _t(sigma))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=_atol(luts))


def test_wrappers_reject_bad_operands():
    codes, luts, fast = _problem(2, 300, 4, 8, 256)
    lut_flat = _t(luts.reshape(4, -1))
    with pytest.raises(ValueError, match="lut_scale"):
        ops.batched_crude_topk(_t(codes), lut_flat.to(torch.int8), 5)
    with pytest.raises(ValueError, match="not a multiple"):
        ops.batched_crude_topk(_t(codes), lut_flat[:, :-3], 5)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.batched_crude_topk(_t(codes).to("meta"), lut_flat, 5)
