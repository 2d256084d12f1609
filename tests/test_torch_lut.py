"""The port's LUT math and code formats against the reference's.

``build_lut`` agrees to rtol 1e-5 (the two frameworks order the einsum
differently).  Given the same LUT, everything downstream is exact:
``lut_sum`` bitwise, ``quantize_lut`` in (q, scale, bias),
``nibble_lut_sum`` and the pack/unpack round trips.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codebooks as ref_cb
from repro.core import encode as ref_enc
from repro.index import base as ref_base
from repro_torch.core import codebooks as cb
from repro_torch.core import encode as enc
from repro_torch.index import base


def _t(a):
    return torch.from_numpy(np.array(a))


def _lut_problem(seed, nq=9, n=301, K=8, m=256, d=16):
    rng = np.random.default_rng(seed)
    C = (rng.standard_normal((K, m, d)) / np.sqrt(K)).astype(np.float32)
    q = rng.standard_normal((nq, d), dtype=np.float32)
    codes = rng.integers(0, m, size=(n, K)).astype(np.int32)
    fast = np.zeros((K,), bool)
    fast[:2] = True
    luts = np.asarray(ref_base.build_lut(jnp.asarray(q), jnp.asarray(C)))
    return q, C, codes, fast, luts


@pytest.mark.parametrize("single", [False, True])
def test_build_lut_close_to_reference(single):
    q, C, _, _, _ = _lut_problem(0)
    q = q[0] if single else q
    want = np.asarray(ref_base.build_lut(jnp.asarray(q), jnp.asarray(C)))
    got = base.build_lut(_t(q), _t(C)).numpy()
    # the einsum orders differ; entries near zero move by up to ~2e-6
    # absolute, so the atol is 1e-6 of the table's largest magnitude
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))
    np.testing.assert_allclose(cb.codeword_sq_norms(_t(C)).numpy(),
                               np.asarray(ref_cb.codeword_sq_norms(
                                   jnp.asarray(C))), rtol=1e-6)


@pytest.mark.parametrize("shape", ["shared", "per_query", "single"])
@pytest.mark.parametrize("masked", [False, True])
def test_lut_sum_bitwise(shape, masked):
    _, _, codes, fast, luts = _lut_problem(1)
    mask = fast if masked else None
    if shape == "per_query":
        codes = codes[:9 * 20].reshape(9, 20, -1)
    if shape == "single":
        luts = luts[0]
    want = ref_base.lut_sum(jnp.asarray(luts), jnp.asarray(codes),
                            None if mask is None else jnp.asarray(mask))
    got = base.lut_sum(_t(luts), _t(codes), None if mask is None
                       else _t(mask))
    if shape == "shared":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        # the reference sums these shapes with jnp.sum, whose order is
        # XLA's; the port keeps codebook order for every shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_quantize_lut_and_int8_sum_exact(masked):
    _, _, codes, fast, luts = _lut_problem(2)
    mask = fast if masked else None
    ref_q = ref_base.quantize_lut(jnp.asarray(luts),
                                  None if mask is None else jnp.asarray(mask))
    got_q = base.quantize_lut(_t(luts), None if mask is None else _t(mask))
    for g, w in zip(got_q, ref_q):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = ref_base.lut_sum(ref_q, jnp.asarray(codes),
                            None if mask is None else jnp.asarray(mask))
    got = base.lut_sum(got_q, _t(codes), None if mask is None else _t(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for g, w in zip(
            base.quantized_kernel_operands(_t(luts), None if mask is None
                                           else _t(mask)),
            ref_base.quantized_kernel_operands(
                jnp.asarray(luts), None if mask is None
                else jnp.asarray(mask))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_quantize_rounds_half_to_even():
    lut = torch.tensor([[0.0, 0.5, 1.5, 2.5, 255.0]])
    want = ref_base.quantize_lut(jnp.asarray(lut.numpy()))
    got = base.quantize_lut(lut)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))


@pytest.mark.parametrize("K", [8, 7])
@pytest.mark.parametrize("quantized", [False, True])
def test_nibble_lut_sum_and_fastscan_operands(K, quantized):
    _, _, codes, fast, luts = _lut_problem(3, K=K, m=16)
    packed = np.asarray(ref_enc.pack_nibbles(jnp.asarray(codes), K))
    lut_r = (ref_base.quantize_lut(jnp.asarray(luts), jnp.asarray(fast))
             if quantized else jnp.asarray(luts))
    lut_p = (base.quantize_lut(_t(luts), _t(fast)) if quantized
             else _t(luts))
    want = ref_base.nibble_lut_sum(lut_r, jnp.asarray(packed), K,
                                   jnp.asarray(fast))
    got = base.nibble_lut_sum(lut_p, _t(packed), K, _t(fast))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for g, w in zip(base.fastscan_kernel_operands(_t(luts), _t(fast)),
                    ref_base.fastscan_kernel_operands(jnp.asarray(luts),
                                                      jnp.asarray(fast))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        base.pad_luts_even(_t(luts)).numpy(),
        np.asarray(ref_base.pad_luts_even(jnp.asarray(luts))))


@pytest.mark.parametrize("K", [1, 6, 7])
def test_code_formats_round_trip(K):
    rng = np.random.default_rng(K)
    codes = rng.integers(0, 16, size=(33, K)).astype(np.int32)
    want = np.asarray(ref_enc.pack_nibbles(jnp.asarray(codes), K))
    got = enc.pack_nibbles(_t(codes), K)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(enc.unpack_nibbles(got, K).numpy(), codes)
    wide = rng.integers(0, 300, size=(5, K)).astype(np.int32)
    assert enc.pack_codes(_t(codes), 256).dtype == torch.uint8
    assert enc.pack_codes(_t(wide), 300).dtype == torch.int32
    np.testing.assert_array_equal(
        enc.unpack_codes(enc.pack_codes(_t(wide), 300)).numpy(), wide)
    C = rng.standard_normal((K, 16, 4)).astype(np.float32)
    np.testing.assert_allclose(
        cb.decode(_t(C), _t(codes)).numpy(),
        np.asarray(ref_cb.decode(jnp.asarray(C), jnp.asarray(codes))),
        rtol=1e-6, atol=1e-6)


def test_chunked_over_queries_pads_and_slices():
    calls = []

    def fn(qs):
        calls.append(qs.shape[0])
        return qs.sum(dim=1), qs[:, :2]

    q = torch.arange(30, dtype=torch.float32).reshape(10, 3)
    s, head = base.chunked_over_queries(fn, q, 4)
    assert calls == [4, 4, 4]
    np.testing.assert_array_equal(s.numpy(), q.sum(dim=1).numpy())
    np.testing.assert_array_equal(head.numpy(), q[:, :2].numpy())


def test_backend_and_device_resolution():
    cpu = torch.device("cpu")
    assert base.resolve_backend("auto", cpu) == "torch"
    assert base.resolve_backend("pallas", cpu) == "torch"
    assert base.resolve_backend("jnp", cpu) == "torch"
    assert base.resolve_backend("pallas", torch.device("cuda")) == "cuda"
    assert base.resolve_backend("auto", torch.device("cuda")) == "cuda"
    # jnp on the card: the kernels with the jnp engine's options
    assert base.resolve_backend("jnp", torch.device("cuda")) == "cuda-jnp"
    # the encoder has no jnp-engine options: jnp names its plain sweep
    assert base.resolve_encode_backend("jnp", cpu) == "torch"
    assert base.resolve_encode_backend("auto", torch.device("cuda")) == "cuda"
    with pytest.raises(ValueError, match="encode.backend"):
        base.resolve_encode_backend("jnp", torch.device("cuda"))
    with pytest.raises(ValueError, match="unknown search backend"):
        base.resolve_backend("triton", cpu)
    assert base.resolve_device("cpu") == cpu
