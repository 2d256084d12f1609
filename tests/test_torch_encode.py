"""The port's encoder held against the reference's.

The same numpy inputs (made from a seed; the codebooks of problem (a)
are the reference's residual k-means on them) go through the port's
``icm_encode`` (its plain version on CPU tensors) and the reference's
encoders.  Codes must be exactly equal: to ``icm_encode(backend="jnp")``,
to ``icm_encode_pallas`` in interpret mode and to the cross-Gram oracle
``kernels/ref.py::icm_encode_gram`` on problem (a) (n = 517, d = 16,
K = 4, m = 16), and to the jnp backend on problem (b) (2048 x 128,
K = 8, m = 256).  Both packages sum the same dot products in their own
BLAS order, so a code may only differ at a near tie; the assertion
reports such rows with the gap between their two best scores.

``encode_database`` must equal the reference's in dtype and value
(ragged last chunk, uint8, 4-bit nibble rows, ``mode="pq"``).

The CUDA kernel itself is held against the plain version on the card
(``tests/test_torch_gpu.py`` and ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.core import codebooks as ref_cb
from repro.core import encode as ref_enc
from repro.kernels.icm_encode import icm_encode_pallas
from repro.kernels.ref import icm_encode_gram
from repro.trainer.encode import encode_database as ref_encode_database
from repro_torch.core import codebooks as port_cb
from repro_torch.core import encode as port_enc
from repro_torch.index.flat import TwoStep
from repro_torch.kernels import ops
from repro_torch.kernels.icm_encode import icm_encode_torch
from repro_torch.trainer import encode_database


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def problem_a():
    """n = 517 (ragged against every block), d = 16 with per-dimension
    scales, K = 4, m = 16 residual k-means codebooks."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((517, 16))
         * np.linspace(0.2, 3.0, 16)).astype(np.float32)
    C = np.asarray(ref_cb.init_residual(jax.random.PRNGKey(0),
                                        jnp.asarray(x), 4, 16, iters=5))
    return x, C


@pytest.fixture(scope="module")
def problem_b():
    """2048 points at SIFT1M width: d = 128, K = 8, m = 256; x is a
    random additive code plus noise."""
    rng = np.random.default_rng(1)
    C = (rng.standard_normal((8, 256, 128)) / np.sqrt(8)).astype(np.float32)
    codes = rng.integers(0, 256, size=(2048, 8))
    x = (C[np.arange(8), codes].sum(1)
         + 0.3 * rng.standard_normal((2048, 128))).astype(np.float32)
    return x, C


def _assert_same_codes(got, want, x, C):
    """Equal codes; a differing row is reported with the gap between the
    two best scores of its first differing codebook step (the first
    sweep's, recomputed in float64), which must be a near tie."""
    got, want = np.asarray(got), np.asarray(want)
    rows = np.flatnonzero((got != want).any(1))
    if rows.size:
        r = rows[0]
        Cd = C.astype(np.float64)
        recon = Cd[np.arange(C.shape[0]), want[r]].sum(0)
        k = int(np.flatnonzero(got[r] != want[r])[0])
        t = x[r].astype(np.float64) - (recon - Cd[k, want[r, k]])
        s = np.sort((Cd[k] ** 2).sum(1) - 2.0 * Cd[k] @ t)
        size = float((t ** 2).sum() + (Cd[k] ** 2).sum(1).max())
        raise AssertionError(
            f"{rows.size} rows differ; row {r} codebook {k}: best two "
            f"scores {s[0]} and {s[1]} (gap {s[1] - s[0]:.3g}, terms' "
            f"size {size:.3g})")


def _port_icm(x, C, iters=3, **kw):
    return port_enc.icm_encode(_t(x), _t(C), iters, **kw).numpy()


# ------------------------------------------------------ encoder parity ----

@pytest.mark.parametrize("oracle", ["jnp", "pallas-interpret", "gram"])
def test_icm_codes_equal_reference_small(problem_a, oracle):
    x, C = problem_a
    xj, Cj = jnp.asarray(x), jnp.asarray(C)
    if oracle == "jnp":
        want = ref_enc.icm_encode(xj, Cj, 3, backend="jnp")
    elif oracle == "pallas-interpret":
        want = icm_encode_pallas(xj, ref_enc.encode_pq(xj, Cj), Cj, iters=3,
                                 block_n=128, interpret=True)
    else:
        want = icm_encode_gram(xj, Cj, 3)
    got = _port_icm(x, C)
    assert got.dtype == np.int32
    _assert_same_codes(got, want, x, C)


@pytest.mark.parametrize("iters", [1, 3])
def test_icm_codes_equal_reference_sift_width(problem_b, iters):
    x, C = problem_b
    want = ref_enc.icm_encode(jnp.asarray(x), jnp.asarray(C), iters,
                              backend="jnp")
    _assert_same_codes(_port_icm(x, C, iters), want, x, C)


def test_encode_pq_equals_reference(problem_b):
    x, C = problem_b
    want = ref_enc.encode_pq(jnp.asarray(x), jnp.asarray(C))
    _assert_same_codes(port_enc.encode_pq(_t(x), _t(C)).numpy(), want, x, C)


# --------------------------------------------------- engine invariants ----

def test_icm_warm_start_equivalence(problem_a):
    """The default warm start is the PQ assignment; one sweep resumed by
    two equals three."""
    x, C = problem_a
    default = _port_icm(x, C, 3)
    explicit = _port_icm(x, C, 3, init_codes=port_enc.encode_pq(_t(x), _t(C)))
    np.testing.assert_array_equal(explicit, default)
    one = _port_icm(x, C, 1)
    np.testing.assert_array_equal(
        _port_icm(x, C, 2, init_codes=_t(one)), default)
    # the reference resumed from the same codes
    ref = ref_enc.icm_encode(jnp.asarray(x), jnp.asarray(C), 2,
                             init_codes=jnp.asarray(one), backend="jnp")
    _assert_same_codes(default, ref, x, C)


@pytest.mark.parametrize("point_chunk", [128, 100, 516])
def test_icm_point_chunk_invariance(problem_a, point_chunk):
    """Chunked blocks, the ragged tail zero-padded, give the same codes,
    with or without given warm-start codes."""
    x, C = problem_a
    full = _port_icm(x, C, 3)
    np.testing.assert_array_equal(_port_icm(x, C, 3, point_chunk=point_chunk),
                                  full)
    init = port_enc.encode_pq(_t(x), _t(C))
    np.testing.assert_array_equal(
        _port_icm(x, C, 3, init_codes=init, point_chunk=point_chunk), full)


def test_icm_pq_codebooks_reduce_to_pq():
    """Orthogonal supports (codebook k lives on dims 4k .. 4k+3): the
    interactions vanish and ICM equals the independent assignment."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((300, 16)).astype(np.float32)
    C = np.zeros((4, 8, 16), np.float32)
    for k in range(4):
        C[k, :, 4 * k:4 * k + 4] = rng.standard_normal((8, 4))
    pq = port_enc.encode_pq(_t(x), _t(C)).numpy()
    np.testing.assert_array_equal(_port_icm(x, C, 3), pq)
    np.testing.assert_array_equal(
        pq, np.asarray(ref_enc.encode_pq(jnp.asarray(x), jnp.asarray(C))))


def test_icm_objective_never_rises_per_sweep(problem_a):
    x, C = problem_a
    xt, Ct = _t(x), _t(C)
    init = port_enc.encode_pq(xt, Ct)
    errs = []
    for iters in range(5):
        codes = ops.icm_encode(xt, init, Ct, iters=iters)
        if iters == 0:
            assert torch.equal(codes, init)
        err = torch.sum(torch.square(xt - port_cb.decode(Ct, codes)), 1)
        errs.append(err)
    for a, b in zip(errs, errs[1:]):
        # per point: each step takes the best codeword given the others
        assert bool((b <= a + 1e-4 * a.max()).all())
        assert float(b.mean()) <= float(a.mean())


def test_duplicated_codewords_take_the_first_index(problem_a):
    """Exact ties: the second half of every codebook repeats the first,
    and the warm start points anywhere; every step must take the first
    index of the minimum."""
    x, C = problem_a
    C = C.copy()
    C[:, 8:] = C[:, :8]
    rng = np.random.default_rng(3)
    init = _t(rng.integers(0, 16, size=(x.shape[0], 4)).astype(np.int32))
    codes = icm_encode_torch(_t(x), init, _t(C), iters=1)
    assert int(codes.max()) < 8


# ------------------------------------------------------ encode_database ----

DB_CASES = {
    "icm-ragged-uint8": dict(mode="icm", icm_iters=2, chunk=200),
    "icm-one-chunk-int32": dict(mode="icm", icm_iters=3, chunk=517,
                                pack=False),
    "icm-4bit-nibbles": dict(mode="icm", icm_iters=3, chunk=128,
                             code_bits=4),
    "pq-ragged": dict(mode="pq", chunk=100),
}


@pytest.mark.parametrize("case", sorted(DB_CASES))
def test_encode_database_equals_reference(problem_a, case):
    x, C = problem_a
    kw = DB_CASES[case]
    want = np.asarray(ref_encode_database(jnp.asarray(x), jnp.asarray(C),
                                          **kw))
    got = encode_database(x, C, device="cpu", **kw).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # torch input and an embedder give the same codes
    again = encode_database(_t(x) / 2.0, _t(C), device="cpu",
                            embed_apply=lambda p, t: t * p,
                            embed_params=2.0, **kw).numpy()
    np.testing.assert_array_equal(again, got)


def test_encode_database_rejects_bad_options(problem_a):
    x, C = problem_a
    with pytest.raises(ValueError, match="mode"):
        encode_database(x, C, mode="opq", device="cpu")
    with pytest.raises(ValueError, match="pack=True"):
        encode_database(x, C, code_bits=4, pack=False, device="cpu")
    wide = np.zeros((4, 32, 16), np.float32)
    with pytest.raises(ValueError, match="m=32"):
        encode_database(x, wide, code_bits=4, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            encode_database(x, C)


# ---------------------------------------------------------- no fallback ----

def test_jnp_backend_refused_on_a_cuda_device():
    """``backend="jnp"`` names the plain version, which never runs on a
    CUDA device: ``icm_encode``, ``encode_database`` and ``Index.add``
    raise before any work (fake CUDA tensors, no card needed)."""
    with FakeTensorMode():
        x = torch.empty((10, 16), device="cuda")
        C = torch.empty((4, 16, 16), device="cuda")
        with pytest.raises(ValueError, match="jnp"):
            port_enc.icm_encode(x, C, 3, backend="jnp")
        with pytest.raises(ValueError, match="jnp"):
            encode_database(x, C, backend="jnp", device="cuda")
        index = TwoStep(codes=torch.empty((10, 4), dtype=torch.uint8,
                                          device="cuda"), C=C)
        with pytest.raises(ValueError, match="jnp"):
            index.add(x, encode_backend="jnp")
