"""The arithmetic of the flash backward kernels' two bodies, emulated
on the CPU (no kernel runs here).

``csrc/flash_attention_bwd.cu`` runs every product on ``mma.sync``
tensor cores: in bf16 with bf16 operands and f32 sums, P rounded to bf16
before dV += P^T dO and dS rounded to bf16 before it multiplies K (dq)
or Q (dk); in f32 with the 3xTF32 split of both operands (hi = x
rounded to TF32 by ``cvt.rna``, lo = x - hi rounded again, a . b as
lo_a hi_b + hi_a lo_b + hi_a hi_b in f32).  ``emulate_bwd`` does those
roundings in torch, one (batch, head) at a time.  It models the
operands' roundings only, not the order of the sums: each product is one
f32 matmul over the whole key or query range, where the tensor cores
accumulate with truncation, the f32 body sums each tile's product from
zero and adds it in f32 (``mma_add``), and the exponential is
``ex2.approx``; those show only on the card (``tests/test_torch_gpu.py``
holds a 16,384-query dK sum).  Each body's
gradients are held with ``chip_smoke.py`` phase 7's rule (each gradient
within 2e-5 (f32) / 2e-2 (bf16) of its own largest magnitude; a
gradient whose largest magnitude is below that tolerance of the whole
gradient's is rounding noise and is held to the whole gradient's
scale) against the plain backward ``flash_attention_bwd_torch`` and
against ``jax.vjp`` of the reference's ``chunked_attention`` (the
tolerances of ``tests/test_torch_flash_grad.py``), on small versions of
phase 7's modes (against the reference, three modes that combine
them), and with a query offset and a mask operand (rows that see no
key: no gradient to q or k, dO / sk to every key's dV, 1 / sk rounded to
the body's type) against the plain backward and ``jax.vjp`` of the
reference's ``full_attention(q_offset=, mask=)``.  One-pass TF32, which
the f32 body does not use, misses the f32 gate.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attn
from repro_torch.index.base import full_f32_matmul
from repro_torch.kernels import flash_attention as fa

TOL = {"bf16": 2e-2, "f32": 2e-5}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}

# (b, sq, sk, H, KVH, dqk, dv, causal, window, kv_valid, chunk): GQA, MQA,
# sq > sk causal, MLA's (192, 128), window 1, one valid key, and a length
# ragged against the kernels' 64- and 32-row tiles; chunk is the
# reference's (it divides sq and sk)
MODES = {
    "gqa": (1, 40, 40, 4, 2, 32, 32, True, 0, 0, 20),
    "mqa": (1, 24, 48, 4, 1, 32, 32, False, 0, 0, 24),
    "sq>sk causal": (1, 40, 20, 2, 2, 32, 32, True, 0, 0, 20),
    "(192, 128)": (1, 16, 16, 2, 2, 192, 128, True, 0, 0, 16),
    "window 1": (1, 24, 24, 2, 1, 32, 32, True, 1, 0, 12),
    "one valid key": (1, 16, 32, 2, 2, 32, 32, False, 0, 1, 16),
    "ragged": (1, 70, 70, 2, 1, 32, 32, True, 0, 0, 35),
}
# against the reference, three modes a body that combine them (each takes
# a ~1 s compile of the reference's backward, less with one chunk);
# window 1 stands alone, as it makes dq and dk rounding noise
REFERENCE_MODES = {
    "gqa, ragged, sq>sk causal, (192, 128)":
        (1, 70, 35, 4, 2, 192, 128, True, 0, 0, 35),
    "mqa, one valid key": (1, 16, 32, 4, 1, 32, 32, False, 0, 1, 32),
    "window 1": (1, 24, 24, 2, 1, 32, 32, True, 1, 0, 24),
}


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on the int32 view: round the 13 dropped
    mantissa bits to nearest, ties away from zero, and clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def mm_3xtf32(a, b):
    """a @ b as the f32 body's mma.sync steps take it."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    with full_f32_matmul():
        return (al @ bh + ah @ bl) + ah @ bh


def mm_tf32(a, b):
    """One-pass TF32 (not used by any body)."""
    with full_f32_matmul():
        return _tf32(a) @ _tf32(b)


def mm_f32(a, b):
    with full_f32_matmul():
        return a @ b


def emulate_bwd(q, k, v, o, do, lse, body, *, causal=True, window=0,
                kv_valid=0, q_offset=0, mask=None, mm=None):
    """(dq, dk, dv) as body ``"bf16"`` or ``"f32"`` computes them, from
    the forward's output and log-sum-exp; ``mm`` replaces the f32 body's
    products (a one-pass TF32 control)."""
    b, sq, sk, H, KVH, dqk, dv = fa._shapes(q, k, v, causal, window,
                                            kv_valid, q_offset, mask)
    g = H // KVH
    scale = dqk ** -0.5
    bf16 = body == "bf16"
    mm = mm or (mm_f32 if bf16 else mm_3xtf32)
    rnd = (lambda x: x.to(torch.bfloat16).float()) if bf16 else (
        lambda x: x)
    visible = fa._visible(sq, sk, causal, window, kv_valid, "cpu", q_offset)
    if mask is not None:
        mask = fa._mask_view(mask, b, H, sq, sk, "cpu")
    dq = torch.empty((b, sq, H, dqk))
    dk = torch.zeros((b, sk, KVH, dqk))
    dvv = torch.zeros((b, sk, KVH, dv))
    for bi in range(b):
        for h in range(H):
            qf, kf = q[bi, :, h].float(), k[bi, :, h // g].float()
            vf, dof = v[bi, :, h // g].float(), do[bi, :, h].float()
            s = mm(qf, kf.T)
            keep = visible if mask is None else visible & mask[bi, h]
            p = torch.where(keep, torch.exp(s * scale - lse[bi, h][:, None]),
                            torch.zeros_like(s))
            d = (dof * o[bi, :, h].float()).sum(dim=1, keepdim=True)
            empty = (lse[bi, h] < fa.NEG_INF / 2)[:, None]
            pv = torch.where(empty, torch.full_like(p, 1.0 / sk), p)
            dvv[bi, :, h // g] += mm(rnd(pv).T.contiguous(), dof)
            ds = rnd(p * (mm(dof, vf.T) - d))
            dq[bi, :, h] = mm(ds, kf) * scale
            dk[bi, :, h // g] += mm(ds.T.contiguous(), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dvv.to(v.dtype)


def phase7_ratios(got, want, tol):
    """Each gradient's max error over its bound under phase 7's rule."""
    peaks = [float(w.abs().max()) for w in want]
    whole = max(1e-30, max(peaks))
    bounds = [tol * (whole if p < tol * whole else p) for p in peaks]
    return [float((x - w).abs().max()) / bd
            for x, w, bd in zip(got, want, bounds)]


def _case(mode, body, modes=MODES):
    b, sq, sk, h, kvh, dqk, dv, causal, window, kv_valid, _ = modes[mode]
    rng = np.random.default_rng(sq + sk + dqk + window + kv_valid)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(DTYPES[body])
        for s in ((b, sq, h, dqk), (b, sk, kvh, dqk), (b, sk, kvh, dv),
                  (b, sq, h, dv)))
    masks = dict(causal=causal, window=window, kv_valid=kv_valid)
    o, lse = fa.flash_attention_torch(q, k, v, with_lse=True, **masks)
    return (q, k, v, o, do, lse), masks


@pytest.mark.parametrize("body", ["bf16", "f32"])
@pytest.mark.parametrize("mode", list(MODES))
def test_body_arithmetic_matches_plain_backward(mode, body):
    args, masks = _case(mode, body)
    got = emulate_bwd(*args, body, **masks)
    want = fa.flash_attention_bwd_torch(*args, **masks)
    for x, w in zip(got, want):
        assert x.dtype == w.dtype == DTYPES[body] and x.shape == w.shape
    ratios = phase7_ratios([x.float() for x in got],
                           [w.float() for w in want], TOL[body])
    assert max(ratios) <= 1.0, (mode, body, ratios)


@pytest.mark.parametrize("body", ["bf16", "f32"])
@pytest.mark.parametrize("mode", list(REFERENCE_MODES))
def test_body_arithmetic_matches_reference_chunked_attention(mode, body):
    args, masks = _case(mode, body, REFERENCE_MODES)
    q, k, v, _, do, _ = args
    chunk = REFERENCE_MODES[mode][-1]
    jd = jnp.bfloat16 if body == "bf16" else jnp.float32

    def to_jax(t):
        return jnp.asarray(t.float().numpy(), jd)

    def ref_grads(q_, k_, v_, do_):
        return jax.vjp(lambda *t: ref_attn.chunked_attention(
            *t, chunk=chunk, **masks), q_, k_, v_)[1](do_)
    # the compile is this test's cost and the run is tiny: no LLVM
    # optimisation (a third less time; the arithmetic is the same IEEE f32)
    jargs = [to_jax(t) for t in (q, k, v, do)]
    compiled = jax.jit(ref_grads).lower(*jargs).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    want = [torch.tensor(np.asarray(w.astype(jnp.float32)))
            for w in compiled(*jargs)]
    got = [x.float() for x in emulate_bwd(*args, body, **masks)]
    ratios = phase7_ratios(got, want, TOL[body])
    assert max(ratios) <= 1.0, (mode, body, ratios)


def test_one_pass_tf32_misses_the_f32_gate():
    """The f32 body's split is needed: one-pass TF32 products put some
    mode's gradient past 2e-5 of its largest magnitude, where 3xTF32
    stays within it."""
    worst = {}
    for mode in MODES:
        args, masks = _case(mode, "f32")
        want = [w.float() for w in fa.flash_attention_bwd_torch(*args,
                                                                **masks)]
        one = emulate_bwd(*args, "f32", mm=mm_tf32, **masks)
        three = emulate_bwd(*args, "f32", **masks)
        worst[mode] = (max(phase7_ratios(one, want, TOL["f32"])),
                       max(phase7_ratios(three, want, TOL["f32"])))
    assert max(one for one, _ in worst.values()) > 1.0, worst
    assert max(three for _, three in worst.values()) <= 1.0, worst


def test_tf32_rounding_is_cvt_rna():
    """``_tf32`` keeps 10 mantissa bits, rounds to nearest with ties away
    from zero (both signs), and the split is exact: hi + lo == x to the
    rounding of lo."""
    one = 1.0 + 2.0 ** -10
    half_ulp = 2.0 ** -11
    x = torch.tensor([one, 1.0 + half_ulp, -(1.0 + half_ulp),
                      1.0 + half_ulp / 2, 3.0 * 2.0 ** -130])
    want = torch.tensor([one, one, -one, 1.0, 3.0 * 2.0 ** -130])
    assert torch.equal(_tf32(x), want)
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1000).astype(np.float32))
    hi, lo = _split(y)
    assert torch.equal(_tf32(hi), hi) and torch.equal(_tf32(lo), lo)
    assert float(((hi.double() + lo.double()) - y.double()).abs().max()
                 / y.abs().max()) < 2.0 ** -21


# the query offset and the mask operand: (b, sq, sk, H, KVH, dqk, dv,
# causal, window, q_offset, mask shape): the triangular scan's sk - sq, a
# negative offset (rows 0-8 see no key), a window with sq > sk, a (sq, sk)
# mask and a (b, H, sq, sk) one at MLA's widths with fully masked rows
OFFSET_MASK_MODES = {
    "offset sk - sq": (1, 24, 56, 4, 2, 32, 32, True, 0, 32, None),
    "negative offset": (1, 40, 30, 2, 1, 32, 32, True, 0, -9, None),
    "window, sq > sk": (1, 48, 24, 2, 2, 32, 32, True, 10, 5, None),
    "mask (sq, sk)": (2, 20, 36, 4, 2, 32, 32, False, 0, 0, "qk"),
    "mask (b, H), (192, 128)": (1, 24, 24, 2, 2, 192, 128, True, 0, 0,
                                "heads"),
}


def _offset_mask_case(mode, body):
    b, sq, sk, h, kvh, dqk, dv, causal, window, q_offset, kind = \
        OFFSET_MASK_MODES[mode]
    rng = np.random.default_rng(sq + sk + dqk + window + q_offset)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(DTYPES[body])
        for s in ((b, sq, h, dqk), (b, sk, kvh, dqk), (b, sk, kvh, dv),
                  (b, sq, h, dv)))
    mask = None
    if kind:
        shape = (sq, sk) if kind == "qk" else (b, h, sq, sk)
        mask = torch.from_numpy(rng.random(shape) > 0.4)
        mask[..., [2, sq - 1], :] = False
    masks = dict(causal=causal, window=window, q_offset=q_offset, mask=mask)
    o, lse = fa.flash_attention_torch(q, k, v, with_lse=True, **masks)
    assert bool((lse < fa.NEG_INF / 2).any()) == (mode != "offset sk - sq")
    return (q, k, v, o, do, lse), masks


@pytest.mark.parametrize("body", ["bf16", "f32"])
@pytest.mark.parametrize("mode", list(OFFSET_MASK_MODES))
def test_body_arithmetic_with_offset_and_mask(mode, body):
    """Each body with a query offset or a mask, rows with no key
    included: within phase 7's rule of the plain backward."""
    args, masks = _offset_mask_case(mode, body)
    got = emulate_bwd(*args, body, **masks)
    want = fa.flash_attention_bwd_torch(*args, **masks)
    ratios = phase7_ratios([x.float() for x in got],
                           [w.float() for w in want], TOL[body])
    assert max(ratios) <= 1.0, (mode, body, ratios)


@pytest.mark.parametrize("body", ["bf16", "f32"])
@pytest.mark.parametrize("mode", ["negative offset", "mask (sq, sk)"])
def test_body_arithmetic_with_offset_and_mask_matches_reference(mode, body):
    """Against ``jax.vjp`` of the reference's ``full_attention`` with the
    same ``q_offset`` and ``mask`` (its uniform softmax on the rows with
    no key)."""
    args, masks = _offset_mask_case(mode, body)
    q, k, v, _, do, _ = args
    jd = jnp.bfloat16 if body == "bf16" else jnp.float32
    mask = masks["mask"]

    def to_jax(t):
        return jnp.asarray(t.float().numpy(), jd)

    def ref_grads(q_, k_, v_, do_):
        return jax.vjp(lambda *t: ref_attn.full_attention(
            *t, causal=masks["causal"], q_offset=masks["q_offset"],
            window=masks["window"],
            mask=None if mask is None else jnp.asarray(mask.numpy())),
            q_, k_, v_)[1](do_)
    want = [torch.tensor(np.asarray(w.astype(jnp.float32)))
            for w in jax.jit(ref_grads)(*(to_jax(t) for t in (q, k, v, do)))]
    got = [x.float() for x in emulate_bwd(*args, body, **masks)]
    ratios = phase7_ratios(got, want, TOL[body])
    assert max(ratios) <= 1.0, (mode, body, ratios)
