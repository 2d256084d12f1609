"""The flash kernel's query offset and mask operand, their plain versions
held against the reference's attention, on the CPU.

``flash_attention_torch`` / ``flash_attention_bwd_torch`` with
``q_offset`` (query row i at position i + q_offset: positive, the
triangular scan's sk - sq, negative with causal, so that the first rows
see no key, and under a window, also past the last key's band) against
the reference's ``chunked_attention`` and ``full_attention`` and
``jax.vjp`` of them; with ``mask`` against ``full_attention(mask=)``,
the mask holding a fully masked row.  A row that keeps no key takes the
reference's softmax of all ``NEG_INF`` scores (uniform: the mean of V,
and in the backward dO / sk to every key's dV and nothing to dq or dk).
The port's card route (``models.attention._flash``, and the triangular
scan with sk > sq on its card branch) runs here through the same plain
versions.  Tolerances: each output and gradient within 2e-5 (f32) /
2e-2 (bf16) of its largest magnitude, ``tests/test_torch_flash_grad.py``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attn
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import attention as attn

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# (b, sq, sk, H, KVH, dqk, dv, causal, window, q_offset, chunk): the
# triangular scan's sk - sq, a smaller positive offset, negative (rows 0-5
# before key 0), a window with sq > sk, a window with a negative offset,
# non-causal under a window with rows past the last key's band, MLA's
# (192, 128)
OFFSET_CASES = [
    (1, 16, 32, 4, 2, 16, 16, True, 0, 16, 8),
    (1, 16, 32, 4, 2, 16, 16, True, 0, 5, 8),
    (2, 16, 16, 4, 1, 16, 16, True, 0, -6, 8),
    (1, 24, 16, 2, 2, 32, 32, True, 5, 3, 8),
    (1, 16, 24, 4, 2, 16, 16, True, 6, -4, 8),
    (1, 16, 16, 2, 1, 16, 16, False, 4, 10, 8),
    (1, 16, 16, 2, 2, 192, 128, True, 0, 8, 8),
]
# (b, sq, sk, H, KVH, dqk, dv, causal, window, q_offset, mask shape): a
# (sq, sk) mask, one of the reference's broadcast (b, KVH, G, sq, sk), a
# (b, 1, 1, sq, sk) one; each with a fully masked row
MASK_CASES = [
    (2, 12, 20, 4, 2, 16, 16, False, 0, 0, "qk"),
    (1, 16, 16, 4, 2, 16, 16, True, 0, 0, "full"),
    (2, 20, 12, 4, 4, 16, 16, True, 6, 3, "batch"),
    (1, 10, 18, 2, 1, 192, 128, False, 0, 0, "qk"),
]


def _operands(seed, b, sq, sk, h, kvh, dqk, dv):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, dqk), (b, sk, kvh, dqk), (b, sk, kvh, dv),
                      (b, sq, h, dv))]


def _mask(seed, kind, b, sq, sk, h, kvh):
    """A random boolean mask of the reference's broadcast shape ``kind``
    with row 3 fully masked (in every head, or in head (0, 1) of the
    full shape)."""
    rng = np.random.default_rng(seed)
    shape = {"qk": (sq, sk), "full": (b, kvh, h // kvh, sq, sk),
             "batch": (b, 1, 1, sq, sk)}[kind]
    m = rng.random(shape) > 0.4
    if kind == "full":
        m[0, 0, 1, 3] = False
    else:
        m[..., 3, :] = False
    return m


def _close(got, want, dtype, what):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = TOL[dtype] * max(1e-30, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max err {err} > {bound}"


def _plain(q, k, v, do, dtype, **masks):
    """The plain forward with its log-sum-exp and the plain backward in
    the working type."""
    tq, tk, tv, tdo = (torch.from_numpy(a).to(dtype) for a in (q, k, v, do))
    o, lse = fa.flash_attention_torch(tq, tk, tv, with_lse=True, **masks)
    return o, lse, fa.flash_attention_bwd_torch(tq, tk, tv, o, tdo, lse,
                                                **masks)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,sq,sk,h,kvh,dqk,dv,causal,window,q_offset,chunk", OFFSET_CASES)
def test_plain_offset_matches_reference(b, sq, sk, h, kvh, dqk, dv, causal,
                                        window, q_offset, chunk, dtype):
    """The plain forward against the reference's ``chunked_attention``
    and ``full_attention`` with the same ``q_offset``, and the plain
    backward against ``jax.vjp`` of ``chunked_attention``."""
    q, k, v, do = _operands(sq + sk + dqk + window + q_offset, b, sq, sk, h,
                            kvh, dqk, dv)
    jd = jnp.dtype(dtype)
    masks = dict(causal=causal, window=window, q_offset=q_offset)

    @jax.jit
    def ref(q_, k_, v_, do_):
        out, vjp = jax.vjp(lambda *t: ref_attn.chunked_attention(
            *t, chunk=chunk, **masks), q_, k_, v_)
        full = ref_attn.full_attention(q_, k_, v_, **masks)
        return out, full, vjp(do_)
    out, full, grads = ref(*(jnp.asarray(a, jd) for a in (q, k, v, do)))
    o, _, got = _plain(q, k, v, do, getattr(torch, dtype), **masks)
    assert o.dtype == getattr(torch, dtype)
    _close(o, out, dtype, "out vs chunked_attention")
    _close(o, full, dtype, "out vs full_attention")
    for name, g, w in zip(("dq", "dk", "dv"), got, grads):
        _close(g, w, dtype, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,sq,sk,h,kvh,dqk,dv,causal,window,q_offset,kind", MASK_CASES)
def test_card_route_mask_matches_reference(b, sq, sk, h, kvh, dqk, dv,
                                           causal, window, q_offset, kind,
                                           dtype):
    """``full_attention(mask=)``'s card route (``attention._flash``: the
    mask broadcast to (b, KVH, G, sq, sk) and read as (b, H, sq, sk)),
    here through the plain versions, against the reference's
    ``full_attention(mask=)`` and ``jax.vjp`` of it, a row fully masked."""
    q, k, v, do = _operands(sq + sk + dqk + window, b, sq, sk, h, kvh, dqk,
                            dv)
    m = _mask(sq + sk, kind, b, sq, sk, h, kvh)
    jd = jnp.dtype(dtype)
    masks = dict(causal=causal, window=window, q_offset=q_offset)

    @jax.jit
    def ref(q_, k_, v_, do_):
        out, vjp = jax.vjp(lambda *t: ref_attn.full_attention(
            *t, mask=jnp.asarray(m), **masks), q_, k_, v_)
        return out, vjp(do_)
    out, grads = ref(*(jnp.asarray(a, jd) for a in (q, k, v, do)))
    leaves = [torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_()
              for a in (q, k, v)]
    o = attn._flash(*leaves, mask=torch.from_numpy(m), **masks)
    o.backward(torch.from_numpy(do).to(getattr(torch, dtype)))
    _close(o.detach(), out, dtype, "out")
    for name, t, w in zip(("dq", "dk", "dv"), leaves, grads):
        _close(t.grad, w, dtype, name)
    # the plain backward from the plain forward's log-sum-exp: the same
    # gradients as autograd of the plain forward
    hm = torch.broadcast_to(torch.from_numpy(m), (b, kvh, h // kvh, sq, sk)) \
        .reshape(b, h, sq, sk)
    _, lse, got = _plain(q, k, v, do, getattr(torch, dtype), mask=hm,
                         **masks)
    assert bool((lse < fa.NEG_INF / 2).any())         # the empty row
    for name, g, w in zip(("dq", "dk", "dv"), got, grads):
        _close(g, w, dtype, f"plain {name}")


def test_fully_masked_row_is_the_mean_of_v():
    """A row with no visible key: the mean of V over all keys, its
    log-sum-exp NEG_INF, no gradient to q (or from it to k), and dO / sk
    to every key's dV; the same row unmasked is untouched by that rule."""
    q, k, v, do = (torch.from_numpy(a) for a in _operands(3, 1, 6, 10, 2, 2,
                                                          16, 16))
    mask = torch.ones((6, 10), dtype=torch.bool)
    mask[2] = False
    o, lse = fa.flash_attention_torch(q, k, v, causal=False, mask=mask,
                                      with_lse=True)
    torch.testing.assert_close(o[0, 2], v[0].mean(dim=0), rtol=1e-6,
                               atol=1e-6)
    assert bool((lse[0, :, 2] == torch.tensor(fa.NEG_INF)).all())
    assert bool((lse[0, :, [0, 1, 3, 4, 5]] > -100).all())
    dq, dk, dv = fa.flash_attention_bwd_torch(q, k, v, o, do, lse,
                                              causal=False, mask=mask)
    assert bool((dq[0, 2] == 0).all())
    keep = mask.clone()
    keep[2] = True
    o2, lse2 = fa.flash_attention_torch(q, k, v, causal=False, mask=keep,
                                        with_lse=True)
    do2 = do.clone()
    do2[0, 2] = 0
    _, _, dv_rest = fa.flash_attention_bwd_torch(q, k, v, o2, do2, lse2,
                                                 causal=False, mask=keep)
    torch.testing.assert_close(dv, dv_rest + do[0, 2][None, None] / 10,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("route", ["card", "cpu"])
@pytest.mark.parametrize("sq,sk,window,chunk", [(16, 32, 0, 8), (8, 24, 0, 8),
                                                (16, 48, 20, 16)])
def test_triangular_with_prefix_keys_matches_reference(monkeypatch, route, sq,
                                                       sk, window, chunk):
    """The triangular scan with sk > sq (its queries at positions sk - sq
    on) against the reference's ``triangular_chunked_attention``: the
    card branch (the flash call with q_offset = sk - sq, here through the
    plain version) and the CPU twin."""
    q, k, v, _ = _operands(sq + sk + window, 1, sq, sk, 4, 2, 16, 16)
    want = ref_attn.triangular_chunked_attention(
        *(jnp.asarray(a) for a in (q, k, v)), chunk=chunk, window=window)
    if route == "card":
        calls = []

        def fwd(q_, k_, v_, **kw):
            calls.append(kw)
            return fa.flash_attention_torch(q_, k_, v_, **kw)
        monkeypatch.setattr(attn, "on_card", lambda t: True)
        monkeypatch.setattr(ops, "_on_card", lambda t: True)
        monkeypatch.setattr(fa, "flash_attention_cuda", fwd)
    got = attn.triangular_chunked_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), chunk=chunk, window=window)
    _close(got, want, "float32", route)
    if route == "card":
        assert [c["q_offset"] for c in calls] == [sk - sq]


def test_offset_and_mask_argument_checks():
    """A window with sq > sk is legal now (an offset places its rows);
    kv_valid still takes only a non-causal call with no window and no
    mask; a mask must be bool and broadcast to (b, H, sq, sk)."""
    q, k, v, _ = (torch.from_numpy(a) for a in _operands(1, 1, 12, 8, 2, 1,
                                                         16, 16))
    assert fa.flash_attention_torch(q, k, v, window=3).shape == (1, 12, 2, 16)
    mask = torch.ones((12, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="kv_valid"):
        fa.flash_attention_torch(q, k, v, causal=False, kv_valid=4,
                                 mask=mask)
    with pytest.raises(ValueError, match="bool"):
        fa.flash_attention_torch(q, k, v, mask=mask.float())
    with pytest.raises(ValueError, match="broadcast"):
        fa.flash_attention_torch(q, k, v, mask=mask[:5])
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention_torch(q, k, v, q_offset=fa.MAX_OFFSET + 1)
