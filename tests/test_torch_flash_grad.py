"""The flash kernel's backward: its plain version held against the
reference's gradients, and the autograd routing of ``ops.flash_attention``.

``flash_attention_bwd_torch`` (P recomputed from the forward's row
log-sum-exp) is held against ``jax.vjp`` of the reference's jnp
``chunked_attention`` (what the reference trains through: GQA, the
sliding window, the key-padding bound, v narrower than q / k) and of
``kernels/ref.py::flash_attention_ref`` (the kernel's oracle, MHA),
from the same numpy q, k, v and output cotangent.  Tolerances: each
gradient within 2e-5 (f32) / 2e-2 (bf16) of its largest magnitude: the
sums run in other orders (f32), and in bf16 the reference's backward
rounds its products' outputs to bf16 where the plain version keeps f32
until the final cast.  The CUDA kernels are held against this plain
version on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``
phase 7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import flash_attention_ref
from repro.models import attention as ref_attn
from repro_torch.kernels import build, ops
from repro_torch.kernels import flash_attention as fa

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# (b, sq, sk, H, KVH, dqk, dv, causal, window, kv_valid, chunk): causal and
# not, GQA and MQA, a window inside and across chunks, the key-padding
# bound, MLA's (192, 128)
CHUNKED_CASES = [
    (2, 16, 16, 4, 2, 16, 16, True, 0, 0, 8),
    (1, 16, 32, 4, 1, 16, 16, False, 0, 0, 16),
    (1, 32, 32, 4, 2, 16, 16, True, 5, 0, 8),
    (1, 16, 16, 2, 2, 32, 32, True, 12, 0, 8),
    (1, 16, 32, 4, 2, 16, 16, False, 0, 21, 16),
    (1, 16, 16, 4, 4, 192, 128, True, 0, 0, 8),
    (1, 16, 32, 2, 1, 24, 16, False, 0, 9, 16),
]


def _operands(seed, b, sq, sk, h, kvh, dqk, dv):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, dqk), (b, sk, kvh, dqk), (b, sk, kvh, dv),
                      (b, sq, h, dv))]


def _to_torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


def _plain_grads(q, k, v, do, dtype, **masks):
    """The plain forward (with its log-sum-exp) and backward in the
    working type, from the numpy operands."""
    tq, tk, tv, tdo = (_to_torch(a, dtype) for a in (q, k, v, do))
    o, lse = fa.flash_attention_torch(tq, tk, tv, with_lse=True, **masks)
    return fa.flash_attention_bwd_torch(tq, tk, tv, o, tdo, lse, **masks)


def _close(got, want, dtype, what):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = TOL[dtype] * max(1e-30, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max err {err} > {bound}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,sq,sk,h,kvh,dqk,dv,causal,window,kv_valid,chunk", CHUNKED_CASES)
def test_plain_backward_matches_reference_chunked_attention(
        b, sq, sk, h, kvh, dqk, dv, causal, window, kv_valid, chunk, dtype):
    q, k, v, do = _operands(sq + sk + dqk + window + kv_valid, b, sq, sk, h,
                            kvh, dqk, dv)
    jd = jnp.dtype(dtype)

    @jax.jit
    def ref_grads(q_, k_, v_, do_):
        return jax.vjp(lambda *t: ref_attn.chunked_attention(
            *t, causal=causal, chunk=chunk, window=window,
            kv_valid=kv_valid), q_, k_, v_)[1](do_)
    want = ref_grads(*(jnp.asarray(a, jd) for a in (q, k, v, do)))
    got = _plain_grads(q, k, v, do, getattr(torch, dtype), causal=causal,
                       window=window, kv_valid=kv_valid)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == getattr(torch, dtype)
        _close(g, w, dtype, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_reference_oracle(causal, dtype):
    """Against ``jax.vjp`` of ``flash_attention_ref`` (flat (b h, s, dh),
    MHA; the port's layout transposed into it)."""
    b, s, h, dh = 2, 24, 3, 32
    q, k, v, do = _operands(7 + causal, b, s, s, h, h, dh, dh)
    jd = jnp.dtype(dtype)

    def flat(a):
        return jnp.asarray(a, jd).transpose(0, 2, 1, 3).reshape(b * h, s, dh)

    @jax.jit
    def ref_grads(q_, k_, v_, do_):
        return jax.vjp(lambda *t: flash_attention_ref(*t, causal=causal),
                       q_, k_, v_)[1](do_)
    want = [w.reshape(b, h, s, dh).transpose(0, 2, 1, 3)
            for w in ref_grads(flat(q), flat(k), flat(v), flat(do))]
    got = _plain_grads(q, k, v, do, getattr(torch, dtype), causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, dtype, name)


def test_plain_forward_log_sum_exp():
    """The plain forward's log-sum-exp is each row's logsumexp of its
    masked scaled scores (f64 reference), and its output unchanged."""
    q, k, v, _ = _operands(3, 1, 20, 30, 4, 2, 16, 16)
    tq, tk, tv = (_to_torch(a, torch.float32) for a in (q, k, v))
    for masks in (dict(causal=True), dict(causal=False, kv_valid=11),
                  dict(causal=True, window=4)):
        o, lse = fa.flash_attention_torch(tq, tk, tv, with_lse=True, **masks)
        assert torch.equal(o, fa.flash_attention_torch(tq, tk, tv, **masks))
        s = torch.einsum("bqhd,bkhd->bhqk", tq.double(),
                         tk.double().repeat_interleave(2, 2)) * 16 ** -0.5
        vis = fa._visible(20, 30, masks.get("causal"), masks.get("window", 0),
                          masks.get("kv_valid", 0), "cpu")
        want = torch.logsumexp(s.masked_fill(~vis, -1e30), dim=-1)
        torch.testing.assert_close(lse.double(), want, rtol=1e-6, atol=1e-6)


def test_ops_flash_attention_grad_on_cpu():
    """On the CPU ``ops.flash_attention`` is the plain forward and
    autograd differentiates it: the same gradients as the plain
    backward."""
    q, k, v, do = _operands(11, 1, 18, 18, 4, 2, 16, 16)
    leaves = [_to_torch(a, torch.float32).requires_grad_() for a in (q, k, v)]
    ops.flash_attention(*leaves, causal=True, window=6).backward(
        _to_torch(do, torch.float32))
    want = _plain_grads(q, k, v, do, torch.float32, causal=True, window=6)
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w, rtol=1e-5, atol=1e-6)


def test_ops_flash_attention_routes_autograd_to_the_kernels(monkeypatch):
    """The card's routing, with each CUDA wrapper standing in by its
    plain version (counting launches as the wrappers do): under autograd
    the forward writes its log-sum-exp and the backward runs the two
    backward kernels, whose gradients reach q, k and v; with no grad (or
    no operand requiring it) the inference forward alone runs, the same
    output."""
    calls = []

    def fwd(q, k, v, *, causal, window, kv_valid, with_lse=False, **rest):
        calls.append(("forward", with_lse))
        build.LAUNCHES["flash_attention"] += 1
        return fa.flash_attention_torch(q, k, v, causal=causal, window=window,
                                        kv_valid=kv_valid, with_lse=with_lse,
                                        **rest)

    def bwd(q, k, v, o, do, lse, **masks):
        calls.append(("backward", None))
        build.LAUNCHES["flash_attention_bwd_dq"] += 1
        build.LAUNCHES["flash_attention_bwd_dkdv"] += 1
        return fa.flash_attention_bwd_torch(q, k, v, o, do, lse, **masks)

    monkeypatch.setattr(fa, "flash_attention_cuda", fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd_cuda", bwd)
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    for key in build.LAUNCHES:
        monkeypatch.setitem(build.LAUNCHES, key, 0)
    q, k, v, do = _operands(13, 2, 20, 20, 4, 1, 16, 16)
    leaves = [_to_torch(a, torch.float32).requires_grad_() for a in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=False, kv_valid=13)
    out.backward(_to_torch(do, torch.float32))
    assert calls == [("forward", True), ("backward", None)]
    want = _plain_grads(q, k, v, do, torch.float32, causal=False, kv_valid=13)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)
    with torch.no_grad():
        plain = ops.flash_attention(*leaves, causal=False, kv_valid=13)
    detached = ops.flash_attention(*(t.detach() for t in leaves),
                                   causal=False, kv_valid=13)
    assert calls[2:] == [("forward", False), ("forward", False)]
    assert torch.equal(plain, out.detach()) and torch.equal(detached, plain)
    assert (build.LAUNCHES["flash_attention"],
            build.LAUNCHES["flash_attention_bwd_dq"],
            build.LAUNCHES["flash_attention_bwd_dkdv"]) == (3, 1, 1)
