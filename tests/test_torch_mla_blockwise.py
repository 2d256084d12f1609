"""MLA's block-wise attention under autograd (``models.mla._MLABlockwise``),
on the CPU.

The Function's output and the gradients of its six inputs (q_nope,
q_rope, latent, k_rope_seq, w_uk, w_uv) against ``jax.vjp`` of the
reference's ``mla_chunked_attention`` from the same numpy inputs (a few
heads at DeepSeek-V2's head widths, ``attn_chunk`` 8 over 32 tokens: 4
blocks, 10 pairs); its bookkeeping runs here through the flash kernel's
plain forward and backward.  Tolerances: 2e-5 (f32) / 2e-2 (bf16) of
each one's largest magnitude, ``tests/test_torch_flash_grad.py``'s.
Then the card's routing with the CUDA wrappers stood in by their plain
versions (one forward and one backward a pair, never the materialized
K and V), and the meta branch the dry run traces (one flash op forward
and one backward a pair).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mla as ref_mla
from repro_torch.configs import smoke_config
from repro_torch.kernels import build, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import hlo_cost
from repro_torch.models import mla

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
NAMES = ("q_nope", "q_rope", "latent", "k_rope_seq", "w_uk", "w_uv")
# (b, s, h, dn, dr, dv, lora, chunk)
SHAPE = (2, 32, 4, 128, 64, 128, 32, 8)


def _inputs(seed, b, s, h, dn, dr, dv, lora):
    rng = np.random.default_rng(seed)
    shapes = ((b, s, h, dn), (b, s, h, dr), (b, s, lora), (b, s, dr),
              (lora, h * dn), (lora, h * dv), (b, s, h, dv))
    scale = (1, 1, 1, 1, lora ** -0.5, lora ** -0.5, 1)
    return [(rng.standard_normal(sh) * sc).astype(np.float32)
            for sh, sc in zip(shapes, scale)]


def _close(got, want, dtype, what):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = TOL[dtype] * max(1e-30, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max err {err} > {bound}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blockwise_function_matches_reference_vjp(dtype):
    b, s, h, dn, dr, dv, lora, chunk = SHAPE
    *args, do = _inputs(31, b, s, h, dn, dr, dv, lora)
    cfg = types.SimpleNamespace(v_head_dim=dv, attn_chunk=chunk)
    jd = jnp.dtype(dtype)

    @jax.jit
    def ref(qn, qr, lat, kr, w_uk, w_uv, do_):
        out, vjp = jax.vjp(lambda qn_, qr_, lat_, kr_, a, b_:
                           ref_mla.mla_chunked_attention(
                               {"w_uk": a, "w_uv": b_}, qn_, qr_, lat_, kr_,
                               cfg), qn, qr, lat, kr, w_uk, w_uv)
        return out, vjp(do_)
    want, grads = ref(*(jnp.asarray(a, jd) for a in args + [do]))
    td = getattr(torch, dtype)
    leaves = [torch.from_numpy(a).to(td).requires_grad_() for a in args]
    out = mla._MLABlockwise.apply(*leaves, chunk)
    out.backward(torch.from_numpy(do).to(td))
    assert out.dtype == td and out.shape == (b, s, h, dv)
    _close(out, want, dtype, "out")
    for name, t, w in zip(NAMES, leaves, grads):
        assert t.grad.dtype == td, name
        _close(t.grad, w, dtype, name)


def _deepseek(s=32, chunk=8):
    cfg = smoke_config("deepseek-v2-236b")
    return dataclasses.replace(cfg, attn_chunk=chunk, qk_nope_head_dim=128,
                               qk_rope_head_dim=64, v_head_dim=128)


def test_card_routes_autograd_to_the_blockwise_kernels(monkeypatch):
    """``mla_attention_apply`` on the card's branch under autograd, with
    the CUDA wrappers stood in by their plain versions (counting launches
    as the wrappers do): the block-wise Function, one forward with its
    log-sum-exp and one backward (dq, then dk / dv) a (query block, key
    block <= it) pair, never the materialized path; the output and every
    parameter's gradient equal to the CPU branch's
    (``mla_chunked_attention``) within 2e-5."""
    calls = []

    def fwd(q, k, v, *, with_lse=False, **masks):
        calls.append(("forward", with_lse, masks["causal"]))
        build.LAUNCHES["flash_attention"] += 1
        return fa.flash_attention_torch(q, k, v, with_lse=with_lse, **masks)

    def bwd(q, k, v, o, do, lse, **masks):
        calls.append(("backward", None, masks["causal"]))
        build.LAUNCHES["flash_attention_bwd_dq"] += 1
        build.LAUNCHES["flash_attention_bwd_dkdv"] += 1
        return fa.flash_attention_bwd_torch(q, k, v, o, do, lse, **masks)

    def materialized(*args, **kw):
        raise AssertionError("the materialized path ran")

    cfg = _deepseek()
    g = torch.Generator().manual_seed(4)
    p = mla.mla_init(g, cfg)
    x = torch.randn((2, 32, cfg.d_model), generator=g)
    pos = torch.arange(32)
    want_leaves = {k: t.clone().requires_grad_() for k, t in p.items()}
    want = mla.mla_attention_apply(want_leaves, x, cfg, pos)
    do = torch.randn(want.shape, generator=g)
    want.backward(do)

    monkeypatch.setattr(fa, "flash_attention_cuda", fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd_cuda", bwd)
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(mla, "on_card", lambda t: True)
    monkeypatch.setattr(mla, "_materialize", materialized)
    for key in build.LAUNCHES:
        monkeypatch.setitem(build.LAUNCHES, key, 0)
    leaves = {k: t.clone().requires_grad_() for k, t in p.items()}
    got = mla.mla_attention_apply(leaves, x, cfg, pos)
    n_fwd = len(calls)
    got.backward(do)
    pairs = [(qi, ki) for qi in range(4) for ki in range(qi + 1)]
    assert calls[:n_fwd] == [("forward", True, ki == qi) for qi, ki in pairs]
    assert calls[n_fwd:] == [("backward", None, ki == qi)
                             for qi, ki in pairs]
    assert (build.LAUNCHES["flash_attention"],
            build.LAUNCHES["flash_attention_bwd_dq"],
            build.LAUNCHES["flash_attention_bwd_dkdv"]) == (10, 10, 10)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    for k in p:
        bound = 2e-5 * float(want_leaves[k].grad.abs().max())
        err = float((leaves[k].grad - want_leaves[k].grad).abs().max())
        assert err <= bound, (k, err, bound)


def test_blockwise_on_meta_counts_one_flash_op_a_pair():
    """The dry run's branch: the Function on meta tensors, counted by
    ``CostCounter``: 10 flash forward ops (4 blocks) and, in the
    backward, 10 flash backward ops, with empty gradients of the
    inputs' shapes."""
    b, s, h, dn, dr, dv, lora, chunk = SHAPE
    shapes = ((b, s, h, dn), (b, s, h, dr), (b, s, lora), (b, s, dr),
              (lora, h * dn), (lora, h * dv))
    leaves = [torch.empty(sh, device="meta", requires_grad=True)
              for sh in shapes]
    with hlo_cost.CostCounter() as counter:
        out = mla._MLABlockwise.apply(*leaves, chunk)
        fwd_calls = counter.cost.flash_calls
        grads = torch.autograd.grad(out.sum(), leaves)
    assert out.shape == (b, s, h, dv) and out.is_meta
    assert (fwd_calls, counter.cost.flash_calls) == (10, 20)
    assert [tuple(x.shape) for x in grads] == list(shapes)
    pairs = 4 * (8 * 9 // 2) + 6 * 8 * 8     # 4 diagonal, 6 full blocks
    assert counter.cost.flops_by_op["flash_attention"] == pytest.approx(
        2.0 * b * h * pairs * ((dn + dr + dv) + (3 * (dn + dr) + 2 * dv)))
