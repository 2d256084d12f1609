"""The arithmetic of the flash forward's f32 body, emulated on the CPU
(no kernel runs here).

``csrc/flash_attention.cu`` runs both products of its f32 body on
``mma.sync`` m16n8k8 TF32 tensor cores with the 3xTF32 split of both
operands (hi = x rounded to TF32 by ``cvt.rna``, lo = x - hi rounded
again, a . b as lo_a hi_b + hi_a lo_b + hi_a hi_b in f32: Q and K for
S, P and V for P . V), with the online softmax over key tiles of 64 keys
at dqk 32, 32 at dqk 64 and 16 at dqk >= 128, in log2 units (p = 2^(s
scale log2(e) - m)), each tile's P . V summed from zero and added to O
corr.
``emulate_fwd`` does those roundings and that tile walk in torch, one
(batch, head) at a time, with the backward test's TF32 helpers.  It
models the operands' roundings and the tiles, not the order of the sums
inside a product (the tensor cores accumulate with truncation; the
exponential is ``ex2.approx``): those show only on the card, where
``chip_smoke.py`` phase 7 holds the kernel itself.  The body's output
and log-sum-exp are held within 2e-5 (phase 7's elementwise
``isclose``) of the plain ``flash_attention_torch`` and of the
reference's ``chunked_attention`` / ``full_attention(q_offset=,
mask=)`` through JAX, on small versions of phase 7's modes: GQA, MQA,
sq > sk causal, (192, 128), (256, 256), window 1, one valid key, a
length ragged against the tiles, query offsets and masks with rows that
see no key (the reference's uniform softmax, log-sum-exp NEG_INF).
One-pass TF32, which the body does not use, misses the gate.
"""
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attn
from repro_torch.kernels import flash_attention as fa
from test_torch_flash_bwd_arith import (MODES, OFFSET_MASK_MODES,
                                        REFERENCE_MODES, mm_3xtf32, mm_f32,
                                        mm_tf32)

TOL = 2e-5
LOG2E = 1.4426950408889634
# the f32 body's compiled widths beyond the backward test's modes
FWD_MODES = {**MODES,
             "(256, 256)": (1, 24, 40, 2, 1, 256, 256, True, 0, 0, 8)}


# the f32 body's rule for its key tile, as ``Tf32Geometry`` states it
KBK_RULE = "kBK = DQK == 32 ? 64 : (DQK >= 128 ? 16 : 32);"


def key_tile(dqk: int) -> int:
    """Keys a tile of the f32 body (``Tf32Geometry::kBK``, ``KBK_RULE``)."""
    return 64 if dqk == 32 else (16 if dqk >= 128 else 32)


def emulate_fwd(q, k, v, *, causal=True, window=0, kv_valid=0, q_offset=0,
                mask=None, mm=mm_3xtf32):
    """(out, lse) as the f32 body computes them: ``mm`` for both products
    (3xTF32; a one-pass TF32 control replaces it), the online softmax
    over the body's key tiles in log2 units, each tile's P . V added to
    O corr in f32, out = O / max(l, 1e-30), lse = m ln 2 + log(l); a row
    that sees no key takes the mean of V over all sk keys, lse NEG_INF."""
    b, sq, sk, H, KVH, dqk, dv = fa._shapes(q, k, v, causal, window,
                                            kv_valid, q_offset, mask)
    g = H // KVH
    sl2 = torch.tensor(dqk ** -0.5, dtype=torch.float32) * LOG2E
    bk = key_tile(dqk)
    visible = fa._visible(sq, sk, causal, window, kv_valid, "cpu", q_offset)
    if mask is not None:
        mask = fa._mask_view(mask, b, H, sq, sk, "cpu")
    out = torch.empty((b, sq, H, dv))
    lse = torch.empty((b, H, sq))
    for bi in range(b):
        for h in range(H):
            qf, kf, vf = q[bi, :, h], k[bi, :, h // g], v[bi, :, h // g]
            keep = fa._kept(visible, mask, bi, h)
            m = torch.full((sq, 1), fa.NEG_INF)
            l = torch.zeros((sq, 1))
            o = torch.zeros((sq, dv))
            for k0 in range(0, sk, bk):
                ks = slice(k0, min(k0 + bk, sk))
                x = torch.where(keep[:, ks], mm(qf, kf[ks].T.contiguous())
                                * sl2, torch.tensor(fa.NEG_INF))
                m_new = torch.maximum(m, x.max(dim=1, keepdim=True).values)
                corr = torch.exp2(m - m_new)
                p = torch.exp2(x - m_new)
                l = l * corr + p.sum(dim=1, keepdim=True)
                o = o * corr + mm(p, vf[ks])
                m = m_new
            empty = ~keep.any(dim=1, keepdim=True)
            o = torch.where(empty, vf.sum(dim=0, keepdim=True), o)
            l = torch.where(empty, torch.tensor(float(sk)), l)
            out[bi, :, h] = o / torch.clamp(l, min=1e-30)
            lse[bi, h] = torch.where(empty, torch.tensor(fa.NEG_INF),
                                     m * math.log(2.0) + torch.log(l))[:, 0]
    return out, lse


def _operands(shape, seed):
    b, sq, sk, h, kvh, dqk, dv = shape
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((b, sq, h, dqk), (b, sk, kvh, dqk), (b, sk, kvh, dv))]


def _case(mode, modes=FWD_MODES):
    b, sq, sk, h, kvh, dqk, dv, causal, window, kv_valid, _ = modes[mode]
    q, k, v = _operands((b, sq, sk, h, kvh, dqk, dv),
                        sq + sk + dqk + window + kv_valid)
    return (q, k, v), dict(causal=causal, window=window, kv_valid=kv_valid)


def _offset_mask_case(mode):
    b, sq, sk, h, kvh, dqk, dv, causal, window, q_offset, kind = \
        OFFSET_MASK_MODES[mode]
    rng = np.random.default_rng(sq + sk + dqk + window + q_offset)
    q, k, v = _operands((b, sq, sk, h, kvh, dqk, dv),
                        sq + sk + dqk + window + q_offset + 1)
    mask = None
    if kind:
        shape = (sq, sk) if kind == "qk" else (b, h, sq, sk)
        mask = torch.from_numpy(rng.random(shape) > 0.4)
        mask[..., [2, sq - 1], :] = False
    return (q, k, v), dict(causal=causal, window=window, q_offset=q_offset,
                           mask=mask)


def within(got, want) -> bool:
    return bool(torch.isclose(got, want, rtol=TOL, atol=TOL).all())


def worst(got, want) -> float:
    """The largest |got - want| over the gate's bound at that element."""
    return float(((got - want).abs() / (TOL + TOL * want.abs())).max())


@pytest.mark.parametrize("mode", list(FWD_MODES))
def test_fwd_body_arithmetic_matches_plain_version(mode):
    args, masks = _case(mode)
    out, lse = emulate_fwd(*args, **masks)
    want, want_lse = fa.flash_attention_torch(*args, with_lse=True, **masks)
    assert out.shape == want.shape and lse.shape == want_lse.shape
    assert within(out, want), (mode, worst(out, want))
    assert within(lse, want_lse), (mode, worst(lse, want_lse))


@pytest.mark.parametrize("mode", list(OFFSET_MASK_MODES))
def test_fwd_body_arithmetic_with_offset_and_mask(mode):
    """A query offset or a mask operand, rows with no key included (the
    mean of V, log-sum-exp NEG_INF on both sides)."""
    args, masks = _offset_mask_case(mode)
    out, lse = emulate_fwd(*args, **masks)
    want, want_lse = fa.flash_attention_torch(*args, with_lse=True, **masks)
    empty = want_lse < fa.NEG_INF / 2
    assert bool(empty.any()) == (mode != "offset sk - sq")
    assert torch.equal(lse < fa.NEG_INF / 2, empty)
    assert within(out, want), (mode, worst(out, want))
    assert within(lse, want_lse), (mode, worst(lse, want_lse))


def _jax(t):
    return jnp.asarray(t.numpy(), jnp.float32)


@pytest.mark.parametrize("mode", list(REFERENCE_MODES))
def test_fwd_body_arithmetic_matches_reference_chunked_attention(mode):
    """Against the reference's ``chunked_attention`` (its online softmax
    over chunks, in f32 through JAX on the CPU)."""
    args, masks = _case(mode, REFERENCE_MODES)
    chunk = REFERENCE_MODES[mode][-1]
    want = torch.tensor(np.asarray(ref_attn.chunked_attention(
        *(_jax(t) for t in args), chunk=chunk, **masks)))
    out, _ = emulate_fwd(*args, **masks)
    assert within(out, want), (mode, worst(out, want))


@pytest.mark.parametrize("mode", ["negative offset", "window, sq > sk",
                                  "mask (sq, sk)"])
def test_fwd_body_arithmetic_matches_reference_full_attention(mode):
    """Against the reference's ``full_attention`` with the same
    ``q_offset`` and ``mask`` (its uniform softmax on the rows with no
    key)."""
    args, masks = _offset_mask_case(mode)
    mask = masks["mask"]
    want = torch.tensor(np.asarray(ref_attn.full_attention(
        *(_jax(t) for t in args), causal=masks["causal"],
        q_offset=masks["q_offset"], window=masks["window"],
        mask=None if mask is None else jnp.asarray(mask.numpy()))))
    out, _ = emulate_fwd(*args, **masks)
    assert within(out, want), (mode, worst(out, want))


def test_one_pass_tf32_misses_the_gate():
    """The split is needed: one-pass TF32 products put some mode's output
    past 2e-5 of the plain version, where 3xTF32 stays within it."""
    ratios = {}
    for mode in FWD_MODES:
        args, masks = _case(mode)
        want = fa.flash_attention_torch(*args, **masks)
        one, _ = emulate_fwd(*args, mm=mm_tf32, **masks)
        three, _ = emulate_fwd(*args, **masks)
        ratios[mode] = (worst(one, want), worst(three, want))
    assert max(one for one, _ in ratios.values()) > 1.0, ratios
    assert max(three for _, three in ratios.values()) <= 1.0, ratios


def test_tile_walk_with_f32_products_matches_plain_version():
    """The emulation's walk itself: with full f32 products in place of
    3xTF32 its online softmax over the body's key tiles (64 keys at dqk
    32, 32 at 64, 16 at 128 and wider, the rule the source states)
    agrees with the plain version's one softmax over every key, in every
    mode."""
    source = (Path(fa.__file__).parent / "csrc" / "flash_attention.cu")
    assert KBK_RULE in source.read_text()
    assert key_tile(32) == 64 and key_tile(64) == 32
    assert key_tile(128) == key_tile(192) == key_tile(256) == 16
    for mode in FWD_MODES:
        args, masks = _case(mode)
        out, lse = emulate_fwd(*args, mm=mm_f32, **masks)
        want, want_lse = fa.flash_attention_torch(*args, with_lse=True,
                                                  **masks)
        assert within(out, want), (mode, worst(out, want))
        assert within(lse, want_lse), (mode, worst(lse, want_lse))
