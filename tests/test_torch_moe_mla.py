"""The port's MoE and MLA serving path held against the reference's, on
the CPU at ``smoke_config`` size (moonshot-v1-16b-a3b: a dense first
layer and a MoE layer; deepseek-v2-236b: an MLA dense layer and an MLA
MoE layer).

The reference draws the params (``init(PRNGKey(0))``); they cross over
as numpy through ``params_from_numpy``.  Tolerances as in
``test_torch_lm.py``: each value within ``TOL[dtype]`` times the largest
magnitude of the reference's tensor (at least 1); f32 1e-5 (a few
layers' sums taken in another order), bf16 2^-5 (four bf16 ulps at the
largest value: every product rounds to 8 bits in both, in other
orders).  Integer results (router ids, the dispatch's slot map, greedy
tokens) are equal exactly.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.launch.steps import scale_config as ref_scale_config
from repro.models import attention as ref_attn
from repro.models import build_model as ref_build_model
from repro.models import mla as ref_mla
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tf
from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.steps import scale_config
from repro_torch.models import build_model
from repro_torch.models import mla as port_mla
from repro_torch.models import moe as port_moe
from repro_torch.models import transformer as port_tf
from repro_torch.models.transformer import params_from_numpy

ARCHS = ["moonshot-v1-16b-a3b", "deepseek-v2-236b"]
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -5}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype, what=""):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = TOL[dtype] * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max err {err} > {bound}"


def _cfgs(arch, bf16=False, **repl):
    ref = dataclasses.replace(ref_configs.smoke_config(arch), **repl)
    port = dataclasses.replace(configs.smoke_config(arch), **repl)
    if bf16:
        ref, port = ref_scale_config(ref), scale_config(port)
    return ref, port


@functools.lru_cache(maxsize=None)
def _ref(arch, bf16=False, attn_chunk=1024, moe_token_chunk=16384):
    """The reference's params (jax and numpy) and jitted serving
    functions, built once per key for the module."""
    cfg, _ = _cfgs(arch, bf16, attn_chunk=attn_chunk,
                   moe_token_chunk=moe_token_chunk)
    model = ref_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    prefill = jax.jit(model.prefill, static_argnums=2)
    decode = jax.jit(model.decode_step)
    return params, jax.tree.map(np.asarray, params), prefill, decode


def _layer(arch, bf16, seg, li=0):
    """Layer ``li`` of segment ``seg`` of the reference's params, as
    numpy (reference side) and tensors (port side)."""
    nparams = _ref(arch, bf16)[1]
    lp = jax.tree.map(lambda a: a[li], nparams[f"seg{seg}"])
    return lp, params_from_numpy(lp, device="cpu")


def _x(shape, dtype, seed=3, scale=1.0):
    x = (np.random.default_rng(seed).standard_normal(shape)
         * scale).astype(np.float32)
    return jnp.asarray(x, getattr(jnp, dtype)), \
        torch.from_numpy(x).to(getattr(torch, dtype))


# ------------------------------------------------------------- the router --

def test_router_topk_and_load_balance_equal_reference():
    """Ids equal exactly, also on exact ties (the lower expert first);
    gates and probabilities to f32 rounding; the aux loss on the same
    inputs to f32 rounding."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((64, 8)).astype(np.float32) * 2
    logits[:8, 2:6] = 1.5                       # four-way ties at the top
    logits[8:12] = 0.0                          # all experts tied
    for k in (1, 2, 6):
        rg, ri, rp = ref_moe.router_topk(logits, k)
        pg, pi, pp = port_moe.router_topk(torch.from_numpy(logits), k)
        assert pi.dtype == torch.int32
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
        np.testing.assert_allclose(pg.numpy(), np.asarray(rg), rtol=1e-6)
        np.testing.assert_allclose(pp.numpy(), np.asarray(rp), rtol=1e-6)
        want = ref_moe.load_balance_loss(rp, ri, 8)
        got = port_moe.load_balance_loss(torch.from_numpy(np.array(rp)),
                                         torch.from_numpy(np.array(ri)), 8)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert np.asarray(ref_moe.router_topk(logits, 2)[1])[8].tolist() == \
        [0, 1]


@pytest.mark.parametrize("capacity", [1, 4, 9, 64])
def test_dispatch_indices_equal_reference(capacity):
    """The slot map and its validity equal the reference's exactly, with
    capacity drops (1, 4: experts over-subscribed, skewed routing) and
    without (64)."""
    rng = np.random.default_rng(capacity)
    E, T, k = 8, 40, 3
    p = np.array([0.4, 0.2, 0.1, 0.1, 0.1, 0.05, 0.03, 0.02])
    ids = np.stack([rng.choice(E, size=k, replace=False, p=p)
                    for _ in range(T)]).astype(np.int32)
    rt, rv = ref_moe._dispatch_indices(jnp.asarray(ids), E, capacity)
    pt, pv = port_moe._dispatch_indices(torch.from_numpy(ids), E, capacity)
    assert pt.dtype == torch.int32 and pt.shape == (E * capacity,)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(rt))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
    dropped = T * k - int(np.asarray(rv).sum())
    assert (dropped > 0) == (capacity < 16), dropped


# ---------------------------------------------------------------- the MoE --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("token_chunk", [16384, 8])
def test_moe_apply_matches_reference(dtype, token_chunk):
    """moonshot's MoE layer (8 experts top-2 + a shared expert) on 2 x 16
    tokens; at token chunk 8 the chunk loop runs 4 rounds of capacity 4,
    where experts drop assignments."""
    rcfg, pcfg = _cfgs("moonshot-v1-16b-a3b", dtype == "bfloat16",
                       moe_token_chunk=token_chunk)
    lp, tp = _layer("moonshot-v1-16b-a3b", dtype == "bfloat16", 1)
    rx, px = _x((2, 16, rcfg.d_model), dtype)
    want, raux = ref_moe.moe_apply(lp["ffn"], rx, rcfg)
    got, paux = port_moe.moe_apply(tp["ffn"], px, pcfg)
    assert got.dtype == px.dtype
    if token_chunk == 8:     # the last round drops an assignment
        last = px.reshape(-1, rcfg.d_model)[24:].float()
        ids = port_moe.router_topk(last @ tp["ffn"]["router"], 2)[1]
        assert int(port_moe._dispatch_indices(ids, 8, 4)[1].sum()) < 16
    _close(got, want, dtype, "moe out")
    np.testing.assert_allclose(float(paux), float(raux), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_equals_dense_oracle_at_unbounded_capacity(dtype):
    """capacity_factor = E, so no assignment drops: the dispatch equals
    the every-expert oracle, the port's and the reference's."""
    rcfg, pcfg = _cfgs("deepseek-v2-236b", dtype == "bfloat16",
                       capacity_factor=8.0)
    lp, tp = _layer("deepseek-v2-236b", dtype == "bfloat16", 1)
    rx, px = _x((3, 8, rcfg.d_model), dtype, seed=5)
    got, _ = port_moe.moe_apply(tp["ffn"], px, pcfg)
    oracle = port_moe.moe_apply_dense_reference(tp["ffn"], px, pcfg)
    _close(got, oracle, dtype, "dispatch vs the port's oracle")
    _close(oracle, ref_moe.moe_apply_dense_reference(lp["ffn"], rx, rcfg),
           dtype, "the port's oracle vs the reference's")


# ---------------------------------------------------------------- the MLA --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attn_chunk", [1024, 8, 5])
def test_mla_attention_apply_matches_reference(dtype, attn_chunk):
    """The full-sequence MLA on both branches: materialized K/V and one
    full attention (s <= attn_chunk), and the lazy per-block
    decompression (attn_chunk 8: two blocks; 5: the chunk shrinks to 4,
    a divisor of 16)."""
    rcfg, pcfg = _cfgs("deepseek-v2-236b", dtype == "bfloat16",
                       attn_chunk=attn_chunk)
    lp, tp = _layer("deepseek-v2-236b", dtype == "bfloat16", 0)
    rx, px = _x((2, 16, rcfg.d_model), dtype, seed=7)
    pos = np.arange(16)
    want = ref_mla.mla_attention_apply(lp["attn"], rx, rcfg, pos)
    got = port_mla.mla_attention_apply(tp["attn"], px, pcfg,
                                       torch.from_numpy(pos))
    _close(got, want, dtype, f"mla attn_chunk {attn_chunk}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_attention_matches_reference(dtype):
    """The absorbed decode against a latent / rope-key cache of 12 valid
    positions out of 16."""
    rcfg, pcfg = _cfgs("deepseek-v2-236b", dtype == "bfloat16")
    lp, tp = _layer("deepseek-v2-236b", dtype == "bfloat16", 1)
    rx, px = _x((2, 1, rcfg.d_model), dtype, seed=8)
    rl, pl = _x((2, 16, rcfg.kv_lora_rank), dtype, seed=9)
    rr, pr = _x((2, 16, rcfg.qk_rope_head_dim), dtype, seed=10)
    positions = np.full((2, 1), 11, np.int32)
    mask = np.arange(16)[None, :] <= 11
    want = ref_mla.mla_decode_attention(lp["attn"], rx, rl, rr, rcfg,
                                        positions, mask)
    got = port_mla.mla_decode_attention(
        tp["attn"], px, pl, pr, pcfg, torch.from_numpy(positions),
        torch.from_numpy(mask))
    _close(got, want, dtype, "mla decode")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kvh,causal", [(4, True), (2, True), (1, False)])
def test_flash_plain_version_takes_a_narrower_v(dtype, kvh, causal):
    """``flash_attention_torch`` with v narrower than q and k (MLA's
    shape: 24 = 16 + 8 and 16 at smoke size) against the reference's
    ``full_attention``; its output is v's width."""
    rng = np.random.default_rng(kvh)
    shapes = ((2, 16, 4, 24), (2, 16, kvh, 24), (2, 16, kvh, 16))
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    want = ref_attn.full_attention(*(jnp.asarray(a, getattr(jnp, dtype))
                                     for a in arrs), causal=causal)
    got = fa.flash_attention_torch(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs),
        causal=causal)
    assert got.shape == (2, 16, 4, 16)
    _close(got, want, dtype, "flash plain, dv != dqk")


# -------------------------------------------------------------- the layers --

@pytest.mark.parametrize("arch,seg,kind", [
    ("moonshot-v1-16b-a3b", 0, "dense_first"),
    ("moonshot-v1-16b-a3b", 1, "moe"),
    ("deepseek-v2-236b", 0, "mla_dense"),
    ("deepseek-v2-236b", 1, "mla_moe")])
def test_layer_apply_kinds_match_reference(arch, seg, kind):
    """The full-sequence layer of each new kind: its output and the MoE
    layers' load-balance loss."""
    rcfg, pcfg = _cfgs(arch)
    lp, tp = _layer(arch, False, seg)
    rx, px = _x((2, 16, rcfg.d_model), "float32", seed=11)
    pos = np.arange(16)
    want, raux = ref_tf.layer_apply(lp, rx, rcfg, pos, kind)
    got, paux = port_tf.layer_apply(tp, px, pcfg, torch.from_numpy(pos),
                                    kind)
    _close(got, want, "float32", kind)
    np.testing.assert_allclose(float(paux), float(raux), rtol=1e-5,
                               atol=1e-9)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_reference(arch):
    """The port's own init draws the reference's tree: same leaves,
    shapes and dtypes (the router f32 under scale_config too)."""
    for bf16 in (False, True):
        rcfg, pcfg = _cfgs(arch, bf16)
        ref = jax.eval_shape(ref_build_model(rcfg).init,
                             jax.random.PRNGKey(0))
        ref = jax.tree.map(lambda a: (a.shape, str(a.dtype)), ref)
        got = build_model(pcfg).init(0, device="cpu")
        got = jax.tree.map(lambda a: (tuple(a.shape),
                                      str(a.dtype).split(".")[-1]), got)
        assert got == ref, (arch, bf16)


# --------------------------------------------------------------- the model --

def _snap(tree):
    if isinstance(tree, dict):
        return {k: _snap(v) for k, v in tree.items()}
    return tree.clone()


def _serve_both(arch, *, bf16=False, attn_chunk=1024, steps=3, b=2, s=16,
                max_len=24):
    """Prefill then ``steps`` greedy decode steps in both packages from
    the same params and prompt; the port is fed the reference's greedy
    tokens (and its own must equal them).  Returns the stages' (ref,
    port) logits and caches (the port's as copies)."""
    rcfg, pcfg = _cfgs(arch, bf16, attn_chunk=attn_chunk)
    rparams, nparams, rprefill, rdecode = _ref(arch, bf16, attn_chunk)
    pmodel = build_model(pcfg)
    pparams = params_from_numpy(nparams, device="cpu")
    toks = np.random.default_rng(0).integers(0, rcfg.vocab_size, (b, s),
                                             dtype=np.int32)
    rl, rc = rprefill(rparams, {"tokens": toks}, max_len)
    pl, pc = pmodel.prefill(pparams, {"tokens": toks}, max_len)
    stages = [("prefill", rl, pl, rc, _snap(pc))]
    for i in range(steps):
        tok = np.asarray(jnp.argmax(rl[:, -1], -1)).astype(np.int32)[:, None]
        ptok = pl[:, -1].float().argmax(-1).numpy()
        assert np.array_equal(ptok, tok[:, 0]), (arch, i, ptok, tok)
        rl, rc = rdecode(rparams, tok, rc)
        pl, pc = pmodel.decode_step(pparams, torch.from_numpy(tok), pc)
        stages.append((f"decode {i}", rl, pl, rc, _snap(pc)))
    return pcfg, stages


def _check_stages(pcfg, stages, dtype):
    for name, rl, pl, rc, pc in stages:
        assert pl.dtype == getattr(torch, pcfg.compute_dtype), name
        _close(pl, rl, dtype, f"{name} logits")
        assert int(pc["pos"]) == int(rc["pos"]), name
        assert set(pc) == set(rc), name
        for seg in (k for k in rc if k != "pos"):
            assert set(pc[seg]) == set(rc[seg]), (name, seg)
            for buf in rc[seg]:
                _close(pc[seg][buf], rc[seg][buf], dtype,
                       f"{name} {seg} {buf}")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("bf16", [False, True])
def test_prefill_decode_match_reference(arch, bf16):
    """Prefill logits, every segment's cache (moonshot: k / v of the
    dense-first and MoE layers; deepseek: latent / k_rope), pos and 3
    greedy decode steps, in f32 and under scale_config (bf16)."""
    pcfg, stages = _serve_both(arch, bf16=bf16)
    _check_stages(pcfg, stages, "bfloat16" if bf16 else "float32")


def test_mla_chunked_prefill_matches_reference():
    """deepseek at attn_chunk 8 with a 16-token prompt: the prefill takes
    the reference's lazy-decompression branch in both MLA layers."""
    pcfg, stages = _serve_both("deepseek-v2-236b", attn_chunk=8)
    _check_stages(pcfg, stages, "float32")


# ------------------------------------------------------------------ the CLI --

def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", *args], capture_output=True, text=True,
        timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
             "JAX_PLATFORMS": "cpu"})


def _bytes_line(stdout):
    lines = [ln for ln in stdout.splitlines() if ln.startswith("icq-kv:")]
    assert len(lines) == 1, stdout
    return lines[0].split(";", 1)[1]


def test_icq_kv_on_a_moe_arch_runs_the_standalone_demo():
    """``--icq-kv`` on an arch ICQ-KV does not serve (MoE here) no longer
    exits with "has no dense KV cache": it serves the arch, then runs the
    reference's standalone ICQ-KV demonstration on the arch's head
    geometry; its bytes line equals the reference launcher's."""
    args = ["--arch", "moonshot-v1-16b-a3b", "--smoke", "--icq-kv",
            "--prompt-len", "16", "--decode-steps", "2", "--batch", "2"]
    port = _cli("repro_torch.launch.serve", *args, "--device", "cpu")
    assert port.returncode == 0, port.stderr
    assert "has no dense KV cache" not in port.stderr
    assert "prefill: 16 tokens x 2" in port.stdout
    assert "decode: 2 steps" in port.stdout
    err = float(port.stdout.split("icq-kv: max err ")[1].split(";")[0])
    assert np.isfinite(err)
    ref = _cli("repro.launch.serve", *args)
    assert ref.returncode == 0, ref.stderr
    assert _bytes_line(port.stdout) == _bytes_line(ref.stdout)
