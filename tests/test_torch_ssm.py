"""The port's SSM (Mamba-2 SSD) and hybrid (RG-LRU + windowed local
attention) LMs held against the reference's, on the CPU at small size.

The same numpy inputs, made from a seed, go through the reference's
functions and the port's: the SSD scan (a length that divides the chunk
and a ragged one, with and without an initial state), the Mamba-2 block
and its decode step, the RG-LRU core (the port's log-depth doubling
scan against ``jax.lax.associative_scan``, with and without h0) and its
decode step, and the flash kernel's plain version under a window
against the reference's full and chunked attention.  The slice as a
whole: both archs' ``smoke_config`` through ``build_model`` -> prefill
-> 4 greedy decode steps, from the reference's params carried across by
``params_from_numpy``; the hybrid at ``num_layers=5`` (one group of
(rglru, local) ... two groups and a tail layer) with a prompt longer
than its window of 32, so that the band masks and the ring wraps.

Tolerances, each value within TOL times the largest magnitude of the
reference's tensor (at least 1): f32 1e-5 (the scans sum in another
order than XLA's: the SSD's chunk states in a Python loop, the RG-LRU
in doubling steps against XLA's odd/even tree); bf16 2^-5, four bf16
ulps at the largest value (both round every product's output to 8
bits, in other orders).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.launch.steps import scale_config as ref_scale_config
from repro.models import attention as ref_attn
from repro.models import build_model as ref_build_model
from repro.models import rglru as ref_rglru
from repro.models import ssm as ref_ssm
from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch.steps import scale_config
from repro_torch.models import attention as port_attn
from repro_torch.models import build_model
from repro_torch.models import rglru as port_rglru
from repro_torch.models import ssm as port_ssm
from repro_torch.models.transformer import params_from_numpy

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -5}
ARCHS = ("mamba2-1.3b", "recurrentgemma-9b")
HYBRID_LAYERS = 5


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype="float32", what=""):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = TOL[dtype] * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max err {err} > {bound}"


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(arch, bf16=False):
    repl = dict(num_layers=HYBRID_LAYERS) if arch == "recurrentgemma-9b" \
        else {}
    ref = dataclasses.replace(ref_configs.smoke_config(arch), **repl)
    port = dataclasses.replace(configs.smoke_config(arch), **repl)
    if bf16:
        ref, port = ref_scale_config(ref), scale_config(port)
    return ref, port


@functools.lru_cache(maxsize=None)
def _ref(arch, bf16=False):
    """The reference's model, params (jax and numpy) and jitted serving
    functions, built once per key for the module."""
    cfg, _ = _cfgs(arch, bf16)
    model = ref_build_model(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    prefill = jax.jit(model.prefill, static_argnums=2)
    decode = jax.jit(model.decode_step)
    return params, jax.tree.map(np.asarray, params), prefill, decode


# ------------------------------------------------------------------ SSD --

def _ssd_inputs(seed, b, l, h, p, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = -np.exp(rng.uniform(0.0, 2.0, h)).astype(np.float32)
    B, C = (rng.standard_normal((b, l, n)).astype(np.float32)
            for _ in range(2))
    D = rng.standard_normal(h).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, A, B, C, D, h0


@pytest.mark.parametrize("l,chunk", [(64, 16), (100, 32)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_reference(l, chunk, with_h0):
    """A length that divides the chunk (4 chunks of 16) and a ragged one
    (100 at chunk 32: the largest divisor below it, 25, four chunks)."""
    x, dt, A, B, C, D, h0 = _ssd_inputs(l + chunk, 2, l, 3, 8, 5)
    h0 = h0 if with_h0 else None
    assert port_ssm.chunk_len(l, chunk) == (16 if l == 64 else 25)
    want_y, want_s = jax.jit(ref_ssm.ssd_chunked, static_argnums=6)(
        x, dt, A, B, C, D, chunk, h0=h0)
    got_y, got_s = port_ssm.ssd_chunked(
        _t(x), _t(dt), _t(A), _t(B), _t(C), _t(D), chunk,
        h0=None if h0 is None else _t(h0))
    _close(got_y, want_y, what="y")
    _close(got_s, want_s, what="final state")


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


@pytest.mark.parametrize("bf16", [False, True])
def test_ssm_block_and_decode_match_reference(bf16):
    """The Mamba-2 block (return_state) and two decode steps from its
    cache, on layer 0's mixer of the reference's params."""
    rcfg, pcfg = _cfgs("mamba2-1.3b", bf16)
    dtype = rcfg.compute_dtype
    mixer = _layer0(_ref("mamba2-1.3b", bf16)[1]["seg0"])["mixer"]
    pmixer = params_from_numpy(mixer, device="cpu")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 20, rcfg.d_model)).astype(np.float32)
    rx, px = jnp.asarray(x, dtype), _t(x).to(getattr(torch, dtype))
    want, want_s = jax.jit(lambda p, x: ref_ssm.ssm_block_apply(
        p, x, rcfg, return_state=True))(mixer, rx)
    ref_step = jax.jit(lambda p, x, c: ref_ssm.ssm_decode_step(p, x, c, rcfg))
    got, got_s = port_ssm.ssm_block_apply(pmixer, px, pcfg,
                                          return_state=True)
    _close(got, want, dtype, "block out")
    _close(got_s, want_s, dtype, "block state")
    rcache = ref_ssm.ssm_init_cache(rcfg, 2, jnp.dtype(dtype))
    rcache["state"] = want_s
    pcache = port_ssm.ssm_init_cache(pcfg, 2, dtype)
    pcache["state"].copy_(_t(np.asarray(jnp.asarray(want_s, jnp.float32)))
                          .to(pcache["state"].dtype))
    for step in range(2):
        xt = rng.standard_normal((2, 1, rcfg.d_model)).astype(np.float32)
        ro, rcache = ref_step(mixer, jnp.asarray(xt, dtype), rcache)
        po, pcache = port_ssm.ssm_decode_step(
            pmixer, _t(xt).to(getattr(torch, dtype)), pcache, pcfg)
        _close(po, ro, dtype, f"decode {step} out")
        for name in ("state", "conv"):
            _close(pcache[name], rcache[name], dtype, f"decode {step} {name}")


# --------------------------------------------------------------- RG-LRU --

@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("l", [37, 64])
def test_rglru_core_matches_associative_scan(with_h0, l):
    _, pcfg = _cfgs("recurrentgemma-9b")
    rcfg = _cfgs("recurrentgemma-9b")[0]
    nparams = _ref("recurrentgemma-9b")[1]
    mixer = _layer0(nparams["groups"]["b0"])["mixer"]
    rng = np.random.default_rng(l)
    x = rng.standard_normal((2, l, rcfg.lru_width)).astype(np.float32)
    h0 = rng.standard_normal((2, rcfg.lru_width)).astype(np.float32) \
        if with_h0 else None
    want_y, want_h = jax.jit(ref_rglru._rglru_core)(mixer, x, h0=h0)
    got_y, got_h = port_rglru._rglru_core(
        params_from_numpy(mixer, device="cpu"), _t(x),
        h0=None if h0 is None else _t(h0))
    _close(got_y, want_y, what="hh")
    _close(got_h, want_h, what="h_last")


def test_linear_scan_equals_sequential_recurrence():
    """The doubling scan against the recurrence run step by step in
    float64 (no reference involved): h_t = a_t h_{t-1} + b_t."""
    rng = np.random.default_rng(9)
    a = rng.uniform(0.5, 1.0, (2, 45, 6))
    b = rng.standard_normal((2, 45, 6))
    aa, hh = port_rglru._linear_scan(_t(a), _t(b))
    h, prod = np.zeros((2, 6)), np.ones((2, 6))
    for t in range(45):
        h, prod = a[:, t] * h + b[:, t], prod * a[:, t]
        np.testing.assert_allclose(hh[:, t].numpy(), h, rtol=1e-12)
        np.testing.assert_allclose(aa[:, t].numpy(), prod, rtol=1e-12)


@pytest.mark.parametrize("bf16", [False, True])
def test_rglru_block_and_decode_match_reference(bf16):
    rcfg, pcfg = _cfgs("recurrentgemma-9b", bf16)
    dtype = rcfg.compute_dtype
    mixer = _layer0(_ref("recurrentgemma-9b", bf16)[1]["groups"]["b0"])[
        "mixer"]
    pmixer = params_from_numpy(mixer, device="cpu")
    assert pmixer["lambda"].dtype == torch.float32
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 19, rcfg.d_model)).astype(np.float32)
    rx, px = jnp.asarray(x, dtype), _t(x).to(getattr(torch, dtype))
    want, want_h = jax.jit(lambda p, x: ref_rglru.rglru_block_apply(
        p, x, rcfg, return_state=True))(mixer, rx)
    ref_step = jax.jit(lambda p, x, c: ref_rglru.rglru_decode_step(
        p, x, c, rcfg))
    got, got_h = port_rglru.rglru_block_apply(pmixer, px, pcfg,
                                              return_state=True)
    _close(got, want, dtype, "block out")
    _close(got_h, want_h, dtype, "h_last")
    rcache = ref_rglru.rglru_init_cache(rcfg, 2, jnp.dtype(dtype))
    rcache["h"] = jnp.asarray(want_h, jnp.float32)
    pcache = port_rglru.rglru_init_cache(pcfg, 2, dtype)
    pcache["h"].copy_(_t(np.asarray(rcache["h"])))
    for step in range(2):
        xt = rng.standard_normal((2, 1, rcfg.d_model)).astype(np.float32)
        ro, rcache = ref_step(mixer, jnp.asarray(xt, dtype), rcache)
        po, pcache = port_rglru.rglru_decode_step(
            pmixer, _t(xt).to(getattr(torch, dtype)), pcache, pcfg)
        _close(po, ro, dtype, f"decode {step} out")
        assert pcache["h"].dtype == torch.float32
        for name in ("h", "conv"):
            _close(pcache[name], rcache[name], dtype, f"decode {step} {name}")


# ------------------------------------------------------ windowed flash --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [1, 7, 32, 100])
def test_flash_window_matches_reference(dtype, window):
    """``flash_attention_torch(window=)`` and ``ops.flash_attention`` (MQA
    16 / 1 as recurrentgemma's, GQA 4 / 2) against the reference's full
    and chunked attention with the same band; the port's chunked
    attention too."""
    rng = np.random.default_rng(window)
    for b, s, H, KVH, dh in ((1, 48, 16, 1, 16), (2, 40, 4, 2, 8)):
        q, k, v = (rng.standard_normal((b, s, n, dh)).astype(np.float32)
                   for n in (H, KVH, KVH))
        jd, td = getattr(jnp, dtype), getattr(torch, dtype)
        rq, rk, rv = (jnp.asarray(a, jd) for a in (q, k, v))
        pq, pk, pv = (_t(a).to(td) for a in (q, k, v))
        full, chunked = jax.jit(lambda q, k, v: (
            ref_attn.full_attention(q, k, v, causal=True, window=window),
            ref_attn.chunked_attention(q, k, v, causal=True, chunk=8,
                                       window=window)))(rq, rk, rv)
        got = fa.flash_attention_torch(pq, pk, pv, causal=True, window=window)
        assert got.dtype == td
        _close(got, full, dtype, "flash vs full")
        _close(got, chunked, dtype, "flash vs chunked")
        _close(ops.flash_attention(pq, pk, pv, window=window), full, dtype,
               "ops")
        _close(port_attn.chunked_attention(pq, pk, pv, causal=True, chunk=8,
                                           window=window), chunked, dtype,
               "port chunked")


def test_flash_window_refuses_bad_calls():
    q = torch.zeros((1, 8, 2, 16))
    k = torch.zeros((1, 4, 2, 16))
    # a window with sq > sk is served (a query offset places its rows);
    # a window with the key-padding bound is refused
    assert fa.flash_attention_torch(q, k, k, window=3).shape == q.shape
    with pytest.raises(ValueError, match="kv_valid"):
        fa.flash_attention_torch(q, k, k, causal=False, window=3, kv_valid=2)
    with pytest.raises(ValueError, match="window must be >= 0"):
        fa.flash_attention_torch(q, q, q, window=-1)
    # a window that covers the whole prompt masks nothing
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 20, 2, 16), generator=g)
    assert torch.equal(fa.flash_attention_torch(q, q, q, window=20),
                       fa.flash_attention_torch(q, q, q))


@pytest.mark.parametrize("kind", ["ssm", "rglru", "local"])
def test_layer_apply_matches_reference(kind):
    """The full-sequence layer of each new kind (``layer_apply``: the
    local layer's window masking a 48-token input) on layer 0 of the
    reference's params."""
    from repro.models import transformer as ref_tf
    from repro_torch.models import transformer as port_tf
    arch = "mamba2-1.3b" if kind == "ssm" else "recurrentgemma-9b"
    rcfg, pcfg = _cfgs(arch)
    nparams = _ref(arch)[1]
    tree = (nparams["seg0"] if kind == "ssm"
            else nparams["groups"]["b0" if kind == "rglru" else "b1"])
    lp = _layer0(tree)
    x = np.random.default_rng(4).standard_normal((2, 48, rcfg.d_model)) \
        .astype(np.float32)
    pos = np.arange(48)
    want, _ = jax.jit(lambda p, x: ref_tf.layer_apply(p, x, rcfg, pos,
                                                      kind))(lp, x)
    got, aux = port_tf.layer_apply(params_from_numpy(lp, device="cpu"),
                                   _t(x), pcfg, _t(pos), kind)
    _close(got, want, what=kind)
    assert float(aux) == 0.0


# ------------------------------------------------------------ the slice --

def _caches_close(pc, rc, dtype, what):
    """Every buffer of the port's caches against the reference's (the
    reference's trees as numpy: ``pos`` and the layers' buffers)."""
    if isinstance(rc, dict):
        assert set(pc) == set(rc), (what, set(pc), set(rc))
        for key in rc:
            _caches_close(pc[key], rc[key], dtype, f"{what}/{key}")
        return
    rc = np.asarray(rc)
    if rc.dtype.kind in "iu":
        assert np.array_equal(pc.numpy(), rc), what
    else:
        assert str(pc.dtype).split(".")[-1] == str(rc.dtype), what
        _close(pc, rc, dtype, what)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_slice_prefill_decode_match_reference(arch, bf16):
    """Prefill (a 48-token prompt: past the hybrid's window of 32, 6 SSD
    chunks of 8) then 4 greedy decode steps, logits and every cache
    buffer after each, the port fed the reference's greedy tokens (equal
    to its own wherever the reference's top-2 gap exceeds the
    tolerance)."""
    rcfg, pcfg = _cfgs(arch, bf16)
    dtype = rcfg.compute_dtype
    rparams, nparams, rprefill, rdecode = _ref(arch, bf16)
    pmodel = build_model(pcfg)
    pparams = params_from_numpy(nparams, device="cpu")
    toks = np.random.default_rng(1).integers(0, rcfg.vocab_size, (2, 48),
                                             dtype=np.int32)
    max_len = 56
    rl, rc = rprefill(rparams, {"tokens": toks}, max_len)
    pl, pc = pmodel.prefill(pparams, {"tokens": toks}, max_len)
    if arch == "recurrentgemma-9b":
        assert set(pc) == {"pos", "groups", "tail0"}
        assert pc["groups"]["b1"]["k"].shape[2] == rcfg.local_window
    for stage in range(5):
        assert pl.dtype == getattr(torch, dtype)
        _close(pl, rl, dtype, f"{arch} stage {stage} logits")
        _caches_close(_clone(pc), jax.tree.map(np.asarray, rc), dtype,
                      f"{arch} stage {stage} caches")
        if stage == 4:
            break
        tok = np.asarray(jnp.argmax(rl[:, -1], -1)).astype(np.int32)[:, None]
        want = _f32(rl[:, -1])
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > TOL[dtype] * max(
            1.0, float(np.abs(want).max()))
        same = pl[:, -1].float().argmax(-1).numpy() == tok[:, 0]
        assert (same | ~clear).all(), (arch, stage)
        rl, rc = rdecode(rparams, tok, rc)
        pl, pc = pmodel.decode_step(pparams, _t(tok), pc)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_reference(arch):
    """The port's own init draws the reference's tree (groups, tail0,
    seg0): same leaves, shapes and dtypes (values differ: other random
    streams), and the caches' tree and shapes too."""
    for bf16 in (False, True):
        rcfg, pcfg = _cfgs(arch, bf16)
        ref = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                           _ref(arch, bf16)[1])
        model = build_model(pcfg)
        got = jax.tree.map(lambda a: (tuple(a.shape),
                                      str(a.dtype).split(".")[-1]),
                           model.init(0, device="cpu"))
        assert got == ref, (arch, bf16)
        rcache = ref_build_model(rcfg).init_cache(2, 40)
        pcache = model.init_cache(2, 40, device="cpu")
        assert jax.tree.map(lambda a: (tuple(a.shape),
                                       str(a.dtype).split(".")[-1]),
                            pcache) == \
            jax.tree.map(lambda a: (a.shape, str(a.dtype)), rcache)
