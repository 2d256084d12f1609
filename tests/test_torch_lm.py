"""The port's dense-LM serving path held against the reference's, on the
CPU at ``smoke_config`` size.

The reference builds each model and draws its params
(``init(PRNGKey(0))``); they cross over as numpy through
``params_from_numpy``, and the same numpy token ids go through the
reference's jitted ``prefill`` / ``decode_step`` and the port's.  One
reference model per (arch, dtype, attn_impl, attn_chunk) is built and
jitted once for the module (``_ref``).

Tolerances, by the compute dtype: each value within ``TOL[dtype]`` times
the largest magnitude of the reference's tensor (at least 1).  f32:
1e-5, about 80 f32 ulps at the largest value, the rounding of a few
layers' sums of d_model products taken in another order.  bf16: 2^-5,
four bf16 ulps at the largest value: every product's output rounds to 8
bits in both, in other orders.  Greedy tokens are equal wherever the
reference's top-2 logit gap exceeds that tolerance (at these sizes: all
of them).
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
from repro.models import build_model as ref_build_model
from repro.models import attention as ref_attn
from repro.models import nn as ref_nn
from repro_torch import configs
from repro_torch.launch.serve import serve_lm
from repro_torch.launch.steps import build_serve_fns, scale_config
from repro_torch.models import attention as port_attn
from repro_torch.models import build_model
from repro_torch.models import nn as port_nn
from repro_torch.models.transformer import params_from_numpy

DENSE = ["tinyllama-1.1b", "llama3-405b", "gemma-7b", "granite-3-8b"]
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
def _ref(arch, bf16=False, attn_impl="chunked", attn_chunk=1024):
    """The reference's model, params (jax and numpy) and jitted serving
    functions, built once per key for the module."""
    cfg, _ = _cfgs(arch, bf16, attn_chunk=attn_chunk)
    model = ref_build_model(cfg, attn_impl=attn_impl)
    params = model.init(jax.random.PRNGKey(0))
    prefill = jax.jit(model.prefill, static_argnums=2)
    decode = jax.jit(model.decode_step)
    return model, params, jax.tree.map(np.asarray, params), prefill, decode


def _tokens(vocab, b=2, s=16, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def _serve_both(arch, *, bf16=False, attn_impl="chunked", attn_chunk=1024,
                steps=3, b=2, s=16, max_len=24):
    """Prefill then ``steps`` greedy decode steps in both packages from
    the same params and prompt; the port is fed the reference's greedy
    tokens.  Returns the (ref, port) logits and caches of each stage
    (the port's caches as copies: its decode writes them in place)."""
    rcfg, pcfg = _cfgs(arch, bf16, attn_chunk=attn_chunk)
    _, rparams, nparams, rprefill, rdecode = _ref(arch, bf16, attn_impl,
                                                  attn_chunk)
    pmodel = build_model(pcfg, attn_impl=attn_impl)
    pparams = params_from_numpy(nparams, device="cpu")
    toks = _tokens(rcfg.vocab_size, b, s)
    rl, rc = rprefill(rparams, {"tokens": toks}, max_len)
    pl, pc = pmodel.prefill(pparams, {"tokens": toks}, max_len)
    snap = lambda c: {"pos": c["pos"].clone(), "seg0": {
        kv: c["seg0"][kv].clone() for kv in ("k", "v")}}
    stages = [("prefill", rl, pl, rc, snap(pc))]
    for i in range(steps):
        tok = np.asarray(jnp.argmax(rl[:, -1], -1)).astype(np.int32)[:, None]
        ptok = pl[:, -1].float().argmax(-1).numpy()
        assert np.array_equal(ptok, tok[:, 0]), (arch, i, ptok, tok)
        rl, rc = rdecode(rparams, tok, rc)
        pl, pc = pmodel.decode_step(pparams, torch.from_numpy(tok), pc)
        stages.append((f"decode {i}", rl, pl, rc, snap(pc)))
    return pcfg, stages


def _check_stages(pcfg, stages, dtype):
    for name, rl, pl, rc, pc in stages:
        assert pl.dtype == getattr(torch, pcfg.compute_dtype), name
        _close(pl, rl, dtype, f"{name} logits")
        assert int(pc["pos"]) == int(rc["pos"]), name
        for kv in ("k", "v"):
            _close(pc["seg0"][kv], rc["seg0"][kv], dtype, f"{name} {kv}")


# ---------------------------------------------------------------- configs --

@pytest.mark.parametrize("arch", ref_configs.list_archs())
def test_configs_equal_reference(arch):
    assert configs.list_archs() == ref_configs.list_archs()
    for fn in ("get_config", "smoke_config"):
        ref, port = getattr(ref_configs, fn)(arch), getattr(configs, fn)(arch)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), fn
        for prop in ("padded_vocab", "q_dim", "kv_dim", "attn_free",
                     "supports_long_context"):
            assert getattr(port, prop) == getattr(ref, prop), prop
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
        assert list(configs.shapes_for(port)) == list(
            ref_configs.shapes_for(ref))
        assert configs.skipped_shapes_for(port) == \
            ref_configs.skipped_shapes_for(ref)
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()}


# ------------------------------------------------------------- primitives --

def test_nn_primitives_match_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32) * 3
    pos = np.arange(5, dtype=np.int32)
    _close(port_nn.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              5e5),
           ref_nn.apply_rope(x, pos, 5e5), "float32", "rope")
    pos2 = np.full((2, 1), 7, np.int32)
    _close(port_nn.apply_rope(torch.from_numpy(x[:, :1]),
                              torch.from_numpy(pos2)),
           ref_nn.apply_rope(x[:, :1], pos2), "float32", "rope decode")
    h = rng.standard_normal((4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    p = {"scale": scale, "bias": rng.standard_normal(16).astype(np.float32)}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    _close(port_nn.rmsnorm(torch.from_numpy(h), torch.from_numpy(scale)),
           ref_nn.rmsnorm(h, scale), "float32", "rmsnorm")
    _close(port_nn.layernorm(torch.from_numpy(h), tp),
           ref_nn.layernorm(h, p), "float32", "layernorm")
    for kind in ("swiglu", "geglu"):
        _close(port_nn.gated_act(kind, torch.from_numpy(h),
                                 torch.from_numpy(h[::-1].copy())),
               ref_nn.gated_act(kind, h, h[::-1]), "float32", kind)
    hb = torch.from_numpy(h).to(torch.bfloat16)
    _close(port_nn.rmsnorm(hb, torch.from_numpy(scale).to(torch.bfloat16)),
           ref_nn.rmsnorm(jnp.asarray(h, jnp.bfloat16),
                          jnp.asarray(scale, jnp.bfloat16)),
           "bfloat16", "rmsnorm bf16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_functions_match_reference(dtype):
    """The CPU twins of full / chunked / triangular / decode attention,
    with GQA, windows and a key padding mask."""
    rng = np.random.default_rng(2)
    b, s, H, KVH, dh = 2, 16, 4, 2, 16
    q, k, v = (rng.standard_normal((b, s, n, dh)).astype(np.float32)
               for n in (H, KVH, KVH))
    jd = getattr(jnp, dtype)
    rq, rk, rv = (jnp.asarray(a, jd) for a in (q, k, v))
    pq, pk, pv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    for causal, window in ((True, 0), (False, 0), (True, 5)):
        _close(port_attn.full_attention(pq, pk, pv, causal=causal,
                                        window=window),
               ref_attn.full_attention(rq, rk, rv, causal=causal,
                                       window=window), dtype, "full")
        _close(port_attn.chunked_attention(pq, pk, pv, causal=causal,
                                           chunk=4, window=window),
               ref_attn.chunked_attention(rq, rk, rv, causal=causal, chunk=4,
                                          window=window), dtype, "chunked")
    _close(port_attn.chunked_attention(pq, pk, pv, causal=False, chunk=8,
                                       kv_valid=11),
           ref_attn.chunked_attention(rq, rk, rv, causal=False, chunk=8,
                                      kv_valid=11), dtype, "kv_valid")
    for window in (0, 6):
        _close(port_attn.triangular_chunked_attention(pq, pk, pv, chunk=4,
                                                      window=window),
               ref_attn.triangular_chunked_attention(rq, rk, rv, chunk=4,
                                                     window=window),
               dtype, "triangular")
    mask = np.arange(s)[None, :] <= np.array([[5], [11]])
    _close(port_attn.decode_attention(pq[:, :1], pk, pv,
                                      torch.from_numpy(mask)),
           ref_attn.decode_attention(rq[:, :1], rk, rv, mask), dtype,
           "decode")


# ------------------------------------------------------------------ model --

@pytest.mark.parametrize("attn_impl", ["full", "chunked", "triangular"])
def test_layer_apply_matches_reference(attn_impl):
    """The full-sequence dense layer (``layer_apply`` through
    ``attention_apply``) on layer 0 of the reference's params."""
    from repro.models import transformer as ref_tf
    from repro_torch.models import transformer as port_tf
    rcfg, pcfg = _cfgs("gemma-7b", attn_chunk=8)
    nparams = _ref("gemma-7b", attn_chunk=8)[2]
    lp = jax.tree.map(lambda a: a[0], nparams["seg0"])
    x = np.random.default_rng(3).standard_normal((2, 16, rcfg.d_model)) \
        .astype(np.float32)
    pos = np.arange(16)
    want, _ = ref_tf.layer_apply(lp, x, rcfg, pos, "dense",
                                 attn_impl=attn_impl)
    got, aux = port_tf.layer_apply(params_from_numpy(lp, device="cpu"),
                                   torch.from_numpy(x), pcfg,
                                   torch.from_numpy(pos), "dense",
                                   attn_impl=attn_impl)
    _close(got, want, "float32", attn_impl)
    assert float(aux) == 0.0


def test_init_tree_matches_reference():
    """The port's own init draws the reference's tree: same leaves,
    shapes and dtypes (values differ: other random streams)."""
    for arch in ("tinyllama-1.1b", "gemma-7b"):
        for bf16 in (False, True):
            _, pcfg = _cfgs(arch, bf16)
            ref = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                               _ref(arch, bf16)[2])
            got = build_model(pcfg).init(0, device="cpu")
            got = jax.tree.map(lambda a: (tuple(a.shape),
                                          str(a.dtype).split(".")[-1]), got)
            assert got == ref, arch


@pytest.mark.parametrize("arch", DENSE)
def test_dense_prefill_decode_match_reference(arch):
    """Prefill logits, the K/V caches and 3 greedy decode steps."""
    pcfg, stages = _serve_both(arch)
    _check_stages(pcfg, stages, "float32")


@pytest.mark.parametrize("attn_impl", ["full", "chunked", "triangular"])
def test_attn_impls_match_reference(attn_impl):
    """attn_chunk 8 with a 16-token prompt, so the chunked branches of
    the prefill run."""
    pcfg, stages = _serve_both("llama3-405b", attn_impl=attn_impl,
                               attn_chunk=8)
    _check_stages(pcfg, stages, "float32")


@pytest.mark.parametrize("arch", ["gemma-7b", "tinyllama-1.1b"])
def test_scale_config_bf16_matches_reference(arch):
    """bf16 params and compute (gemma: GeGLU, tied embeddings scaled by
    sqrt(d) in bf16)."""
    pcfg, stages = _serve_both(arch, bf16=True)
    _check_stages(pcfg, stages, "bfloat16")


def test_prefill_decode_consistency():
    """Decoding token t+1 after prefill(0..t) matches a longer prefill's
    last-position logits (twin of the reference's smoke test), from the
    port's own init."""
    _, cfg = _cfgs("tinyllama-1.1b")
    m = build_model(cfg)
    params = m.init(0, device="cpu")
    toks = _tokens(cfg.vocab_size, 1, 17, seed=7)
    logits_full, _ = m.prefill(params, {"tokens": toks}, 32)
    _, cache = m.prefill(params, {"tokens": toks[:, :16]}, 32)
    logits_step, cache = m.decode_step(params, torch.from_numpy(
        toks[:, 16:17]), cache)
    assert int(cache["pos"]) == 17
    np.testing.assert_allclose(logits_step[:, 0].numpy(),
                               logits_full[:, -1].numpy(), rtol=2e-2,
                               atol=2e-3)


def test_serve_lm_matches_reference_greedy():
    """``serve_lm`` (the CLI's path) on the reference's params and the
    reference launcher's prompt (default_rng(0)) generates the
    reference's greedy tokens."""
    rcfg, pcfg = _cfgs("granite-3-8b")
    model, rparams, nparams, rprefill, rdecode = _ref("granite-3-8b")
    out = serve_lm(pcfg, prompt_len=12, decode_steps=4, batch=2,
                   device="cpu", params=params_from_numpy(nparams,
                                                          device="cpu"),
                   verbose=False)
    toks = np.random.default_rng(0).integers(0, rcfg.vocab_size, (2, 12),
                                             dtype=np.int32)
    logits, cache = rprefill(rparams, {"tokens": toks}, 16)
    want = []
    for _ in range(5):
        tok = np.asarray(jnp.argmax(logits[:, -1], -1)).astype(np.int32)
        want.append(tok)
        logits, cache = rdecode(rparams, tok[:, None], cache)
    assert np.array_equal(out["tokens"], np.stack(want, axis=1))
    assert out["logits"].shape == (2, 5, rcfg.vocab_size)
    assert out["launches"] == {"prefill": 0, "decode": 0}


def test_unported_families_raise_naming_their_item():
    for arch in ("deepseek-v2-236b", "moonshot-v1-16b-a3b",    # item 19
                 "mamba2-1.3b", "recurrentgemma-9b",           # item 20
                 "whisper-large-v3", "internvl2-76b"):         # item 21
        for cfg in (configs.get_config(arch), configs.smoke_config(arch)):
            assert build_model(cfg).cfg is cfg
    # LM sharding (item 23) and tensor parallelism (items 31, 38) are
    # ported: over (data 2, model 2) a dense model's prefill and an
    # SSM's run split over the model axis, their logits within 2e-5 of
    # the largest of the unsharded ones (f32 partials summed in another
    # order)
    from repro_torch.distributed.sharding import make_mesh_auto
    mesh = make_mesh_auto((2, 2), ("data", "model"), devices="cpu")
    for arch, tol in (("tinyllama-1.1b", 2e-5), ("mamba2-1.3b", 2e-5)):
        cfg = configs.smoke_config(arch)
        params = build_model(cfg).init(0, device="cpu")
        toks = _tokens(cfg.vocab_size, 2, 8)
        prefill, _, _ = build_serve_fns(cfg, mesh=mesh)
        got, _ = prefill(params, {"tokens": toks}, 12)
        want, _ = build_model(cfg).prefill(params, {"tokens": toks}, 12)
        assert float((got - want).abs().max()) <= \
            tol * float(want.abs().max()), arch
        assert build_model(cfg, mesh=mesh).cfg is cfg
        assert build_model(cfg, mesh=mesh).split == (tol > 0)
    cfg = configs.smoke_config("tinyllama-1.1b")
    # LM training (item 22) is ported: train_forward gives a finite loss
    model = build_model(cfg)
    toks = _tokens(cfg.vocab_size, 1, 8)
    loss, aux = model.train_forward(model.init(0, device="cpu"),
                                    {"tokens": toks, "labels": toks})
    assert bool(torch.isfinite(loss)) and float(aux["aux"]) == 0.0


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is valid")
    cfg = configs.smoke_config("tinyllama-1.1b")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        build_model(cfg).init(0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        params_from_numpy({"w": np.zeros(2, np.float32)})


@pytest.mark.parametrize("icq", [False, True])
def test_cli_serves_a_dense_lm_on_the_cpu(icq):
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "tinyllama-1.1b", "--smoke", "--device", "cpu", "--prompt-len",
           "16", "--decode-steps", "3", "--batch", "2"]
    out = subprocess.run(cmd + (["--icq-kv"] if icq else []),
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ,
                              "PYTHONPATH": os.path.join(ROOT, "src")})
    assert out.returncode == 0, out.stderr
    assert "prefill: 16 tokens x 2" in out.stdout
    assert "decode: 3 steps" in out.stdout
    assert ("icq-kv: d_fast=16" in out.stdout) == icq
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    # the SSM and the hybrid serve (a prompt past the hybrid's window of
    # 32); --icq-kv there runs the standalone demonstration
    for arch in ("mamba2-1.3b", "recurrentgemma-9b"):
        ok = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
             arch, "--smoke", "--device", "cpu", "--prompt-len", "40",
             "--decode-steps", "3", "--batch", "2"]
            + (["--icq-kv"] if icq else []), capture_output=True, text=True,
            timeout=120, env=env)
        assert ok.returncode == 0, ok.stderr
        assert "prefill: 40 tokens x 2" in ok.stdout
        assert "decode: 3 steps" in ok.stdout
        assert ("icq-kv: max err" in ok.stdout) == icq
    # whisper serves (its refusal until the encoder-decoder was ported);
    # an unknown arch exits with a one-line error
    ok = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                         "--arch", "whisper-large-v3", "--smoke", "--device",
                         "cpu", "--prompt-len", "16", "--decode-steps", "3",
                         "--batch", "2"], capture_output=True, text=True,
                        timeout=120, env=env)
    assert ok.returncode == 0, ok.stderr
    assert "prefill: 16 tokens x 2" in ok.stdout
    bad = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--arch", "whisper-tiny", "--smoke", "--device",
                          "cpu"], capture_output=True, text=True,
                         timeout=120, env=env)
    assert bad.returncode != 0 and "unknown arch" in bad.stderr
    assert len(bad.stderr.strip().splitlines()) == 1
