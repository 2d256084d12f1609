"""The port's ICQ-KV quantization held against the reference's on the
CPU: the same numpy K/V, queries and params through ``repro.quant`` and
``repro_torch.quant``.

Exact where the reference is exact: the int8 codes (round half to even,
clipped to +-127), the variance permutation, the bf16 crude slab and
the positions written.  Scales to rtol 1e-6 (one f32 division).
Attention outputs and logits to rtol 1e-5 with an atol of 1e-6 times the
reference's largest magnitude (f32 sums in another order); the ICQ-KV
decode step within ``test_torch_lm``'s f32 tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro import quant as ref_quant
from repro.models import build_model as ref_build_model
from repro.quant import kv_cache as ref_kv
from repro.quant import serve_icq as ref_serve_icq
from repro_torch import configs
from repro_torch import quant
from repro_torch.launch.serve import icq_caches_from_prefill
from repro_torch.models import build_model
from repro_torch.models.transformer import params_from_numpy
from repro_torch.quant import kv_cache as port_kv
from repro_torch.quant import serve_icq as port_serve_icq


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = jnp.asarray(x)
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def _close(got, want, rtol=1e-5):
    got, want = _np(got), _np(want)
    atol = 1e-6 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _structured_kv(seed, b, s, kvh, dh, hot=8):
    """Keys with a high-variance subspace (the reference test's regime)."""
    rng = np.random.default_rng(seed)
    scale = np.concatenate([np.full(hot, 3.0), np.full(dh - hot, 0.3)])
    scale = scale[rng.permutation(dh)].astype(np.float32)
    k = (rng.standard_normal((b, s, kvh, dh)) * scale).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, dh)).astype(np.float32)
    return k, v, scale


def _same_cache(port, ref):
    for name in ("perm", "k_fast", "kq", "vq", "len"):
        assert np.array_equal(_np(port[name]), _np(ref[name])), name
    for name in ("ks", "vs"):
        np.testing.assert_allclose(_np(port[name]), _np(ref[name]),
                                   rtol=1e-6, err_msg=name)


# ------------------------------------------------------------------- int8 --

@pytest.mark.parametrize("shape,axis,scale", [
    ((32, 64), -1, 5.0), ((3, 7, 2, 16), -1, 0.01), ((17, 9), 0, 100.0)])
def test_int8_codes_equal_reference(shape, axis, scale):
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    x.flat[::7] = 0.0
    x.flat[1] = np.float32(127.5)            # a rounding tie at the top
    rq, rs = ref_quant.quantize_int8(x, axis)
    pq, ps = quant.quantize_int8(_t(x), axis)
    assert pq.dtype == torch.int8
    assert np.array_equal(pq.numpy(), np.asarray(rq))
    np.testing.assert_allclose(ps.numpy(), np.asarray(rs), rtol=1e-6)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        _close(quant.dequantize_int8(pq, ps, dt),
               ref_quant.dequantize_int8(rq, rs, jdt))


def test_int8_roundtrip_error_bounded():
    x = np.random.default_rng(0).standard_normal((32, 64)).astype(
        np.float32) * 5
    q, s = quant.quantize_int8(_t(x))
    rec = quant.dequantize_int8(q, s).numpy()
    bound = np.abs(x).max(-1, keepdims=True) / 127.0
    assert (np.abs(rec - x) <= bound / 2 + 1e-6).all()


# ---------------------------------------------------------------- ICQ-KV --

@pytest.mark.parametrize("hot", [4, 8, 0])
def test_variance_perm_equals_reference(hot):
    k, _, _ = _structured_kv(hot, 2, 96, 3, 32, hot=hot)
    want = np.asarray(ref_kv._variance_perm(k))
    got = port_kv._variance_perm(_t(k))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_build_cache_equals_reference():
    k, v, _ = _structured_kv(1, 2, 40, 2, 32)
    cfg_r, cfg_p = ref_quant.ICQKVConfig(d_fast=8), quant.ICQKVConfig(d_fast=8)
    ref = ref_quant.build_icq_kv_cache(cfg_r, k, v, max_len=64)
    got = quant.build_icq_kv_cache(cfg_p, _t(k), _t(v), max_len=64)
    assert got["k_fast"].dtype == torch.bfloat16
    _same_cache(got, ref)
    init_r = ref_quant.init_icq_kv_cache(cfg_r, 2, 64, 2, 32)
    init_p = quant.init_icq_kv_cache(cfg_p, 2, 64, 2, 32, device="cpu")
    for name in init_r:
        assert np.array_equal(_np(init_p[name]), _np(init_r[name])), name


def test_append_equals_reference_and_build():
    """Appending positions 96..127 one at a time writes what the
    reference writes; the result serves as a cache built in one go does
    (the reference's consistency test)."""
    b, s, kvh, g, dh = 1, 128, 2, 2, 32
    k, v, _ = _structured_kv(2, b, s, kvh, dh)
    cfg_r, cfg_p = ref_quant.ICQKVConfig(d_fast=8), quant.ICQKVConfig(d_fast=8)
    ref = ref_quant.build_icq_kv_cache(cfg_r, k[:, :96], v[:, :96], max_len=s)
    got = quant.build_icq_kv_cache(cfg_p, _t(k[:, :96]), _t(v[:, :96]),
                                   max_len=s)
    for pos in range(96, 128):
        ref = ref_quant.icq_kv_append(ref, cfg_r, k[:, pos:pos + 1],
                                      v[:, pos:pos + 1], pos)
        got = quant.icq_kv_append(got, cfg_p, _t(k[:, pos:pos + 1]),
                                  _t(v[:, pos:pos + 1]),
                                  torch.tensor(pos, dtype=torch.int32))
    _same_cache(got, ref)
    full = quant.build_icq_kv_cache(cfg_p, _t(k), _t(v), max_len=s)
    q = np.random.default_rng(9).standard_normal((b, 1, kvh * g, dh)).astype(
        np.float32)
    o1 = quant.icq_kv_decode_attention(_t(q), got, cfg_p, 127, top_c=32)
    o2 = quant.icq_kv_decode_attention(_t(q), full, cfg_p, 127, top_c=32)
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), rtol=0.15, atol=0.05)
    _close(o1, ref_quant.icq_kv_decode_attention(q, ref, cfg_r, 127,
                                                 top_c=32))


@pytest.mark.parametrize("top_c,pos", [(32, 127), (64, 100), (128, 127),
                                       (16, 10)])
def test_decode_attention_matches_reference(top_c, pos):
    b, s, kvh, g, dh = 2, 128, 2, 4, 32
    k, v, dim_scale = _structured_kv(3, b, s, kvh, dh)
    q = (np.random.default_rng(4).standard_normal((b, 1, kvh * g, dh))
         * dim_scale).astype(np.float32)
    cfg_r, cfg_p = (ref_quant.ICQKVConfig(d_fast=8),
                    quant.ICQKVConfig(d_fast=8))
    ref = ref_quant.build_icq_kv_cache(cfg_r, k, v, max_len=s)
    got = quant.build_icq_kv_cache(cfg_p, _t(k), _t(v), max_len=s)
    _close(quant.icq_kv_decode_attention(_t(q), got, cfg_p, pos, top_c),
           ref_quant.icq_kv_decode_attention(q, ref, cfg_r, pos, top_c))
    _close(port_kv.reference_decode_attention(_t(q), _t(k), _t(v), pos),
           ref_kv.reference_decode_attention(q, k, v, pos))


def test_duplicated_keys_keep_the_reference_survivors():
    """Equal crude scores among real keys: the survivors are the lowest
    positions, as ``lax.top_k`` picks them."""
    b, s, kvh, g, dh = 1, 64, 1, 2, 16
    k, v, _ = _structured_kv(5, b, s, kvh, dh)
    k[:, 20:40] = k[:, 3:4]                   # 21 copies of one key
    q = np.random.default_rng(6).standard_normal((b, 1, kvh * g, dh)).astype(
        np.float32)
    cfg_r, cfg_p = (ref_quant.ICQKVConfig(d_fast=4),
                    quant.ICQKVConfig(d_fast=4))
    for top_c in (5, 12):
        _close(quant.icq_kv_decode_attention(
                   _t(q), quant.build_icq_kv_cache(cfg_p, _t(k), _t(v), s),
                   cfg_p, s - 1, top_c),
               ref_quant.icq_kv_decode_attention(
                   q, ref_quant.build_icq_kv_cache(cfg_r, k, v, s), cfg_r,
                   s - 1, top_c))


def test_full_top_c_is_attention_over_the_dequantized_cache():
    """top_c = S disables pruning: the result is exact attention over
    the int8-dequantized cache (and near the raw cache's)."""
    b, s, kvh, g, dh = 1, 64, 2, 2, 16
    k, v, _ = _structured_kv(7, b, s, kvh, dh, hot=4)
    q = np.random.default_rng(8).standard_normal((b, 1, kvh * g, dh)).astype(
        np.float32)
    cfg = quant.ICQKVConfig(d_fast=16)
    cache = quant.build_icq_kv_cache(cfg, _t(k), _t(v), max_len=s)
    out = quant.icq_kv_decode_attention(_t(q), cache, cfg, s - 1, top_c=s)
    inv = torch.argsort(cache["perm"].long(), dim=-1)
    kd = quant.dequantize_int8(cache["kq"], cache["ks"])
    kd = torch.gather(kd, -1, inv[None, None].expand(kd.shape))
    vd = quant.dequantize_int8(cache["vq"], cache["vs"])
    _close(out, port_kv.reference_decode_attention(_t(q), kd, vd, s - 1))
    np.testing.assert_allclose(
        out.numpy(), np.asarray(ref_kv.reference_decode_attention(
            q, k, v, s - 1)), rtol=0.05, atol=0.05)


def test_partials_combine_like_the_reference():
    b, s, kvh, g, dh = 1, 128, 2, 2, 32
    k, v, dim_scale = _structured_kv(9, b, s, kvh, dh)
    q = (np.random.default_rng(10).standard_normal((b, 1, kvh * g, dh))
         * dim_scale).astype(np.float32)
    cfg_r, cfg_p = (ref_quant.ICQKVConfig(d_fast=8),
                    quant.ICQKVConfig(d_fast=8))
    ref = ref_quant.build_icq_kv_cache(cfg_r, k, v, max_len=s)
    got = quant.build_icq_kv_cache(cfg_p, _t(k), _t(v), max_len=s)
    pr, pp = [], []
    for sh in range(2):
        sl = slice(sh * 64, (sh + 1) * 64)
        rc = {n: (a if n in ("perm", "len") else a[:, sl])
              for n, a in ref.items()}
        pc = {n: (a if n in ("perm", "len") else a[:, sl])
              for n, a in got.items()}
        pr.append(ref_kv.icq_kv_attention_partial(q, rc, cfg_r, 100, 16,
                                                  shard_offset=sh * 64))
        pp.append(port_kv.icq_kv_attention_partial(_t(q), pc, cfg_p, 100, 16,
                                                   shard_offset=sh * 64))
        for a, w in zip(pp[-1], pr[-1]):
            _close(a, w)
    want = ref_kv.combine_partials_local(*(jnp.stack(x) for x in zip(*pr)))
    _close(port_kv.combine_partials_local(*(torch.stack(x)
                                            for x in zip(*pp))), want)


# ------------------------------------------------------- the decode step --

@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma-7b"])
def test_icq_decode_step_matches_reference(arch):
    """``build_icq_decode``'s step from the reference's params, its
    caches quantized per layer from the prefill's K/V, 3 steps."""
    rcfg, pcfg = ref_configs.smoke_config(arch), configs.smoke_config(arch)
    assert port_serve_icq.supports_icq_kv(pcfg) and \
        ref_serve_icq.supports_icq_kv(rcfg)
    kv_r, kv_p = ref_quant.ICQKVConfig(d_fast=8), quant.ICQKVConfig(d_fast=8)
    rmodel = ref_build_model(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    pparams = params_from_numpy(jax.tree.map(np.asarray, rparams),
                                device="cpu")
    b, s, max_len, top_c = 2, 16, 24, 8
    toks = np.random.default_rng(0).integers(0, rcfg.vocab_size, (b, s),
                                             dtype=np.int32)
    logits, dense = build_model(pcfg).prefill(pparams, {"tokens": toks},
                                              max_len)
    caches = icq_caches_from_prefill(kv_p, dense, s, max_len)
    k = dense["seg0"]["k"].numpy()[:, :, :s]
    v = dense["seg0"]["v"].numpy()[:, :, :s]
    per = [ref_quant.build_icq_kv_cache(kv_r, k[li], v[li], max_len)
           for li in range(rcfg.num_layers)]
    rcaches = {"pos": jnp.asarray(s, jnp.int32), "layers": jax.tree.map(
        lambda *a: jnp.stack(a), *per)}
    for name in per[0]:
        assert np.array_equal(_np(caches["layers"][name]),
                              _np(rcaches["layers"][name])), name
    rdecode, _ = ref_serve_icq.build_icq_decode(rcfg, kv_r)
    rstep = jax.jit(lambda p, t, c: rdecode(p, t, c, top_c=top_c))
    pdecode, _ = port_serve_icq.build_icq_decode(pcfg, kv_p)
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None].numpy()
    for _ in range(3):
        rl, rcaches = rstep(rparams, tok, rcaches)
        pl, caches = pdecode(pparams, torch.from_numpy(tok), caches,
                             top_c=top_c)
        bound = 1e-5 * max(1.0, float(np.abs(np.asarray(rl)).max()))
        assert float(np.abs(pl.numpy() - np.asarray(rl)).max()) <= bound
        assert int(caches["pos"]) == int(rcaches["pos"])
        tok = np.asarray(jnp.argmax(rl[:, -1], -1)).astype(np.int32)[:, None]
        assert np.array_equal(pl[:, -1].argmax(-1).numpy(), tok[:, 0])
    assert np.array_equal(caches["layers"]["len"].numpy(),
                          np.asarray(rcaches["layers"]["len"]))


def test_icq_decode_refuses_what_it_does_not_serve():
    for arch in ("mamba2-1.3b", "recurrentgemma-9b"):
        with pytest.raises(NotImplementedError,
                           match="supports_icq_kv.*has no dense KV cache"):
            port_serve_icq.build_icq_decode(configs.smoke_config(arch),
                                            quant.ICQKVConfig())
    # a mesh is accepted and, as in the reference, unused
    from repro_torch.distributed.sharding import make_mesh_auto
    mesh = make_mesh_auto((1, 1), ("data", "model"), devices="cpu")
    step, init = port_serve_icq.build_icq_decode(
        configs.smoke_config("gemma-7b"), quant.ICQKVConfig(), mesh=mesh)
    assert callable(step) and init(1, 8, device="cpu")["pos"].ndim == 0
    assert port_serve_icq.AnnEngine.__module__ == "repro_torch.api.serving"
    for arch in configs.list_archs():
        assert port_serve_icq.supports_icq_kv(configs.get_config(arch)) == \
            ref_serve_icq.supports_icq_kv(ref_configs.get_config(arch))
