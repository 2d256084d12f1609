"""The port's encoder-decoder (whisper-large-v3) and VLM (internvl2-76b)
held against the reference's, on the CPU at small size.

The same numpy inputs, made from a seed, go through the reference's
functions and the port's: the ``enc`` and ``dec`` layers, cross
attention in both of its branches (whole, and padded to attn_chunk with
the padded keys masked by ``kv_valid``) and at decode, and the flash
kernel's plain version with the key-padding bound ``kv_valid`` against
the reference's ``chunked_attention(kv_valid=)`` (and the unpadded call
against the padded one's first rows, which is what the card computes).
The slice as a whole: both archs' ``smoke_config`` through
``build_model`` -> prefill -> 3 greedy decode steps from the
reference's params carried across by ``params_from_numpy``, logits and
every cache buffer (``k``, ``v``, whisper's cross ``ck`` / ``cv``, and
``pos``, which counts the VLM's vision tokens) after each, in f32 and
bf16 at attn_chunk 1024, and in f32 at attn_chunk 8 (whisper's 20
frames then pad to 24); ``serve_lm``'s greedy tokens against the
reference launcher's batch; the init trees; the command line.

Tolerances, each value within TOL times the largest magnitude of the
reference's tensor (at least 1): f32 1e-5 (sums in another order than
XLA's), bf16 2^-5, four bf16 ulps at the largest value (both round
every product's output to 8 bits, in other orders).
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
from repro.models import transformer as ref_tf
from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.launch.serve import lm_batch, serve_lm
from repro_torch.launch.steps import scale_config
from repro_torch.models import attention as port_attn
from repro_torch.models import build_model
from repro_torch.models import transformer as port_tf
from repro_torch.models.transformer import params_from_numpy

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -5}
ARCHS = ("whisper-large-v3", "internvl2-76b")
ENC_LEN = 20        # whisper's frames here: ragged against attn_chunk 8


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


def _cfgs(arch, bf16=False, attn_chunk=1024):
    repl = dict(attn_chunk=attn_chunk)
    if arch == "whisper-large-v3":
        repl["encoder_seq_len"] = ENC_LEN
    ref = dataclasses.replace(ref_configs.smoke_config(arch), **repl)
    port = dataclasses.replace(configs.smoke_config(arch), **repl)
    if bf16:
        ref, port = ref_scale_config(ref), scale_config(port)
    return ref, port


@functools.lru_cache(maxsize=None)
def _ref(arch, bf16=False, attn_chunk=1024):
    """The reference's params (jax and numpy) and jitted serving
    functions, built once per key for the module."""
    cfg, _ = _cfgs(arch, bf16, attn_chunk)
    model = ref_build_model(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    prefill = jax.jit(model.prefill, static_argnums=2)
    decode = jax.jit(model.decode_step)
    return params, jax.tree.map(np.asarray, params), prefill, decode


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _typed(a, dtype):
    """A numpy f32 array as (the reference's, the port's) operand of
    ``dtype``."""
    return jnp.asarray(a, dtype), _t(a).to(getattr(torch, dtype))


# --------------------------------------------------------------- layers --

@pytest.mark.parametrize("kind", ["enc", "dec"])
def test_layer_apply_matches_reference(kind):
    """The encoder layer (non-causal, learned positions: no rope) and the
    decoder layer (causal self-attention, then cross attention over 20
    encoder states) on layer 0 of the reference's params."""
    rcfg, pcfg = _cfgs("whisper-large-v3")
    nparams = _ref("whisper-large-v3")[1]
    lp = _layer0(nparams["enc_layers" if kind == "enc" else "seg0"])
    rng = np.random.default_rng(11)
    s = ENC_LEN if kind == "enc" else 12
    x = rng.standard_normal((2, s, rcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, ENC_LEN, rcfg.d_model)).astype(np.float32)
    pos = np.arange(s)
    want, _ = jax.jit(lambda p, x, e: ref_tf.layer_apply(
        p, x, rcfg, pos, kind, enc_out=e))(lp, x, enc)
    got, aux = port_tf.layer_apply(params_from_numpy(lp, device="cpu"),
                                   _t(x), pcfg, _t(pos), kind,
                                   enc_out=_t(enc))
    _close(got, want, what=kind)
    assert float(aux) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attn_chunk,s", [(1024, 16), (8, 16), (8, 5)])
def test_cross_attention_apply_matches_reference(attn_chunk, s, dtype):
    """Both branches: max(s, sk) <= attn_chunk (one full attention), and
    past it (q padded to a multiple of 8, the 20 keys to 24 and masked
    with kv_valid 20; also a query shorter than the chunk)."""
    rcfg, pcfg = _cfgs("whisper-large-v3", dtype == "bfloat16", attn_chunk)
    cross = _layer0(_ref("whisper-large-v3", dtype == "bfloat16")[1]
                    ["seg0"])["cross"]
    rng = np.random.default_rng(attn_chunk + s)
    rx, px = _typed(rng.standard_normal((2, s, rcfg.d_model))
                    .astype(np.float32), dtype)
    re, pe = _typed(rng.standard_normal((2, ENC_LEN, rcfg.d_model))
                    .astype(np.float32), dtype)
    want = jax.jit(lambda p, x, e: ref_attn.cross_attention_apply(
        p, x, e, rcfg))(cross, rx, re)
    pcross = params_from_numpy(cross, device="cpu")
    got = port_attn.cross_attention_apply(pcross, px, pe, pcfg)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype, "cross")
    # the prefill's form: K/V handed in, computed once
    kv = port_attn.cross_kv(pcross, pe, pcfg)
    assert torch.equal(port_attn.cross_attention_apply(pcross, px, pe, pcfg,
                                                       kv=kv), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_decode_matches_reference(dtype):
    rcfg, pcfg = _cfgs("whisper-large-v3", dtype == "bfloat16")
    cross = _layer0(_ref("whisper-large-v3", dtype == "bfloat16")[1]
                    ["seg0"])["cross"]
    rng = np.random.default_rng(3)
    kvh, dh = rcfg.num_kv_heads, rcfg.head_dim
    rx, px = _typed(rng.standard_normal((2, 1, rcfg.d_model))
                    .astype(np.float32), dtype)
    rk, pk = _typed(rng.standard_normal((2, ENC_LEN, kvh, dh))
                    .astype(np.float32), dtype)
    rv, pv = _typed(rng.standard_normal((2, ENC_LEN, kvh, dh))
                    .astype(np.float32), dtype)
    want = jax.jit(lambda p, x, k, v: ref_attn.cross_attention_decode(
        p, x, k, v, rcfg))(cross, rx, rk, rv)
    got = port_attn.cross_attention_decode(
        params_from_numpy(cross, device="cpu"), px, pk, pv, pcfg)
    _close(got, want, dtype, "cross decode")


# -------------------------------------------------- flash with kv_valid --

# (b, sq, sk, H, KVH, dh, kv_valid): one key, a chunk's edge and one key
# past it, inside a chunk, the whole padded length, MQA
KV_VALID_CASES = [(1, 16, 24, 2, 2, 8, 1), (2, 16, 24, 4, 2, 8, 8),
                  (1, 8, 24, 2, 1, 16, 9), (2, 24, 32, 4, 4, 8, 20),
                  (1, 8, 16, 4, 1, 16, 16)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,H,KVH,dh,kv_valid", KV_VALID_CASES)
def test_flash_kv_valid_matches_reference(b, sq, sk, H, KVH, dh, kv_valid,
                                          dtype):
    """``flash_attention_torch(kv_valid=)`` and ``ops.flash_attention``
    against the reference's ``chunked_attention(kv_valid=)`` on padded
    operands; the unpadded call (keys [0, kv_valid)) gives the same rows
    (what the card's cross attention computes; here to rounding, as the
    CPU's products sum the zero terms in a shape-dependent order)."""
    rng = np.random.default_rng(sq + sk + kv_valid)
    q, k, v = (rng.standard_normal((b, n, h, dh)).astype(np.float32)
               for n, h in ((sq, H), (sk, KVH), (sk, KVH)))
    k[:, kv_valid:], v[:, kv_valid:] = 0.0, 0.0        # the padded rows
    (rq, pq), (rk, pk), (rv, pv) = (_typed(a, dtype) for a in (q, k, v))
    want = jax.jit(lambda q, k, v: ref_attn.chunked_attention(
        q, k, v, causal=False, chunk=8, kv_valid=kv_valid))(rq, rk, rv)
    got = fa.flash_attention_torch(pq, pk, pv, causal=False,
                                   kv_valid=kv_valid)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype, "flash kv_valid vs chunked")
    _close(ops.flash_attention(pq, pk, pv, causal=False, kv_valid=kv_valid),
           want, dtype, "ops")
    _close(port_attn.chunked_attention(pq, pk, pv, causal=False, chunk=8,
                                       kv_valid=kv_valid), want, dtype,
           "port chunked")
    short = fa.flash_attention_torch(pq, pk[:, :kv_valid].contiguous(),
                                     pv[:, :kv_valid].contiguous(),
                                     causal=False)
    _close(short, got, dtype, "unpadded vs padded")


def test_flash_kv_valid_refuses_bad_calls():
    """kv_valid with causal or a window raises (a row could keep no key),
    and so does a bound outside [0, sk]; 0 and sk mask nothing."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 8, 2, 16), generator=g)
    for kw in (dict(causal=True, kv_valid=4),
               dict(causal=False, window=3, kv_valid=4),
               dict(causal=False, kv_valid=9),
               dict(causal=False, kv_valid=-1)):
        with pytest.raises(ValueError, match="kv_valid"):
            fa.flash_attention_torch(q, q, q, **kw)
    whole = fa.flash_attention_torch(q, q, q, causal=False)
    assert torch.equal(fa.flash_attention_torch(q, q, q, causal=False,
                                                kv_valid=8), whole)


# ------------------------------------------------------------ the slice --

def _caches_close(pc, rc, dtype, what):
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


@pytest.mark.parametrize("bf16,attn_chunk", [(False, 1024), (True, 1024),
                                             (False, 8)])
@pytest.mark.parametrize("arch", ARCHS)
def test_slice_prefill_decode_match_reference(arch, bf16, attn_chunk):
    """Prefill of a 16-position prompt (the VLM: 4 patch tokens and 12
    text tokens; whisper: 16 tokens over 20 frames) then 3 greedy decode
    steps: logits and every cache buffer after each, ``pos`` included,
    the port fed the reference's greedy tokens (equal to its own wherever
    the reference's top-2 gap exceeds the tolerance).  At attn_chunk 8
    the prompt takes the chunked branch and whisper's cross attention
    the padded one (in f32 only: the bf16 rounding of the padded form is
    held by ``test_cross_attention_apply_matches_reference``)."""
    rcfg, pcfg = _cfgs(arch, bf16, attn_chunk)
    dtype = rcfg.compute_dtype
    rparams, nparams, rprefill, rdecode = _ref(arch, bf16, attn_chunk)
    pmodel = build_model(pcfg)
    pparams = params_from_numpy(nparams, device="cpu")
    batch = lm_batch(pcfg, 2, 16, seed=1)
    max_len = 19
    rl, rc = rprefill(rparams, batch, max_len)
    pl, pc = pmodel.prefill(pparams, batch, max_len)
    assert int(pc["pos"]) == 16
    if arch == "whisper-large-v3":
        assert tuple(pc["seg0"]["ck"].shape[1:3]) == (2, ENC_LEN)
    for stage in range(4):
        assert pl.dtype == getattr(torch, dtype)
        _close(pl, rl, dtype, f"{arch} stage {stage} logits")
        _caches_close(_clone(pc), jax.tree.map(np.asarray, rc), dtype,
                      f"{arch} stage {stage} caches")
        if stage == 3:
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


def _shapes(tree):
    return jax.tree.map(lambda a: (tuple(a.shape),
                                   str(a.dtype).split(".")[-1]), tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_reference(arch):
    """The port's own init draws the reference's tree (whisper:
    enc_layers, enc_norm, enc_pos, dec_pos, seg0 of kind dec; the VLM:
    vis_proj): same leaves, shapes and dtypes (values differ: other
    random streams), and so do the caches; ``params_from_numpy``
    carries every leaf of the reference's params over exactly."""
    for bf16 in (False, True):
        rcfg, pcfg = _cfgs(arch, bf16)
        nparams = _ref(arch, bf16)[1]
        model = build_model(pcfg)
        assert _shapes(model.init(0, device="cpu")) == _shapes(nparams)
        assert _shapes(model.init_cache(2, 40, device="cpu")) == _shapes(
            ref_build_model(rcfg).init_cache(2, 40))
        carried = params_from_numpy(nparams, device="cpu")
        for got, want in zip(jax.tree.leaves(carried),
                             jax.tree.leaves(nparams)):
            assert np.array_equal(_f32(got), want.astype(np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_lm_matches_reference_launcher(arch):
    """``lm_batch`` draws the reference launcher's batch (one rng: the
    text tokens, then patch_emb, then audio_emb), and ``serve_lm``'s
    greedy tokens equal the reference's prefill + decode on it."""
    rcfg, pcfg = _cfgs(arch)
    rparams, nparams, rprefill, rdecode = _ref(arch)
    rng = np.random.default_rng(0)
    s_text = 16 - (rcfg.num_vision_tokens
                   if rcfg.frontend == "vision_stub" else 0)
    want_batch = {"tokens": rng.integers(0, rcfg.vocab_size, (2, s_text),
                                         dtype=np.int32)}
    if rcfg.frontend == "vision_stub":
        want_batch["patch_emb"] = rng.standard_normal(
            (2, rcfg.num_vision_tokens, rcfg.vision_dim)).astype(np.float32)
    if rcfg.encdec:
        want_batch["audio_emb"] = rng.standard_normal(
            (2, rcfg.encoder_seq_len, rcfg.d_model)).astype(np.float32)
    got_batch = lm_batch(pcfg, 2, 16)
    assert set(got_batch) == set(want_batch)
    for key, a in want_batch.items():
        assert got_batch[key].dtype == a.dtype
        assert np.array_equal(got_batch[key], a), key
    out = serve_lm(pcfg, prompt_len=16, decode_steps=4, batch=2,
                   device="cpu",
                   params=params_from_numpy(nparams, device="cpu"),
                   verbose=False)
    logits, cache = rprefill(rparams, want_batch, 20)
    want = []
    for _ in range(5):
        tok = np.asarray(jnp.argmax(logits[:, -1], -1)).astype(np.int32)
        want.append(tok)
        logits, cache = rdecode(rparams, tok[:, None], cache)
    assert np.array_equal(out["tokens"], np.stack(want, axis=1))
    assert out["launches"] == {"prefill": 0, "decode": 0}
    with pytest.raises(ValueError, match="vision tokens"):
        lm_batch(configs.smoke_config("internvl2-76b"), 1, 4)


@pytest.mark.parametrize("icq", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_on_the_cpu(arch, icq, capsys):
    """``--arch whisper-large-v3 / internvl2-76b --smoke --device cpu``
    serves (the command line's ``main``, in this process; the ``-m``
    entry itself is run by ``test_torch_lm``); ``--icq-kv`` runs the
    standalone demonstration after it (ICQ-KV does not serve these
    families, as in the reference)."""
    serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                "--prompt-len", "16", "--decode-steps", "3", "--batch", "2"]
               + (["--icq-kv"] if icq else []))
    out = capsys.readouterr().out
    assert "prefill: 16 tokens x 2" in out
    assert "decode: 3 steps" in out
    assert ("icq-kv: max err" in out) == icq
