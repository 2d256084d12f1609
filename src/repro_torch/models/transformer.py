"""Model assembly of the dense decoder LMs (twin of
``repro.models.transformer`` for the ``"dense"`` layer kind: tinyllama,
llama3, gemma and granite).

Layers are *stacked* as in the reference: every leaf of
``params["seg0"]`` has a leading layer axis, so the reference's params
carry across leaf for leaf (``params_from_numpy``).  A Python loop over
the layer index applies them.  The prefill's attention runs the flash
kernel on the card (``models.attention``); the decode step writes its
K/V into the cache in place (the reference donates the cache) at the
position held by a 0-d device tensor, so a step does not synchronise
the host.  Every matrix product runs in full f32 on the card (TF32 off,
``index.base.full_f32_matmul``).

Entry points (``build_model``):
  init(generator)                       -> params
  init_cache(batch, max_len)            -> caches
  prefill(params, batch, max_len)       -> (last-token logits, caches)
  decode_step(params, tokens, caches)   -> (logits, caches)

The other layer kinds, ``train_forward`` and a ``mesh`` raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.index.base import full_f32_matmul, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import nn

# ROADMAP items of what this module does not build yet
_MOE_MLA = "item 19 (MoE and MLA)"
_SSM_HYBRID = "item 20 (SSM and the hybrid)"
_ENCDEC_VLM = "item 21 (the encoder-decoder and the VLM)"
_TRAIN = "item 22 (LM training)"
_SHARDING = "item 23 (LM sharding and the dry run)"


def unported_item(cfg) -> str:
    """The ROADMAP item that brings ``cfg``'s family, or "" for a dense
    decoder-only arch (what this module serves)."""
    if cfg.num_experts or cfg.mla:
        return _MOE_MLA
    if cfg.ssm or cfg.hybrid:
        return _SSM_HYBRID
    if cfg.encdec or cfg.frontend != "none" or cfg.learned_pos_emb:
        return _ENCDEC_VLM
    return ""


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _layer(stacked, li: int):
    """Layer ``li``'s params (or cache) of a stacked tree: views."""
    return _tree_map(lambda a: a[li], stacked)


# =================================================================
# per-layer init / apply (the "dense" kind)
# =================================================================

def _norm_init(cfg, dtype, device=None):
    if cfg.norm_type == "layernorm":
        return nn.layernorm_init(cfg.d_model, dtype, device)
    return nn.rmsnorm_init(cfg.d_model, dtype, device)


def _norm_apply(cfg, p, x):
    if cfg.norm_type == "layernorm":
        return nn.layernorm(x, p, cfg.norm_eps)
    return nn.rmsnorm(x, p, cfg.norm_eps)


def _check_kind(kind: str):
    if kind != "dense":
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported; the port builds the dense "
            f"decoder layer only (MoE / MLA kinds: ROADMAP {_MOE_MLA}; "
            f"ssm / rglru / local: {_SSM_HYBRID}; enc / dec: {_ENCDEC_VLM})")


def layer_init(generator: torch.Generator, cfg, dtype, kind: str):
    _check_kind(kind)
    dev = generator.device
    return {"norm1": _norm_init(cfg, dtype, dev),
            "norm2": _norm_init(cfg, dtype, dev),
            "attn": attn.attn_init(generator, cfg, dtype),
            "ffn": nn.mlp_init(generator, cfg.d_model, cfg.d_ff,
                               cfg.activation, dtype)}


def layer_apply(p, x, cfg, positions, kind: str, *, enc_out=None,
                attn_impl="chunked"):
    """Full-sequence layer.  Returns (x, aux)."""
    _check_kind(kind)
    h = _norm_apply(cfg, p["norm1"], x)
    x = x + attn.attention_apply(p["attn"], h, cfg, positions, causal=True,
                                 impl=attn_impl, rope=not cfg.learned_pos_emb)
    h2 = _norm_apply(cfg, p["norm2"], x)
    x = x + nn.mlp_apply(p["ffn"], h2, cfg.activation)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def layer_init_cache(cfg, kind: str, batch: int, max_len: int, dtype,
                     device=None):
    _check_kind(kind)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=nn.as_dtype(dtype), device=device),
            "v": torch.zeros(shape, dtype=nn.as_dtype(dtype), device=device)}


def layer_prefill(p, x, cfg, positions, kind: str, max_len: int, *,
                  enc_out=None, attn_impl="chunked", cache=None):
    """Layer forward that also fills its decode cache: K/V at positions
    [0, s) of ``cache`` (made with ``layer_init_cache`` when None),
    zeros past them.  Returns (x, cache)."""
    _check_kind(kind)
    b, s, _ = x.shape
    h = _norm_apply(cfg, p["norm1"], x)
    q, k, v = attn.qkv_project(p["attn"], h, cfg, positions,
                               rope=not cfg.learned_pos_emb)
    if s <= cfg.attn_chunk:
        o = attn.full_attention(q, k, v, causal=True)
    elif attn_impl == "triangular":
        o = attn.triangular_chunked_attention(q, k, v, chunk=cfg.attn_chunk)
    else:
        o = attn.chunked_attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
    if cache is None:
        cache = layer_init_cache(cfg, kind, b, max(max_len, s), x.dtype,
                                 x.device)
    cache["k"][:, :s] = k
    cache["v"][:, :s] = v
    x = x + o.reshape(b, s, cfg.num_heads * cfg.head_dim) @ p["attn"]["wo"]
    h2 = _norm_apply(cfg, p["norm2"], x)
    x = x + nn.mlp_apply(p["ffn"], h2, cfg.activation)
    return x, cache


def layer_decode(p, x, cfg, cache, pos, kind: str):
    """One-token layer step.  x: (b,1,d); pos: the write index (a 0-d
    tensor on x's device, or an int).  Writes K/V at ``pos`` of
    ``cache`` in place and returns (x, cache)."""
    _check_kind(kind)
    b = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    h = _norm_apply(cfg, p["norm1"], x)
    positions = pos.reshape(1, 1).expand(b, 1)
    q, k, v = attn.qkv_project(p["attn"], h, cfg, positions,
                               rope=not cfg.learned_pos_emb)
    kc, vc = cache["k"], cache["v"]
    at = pos.long().reshape(1)
    kc.index_copy_(1, at, k.to(kc.dtype))
    vc.index_copy_(1, at, v.to(vc.dtype))
    S = kc.shape[1]
    mask = (torch.arange(S, device=x.device) <= pos)[None, :].expand(b, S)
    o = attn.decode_attention(q, kc, vc, mask)
    x = x + o.reshape(b, 1, cfg.num_heads * cfg.head_dim) @ p["attn"]["wo"]
    h2 = _norm_apply(cfg, p["norm2"], x)
    x = x + nn.mlp_apply(p["ffn"], h2, cfg.activation)
    return x, cache


# =================================================================
# stacks
# =================================================================

def _stacked_init(generator, cfg, dtype, kind: str, n: int):
    """``n`` layers drawn one after another into stacked leaves (peak
    memory: the stack plus one layer)."""
    first = layer_init(generator, cfg, dtype, kind)
    stacked = _tree_map(
        lambda a: torch.empty((n,) + tuple(a.shape), dtype=a.dtype,
                              device=a.device), first)
    for li in range(n):
        one = first if li == 0 else layer_init(generator, cfg, dtype, kind)
        _tree_map(lambda buf, a: buf[li].copy_(a), stacked, one)
        del one
    return stacked


def params_from_numpy(tree, *, device=None):
    """The reference's params (a nested dict of numpy arrays, as
    ``jax.tree.map(np.asarray, params)`` gives them; bf16 arrays of
    ml_dtypes' ``bfloat16``) as the port's, keeping every dtype, on
    ``device`` (the card unless the caller names another)."""
    dev = resolve_device(device)

    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                 .copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, copy=True))
        return t.to(dev)
    return _tree_map(one, tree)


# =================================================================
# model builder
# =================================================================

@dataclasses.dataclass
class ModelFns:
    cfg: Any
    init: Any
    train_forward: Any
    prefill: Any
    decode_step: Any
    init_cache: Any


def _layer_plan(cfg):
    """Returns list of (kind, count) segments, in order."""
    if cfg.ssm:
        return [("ssm", cfg.num_layers)]
    if cfg.hybrid:
        return [("hybrid", cfg.num_layers)]
    if cfg.encdec:
        return [("dec", cfg.num_layers)]
    if cfg.num_experts:
        kind = "mla_moe" if cfg.mla else "moe"
        segs = []
        if cfg.first_k_dense:
            segs.append(("mla_dense" if cfg.mla else "dense_first",
                         cfg.first_k_dense))
        segs.append((kind, cfg.num_layers - cfg.first_k_dense))
        return segs
    if cfg.mla:
        return [("mla_dense", cfg.num_layers)]
    return [("dense", cfg.num_layers)]


def build_model(cfg, *, attn_impl: str = "chunked", mesh=None) -> ModelFns:
    """The dense decoder LM of ``cfg``.  ``init(generator)`` draws the
    params on the generator's device (an int seeds a generator on
    ``device``, the card unless the caller names another); the other
    entry points run where the params are."""
    if mesh is not None:
        raise NotImplementedError(
            f"a sharded model (mesh=) waits for ROADMAP {_SHARDING}")
    item = unported_item(cfg)
    if item:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) is not ported; the port serves the "
            f"dense decoder LMs, and this family waits for ROADMAP {item}")
    dtype = nn.as_dtype(cfg.param_dtype)
    cdt = nn.as_dtype(cfg.compute_dtype)
    tied = cfg.tie_embeddings
    emb_scale = float(cfg.d_model) ** 0.5 if tied else 1.0
    plan = _layer_plan(cfg)

    def init(generator, *, device=None):
        if not isinstance(generator, torch.Generator):
            generator = torch.Generator(
                device=resolve_device(device)).manual_seed(int(generator))
        params: Dict[str, Any] = {
            "embed": nn.embedding_init(generator, cfg.padded_vocab,
                                       cfg.d_model, dtype),
            "final_norm": _norm_init(cfg, dtype, generator.device),
        }
        if not tied:
            params["head"] = nn.dense_init(generator, cfg.d_model,
                                           cfg.padded_vocab, dtype)
        for si, (kind, n) in enumerate(plan):
            params[f"seg{si}"] = _stacked_init(generator, cfg, dtype, kind, n)
        return params

    def _embed_tokens(params, tokens):
        tokens = torch.as_tensor(tokens, device=params["embed"].device)
        x = params["embed"][tokens.long()].to(cdt)
        if tied:   # sqrt(d) cast to x's type (a host scalar, no copy)
            x = x * torch.tensor(emb_scale, dtype=x.dtype)
        return x

    def _logits(params, x):
        x = _norm_apply(cfg, params["final_norm"], x)
        logits = (x @ params["embed"].T.to(x.dtype) if tied
                  else x @ params["head"])
        return logits[..., : cfg.vocab_size]

    def train_forward(params, batch):
        raise NotImplementedError(
            f"train_forward waits for ROADMAP {_TRAIN}; the port serves")

    def init_cache(batch_size: int, max_len: int, dtype_=None, *,
                   device=None):
        dt = dtype_ or cdt
        dev = resolve_device(device)
        caches: Dict[str, Any] = {
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}
        for si, (kind, n) in enumerate(plan):
            one = layer_init_cache(cfg, kind, batch_size, max_len, dt, dev)
            caches[f"seg{si}"] = _tree_map(
                lambda a: a[None].repeat((n,) + (1,) * a.ndim), one)
        return caches

    def prefill(params, batch, max_len: int):
        dev = params["embed"].device
        with full_f32_matmul():
            x = _embed_tokens(params, batch["tokens"])
            b, s, _ = x.shape
            positions = torch.arange(s, device=dev)
            caches = init_cache(b, max(max_len, s), device=dev)
            caches["pos"].fill_(s)
            for si, (kind, n) in enumerate(plan):
                seg, cseg = params[f"seg{si}"], caches[f"seg{si}"]
                for li in range(n):
                    x, _ = layer_prefill(_layer(seg, li), x, cfg, positions,
                                         kind, max_len, attn_impl=attn_impl,
                                         cache=_layer(cseg, li))
            logits = _logits(params, x[:, -1:, :])
        return logits, caches

    def decode_step(params, tokens, caches):
        """tokens: (b,1) ints.  Returns (logits (b,1,V), caches): the
        cache buffers are written in place, ``pos`` advances by one."""
        pos = caches["pos"]
        with full_f32_matmul():
            x = _embed_tokens(params, tokens)
            for si, (kind, n) in enumerate(plan):
                seg, cseg = params[f"seg{si}"], caches[f"seg{si}"]
                for li in range(n):
                    x, _ = layer_decode(_layer(seg, li), x, cfg,
                                        _layer(cseg, li), pos, kind)
            logits = _logits(params, x)
        return logits, {**caches, "pos": pos + 1}

    return ModelFns(cfg=cfg, init=init, train_forward=train_forward,
                    prefill=prefill, decode_step=decode_step,
                    init_cache=init_cache)
