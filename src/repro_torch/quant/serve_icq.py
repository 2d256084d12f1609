"""ICQ serving hot paths (twin of ``repro.quant.serve_icq``): the batched
ANN engine entry point, re-exported from ``repro_torch.api.serving``,
and the ICQ-KV decode step of the dense decoder LMs.

The ICQ-KV step replaces the dense ``decode_step``: each layer's KV
cache is held in the interleaved quantized form (a per-head
variance-permuted d_fast crude slab plus int8 full-width codes,
``quant.kv_cache``), and attention runs crude-first over the d_fast
dims, refining only the ``top_c`` survivors.  It is plain PyTorch on
both devices, as the reference's is not a Pallas kernel; the cache is
written in place.  ``icq_kv_cache_shardings`` are the reference's
rules for the quantized cache (the dry run reads them); a ``mesh``
given to ``build_icq_decode`` is accepted and does not change what the
step computes: its params and caches stay whole under a ``model`` axis
(the split of ICQ-KV's decode is ROADMAP item 38).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.api.serving import AnnEngine, build_ann_engine  # noqa: F401
from repro_torch.distributed import sharding as shrules
from repro_torch.index.base import full_f32_matmul, resolve_device
from repro_torch.models import nn
from repro_torch.models.attention import qkv_project
from repro_torch.models.transformer import _layer, _norm_apply, _tree_map
from repro_torch.quant.kv_cache import (ICQKVConfig, icq_kv_append,
                                        icq_kv_decode_attention,
                                        init_icq_kv_cache)


def supports_icq_kv(cfg) -> bool:
    """Dense decoder-only GQA archs (uniform layer plan)."""
    return (not cfg.ssm and not cfg.hybrid and not cfg.encdec
            and not cfg.mla and cfg.num_experts == 0
            and cfg.frontend == "none")


def build_icq_decode(cfg, kv_cfg: ICQKVConfig, *, mesh=None):
    """Returns (decode_fn, init_cache_fn) mirroring ModelFns' signatures.

    decode_fn(params, tokens, caches, *, top_c) -> (logits, caches); the
    caches are the stacked ICQ-KV tree of every layer (``"layers"``) and
    the position (``"pos"``, a 0-d tensor), written in place.  ``mesh``
    is accepted and unused (module docstring)."""
    if not supports_icq_kv(cfg):
        raise NotImplementedError(
            f"ICQ-KV serves dense decoder-only archs (supports_icq_kv, the "
            f"reference's gate: no SSM, hybrid, encoder-decoder, MLA, "
            f"experts or frontend); {cfg.name} ({cfg.family}) has no dense "
            "KV cache")
    tied = cfg.tie_embeddings
    emb_scale = float(cfg.d_model) ** 0.5 if tied else 1.0
    cdt = nn.as_dtype(cfg.compute_dtype)

    def init_cache(batch: int, max_len: int, dtype=torch.bfloat16, *,
                   device=None) -> Dict:
        dev = resolve_device(device)
        one = init_icq_kv_cache(kv_cfg, batch, max_len, cfg.num_kv_heads,
                                cfg.head_dim, dtype, device=dev)
        L = cfg.num_layers
        return {"pos": torch.zeros((), dtype=torch.int32, device=dev),
                "layers": _tree_map(
                    lambda a: a[None].repeat((L,) + (1,) * a.ndim), one)}

    def layer_decode(lp, x, cache, pos, top_c):
        h = _norm_apply(cfg, lp["norm1"], x)
        b = x.shape[0]
        positions = pos.reshape(1, 1).expand(b, 1)
        q, k, v = qkv_project(lp["attn"], h, cfg, positions)
        cache = icq_kv_append(cache, kv_cfg, k, v, pos)
        o = icq_kv_decode_attention(q, cache, kv_cfg, pos, top_c)
        o = o.reshape(b, 1, cfg.num_heads * cfg.head_dim)
        x = x + o @ lp["attn"]["wo"]
        h2 = _norm_apply(cfg, lp["norm2"], x)
        x = x + nn.mlp_apply(lp["ffn"], h2, cfg.activation)
        return x, cache

    def decode_step(params, tokens, caches, *, top_c: int):
        pos = caches["pos"]
        layers = caches["layers"]
        dev = params["embed"].device
        with full_f32_matmul():
            tokens = torch.as_tensor(tokens, device=dev)
            x = params["embed"][tokens.long()].to(cdt)
            if tied:   # sqrt(d) cast to x's type (a host scalar, no copy)
                x = x * torch.tensor(emb_scale, dtype=x.dtype)
            for li in range(cfg.num_layers):
                x, nc = layer_decode(_layer(params["seg0"], li), x,
                                     _layer(layers, li), pos, top_c)
                layers["len"][li] = nc["len"]
            x = _norm_apply(cfg, params["final_norm"], x)
            logits = (x @ params["embed"].T.to(x.dtype) if tied
                      else x @ params["head"])
        return logits[..., : cfg.vocab_size], dict(pos=pos + 1,
                                                   layers=layers)

    return decode_step, init_cache


def icq_kv_cache_shardings(cache_sh, cfg, mesh):
    """The quantized cache's shardings (the reference's rules): batch
    over "data"; heads over "model" when they divide, else positions
    over "model" (as the dense cache's rules)."""
    P, NamedSharding = shrules.PartitionSpec, shrules.NamedSharding
    msize = shrules.axis_size(mesh, "model")
    heads_ok = (cfg.num_kv_heads % max(msize, 1) == 0
                and cfg.num_kv_heads >= msize)

    def one(path, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        last = shrules._path_str(path).rsplit("/", 1)[-1]
        if last == "pos" or nd <= 1:
            return NamedSharding(mesh, P())
        if last == "perm":                           # (L, kvh, dh)
            return NamedSharding(mesh, P(
                None, shrules.maybe("model", shape[1], mesh)
                if heads_ok else None, None))
        spec = [None] * nd                           # (L, b, S, kvh, ...)
        spec[1] = shrules.maybe(("data",), shape[1], mesh)
        if heads_ok and nd >= 4:
            spec[3] = shrules.maybe("model", shape[3], mesh)
        elif nd >= 3:
            spec[2] = shrules.maybe("model", shape[2], mesh)
        return NamedSharding(mesh, P(*spec))

    return shrules.tree_map_with_path(one, cache_sh)

