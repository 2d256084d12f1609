"""ICQ serving hot paths (twin of ``repro.quant.serve_icq``): the batched
ANN engine entry point, re-exported from ``repro_torch.api.serving``,
and the ICQ-KV decode step of the dense decoder LMs.

The ICQ-KV step replaces the dense ``decode_step``: each layer's KV
cache is held in the interleaved quantized form (a per-head
variance-permuted d_fast crude slab plus int8 full-width codes,
``quant.kv_cache``), and attention runs crude-first over the d_fast
dims, refining only the ``top_c`` survivors.  It is plain PyTorch on
both devices, as the reference's is not a Pallas kernel; the cache is
written in place.  Its sharding rules (``icq_kv_cache_shardings``) wait
for ROADMAP item 23.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.api.serving import AnnEngine, build_ann_engine  # noqa: F401
from repro_torch.index.base import full_f32_matmul, resolve_device
from repro_torch.models import nn
from repro_torch.models.attention import qkv_project
from repro_torch.models.transformer import (_layer, _norm_apply, _tree_map,
                                            unported_item)
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
    the position (``"pos"``, a 0-d tensor), written in place."""
    if mesh is not None:
        raise NotImplementedError(
            "the sharded ICQ-KV decode (mesh=) waits for ROADMAP item 23 "
            "(LM sharding and the dry run)")
    if not supports_icq_kv(cfg):
        item = unported_item(cfg)
        raise NotImplementedError(
            f"ICQ-KV serves dense decoder-only archs (no MLA, no experts: "
            f"the reference's gate); {cfg.name} ({cfg.family}) "
            + (f"waits for ROADMAP {item}" if item
               else "has no dense KV cache"))
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
