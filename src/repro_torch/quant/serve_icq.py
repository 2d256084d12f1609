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
rules for the quantized cache (the dry run reads them).

Over a ``mesh`` whose ``model`` axis exceeds 1 the step runs split over
a model group as ``icq_kv_cache_shardings`` lays the cache out: by KV
heads where they divide (each shard appends and attends over its own
heads, whose top-c are its own), by positions otherwise (the global
top-c over all S positions, what GSPMD gives the reference's step:
``quant.kv_cache.icq_kv_decode_attention_tp`` merges the shards' local
top-c exactly); ``wo``, the MLP, the embedding and the head split as in
``models.transformer``.  The per-head variance permutation is taken
from the whole prefill's K before the split.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.api.serving import AnnEngine, build_ann_engine  # noqa: F401
from repro_torch.distributed import sharding as shrules
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.index.base import full_f32_matmul, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import nn
from repro_torch.models.attention import qkv_project
from repro_torch.models.transformer import (_layer, _lead, _norm_apply,
                                            _tree_map, build_model)
from repro_torch.quant.kv_cache import (ICQKVConfig, icq_kv_append,
                                        icq_kv_decode_attention,
                                        icq_kv_decode_attention_tp,
                                        init_icq_kv_cache, quantized_rows)


def supports_icq_kv(cfg) -> bool:
    """Dense decoder-only GQA archs (uniform layer plan)."""
    return (not cfg.ssm and not cfg.hybrid and not cfg.encdec
            and not cfg.mla and cfg.num_experts == 0
            and cfg.frontend == "none")


def build_icq_decode(cfg, kv_cfg: ICQKVConfig, *, mesh=None):
    """Returns (decode_fn, init_cache_fn) mirroring ModelFns' signatures.

    decode_fn(params, tokens, caches, *, top_c, record=None) -> (logits,
    caches); the caches are the stacked ICQ-KV tree of every layer
    (``"layers"``) and the position (``"pos"``, a 0-d tensor), written in
    place; ``record`` a list that takes each layer's survivors (their
    positions (b, kvh, g, top_c), the crude gap at rank top_c unsplit,
    the crude scores of every position (b, kvh, g, S) and the rows'
    largest sums of |products|; ``quant.kv_cache._survivors``).

    Over a ``mesh`` whose ``model`` axis M exceeds 1 the step runs split
    over the model group of its first position (module docstring): the
    params whole, placed or a group's ``Split`` tree, as
    ``build_model(mesh=)`` takes them; the caches whole (laid out by
    ``icq_kv_cache_shardings``' model entries at the first step) or as
    the step returns them (``"layers"`` a ``Split`` tree);
    ``init_cache`` gives them whole, as the reference's does."""
    if not supports_icq_kv(cfg):
        raise NotImplementedError(
            f"ICQ-KV serves dense decoder-only archs (supports_icq_kv, the "
            f"reference's gate: no SSM, hybrid, encoder-decoder, MLA, "
            f"experts or frontend); {cfg.name} ({cfg.family}) has no dense "
            "KV cache")
    tied = cfg.tie_embeddings
    emb_scale = float(cfg.d_model) ** 0.5 if tied else 1.0
    cdt = nn.as_dtype(cfg.compute_dtype)
    split = tp.model_size(mesh) > 1
    model = build_model(cfg, mesh=mesh) if split else None

    def init_cache(batch: int, max_len: int, dtype=torch.bfloat16, *,
                   device=None) -> Dict:
        dev = resolve_device(device)
        one = init_icq_kv_cache(kv_cfg, batch, max_len, cfg.num_kv_heads,
                                cfg.head_dim, dtype, device=dev)
        L = cfg.num_layers
        return {"pos": torch.zeros((), dtype=torch.int32, device=dev),
                "layers": _tree_map(
                    lambda a: a[None].repeat((L,) + (1,) * a.ndim), one)}

    def _split_caches(caches):
        """The caches with ``"layers"`` the model group's ``Split`` tree
        of ``icq_kv_cache_shardings``' model entries (heads, or
        positions); the position on the first device."""
        if tp.is_view(caches["layers"]):
            return caches
        sh = icq_kv_cache_shardings(caches, cfg, mesh)["layers"]
        placed = tp._map2(
            lambda t, s: shrules.NamedSharding(mesh, shrules.P(*[
                "model" if "model" in shrules.entry_axes(e) else None
                for e in s.spec])).lay_out(t), caches["layers"], sh)
        return {"pos": caches["pos"].to(tp.model_group(mesh).lead),
                "layers": tp.group_view(placed, mesh)}

    def layer_decode(lp, x, cache, pos, top_c, record):
        h = _norm_apply(cfg, lp["norm1"], x)
        b = x.shape[0]
        positions = pos.reshape(1, 1).expand(b, 1)
        q, k, v = qkv_project(lp["attn"], h, cfg, positions)
        cache = icq_kv_append(cache, kv_cfg, k, v, pos)
        o = icq_kv_decode_attention(q, cache, kv_cfg, pos, top_c,
                                    record=record)
        o = o.reshape(b, 1, cfg.num_heads * cfg.head_dim)
        x = x + o @ lp["attn"]["wo"]
        h2 = _norm_apply(cfg, lp["norm2"], x)
        x = x + nn.mlp_apply(lp["ffn"], h2, cfg.activation)
        return x, cache

    def layer_decode_tp(lp, x, cache, pos, top_c, g, record):
        """``layer_decode`` split over the model group ``g``: each shard
        its query heads (``qkv_project_tp``).  Heads over model: each
        shard appends its KV heads' K / V and attends over them (every
        head's top-c is its own); positions over model: every KV head's
        K / V all-gathered, quantized once and written by the shard
        holding ``pos``, the queries all-gathered, the global top-c of
        ``icq_kv_decode_attention_tp``.  ``wo``'s rows and the MLP split
        as in ``models.transformer``, partials all-reduced."""
        h = _norm_apply(cfg, _lead(lp["norm1"]), x)
        b = x.shape[0]
        positions = pos.reshape(1, 1).expand(b, 1)
        qkv = attn.qkv_project_tp(lp["attn"], h, cfg, positions, g)
        poss = tp.broadcast(pos, g)
        Hl, _ = attn.head_split(cfg, g.size)
        if cache["kq"].dim is None:
            raise ValueError("the ICQ-KV cache splits over the model axis "
                             "by KV heads or by positions; neither divides")
        if cache["kq"].dim == 2:                 # heads over model
            outs, recs = [], []
            for j, ((qj, kj, vj), pj) in enumerate(zip(qkv, poss)):
                cj = icq_kv_append(tp.shard(cache, j), kv_cfg, kj, vj, pj)
                outs.append(icq_kv_decode_attention(
                    qj, cj, kv_cfg, pj, top_c,
                    record=recs if record is not None else None))
            if record is not None:       # the shards' KV heads in order
                cand, crude, mag = (torch.cat([r[i].to(g.lead) for r in recs],
                                              1) for i in (0, 2, 3))
                record.append((cand, None, crude, mag))
        else:                                    # positions over model
            k_all = attn.owned_kv([t[1] for t in qkv], cfg, g)
            v_all = attn.owned_kv([t[2] for t in qkv], cfg, g)
            new = quantized_rows(cache["perm"].whole, kv_cfg, k_all, v_all)
            for name, val in new.items():
                c = cache[name]
                n = c[0].shape[1]
                for j, (vj, pj) in enumerate(zip(tp.broadcast(val, g),
                                                 poss)):
                    attn.write_at(c[j], vj, pj, j * n)
            q_all = tp.all_gather([t[0] for t in qkv], g, dim=2)
            o = icq_kv_decode_attention_tp(
                q_all, [tp.shard(cache, j) for j in g.shards], kv_cfg, pos,
                top_c, g, record=record)
            outs = [oj[:, :, j * Hl:(j + 1) * Hl]
                    for j, oj in enumerate(tp.broadcast(o, g))]
        parts = [o.reshape(b, 1, Hl * cfg.head_dim) @ lp["attn"]["wo"][j]
                 for j, o in enumerate(outs)]
        x = x + tp.all_reduce(parts, g)
        h2 = _norm_apply(cfg, _lead(lp["norm2"]), x)
        return x + nn.mlp_apply_tp(lp["ffn"], h2, cfg.activation, g)

    def decode_step(params, tokens, caches, *, top_c: int, record=None):
        if split:
            return _decode_split(params, tokens, caches, top_c, record)
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
                                     _layer(layers, li), pos, top_c, record)
                layers["len"][li] = nc["len"]
            x = _norm_apply(cfg, params["final_norm"], x)
            logits = (x @ params["embed"].T.to(x.dtype) if tied
                      else x @ params["head"])
        return logits[..., : cfg.vocab_size], dict(pos=pos + 1,
                                                   layers=layers)

    def _decode_split(params, tokens, caches, top_c, record):
        params, g = model.view(params)
        caches = _split_caches(caches)
        pos, layers = caches["pos"], caches["layers"]
        with full_f32_matmul():
            x = nn.embed_tp(params["embed"],
                            torch.as_tensor(tokens, device=g.lead), g) \
                .to(cdt)
            if tied:
                x = x * torch.tensor(emb_scale, dtype=x.dtype)
            for li in range(cfg.num_layers):
                x = layer_decode_tp(_layer(params["seg0"], li), x,
                                    _layer(layers, li), pos, top_c, g,
                                    record)
                for blk in {id(b): b for b in layers["len"]}.values():
                    blk[li] = torch.maximum(blk[li], pos.to(blk.device) + 1)
            x = _norm_apply(cfg, _lead(params["final_norm"]), x)
            logits = nn.head_tp(x, params["embed"] if tied
                                else params["head"], g, tied=tied)
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

