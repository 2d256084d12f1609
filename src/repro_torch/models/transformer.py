"""Model assembly of the served LMs (twin of ``repro.models.transformer``
for the layer kinds ``"dense"`` (tinyllama, llama3, gemma, granite, and
the VLM internvl2's backbone), ``"dense_first"`` and ``"moe"``
(moonshot), ``"mla_dense"`` and ``"mla_moe"`` (deepseek-v2), ``"ssm"``
(mamba2), the hybrid's ``"rglru"`` and ``"local"`` (recurrentgemma),
and the encoder-decoder's ``"enc"`` and ``"dec"`` (whisper)).

Layers are *stacked* as in the reference: every leaf of a segment's
params (``params["seg0"]``, ``["seg1"]``, one per run of one kind) has a
leading layer axis, so the reference's params carry across leaf for leaf
(``params_from_numpy``).  The hybrid keeps the reference's layout too:
``params["groups"]["b{i}"]`` stacked over the ``num_layers //
len(block_pattern)`` groups, ``params["tail{i}"]`` the leftover layers
(the caches alike); whisper's encoder is ``params["enc_layers"]``,
stacked the same way, and its decoder ``params["seg0"]`` of kind
``"dec"``.  A Python loop over the layer index applies them.  The
stubbed frontends take precomputed inputs as the reference's do: the
VLM's ``batch["patch_emb"]`` (b, num_vision_tokens, vision_dim),
projected by ``vis_proj`` and prepended to the text tokens (its
positions count them); whisper's ``batch["audio_emb"]`` (b, frames,
d_model), plus the learned ``enc_pos``, through the non-causal encoder;
the decoder adds the learned ``dec_pos`` and attends over the encoder's
output in every layer (cross attention, its K/V computed once a prefill
for both the cache and the attention).
The prefill's attention runs the flash kernel on the card
(``models.attention``, ``models.mla``; the local layers' with the
sliding window; the encoder's and the cross attention non-causal); the
decode step writes its cache (K/V, MLA's latent and rope key, the SSM's
state and conv window, the RG-LRU's state, the local layers' ring of
``min(max_len, local_window)`` slots; the cross cache ``ck`` / ``cv`` is
written by the prefill and only read after) in place (the
reference donates the cache) at the position held by a 0-d device
tensor, so a step does not synchronise the host.  Every matrix product
runs in full f32 on the card (TF32 off, ``index.base.full_f32_matmul``).

Entry points (``build_model``):
  init(generator)                       -> params
  train_forward(params, batch)          -> (loss, {"ce", "aux"})
  init_cache(batch, max_len)            -> caches
  prefill(params, batch, max_len)       -> (last-token logits, caches)
  decode_step(params, tokens, caches)   -> (logits, caches)

``train_forward`` is differentiable by autograd (on the card the flash
kernel's backward kernels run).  ``cfg.remat`` recomputes each layer in
the backward (``torch.utils.checkpoint``, non-reentrant: the reference's
``jax.checkpoint`` of the layer scan's body; the hybrid's per group),
and ``cfg.remat_block`` G > 0 adds the reference's outer level: blocks
of G layers checkpointed around their per-layer checkpoints, so that
one carry a block is kept.

Over a ``mesh`` whose ``model`` axis M exceeds 1, every kind runs split
over a model group (the reference's mesh is a placement hint for GSPMD,
its ``_act_constraint``; the port executes the split its rule tables
give, ``distributed.tensor_parallel``): the residual stream and the
norms replicated on the group's first device; attention over each
shard's heads (on the card one flash launch a shard: causal, windowed in
the local layers, non-causal in the encoder and the cross attention),
the MLP over its ``d_ff`` columns, the MoE over its experts, MLA over
its heads, the SSM over its heads of z, x and dt and its state columns
of B and C (``w_in`` and the conv in the segment layout, B and C
all-gathered after the conv, the gated norm's sums of squares
all-reduced), the RG-LRU over its channels and gate blocks; the
embedding and the head vocabulary-parallel, the VLM's ``vis_proj`` over
its output columns; the partials all-reduced, the logit and projection
slices all-gathered; the caches split by ``tensor_parallel.shardings``
(``cache_pspec``'s model entries: heads, or the sequence, whose decode
merges each shard's softmax partials, a local layer's ring by its
slots; the SSM's state by heads and conv window by segments, the
RG-LRU's by channels; the cross cache by KV heads).

``train_forward`` also takes a (pod, data) position's FSDP view
(``distributed.fsdp``: the train step of params laid out by the full
rule-table specs): each leaf is gathered where it is read, a stacked
leaf's layer inside ``_layer`` (so inside the layer's checkpoint: freed
after the layer, gathered again when it is recomputed), the unstacked
ones (``embed``, ``head``, the norms, ``vis_proj``, ``enc_pos`` /
``dec_pos``, the hybrid's tail layers) at their use; a tied embedding
once for the input and the head.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
import torch.utils.checkpoint as torch_checkpoint

from repro_torch.distributed import fsdp
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.index.base import full_f32_matmul, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import nn
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod



def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _layer(stacked, li: int):
    """Layer ``li``'s params (or cache) of a stacked tree: views (of
    each block, for a model group's ``Split`` leaves); an FSDP view's
    leaves gathered, this layer's slice of each (``fsdp.use``)."""
    def one(a):
        if isinstance(a, tp.Split):
            return a.at(li)
        if isinstance(a, fsdp.Sharded):
            return fsdp.use(a.at(li))
        return a[li]
    return _tree_map(one, stacked)


# =================================================================
# per-layer init / apply, switched on ``kind``
# =================================================================

_KINDS = ("dense", "dense_first", "moe", "mla_dense", "mla_moe", "ssm",
          "rglru", "local", "enc", "dec")
_MLA_KINDS = ("mla_dense", "mla_moe")
_MOE_KINDS = ("moe", "mla_moe")


def _norm_init(cfg, dtype, device=None):
    if cfg.norm_type == "layernorm":
        return nn.layernorm_init(cfg.d_model, dtype, device)
    return nn.rmsnorm_init(cfg.d_model, dtype, device)


def _norm_apply(cfg, p, x):
    if cfg.norm_type == "layernorm":
        return nn.layernorm(x, p, cfg.norm_eps)
    return nn.rmsnorm(x, p, cfg.norm_eps)


def _check_kind(kind: str):
    if kind not in _KINDS:
        raise ValueError(f"layer kind {kind!r} is not one of {_KINDS}")


def layer_init(generator: torch.Generator, cfg, dtype, kind: str):
    _check_kind(kind)
    dev = generator.device
    if kind == "ssm":
        return {"norm1": _norm_init(cfg, dtype, dev),
                "mixer": ssm_mod.ssm_init(generator, cfg, dtype)}
    p = {"norm1": _norm_init(cfg, dtype, dev),
         "norm2": _norm_init(cfg, dtype, dev)}
    if kind == "rglru":
        p["mixer"] = rglru_mod.rglru_init(generator, cfg, dtype)
    elif kind in _MLA_KINDS or (kind == "dense_first" and cfg.mla):
        p["attn"] = mla_mod.mla_init(generator, cfg, dtype)
    else:
        p["attn"] = attn.attn_init(generator, cfg, dtype)
    if kind == "dec":
        p["norm_cross"] = _norm_init(cfg, dtype, dev)
        p["cross"] = attn.cross_attn_init(generator, cfg, dtype)
    if kind in _MOE_KINDS:
        p["ffn"] = moe_mod.moe_init(generator, cfg, dtype)
    elif kind in ("mla_dense", "dense_first"):
        p["ffn"] = nn.mlp_init(generator, cfg.d_model,
                               cfg.dense_d_ff or cfg.d_ff, cfg.activation,
                               dtype)
    else:
        p["ffn"] = nn.mlp_init(generator, cfg.d_model, cfg.d_ff,
                               cfg.activation, dtype)
    return p


def _ffn(p, x, cfg, kind: str):
    """The layer's feed-forward on x: (out, aux), aux the MoE layers'
    load-balance loss (None for an MLP)."""
    if kind in _MOE_KINDS:
        return moe_mod.moe_apply(p["ffn"], x, cfg)
    return nn.mlp_apply(p["ffn"], x, cfg.activation), None


def _lead(p):
    """The first shard's view of a model group's (sub)tree: its whole
    copies of the replicated leaves (the norms)."""
    return tp.shard(p, 0)


def _whole(t):
    """A replicated leaf's value: a ``Split``'s first copy, else ``t``."""
    return t.whole if isinstance(t, tp.Split) else t


def _ffn_tp(p, x, cfg, kind: str, group):
    if kind in _MOE_KINDS:
        return moe_mod.moe_apply(p["ffn"], x, cfg, group)
    return nn.mlp_apply_tp(p["ffn"], x, cfg.activation, group), None


def _attn_args(cfg, kind, attn_impl):
    """``attention_apply``'s keywords for a layer of ``kind``: the local
    layers' window, the encoder's non-causal full attention."""
    return dict(causal=kind != "enc",
                window=cfg.local_window if kind == "local" else 0,
                impl="full" if kind == "enc" else attn_impl,
                rope=not cfg.learned_pos_emb)


def _layer_apply_tp(p, x, cfg, positions, kind, group, attn_impl,
                    enc_out=None):
    """``layer_apply`` split over a model group: the residual stream and
    the norms replicated on the first device, the mixer (attention, the
    SSM, the RG-LRU), the cross attention and the feed-forward split
    (``*_tp``), their outputs all-reduced."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = _norm_apply(cfg, _lead(p["norm1"]), x)
    if kind == "ssm":
        return x + ssm_mod.ssm_block_apply_tp(p["mixer"], h, cfg, group), aux
    if kind == "rglru":
        x = x + rglru_mod.rglru_block_apply_tp(p["mixer"], h, cfg, group)
    elif kind in _MLA_KINDS:
        x = x + mla_mod.mla_attention_apply_tp(p["attn"], h, cfg, positions,
                                               group)
    else:
        x = x + attn.attention_apply_tp(p["attn"], h, cfg, positions, group,
                                        **_attn_args(cfg, kind, attn_impl))
    if kind == "dec":
        x = x + attn.cross_attention_apply_tp(
            p["cross"], _norm_apply(cfg, _lead(p["norm_cross"]), x), enc_out,
            cfg, group)
    y, moe_aux = _ffn_tp(p, _norm_apply(cfg, _lead(p["norm2"]), x), cfg,
                         kind, group)
    return x + y, aux if moe_aux is None else moe_aux


def layer_apply(p, x, cfg, positions, kind: str, *, enc_out=None,
                attn_impl="chunked", group=None):
    """Full-sequence layer.  Returns (x, aux).  With a model ``group``
    (``p`` a ``Split`` tree) the layer runs split over it."""
    _check_kind(kind)
    if group is not None:
        return _layer_apply_tp(p, x, cfg, positions, kind, group, attn_impl,
                               enc_out)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = _norm_apply(cfg, p["norm1"], x)
    if kind == "ssm":
        return x + ssm_mod.ssm_block_apply(p["mixer"], h, cfg), aux
    if kind == "rglru":
        x = x + rglru_mod.rglru_block_apply(p["mixer"], h, cfg)
    elif kind == "local":
        x = x + attn.attention_apply(p["attn"], h, cfg, positions,
                                     causal=True, window=cfg.local_window,
                                     impl=attn_impl)
    elif kind in _MLA_KINDS:
        x = x + mla_mod.mla_attention_apply(p["attn"], h, cfg, positions)
    elif kind == "enc":
        x = x + attn.attention_apply(p["attn"], h, cfg, positions,
                                     causal=False, impl="full",
                                     rope=not cfg.learned_pos_emb)
    else:
        x = x + attn.attention_apply(p["attn"], h, cfg, positions,
                                     causal=True, impl=attn_impl,
                                     rope=not cfg.learned_pos_emb)
    if kind == "dec":
        x = x + attn.cross_attention_apply(
            p["cross"], _norm_apply(cfg, p["norm_cross"], x), enc_out, cfg)
    y, moe_aux = _ffn(p, _norm_apply(cfg, p["norm2"], x), cfg, kind)
    return x + y, aux if moe_aux is None else moe_aux


def layer_init_cache(cfg, kind: str, batch: int, max_len: int, dtype,
                     device=None, enc_len=None):
    """A layer's zeroed decode cache; a ``dec`` layer's cross cache holds
    ``enc_len`` encoder positions (default ``cfg.encoder_seq_len``)."""
    _check_kind(kind)
    dt = nn.as_dtype(dtype)
    if kind == "ssm":
        return ssm_mod.ssm_init_cache(cfg, batch, dt, device)
    if kind == "rglru":
        return rglru_mod.rglru_init_cache(cfg, batch, dt, device)
    if kind in _MLA_KINDS:
        return {"latent": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                      dtype=dt, device=device),
                "k_rope": torch.zeros((batch, max_len,
                                       cfg.qk_rope_head_dim), dtype=dt,
                                      device=device)}
    S = min(max_len, cfg.local_window) if kind == "local" else max_len
    shape = (batch, S, cfg.num_kv_heads, cfg.head_dim)
    c = {"k": torch.zeros(shape, dtype=dt, device=device),
         "v": torch.zeros(shape, dtype=dt, device=device)}
    if kind == "local":        # the ring's absolute positions, -1 = empty
        c["k_pos"] = torch.full((batch, S), -1, dtype=torch.int32,
                                device=device)
    if kind == "dec":
        cross = (batch, enc_len or cfg.encoder_seq_len, cfg.num_kv_heads,
                 cfg.head_dim)
        c["ck"] = torch.zeros(cross, dtype=dt, device=device)
        c["cv"] = torch.zeros(cross, dtype=dt, device=device)
    return c


def _write_prefix(block_split, rows, s: int):
    """Rows [0, s) of the whole sequence written into a cache leaf's
    blocks: a sequence block its own positions, a replicated leaf each
    distinct copy."""
    if block_split.dim == 1:
        n = block_split[0].shape[1]
        for j, blk in enumerate(block_split):
            k = min(n, rows.shape[1] - j * n)
            if k > 0:
                blk[:, :k] = rows[:, j * n:j * n + k].to(blk.device,
                                                         blk.dtype)
        return
    for blk in {id(b): b for b in block_split}.values():
        blk[:, :s] = rows.to(blk.device, blk.dtype)


def _layer_prefill_tp(p, x, cfg, positions, kind, cache, group, attn_impl,
                      enc_out=None):
    """``layer_prefill`` split over a model group: the layer as in
    ``_layer_apply_tp``, the cache written by its layout (heads over
    model: each shard its KV heads; the sequence over model: every KV
    head all-gathered and each shard its positions, a local layer's ring
    its slots; MLA's latent and rope key, computed once, each shard its
    positions; the SSM's state by heads and conv window by segments, the
    RG-LRU's by channels; the cross cache by KV heads)."""
    s = x.shape[1]
    h = _norm_apply(cfg, _lead(p["norm1"]), x)
    if kind == "ssm":
        return x + ssm_mod.ssm_prefill_tp(p["mixer"], h, cfg, cache,
                                          group), cache
    if kind == "rglru":
        x = x + rglru_mod.rglru_prefill_tp(p["mixer"], h, cfg, cache, group)
    elif kind in _MLA_KINDS:
        latent = mla_mod.mla_prefill_latent(_lead(p["attn"]), h, cfg,
                                            positions)
        _write_prefix(cache["latent"], latent[0], s)
        _write_prefix(cache["k_rope"], latent[1], s)
        x = x + mla_mod.mla_attention_apply_tp(p["attn"], h, cfg, positions,
                                               group, latent=latent)
    else:
        qkv = attn.qkv_project_tp(p["attn"], h, cfg, positions, group,
                                  rope=not cfg.learned_pos_emb)
        if kind == "local":
            attn.write_ring(cache, [t[1] for t in qkv], [t[2] for t in qkv],
                            positions, cfg, group)
        else:
            for i, name in ((1, "k"), (2, "v")):
                c = cache[name]
                if c.dim == 2:              # heads over model
                    for j, t in enumerate(qkv):
                        c[j][:, :s] = t[i]
                else:
                    _write_prefix(c, attn.owned_kv([t[i] for t in qkv], cfg,
                                                   group), s)
        x = x + attn.attention_apply_tp(p["attn"], h, cfg, positions, group,
                                        qkv=qkv,
                                        **_attn_args(cfg, kind, attn_impl))
    if kind == "dec":
        kv = attn.cross_kv_tp(p["cross"], enc_out, cfg, group)
        attn.write_cross(cache, kv, cfg, group)
        x = x + attn.cross_attention_apply_tp(
            p["cross"], _norm_apply(cfg, _lead(p["norm_cross"]), x), enc_out,
            cfg, group, kv=kv)
    y, _ = _ffn_tp(p, _norm_apply(cfg, _lead(p["norm2"]), x), cfg, kind,
                   group)
    return x + y, cache


def _layer_decode_tp(p, x, cfg, cache, pos, kind, group):
    """``layer_decode`` split over a model group (``decode_attention_tp``,
    ``mla_decode_attention_tp``): the new latent and rope key, computed
    once, written by the shard whose sequence block holds ``pos``."""
    b = x.shape[0]
    h = _norm_apply(cfg, _lead(p["norm1"]), x)
    positions = pos.reshape(1, 1).expand(b, 1)
    if kind == "ssm":
        out, cache = ssm_mod.ssm_decode_step_tp(p["mixer"], h, cache, cfg,
                                                group)
        return x + out, cache
    if kind == "rglru":
        out, cache = rglru_mod.rglru_decode_step_tp(p["mixer"], h, cache,
                                                    cfg, group)
        x = x + out
    elif kind in _MLA_KINDS:
        latent, k_rope = mla_mod.mla_prefill_latent(_lead(p["attn"]), h,
                                                    cfg, positions)
        lat_c, kr_c = cache["latent"], cache["k_rope"]
        if lat_c.dim == 1:
            n = lat_c[0].shape[1]
            for j, (lat, kr, pj) in enumerate(zip(
                    tp.broadcast(latent, group), tp.broadcast(k_rope, group),
                    tp.broadcast(pos, group))):
                attn.write_at(lat_c[j], lat, pj, j * n)
                attn.write_at(kr_c[j], kr, pj, j * n)
        else:
            attn.write_copies(lat_c, latent, pos)
            attn.write_copies(kr_c, k_rope, pos)
        x = x + mla_mod.mla_decode_attention_tp(p["attn"], h, lat_c, kr_c,
                                                cfg, positions, pos, group)
    else:
        x = x + attn.decode_attention_tp(
            p["attn"], h, cfg, cache, pos, group,
            window=cfg.local_window if kind == "local" else 0,
            rope=not cfg.learned_pos_emb)
    if kind == "dec":
        x = x + attn.cross_attention_decode_tp(
            p["cross"], _norm_apply(cfg, _lead(p["norm_cross"]), x),
            cache["ck"], cache["cv"], cfg, group)
    y, _ = _ffn_tp(p, _norm_apply(cfg, _lead(p["norm2"]), x), cfg, kind,
                   group)
    return x + y, cache


def layer_prefill(p, x, cfg, positions, kind: str, max_len: int, *,
                  enc_out=None, attn_impl="chunked", cache=None,
                  group=None):
    """Layer forward that also fills its decode cache (made with
    ``layer_init_cache`` when None): K/V (or MLA's latent and rope key)
    at positions [0, s), zeros past them; a local layer's last min(s, W)
    K/V at ring slots ``i % W`` with their positions; the SSM's and the
    RG-LRU's final state and conv window; a ``dec`` layer's cross K/V of
    ``enc_out`` (computed once, for the cache and the cross attention;
    the reference computes them twice).  Returns (x, cache).  With a
    model ``group`` (``p`` and ``cache`` ``Split`` trees) the layer runs
    split over it."""
    _check_kind(kind)
    if group is not None:
        return _layer_prefill_tp(p, x, cfg, positions, kind, cache, group,
                                 attn_impl, enc_out)
    b, s, _ = x.shape
    if cache is None:
        cache = layer_init_cache(
            cfg, kind, b, max(max_len, s), x.dtype, x.device,
            enc_len=enc_out.shape[1] if enc_out is not None else None)
    h = _norm_apply(cfg, p["norm1"], x)
    if kind == "ssm":
        return x + ssm_mod.ssm_prefill(p["mixer"], h, cfg, cache), cache
    if kind == "rglru":
        x = x + rglru_mod.rglru_prefill(p["mixer"], h, cfg, cache)
    elif kind == "local":
        q, k, v = attn.qkv_project(p["attn"], h, cfg, positions,
                                   rope=not cfg.learned_pos_emb)
        o = attn.chunked_attention(q, k, v, causal=True, chunk=cfg.attn_chunk,
                                   window=cfg.local_window)
        # ring buffer: the token at absolute position i lives in slot i %
        # W, so that the decode's writes at pos % W stay consistent
        W = cache["k"].shape[1]
        t = min(s, W)
        slots = torch.arange(s - t, s, device=x.device) % W
        cache["k"].index_copy_(1, slots, k[:, -t:].to(cache["k"].dtype))
        cache["v"].index_copy_(1, slots, v[:, -t:].to(cache["v"].dtype))
        cache["k_pos"].index_copy_(
            1, slots, positions[-t:].to(torch.int32)[None].expand(b, t))
        x = x + o.reshape(b, s, cfg.num_heads * cfg.head_dim) \
            @ p["attn"]["wo"]
    elif kind in _MLA_KINDS:
        latent, k_rope = mla_mod.mla_prefill_latent(p["attn"], h, cfg,
                                                    positions)
        cache["latent"][:, :s] = latent
        cache["k_rope"][:, :s] = k_rope
        x = x + mla_mod.mla_attention_apply(p["attn"], h, cfg, positions)
    else:
        q, k, v = attn.qkv_project(p["attn"], h, cfg, positions,
                                   rope=not cfg.learned_pos_emb)
        if s <= cfg.attn_chunk:
            o = attn.full_attention(q, k, v, causal=True)
        elif attn_impl == "triangular":
            o = attn.triangular_chunked_attention(q, k, v,
                                                  chunk=cfg.attn_chunk)
        else:
            o = attn.chunked_attention(q, k, v, causal=True,
                                       chunk=cfg.attn_chunk)
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
        x = x + o.reshape(b, s, cfg.num_heads * cfg.head_dim) \
            @ p["attn"]["wo"]
    if kind == "dec":
        ck, cv = attn.cross_kv(p["cross"], enc_out, cfg)
        cache["ck"].copy_(ck)
        cache["cv"].copy_(cv)
        x = x + attn.cross_attention_apply(
            p["cross"], _norm_apply(cfg, p["norm_cross"], x), enc_out, cfg,
            kv=(ck, cv))
    y, _ = _ffn(p, _norm_apply(cfg, p["norm2"], x), cfg, kind)
    return x + y, cache


def layer_decode(p, x, cfg, cache, pos, kind: str, group=None):
    """One-token layer step.  x: (b,1,d); pos: the write index (a 0-d
    tensor on x's device, or an int).  Writes K/V (or the latent and
    rope key) at ``pos`` of ``cache`` (a local layer: at ring slot ``pos
    % W``; the SSM and the RG-LRU: their state and conv window) in place
    and returns (x, cache); a ``dec`` layer also attends over its cross
    cache, which it only reads.  With a model ``group`` (``p`` and
    ``cache`` ``Split`` trees) the layer runs split over it."""
    _check_kind(kind)
    b = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    if group is not None:
        return _layer_decode_tp(p, x, cfg, cache, pos, kind, group)
    h = _norm_apply(cfg, p["norm1"], x)
    if kind == "ssm":
        out, cache = ssm_mod.ssm_decode_step(p["mixer"], h, cache, cfg)
        return x + out, cache
    positions = pos.reshape(1, 1).expand(b, 1)
    at = pos.long().reshape(1)
    if kind == "rglru":
        out, cache = rglru_mod.rglru_decode_step(p["mixer"], h, cache, cfg)
        x = x + out
    elif kind == "local":
        q, k, v = attn.qkv_project(p["attn"], h, cfg, positions,
                                   rope=not cfg.learned_pos_emb)
        kc, vc, kp = cache["k"], cache["v"], cache["k_pos"]
        slot = at % kc.shape[1]
        kc.index_copy_(1, slot, k.to(kc.dtype))
        vc.index_copy_(1, slot, v.to(vc.dtype))
        kp.index_copy_(1, slot, positions)
        o = attn.decode_attention(q, kc, vc,
                                  attn.ring_mask(kp, pos, cfg.local_window))
        x = x + o.reshape(b, 1, cfg.num_heads * cfg.head_dim) \
            @ p["attn"]["wo"]
    elif kind in _MLA_KINDS:
        latent, k_rope = mla_mod.mla_prefill_latent(p["attn"], h, cfg,
                                                    positions)
        lat_c, kr_c = cache["latent"], cache["k_rope"]
        lat_c.index_copy_(1, at, latent.to(lat_c.dtype))
        kr_c.index_copy_(1, at, k_rope.to(kr_c.dtype))
        S = lat_c.shape[1]
        mask = (torch.arange(S, device=x.device) <= pos)[None, :]
        x = x + mla_mod.mla_decode_attention(p["attn"], h, lat_c, kr_c, cfg,
                                             positions, mask)
    else:
        q, k, v = attn.qkv_project(p["attn"], h, cfg, positions,
                                   rope=not cfg.learned_pos_emb)
        kc, vc = cache["k"], cache["v"]
        kc.index_copy_(1, at, k.to(kc.dtype))
        vc.index_copy_(1, at, v.to(vc.dtype))
        S = kc.shape[1]
        mask = (torch.arange(S, device=x.device) <= pos)[None, :] \
            .expand(b, S)
        o = attn.decode_attention(q, kc, vc, mask)
        x = x + o.reshape(b, 1, cfg.num_heads * cfg.head_dim) \
            @ p["attn"]["wo"]
    if kind == "dec":
        x = x + attn.cross_attention_decode(
            p["cross"], _norm_apply(cfg, p["norm_cross"], x), cache["ck"],
            cache["cv"], cfg)
    y, _ = _ffn(p, _norm_apply(cfg, p["norm2"], x), cfg, kind)
    return x + y, cache


# =================================================================
# stacks
# =================================================================

def _checkpointed(fn):
    """``fn`` recomputed in the backward (non-reentrant checkpoint)."""
    return lambda *args: torch_checkpoint.checkpoint(fn, *args,
                                                     use_reentrant=False)


def _apply_stack(stacked, L: int, x, cfg, positions, kind: str, *,
                 enc_out=None, attn_impl="chunked", group=None):
    """A stacked segment's ``L`` layers in order (the reference's
    ``_scan_layers``): (x, summed aux).  Under ``cfg.remat`` each layer
    is recomputed in its backward; with ``cfg.remat_block`` G dividing
    the L layers into more than one block, each block of G is
    checkpointed too (the two-level remat)."""

    def body(h, aux, li):
        h, a = layer_apply(_layer(stacked, li), h, cfg, positions, kind,
                           enc_out=enc_out, attn_impl=attn_impl, group=group)
        return h, aux + a

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if not cfg.remat:
        for li in range(L):
            x, aux = body(x, aux, li)
        return x, aux
    layer = _checkpointed(body)
    G = getattr(cfg, "remat_block", 0)
    if G and L % G == 0 and L // G > 1:
        def block(h, aux, b0):
            for li in range(b0, b0 + G):
                h, aux = layer(h, aux, li)
            return h, aux
        block = _checkpointed(block)
        for b0 in range(0, L, G):
            x, aux = block(x, aux, b0)
        return x, aux
    for li in range(L):
        x, aux = layer(x, aux, li)
    return x, aux


def _tree_meta(tree) -> bool:
    """Whether a tree's first leaf is a meta tensor (shapes only)."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return isinstance(tree, torch.Tensor) and tree.is_meta


def _stacked_init(generator, cfg, dtype, kind: str, n: int):
    """``n`` layers drawn one after another into stacked leaves (peak
    memory: the stack plus one layer)."""
    one = layer_init(generator, cfg, dtype, kind)
    stacked = _tree_map(
        lambda a: torch.empty((n,) + tuple(a.shape), dtype=a.dtype,
                              device=a.device), one)
    if _tree_meta(stacked):    # shapes only (launch.steps.eval_shape)
        return stacked
    for li in range(n):
        if li:
            one = layer_init(generator, cfg, dtype, kind)
        _tree_map(lambda buf, a: buf[li].copy_(a), stacked, one)
        one = None
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
    split: bool = False        # runs split over the mesh's model axis
    # params -> (the model group's ``Split`` tree, the group), or
    # (params, None) unsplit
    view: Any = None


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


def _max_pos(cfg):
    return 65536 if not cfg.encdec else 32768


def build_model(cfg, *, attn_impl: str = "chunked", mesh=None) -> ModelFns:
    """The LM of ``cfg`` (dense, MoE, MLA, SSM, hybrid, encoder-decoder
    or VLM).  ``init(generator)`` draws the params on the generator's
    device (an int seeds a generator on ``device``, the card unless the
    caller names another); the other entry points run where the params
    are.  ``batch`` is the reference's: ``"tokens"`` (b, s) ids, and
    ``"patch_emb"`` (the VLM) or ``"audio_emb"`` (whisper), numpy arrays
    or tensors.

    With a ``mesh`` whose ``model`` axis M exceeds 1 (``split``; every
    kind splits), the entry points run split over the
    model group of the mesh's first position (module docstring): they
    take the params whole (laid out first), placed
    (``distributed.tensor_parallel.place``) or as a group's ``Split``
    tree; ``init`` still draws them whole; the caches are the group's
    ``Split`` tree (plus ``pos`` on the first device) by
    ``tensor_parallel.shardings``."""
    dtype = nn.as_dtype(cfg.param_dtype)
    cdt = nn.as_dtype(cfg.compute_dtype)
    tied = cfg.tie_embeddings
    emb_scale = float(cfg.d_model) ** 0.5 if tied else 1.0
    plan = _layer_plan(cfg)
    split = tp.model_size(mesh) > 1

    def _view(params):
        """(the model group's ``Split`` tree of ``params``, the group),
        or (params, None) unsplit."""
        if fsdp.is_view(params):
            return params, fsdp.group_of(params) if split else None
        if not split:
            return params, None
        if not tp.is_view(params):
            params = tp.group_view(tp.place(params, mesh), mesh)
        return params, tp.group_of(params)
    # the hybrid: groups of block_pattern, stacked over n_groups, then
    # the leftover layers one by one (the reference's layout)
    pattern = tuple(cfg.block_pattern) if cfg.hybrid else ()
    n_groups = cfg.num_layers // len(pattern) if cfg.hybrid else 0
    tail = pattern[: cfg.num_layers % len(pattern)] if cfg.hybrid else ()

    def _walk(tree):
        """(kind, layer view) of a params or caches tree, in the order
        the layers apply."""
        if cfg.hybrid:
            for g in range(n_groups):
                for i, kind in enumerate(pattern):
                    yield kind, _layer(tree["groups"][f"b{i}"], g)
            for i, kind in enumerate(tail):
                yield kind, tree[f"tail{i}"]
            return
        for si, (kind, n) in enumerate(plan):
            for li in range(n):
                yield kind, _layer(tree[f"seg{si}"], li)

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
        if cfg.frontend == "vision_stub":
            params["vis_proj"] = nn.dense_init(generator, cfg.vision_dim,
                                               cfg.d_model, dtype)
        if cfg.encdec:
            params["enc_layers"] = _stacked_init(generator, cfg, dtype, "enc",
                                                 cfg.encoder_layers)
            params["enc_norm"] = _norm_init(cfg, dtype, generator.device)
            if cfg.learned_pos_emb:
                params["enc_pos"] = nn.embedding_init(
                    generator, cfg.encoder_seq_len, cfg.d_model, dtype)
        if cfg.learned_pos_emb:
            params["dec_pos"] = nn.embedding_init(generator, _max_pos(cfg),
                                                  cfg.d_model, dtype)
        if cfg.hybrid:
            params["groups"] = {
                f"b{i}": _stacked_init(generator, cfg, dtype, kind, n_groups)
                for i, kind in enumerate(pattern)}
            for i, kind in enumerate(tail):
                params[f"tail{i}"] = layer_init(generator, cfg, dtype, kind)
            return params
        for si, (kind, n) in enumerate(plan):
            params[f"seg{si}"] = _stacked_init(generator, cfg, dtype, kind, n)
        return params

    def _embed_tokens(params, tokens, g=None):
        emb = fsdp.use(params["embed"])
        if g is not None:
            x = nn.embed_tp(emb, torch.as_tensor(tokens, device=g.lead), g) \
                .to(cdt)
        else:
            tokens = torch.as_tensor(tokens, device=emb.device)
            x = emb[tokens.long()].to(cdt)
        if tied:   # sqrt(d) cast to x's type (a host scalar, no copy)
            x = x * torch.tensor(emb_scale, dtype=x.dtype)
        return x

    def _vis(params, patches, g):
        """The patches projected by ``vis_proj``: split over a model
        group, each shard its columns, all-gathered."""
        vp = fsdp.use(params["vis_proj"])
        if g is None or vp.dim is None:
            return patches @ (vp if g is None else vp.whole)
        return tp.all_gather([pj @ vp[j] for j, pj in
                              enumerate(tp.broadcast(patches, g))], g)

    def _inputs(params, batch, g=None):
        """The decoder's input rows (the VLM's projected patches first,
        then the text tokens; plus ``dec_pos`` under learned positions)
        and their positions."""
        dev = g.lead if g is not None else params["embed"].device
        x = _embed_tokens(params, batch["tokens"], g)
        if cfg.frontend == "vision_stub":
            patches = torch.as_tensor(batch["patch_emb"], device=dev)
            x = torch.cat([_vis(params, patches.to(cdt), g), x], dim=1)
        if cfg.learned_pos_emb:
            x = x + _whole(fsdp.use(params["dec_pos"]))[: x.shape[1]][None] \
                .to(x.dtype)
        return x, torch.arange(x.shape[1], device=dev)

    def _encode(params, batch, g=None):
        """Whisper's encoder over ``batch["audio_emb"]``: learned
        positions, the non-causal ``enc`` layers (``_apply_stack``, so
        under ``cfg.remat`` each recomputed in the backward; split over
        a model group ``g``), the final norm."""
        dev = g.lead if g is not None else params["embed"].device
        a = torch.as_tensor(batch["audio_emb"], device=dev).to(cdt)
        if cfg.learned_pos_emb:
            a = a + _whole(fsdp.use(params["enc_pos"]))[: a.shape[1]][None] \
                .to(a.dtype)
        pos = torch.arange(a.shape[1], device=a.device)
        a, _ = _apply_stack(params["enc_layers"], cfg.encoder_layers, a,
                            cfg, pos, "enc", group=g)
        norm = fsdp.use(params["enc_norm"])
        return _norm_apply(cfg, norm if g is None else _lead(norm), a)

    def _head(params, g):
        """The head as a function of normed rows: the tied embedding's
        transpose or ``head``, split over the vocabulary with a group."""
        w = fsdp.use(params["embed"] if tied else params["head"])
        if g is not None:
            return lambda x: nn.head_tp(x, w, g, tied=tied)
        return lambda x: x @ (w.T.to(x.dtype) if tied else w)

    def _final_norm(params, x, g):
        norm = fsdp.use(params["final_norm"])
        return _norm_apply(cfg, norm if g is None else _lead(norm), x)

    def _logits(params, x, g=None):
        x = _final_norm(params, x, g)
        return _head(params, g)(x)[..., : cfg.vocab_size]

    def _hybrid_apply(params, x, positions, mg=None):
        """The hybrid's groups (each one checkpoint under ``cfg.remat``,
        as the reference's scan body), then its tail layers; split over
        a model group ``mg``."""
        def group(h, aux, g):
            for i, kind in enumerate(pattern):
                h, a = layer_apply(_layer(params["groups"][f"b{i}"], g), h,
                                   cfg, positions, kind, attn_impl=attn_impl,
                                   group=mg)
                aux = aux + a
            return h, aux
        run = _checkpointed(group) if cfg.remat else group
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for g in range(n_groups):
            x, aux = run(x, aux, g)
        for i, kind in enumerate(tail):
            x, a = layer_apply(fsdp.use(params[f"tail{i}"]), x, cfg,
                               positions, kind, attn_impl=attn_impl,
                               group=mg)
            aux = aux + a
        return x, aux

    def _backbone_train(params, x, positions, g=None):
        if cfg.hybrid:
            return _hybrid_apply(params, x, positions, g)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for si, (kind, n) in enumerate(plan):
            x, a = _apply_stack(params[f"seg{si}"], n, x, cfg, positions,
                                kind, attn_impl=attn_impl, group=g)
            aux = aux + a
        return x, aux

    def train_forward(params, batch):
        """Mean next-token CE (+ z-loss) plus the MoE layers' summed
        load-balance loss: (loss + aux, {"ce": loss, "aux": aux}).
        ``batch``: ``tokens`` and ``labels`` (b, s) ids, and
        ``patch_emb`` (the VLM, whose patch positions carry no loss) or
        ``audio_emb`` (the encoder-decoder); numpy arrays or tensors.
        With ``cfg.ce_chunk`` the head and CE run fused over sequence
        chunks, the final position masked (the shift without slicing);
        else the full logits and CE of positions [0, s - 1)."""
        params, g = _view(params)
        dev = g.lead if g is not None else params["embed"].device
        if tied:        # one gather for the input and the head
            params = dict(params, embed=fsdp.use(params["embed"]))
        with full_f32_matmul():
            if cfg.encdec:
                enc_out = _encode(params, batch, g)
                x, positions = _inputs(params, batch, g)
                x, aux = _apply_stack(params["seg0"], cfg.num_layers, x, cfg,
                                      positions, "dec", enc_out=enc_out,
                                      attn_impl=attn_impl, group=g)
            else:
                x, positions = _inputs(params, batch, g)
                x, aux = _backbone_train(params, x, positions, g)
            labels = torch.as_tensor(batch["labels"], device=dev).long()
            if cfg.frontend == "vision_stub":   # loss over text positions
                x = x[:, cfg.num_vision_tokens:, :]
            x = _final_norm(params, x, g)
            w = (_head(params, g) if g is not None
                 else params["embed"].T.to(x.dtype) if tied
                 else fsdp.use(params["head"]))
            if cfg.ce_chunk:
                s = labels.shape[1]
                labels_next = torch.cat(
                    [labels[:, 1:], torch.zeros_like(labels[:, :1])], dim=1)
                pos_mask = (torch.arange(s, device=dev) < s - 1)[None, :] \
                    .expand(labels.shape)
                loss = nn.chunked_cross_entropy_head(
                    x, w, labels_next, pos_mask, chunk=cfg.ce_chunk,
                    vocab_real=cfg.vocab_size)
            else:
                logits = (w(x) if g is not None else x @ w)[
                    ..., : cfg.vocab_size]
                loss = nn.cross_entropy(logits[:, :-1], labels[:, 1:])
        return loss + aux, {"ce": loss, "aux": aux}

    def init_cache(batch_size: int, max_len: int, dtype_=None, *,
                   device=None, enc_len=None):
        if split:       # the model group's blocks (``device`` unused)
            return _split_cache(batch_size, max_len, dtype_, enc_len)
        return _whole_cache(batch_size, max_len, dtype_, device=device,
                            enc_len=enc_len)

    def _split_cache(batch_size, max_len, dtype_, enc_len=None):
        """Zeroed blocks of the caches over the mesh's first model
        group: each split leaf shard j's block of its model split
        (``tensor_parallel.shardings``: ``cache_pspec``'s, the SSM's conv
        window by segments, the cross cache by heads) on its device,
        each replicated leaf one copy a device."""
        whole = _whole_cache(batch_size, max_len, dtype_, device="meta",
                             enc_len=enc_len)
        pos = whole.pop("pos")
        g = tp.model_group(mesh)

        def one(t, sh):
            dim = next((i for i, e in enumerate(sh.spec) if e is not None),
                       None)
            if dim is None:
                copies = {d: torch.zeros(t.shape, dtype=t.dtype, device=d)
                          for d in dict.fromkeys(g.devices)}
                return tp.Split([copies[d] for d in g.devices], None)
            block = sh.shard_shape(t.shape)
            return tp.Split([torch.zeros(block, dtype=t.dtype, device=d)
                             for d in g.devices], dim, sh.segments)
        out = tp._map2(one, whole, tp.shardings(whole, mesh, cfg))
        out["pos"] = torch.zeros((), dtype=pos.dtype, device=g.lead)
        return out

    def _whole_cache(batch_size, max_len, dtype_=None, *, device=None,
                     enc_len=None):
        dt = dtype_ or cdt
        dev = resolve_device(device)
        caches: Dict[str, Any] = {
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}

        def stack(kind, n):
            one = layer_init_cache(cfg, kind, batch_size, max_len, dt, dev,
                                   enc_len)
            return _tree_map(lambda a: a[None].repeat((n,) + (1,) * a.ndim),
                             one)
        if cfg.hybrid:
            caches["groups"] = {f"b{i}": stack(kind, n_groups)
                                for i, kind in enumerate(pattern)}
            for i, kind in enumerate(tail):
                caches[f"tail{i}"] = layer_init_cache(
                    cfg, kind, batch_size, max_len, dt, dev)
            return caches
        for si, (kind, n) in enumerate(plan):
            caches[f"seg{si}"] = stack(kind, n)
        return caches

    def prefill(params, batch, max_len: int):
        params, g = _view(params)
        dev = g.lead if g is not None else params["embed"].device
        with full_f32_matmul():
            enc_out = _encode(params, batch, g) if cfg.encdec else None
            x, positions = _inputs(params, batch, g)
            b, s, _ = x.shape
            caches = init_cache(
                b, max(max_len, s), device=dev,
                enc_len=enc_out.shape[1] if cfg.encdec else None)
            caches["pos"].fill_(s)
            for (kind, lp), (_, lc) in zip(_walk(params), _walk(caches)):
                x, _ = layer_prefill(lp, x, cfg, positions, kind, max_len,
                                     enc_out=enc_out, attn_impl=attn_impl,
                                     cache=lc, group=g)
            logits = _logits(params, x[:, -1:, :], g)
        return logits, caches

    def decode_step(params, tokens, caches):
        """tokens: (b,1) ints.  Returns (logits (b,1,V), caches): the
        cache buffers are written in place, ``pos`` advances by one."""
        params, g = _view(params)
        pos = caches["pos"]
        with full_f32_matmul():
            x = _embed_tokens(params, tokens, g)
            if cfg.learned_pos_emb:   # a gather at the device pos: no sync
                x = x + _whole(params["dec_pos"]).index_select(
                    0, pos.long().reshape(1))[None].to(x.dtype)
            for (kind, lp), (_, lc) in zip(_walk(params), _walk(caches)):
                x, _ = layer_decode(lp, x, cfg, lc, pos, kind, group=g)
            logits = _logits(params, x, g)
        return logits, {**caches, "pos": pos + 1}

    return ModelFns(cfg=cfg, init=init, train_forward=train_forward,
                    prefill=prefill, decode_step=decode_step,
                    init_cache=init_cache, split=split, view=_view)
