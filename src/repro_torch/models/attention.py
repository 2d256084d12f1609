"""Attention layers (twin of ``repro.models.attention``): GQA with
chunked online-softmax, the triangular chunk-pair scan, full einsum
attention, cross attention over encoder states and single-token decode
against a KV cache.

On the CPU each function is the plain twin of the reference's.  On a
CUDA tensor ``full_attention``, ``chunked_attention`` and
``triangular_chunked_attention`` compute exactly what the flash kernel
computes (causal or not, with or without a sliding window, the
key-padding bound ``kv_valid``, a query offset ``q_offset``: query row
i at position i + q_offset, the triangular scan's sk > sq as q_offset
= sk - sq; ``full_attention``'s ``mask=`` as the kernel's mask operand,
broadcast as the reference broadcasts it against the (b, KVH, G, sq,
sk) scores; a row that keeps no key takes the reference's uniform
softmax in both), so there they launch ``kernels.ops.flash_attention``
and nothing else; so does ``cross_attention_apply``, on the unpadded
operands (each query row is computed on its own, and the kernel's
ragged-tail mask masks what the reference's padding and ``kv_valid``
mask, so rows [0, s) are the padded call's).  A meta tensor takes the
card's branch (the dry run).  v may be narrower than q and k (MLA's
prefill: q/k 192, v 128; the output takes v's width); a (q/k, v) width
pair the kernel does not compile (it compiles 32, 64, 128 and 256 with
v as wide, and (192, 128)) raises its ``ValueError``.
``decode_attention`` and ``cross_attention_decode`` are not kernels in
the reference either and stay plain PyTorch on both devices.

Training takes the same branches: under autograd (``train_forward``) the
card's flash launch is differentiable, its forward writing the rows'
log-sum-exp and its backward running the flash backward kernels
(``kernels.ops.flash_attention``); on the CPU autograd differentiates
the plain twins, as XLA differentiates the reference's.

Split over a mesh's ``model`` axis (``*_tp``, ``distributed.
tensor_parallel``): each shard projects and attends over its H / M query
heads and the KV heads they read (``wk`` / ``wv`` all-gathered first
when the rule table's column split falls inside a head), ``wo``'s rows
of them give a partial that is all-reduced; the decode reads the cache
layout ``cache_pspec`` picks (heads, or the sequence: every head's
softmax partials over each shard's positions, merged by
``combine_attention_partials``) and writes the new K / V in place at
the 0-d device position, by a mask where the sequence is split.  A local
layer's ring splits by sequence or stays whole (``write_ring``; its
decode masks each slot by ``k_pos``; a ring by heads raises); the cross
attention splits by heads over the cross cache held by KV heads
(``cross_kv_tp``, ``write_cross``, ``cross_attention_apply_tp``: one
non-causal flash launch a shard on the card,
``cross_attention_decode_tp``).
"""
from __future__ import annotations

import torch

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels import ops
from repro_torch.models import nn

NEG_INF = -1e30


def attn_init(generator: torch.Generator, cfg, dtype=torch.float32):
    d = cfg.d_model
    return {
        "wq": nn.dense_init(generator, d, cfg.num_heads * cfg.head_dim, dtype),
        "wk": nn.dense_init(generator, d, cfg.num_kv_heads * cfg.head_dim,
                            dtype),
        "wv": nn.dense_init(generator, d, cfg.num_kv_heads * cfg.head_dim,
                            dtype),
        "wo": nn.dense_init(generator, cfg.num_heads * cfg.head_dim, d, dtype),
    }


def _split_heads(x, n_heads, head_dim):
    return x.reshape(*x.shape[:-1], n_heads, head_dim)


def qkv_project(p, x, cfg, positions, rope: bool = True):
    """Project + rope.  Returns q:(b,s,H,dh), k,v:(b,s,KVH,dh), each
    contiguous (what the flash kernel reads, with no transpose)."""
    q = _split_heads(x @ p["wq"], cfg.num_heads, cfg.head_dim)
    k = _split_heads(x @ p["wk"], cfg.num_kv_heads, cfg.head_dim)
    v = _split_heads(x @ p["wv"], cfg.num_kv_heads, cfg.head_dim)
    if rope:
        q = nn.apply_rope(q, positions, cfg.rope_theta)
        k = nn.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _gqa_scores(q, k, scale):
    """q:(b,sq,H,dh) k:(b,sk,KVH,dh) -> scores (b,KVH,G,sq,sk) f32 (the
    products of the inputs' values, summed in f32)."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, dh)
    return torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale


def _gqa_out(probs, v):
    """probs:(b,KVH,G,sq,sk) v:(b,sk,KVH,dh) -> (b,sq,H,dh) in v's type."""
    b, kvh, g, sq, sk = probs.shape
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, kvh * g, v.shape[-1])


def on_card(t) -> bool:
    """Whether ``t`` takes the card's branch: a CUDA tensor, or a meta
    tensor (the dry run traces the card's program)."""
    return t.device.type in ("cuda", "meta")


def _flash(q, k, v, *, causal, window=0, kv_valid=0, q_offset=0,
           mask=None):
    """The card's attention: the flash kernel, causal or not, with the
    band mask under ``window``, the key-padding bound ``kv_valid``, query
    positions shifted by ``q_offset`` and ``mask`` (the reference's,
    broadcast against (b, KVH, G, sq, sk) and read as (b, H, sq, sk):
    head h = kvh G + g) as its mask operand."""
    if mask is not None:
        b, sq, h, _ = q.shape
        sk, kvh = k.shape[1], k.shape[2]
        mask = torch.broadcast_to(mask, (b, kvh, h // kvh, sq, sk)) \
            .reshape(b, h, sq, sk)
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               kv_valid=kv_valid, q_offset=q_offset,
                               mask=mask)


def chunked_attention(q, k, v, *, causal: bool, chunk: int,
                      q_offset: int = 0, window: int = 0,
                      kv_valid: int = 0):
    """Online-softmax attention over (query chunk, key chunk) pairs,
    carrying (running max, normalizer, accumulator).  ``window>0`` adds
    a sliding band mask, ``kv_valid>0`` masks keys at positions >=
    kv_valid.  On the card: the flash kernel (module docstring)."""
    if on_card(q):
        return _flash(q, k, v, causal=causal, window=window,
                      kv_valid=kv_valid, q_offset=q_offset)
    b, sq, h, dh = q.shape
    sk, kvh, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = h // kvh
    scale = dh ** -0.5
    qc, kc = min(chunk, sq), min(chunk, sk)
    nq, nk = sq // qc, sk // kc
    assert sq % qc == 0 and sk % kc == 0, (sq, qc, sk, kc)
    outs = []
    for qi in range(nq):
        qblk = q[:, qi * qc:(qi + 1) * qc]
        q_pos = q_offset + qi * qc + torch.arange(qc)
        m = torch.full((b, kvh, g, qc), NEG_INF)
        l = torch.zeros((b, kvh, g, qc))
        acc = torch.zeros((b, kvh, g, qc, dv))
        for ki in range(nk):
            kblk = k[:, ki * kc:(ki + 1) * kc]
            vblk = v[:, ki * kc:(ki + 1) * kc]
            k_pos = ki * kc + torch.arange(kc)
            s = _gqa_scores(qblk, kblk, scale)           # (b,kvh,g,qc,kc)
            mask = torch.ones((qc, kc), dtype=torch.bool)
            if causal:
                mask &= q_pos[:, None] >= k_pos[None, :]
            if window:
                mask &= (q_pos[:, None] - k_pos[None, :]) < window
            if kv_valid:
                mask &= (k_pos < kv_valid)[None, :]
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(vblk.dtype), vblk).float()
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]  # (b,kvh,g,qc,dv)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, qc, h, dv)
                    .to(v.dtype))
    return torch.cat(outs, dim=1)


def triangular_chunked_attention(q, k, v, *, chunk: int, window: int = 0):
    """Causal attention over the (query chunk, key chunk <= it) pairs
    only, skipping the fully masked upper triangle; the reference's
    pair order and online-softmax state per query chunk.  On the card:
    the flash kernel, which skips those tiles too (module docstring)."""
    b, sq, h, dh = q.shape
    sk, kvh, dv = k.shape[1], k.shape[2], v.shape[-1]
    if on_card(q):
        return _flash(q, k, v, causal=True, window=window,
                      q_offset=sk - sq)
    g = h // kvh
    scale = dh ** -0.5
    qc = kc = min(chunk, sq, sk)
    nq, nk = sq // qc, sk // kc
    assert sq % qc == 0 and sk % kc == 0
    offset = nk - nq
    m = torch.full((b, kvh, g, nq, qc), NEG_INF)
    l = torch.zeros((b, kvh, g, nq, qc))
    acc = torch.zeros((b, kvh, g, nq, qc, dv))
    for qi in range(nq):
        for ki in range(qi + offset + 1):
            if window and (qi + offset - ki) * kc >= window + kc:
                continue
            qblk = q[:, qi * qc:(qi + 1) * qc]
            kblk = k[:, ki * kc:(ki + 1) * kc]
            vblk = v[:, ki * kc:(ki + 1) * kc]
            q_pos = qi * qc + torch.arange(qc) + offset * kc
            k_pos = ki * kc + torch.arange(kc)
            s = _gqa_scores(qblk, kblk, scale)
            mask = q_pos[:, None] >= k_pos[None, :]
            if window:
                mask &= (q_pos[:, None] - k_pos[None, :]) < window
            s = torch.where(mask, s, NEG_INF)
            m_prev, l_prev = m[:, :, :, qi], l[:, :, :, qi]
            m_new = torch.maximum(m_prev, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_prev - m_new)
            l[:, :, :, qi] = l_prev * corr + p.sum(dim=-1)
            acc[:, :, :, qi] = acc[:, :, :, qi] * corr[..., None] + \
                torch.einsum("bkgqs,bskd->bkgqd", p.to(vblk.dtype),
                             vblk).float()
            m[:, :, :, qi] = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]     # (b,kvh,g,nq,qc,dv)
    out = out.permute(0, 3, 4, 1, 2, 5).reshape(b, sq, kvh * g, dv)
    return out.to(v.dtype)


def full_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                   window: int = 0, mask=None):
    """Einsum attention over the whole score matrix.  On the card: the
    flash kernel (module docstring)."""
    if on_card(q):
        return _flash(q, k, v, causal=causal, window=window,
                      q_offset=q_offset, mask=mask)
    sq, dh = q.shape[1], q.shape[3]
    sk = k.shape[1]
    s = _gqa_scores(q, k, dh ** -0.5)
    q_pos = q_offset + torch.arange(sq)
    k_pos = torch.arange(sk)
    m = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window:
        m &= (q_pos[:, None] - k_pos[None, :]) < window
    if mask is not None:
        m = m & mask
    s = torch.where(m, s, NEG_INF)
    return _gqa_out(torch.softmax(s, dim=-1), v)


def decode_attention(q, k_cache, v_cache, length_mask):
    """Single-token decode.  q:(b,1,H,dh), caches:(b,S,KVH,dh),
    length_mask:(b,S) bool (True = valid slot).  Plain PyTorch on both
    devices (the flash kernel's top-left causal mask does not fit one
    query at a later position)."""
    b, _, h, dh = q.shape
    kvh = k_cache.shape[2]
    qg = q.reshape(b, kvh, h // kvh, dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) \
        * dh ** -0.5
    s = torch.where(length_mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, h, dh)


def attention_apply(p, x, cfg, positions, *, causal=True, window=0,
                    impl="chunked", rope=True):
    """Full-sequence attention (train / prefill)."""
    q, k, v = qkv_project(p, x, cfg, positions, rope=rope)
    out = _attend(q, k, v, cfg, causal=causal, window=window, impl=impl)
    return out.flatten(-2) @ p["wo"]


def _attend(q, k, v, cfg, *, causal, window, impl):
    """The attention of ``attention_apply`` over q's heads: (b, s, h,
    dv)."""
    s = q.shape[1]
    if impl == "full" or s <= cfg.attn_chunk:
        out = full_attention(q, k, v, causal=causal, window=window)
    elif impl == "triangular" and causal:
        out = triangular_chunked_attention(q, k, v, chunk=cfg.attn_chunk,
                                           window=window)
    elif not causal and s % cfg.attn_chunk:
        # ragged non-causal (whisper's 1500-frame encoder): pad + mask
        sp = _pad_len(s, cfg.attn_chunk)
        pad = (0, 0, 0, 0, 0, sp - s)
        out = chunked_attention(
            torch.nn.functional.pad(q, pad), torch.nn.functional.pad(k, pad),
            torch.nn.functional.pad(v, pad), causal=False,
            chunk=cfg.attn_chunk, kv_valid=s)[:, :s]
    else:
        out = chunked_attention(q, k, v, causal=causal, chunk=cfg.attn_chunk,
                                window=window)
    return out


def _pad_len(n: int, c: int) -> int:
    return ((n + c - 1) // c) * c


# ------------------------------------------------------ cross attention ----

def cross_attn_init(generator: torch.Generator, cfg, dtype=torch.float32):
    return attn_init(generator, cfg, dtype)


def cross_kv(p, enc_out, cfg):
    """The cross attention's K and V of the encoder states: (b, s_enc,
    KVH, dh) each, contiguous (the decoder's static cross cache)."""
    return (_split_heads(enc_out @ p["wk"], cfg.num_kv_heads, cfg.head_dim),
            _split_heads(enc_out @ p["wv"], cfg.num_kv_heads, cfg.head_dim))


def cross_attention_apply(p, x, enc_out, cfg, *, kv=None):
    """Decoder cross attention over encoder states (no rope, no mask).
    ``kv``: the ``cross_kv`` of ``enc_out`` when the caller has them
    already (the prefill, which also caches them).  On the CPU, chunked
    when either side exceeds attn_chunk, q and k / v padded to multiples
    of it and the padded keys masked with ``kv_valid``, as the
    reference; on the card the flash kernel on the unpadded operands
    (module docstring)."""
    q = _split_heads(x @ p["wq"], cfg.num_heads, cfg.head_dim)
    k, v = kv if kv is not None else cross_kv(p, enc_out, cfg)
    return _cross_attend(q, k, v, cfg).flatten(-2) @ p["wo"]


def _cross_attend(q, k, v, cfg):
    """The cross attention of ``cross_attention_apply`` over q's heads:
    (b, s, h, dh)."""
    s, sk = q.shape[1], k.shape[1]
    if on_card(q) or max(s, sk) <= cfg.attn_chunk:
        return full_attention(q, k, v, causal=False)
    qc, kc = _pad_len(s, cfg.attn_chunk), _pad_len(sk, cfg.attn_chunk)
    qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, qc - s))
    kp, vp = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, kc - sk))
              for t in (k, v))
    return chunked_attention(qp, kp, vp, causal=False, chunk=cfg.attn_chunk,
                             kv_valid=sk)[:, :s]


def cross_attention_decode(p, x, k_cache, v_cache, cfg):
    """Decode-time cross attention against the static cross cache (read
    only); plain PyTorch on both devices."""
    b = x.shape[0]
    q = _split_heads(x @ p["wq"], cfg.num_heads, cfg.head_dim)
    valid = torch.ones(k_cache.shape[:2], dtype=torch.bool,
                       device=x.device)
    out = decode_attention(q, k_cache, v_cache, valid)
    return out.reshape(b, 1, cfg.num_heads * cfg.head_dim) @ p["wo"]


# -------------------------------------------------- tensor parallelism ----

def head_split(cfg, M: int):
    """(H / M query heads a shard, [(lo, hi)]: the KV heads shard j's
    query heads read).  Raises when the query heads do not split over M
    or a shard's heads straddle their KV groups unevenly."""
    H, KVH = cfg.num_heads, cfg.num_kv_heads
    G = H // KVH
    Hl = H // M
    if H % M or (G % Hl and Hl % G):
        raise ValueError(f"{H} query heads over {KVH} KV heads do not "
                         f"split into {M} model shards head by head")
    return Hl, [(j * Hl // G, ((j + 1) * Hl - 1) // G + 1)
                for j in range(M)]


def _kv_weight(w, cfg, kv, group, kv_heads_split: bool):
    """Shard j's K (or V) kernel columns: its block when the KV heads
    split over the group; else the heads [lo, hi) of the whole kernel,
    which a column split inside a head all-gathers first (GSPMD's
    result of the rule table's split)."""
    if kv_heads_split:
        return list(w)
    whole = (list(w) if w.dim is None
             else tp.broadcast(tp.all_gather(list(w), group, dim=-1),
                               group))
    dh = cfg.head_dim
    return [wj[:, lo * dh:hi * dh] for wj, (lo, hi) in zip(whole, kv)]


def kv_heads_split(cfg, p, M: int) -> bool:
    """Whether the KV heads split over the model group block by block
    (``cache_pspec``'s head rule, and ``wk`` split)."""
    return cfg.num_kv_heads % M == 0 and p["wk"].dim is not None


def qkv_project_tp(p, x, cfg, positions, group, rope: bool = True):
    """``qkv_project`` on each shard of a model group (``p`` a ``Split``
    tree, x and positions replicated on the first device): [(q_j (b, s,
    H / M, dh), k_j, v_j (b, s, hi - lo, dh))] on the shards' devices,
    shard j's query heads and the KV heads they read."""
    M = group.size
    if p["wq"].dim is None or p["wo"].dim is None:
        raise ValueError("wq / wo are not split over the model axis")
    Hl, kv = head_split(cfg, M)
    split = kv_heads_split(cfg, p, M)
    wk = _kv_weight(p["wk"], cfg, kv, group, split)
    wv = _kv_weight(p["wv"], cfg, kv, group, split)
    out = []
    for j, (xj, pos) in enumerate(zip(tp.broadcast(x, group),
                                      tp.broadcast(positions, group))):
        n = kv[j][1] - kv[j][0]
        q = _split_heads(xj @ p["wq"][j], Hl, cfg.head_dim)
        k = _split_heads(xj @ wk[j], n, cfg.head_dim)
        v = _split_heads(xj @ wv[j], n, cfg.head_dim)
        if rope:
            q = nn.apply_rope(q, pos, cfg.rope_theta)
            k = nn.apply_rope(k, pos, cfg.rope_theta)
        out.append((q, k, v))
    return out


def attention_apply_tp(p, x, cfg, positions, group, *, causal=True,
                       window=0, impl="chunked", rope=True, qkv=None):
    """``attention_apply`` split over a model group: each shard its
    query heads (on the card one flash launch a shard), ``wo``'s rows
    of them giving a partial that is all-reduced.  ``qkv``: the shards'
    ``qkv_project_tp`` when the caller has them (the prefill)."""
    qkv = qkv or qkv_project_tp(p, x, cfg, positions, group, rope=rope)
    parts = [_attend(q, k, v, cfg, causal=causal, window=window,
                     impl=impl).flatten(-2) @ p["wo"][j]
             for j, (q, k, v) in enumerate(qkv)]
    return tp.all_reduce(parts, group)


def owned_kv(ks, cfg, group):
    """Every KV head of the shards' ``qkv_project_tp`` keys (or values),
    (b, s, KVH, dh) on the first device: each head from the first shard
    that reads it, all-gathered in shard order."""
    _, kv = head_split(cfg, group.size)
    parts, done = [], 0
    for k, (lo, hi) in zip(ks, kv):
        parts.append(k[:, :, max(lo, done) - lo:])
        done = max(done, hi)
    return tp.all_gather(parts, group, dim=2, size=cfg.num_kv_heads)


def write_at(block, val, pos, start: int):
    """``val`` (b, 1, ...) written in place at position ``pos`` (a 0-d
    tensor on the block's device) of a sequence block holding positions
    [start, start + its length): by a mask where the block does not
    hold it (no host branch, no synchronize)."""
    n = block.shape[1]
    local = pos.long() - start
    idx = torch.clamp(local, 0, n - 1).reshape(1)
    mine = (local >= 0) & (local < n)
    old = block.index_select(1, idx)
    block.index_copy_(1, idx, torch.where(mine, val.to(block.dtype), old))


def write_copies(split, val, pos):
    """``val`` (b, 1, ...) written in place at ``pos`` into every
    distinct copy of a cache leaf the rule table keeps whole."""
    at = pos.long().reshape(1)
    for blk in {id(b): b for b in split}.values():
        blk.index_copy_(1, at.to(blk.device), val.to(blk.device, blk.dtype))


def decode_partials(q, k_cache, v_cache, length_mask):
    """``decode_attention``'s softmax over one block of positions as
    unnormalized partials (m, l, o): (b, KVH, G) and (b, KVH, G, dh), in
    f32, for ``combine_attention_partials``."""
    b, _, h, dh = q.shape
    kvh = k_cache.shape[2]
    qg = q.reshape(b, kvh, h // kvh, dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) \
        * dh ** -0.5
    s = torch.where(length_mask[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None])
    return m, e.sum(dim=-1), torch.einsum("bkgs,bskd->bkgd", e,
                                          v_cache.float())


def combine_partials_tp(parts, group):
    """The shards' (m, l, o) partials (shard order) merged on the first
    device (``quant.kv_cache.combine_attention_partials``), counted as
    the all-gather that brings them there: o / l in f32."""
    from repro_torch.quant.kv_cache import combine_attention_partials
    M = group.size
    tp.count(tp.ALL_GATHER, (M - 1) * sum(
        t.numel() * t.element_size() for t in parts[0]))
    ms, ls, os_ = zip(*parts)
    return combine_attention_partials(list(ms), list(ls), list(os_))


def ring_mask(kp, pos, window: int):
    """The valid slots of a ring block from its absolute positions."""
    return (kp >= 0) & (kp > pos - window) & (kp <= pos)


def _ring_split(cache):
    """A local layer's ring's ``k_pos``, after checking that the ring is
    split by sequence or kept whole: a ring split by KV heads (a local
    layer with as many KV heads as the group, which no shipped config
    has: recurrentgemma's one) raises."""
    if cache["k"].dim == 2:
        raise NotImplementedError(
            "a local layer's ring split by KV heads over the model axis")
    return cache["k_pos"]


def decode_attention_tp(p, x, cfg, cache, pos, group, *, window=0,
                        rope=True):
    """One token's attention split over a model group, writing its K / V
    at ``pos`` (0-d, on the first device) into ``cache`` ("k", "v":
    ``Split``s of the layout ``cache_pspec`` picks) in place.  Heads over
    ``model``: each shard its heads over its KV heads.  The sequence over
    ``model``: the new K / V of every KV head all-gathered and written
    by the shard that holds ``pos``; the queries all-gathered, each shard
    the softmax partials of every head over its positions, merged by
    ``combine_attention_partials``; each shard then its heads' rows of
    ``wo``.  A whole cache: each shard its heads over its KV heads of
    it.  The partials of ``wo`` are all-reduced.

    With ``window`` (a local layer) the cache is the ring of ``W`` slots
    and its ``k_pos`` (split by sequence, or whole where ``W`` does not
    divide over the group: ``_ring_split``): the token goes to slot
    ``pos % W`` (by the shard whose block holds it, with its position),
    and each slot counts where ``k_pos`` puts it inside the window."""
    b = x.shape[0]
    M = group.size
    Hl, kv = head_split(cfg, M)
    positions = pos.reshape(1, 1).expand(b, 1)
    qkv = qkv_project_tp(p, x, cfg, positions, group, rope=rope)
    kc, vc = cache["k"], cache["v"]
    kp = _ring_split(cache) if window else None
    S = kc[0].shape[1]                    # a block's (or a copy's) slots
    at = pos % (S * M if kc.dim == 1 else S) if window else pos
    poss, ats = tp.broadcast(pos, group), tp.broadcast(at, group)
    if window and kc.dim is None:         # a whole ring
        write_copies(kp, positions, at)

    def mask_of(j, dev, start=0):
        if window:
            return ring_mask(kp[j], poss[j], window)
        return (start + torch.arange(S, device=dev) <= poss[j])[None, :] \
            .expand(b, S)
    outs = []
    if kc.dim == 2:                       # heads over model
        for j, (q, k, v) in enumerate(qkv):
            i = ats[j].long().reshape(1)
            kc[j].index_copy_(1, i, k.to(kc[j].dtype))
            vc[j].index_copy_(1, i, v.to(vc[j].dtype))
            outs.append(decode_attention(q, kc[j], vc[j],
                                         mask_of(j, q.device)))
    else:
        k_all = owned_kv([t[1] for t in qkv], cfg, group)
        v_all = owned_kv([t[2] for t in qkv], cfg, group)
        if kc.dim == 1:                   # the sequence over model
            q_all = tp.all_gather([t[0] for t in qkv], group, dim=2)
            parts = []
            for j, (qj, kj, vj, pj) in enumerate(zip(
                    tp.broadcast(q_all, group), tp.broadcast(k_all, group),
                    tp.broadcast(v_all, group),
                    tp.broadcast(positions, group))):
                write_at(kc[j], kj, ats[j], j * S)
                write_at(vc[j], vj, ats[j], j * S)
                if window:
                    write_at(kp[j], pj, ats[j], j * S)
                parts.append(decode_partials(qj, kc[j], vc[j],
                                             mask_of(j, qj.device, j * S)))
            o = combine_partials_tp(parts, group)    # (b, KVH, G, dh)
            o = o.reshape(b, 1, cfg.num_heads, cfg.head_dim).to(x.dtype)
            outs = [oj[:, :, j * Hl:(j + 1) * Hl]
                    for j, oj in enumerate(tp.broadcast(o, group))]
        else:                             # a whole cache
            write_copies(kc, k_all, at)
            write_copies(vc, v_all, at)
            for j, (q, _, _) in enumerate(qkv):
                lo, hi = kv[j]
                outs.append(decode_attention(q, kc[j][:, :, lo:hi],
                                             vc[j][:, :, lo:hi],
                                             mask_of(j, q.device)))
    parts = [o.reshape(b, 1, Hl * cfg.head_dim) @ p["wo"][j]
             for j, o in enumerate(outs)]
    return tp.all_reduce(parts, group)


def write_ring(cache, ks, vs, positions, cfg, group):
    """A local layer's prefill K / V (the shards' ``qkv_project_tp``
    keys ``ks`` and values ``vs``) written into its ring of ``W`` slots
    (``cache`` "k", "v", "k_pos": ``Split``s) at slots ``i % W`` of its
    last min(s, W) positions, as ``layer_prefill`` writes the whole
    ring: every KV head all-gathered, the ring built once and each shard
    given its block of slots (the sequence over model), or each copy
    written (a whole ring; ``_ring_split``)."""
    kc, vc, kp = cache["k"], cache["v"], _ring_split(cache)
    s = positions.shape[0]
    W = kc[0].shape[1] * (group.size if kc.dim == 1 else 1)
    t = min(s, W)
    slots = torch.arange(s - t, s, device=positions.device) % W
    pos_rows = positions[-t:].to(torch.int32)[None].expand(
        kc[0].shape[0], t)
    rings = {"k": (kc, owned_kv(ks, cfg, group)),
             "v": (vc, owned_kv(vs, cfg, group)), "k_pos": (kp, pos_rows)}
    for c, rows in rings.values():
        ring = torch.full((rows.shape[0], W) + tuple(rows.shape[2:]),
                          -1 if c is kp else 0, dtype=c[0].dtype,
                          device=rows.device)
        ring.index_copy_(1, slots, rows[:, -t:].to(ring.dtype))
        if c.dim is None:                 # each copy takes the whole ring
            for blk in {id(b): b for b in c}.values():
                blk.copy_(ring)
            continue
        n = c[0].shape[1]
        for j, blk in enumerate(c):
            blk.copy_(ring[:, j * n:(j + 1) * n])


# ------------------------------------------ cross attention, split ----

def cross_kv_tp(p, enc_out, cfg, group):
    """``cross_kv`` on each shard of a model group: [(k_j, v_j)], shard
    j's KV heads (those its query heads read, ``head_split``) of the
    encoder states, on its device."""
    _, kv = head_split(cfg, group.size)
    split = kv_heads_split(cfg, p, group.size)
    wk = _kv_weight(p["wk"], cfg, kv, group, split)
    wv = _kv_weight(p["wv"], cfg, kv, group, split)
    out = []
    for j, ej in enumerate(tp.broadcast(enc_out, group)):
        n = kv[j][1] - kv[j][0]
        out.append((_split_heads(ej @ wk[j], n, cfg.head_dim),
                    _split_heads(ej @ wv[j], n, cfg.head_dim)))
    return out


def write_cross(cache, kv, cfg, group):
    """The prefill's cross K / V (``cross_kv_tp``) into the cross cache
    (``ck`` / ``cv`` ``Split``s, by KV heads: ``tensor_parallel.
    shardings``): each shard its heads; a cache kept whole takes every
    head, all-gathered."""
    for i, name in ((0, "ck"), (1, "cv")):
        c = cache[name]
        if c.dim is not None:
            for j, t in enumerate(kv):
                c[j].copy_(t[i])
            continue
        whole = owned_kv([t[i] for t in kv], cfg, group)
        for blk in {id(b): b for b in c}.values():
            blk.copy_(whole.to(blk.device))


def cross_attention_apply_tp(p, x, enc_out, cfg, group, *, kv=None):
    """``cross_attention_apply`` split over a model group: each shard its
    query heads over its KV heads of the encoder states (on the card one
    non-causal flash launch a shard), ``wo``'s rows of them giving a
    partial that is all-reduced.  ``kv``: the shards' ``cross_kv_tp``
    when the caller has them (the prefill)."""
    Hl, _ = head_split(cfg, group.size)
    kv = kv or cross_kv_tp(p, enc_out, cfg, group)
    parts = []
    for j, (xj, (k, v)) in enumerate(zip(tp.broadcast(x, group), kv)):
        q = _split_heads(xj @ p["wq"][j], Hl, cfg.head_dim)
        parts.append(_cross_attend(q, k, v, cfg).flatten(-2) @ p["wo"][j])
    return tp.all_reduce(parts, group)


def cross_attention_decode_tp(p, x, ck, cv, cfg, group):
    """``cross_attention_decode`` split over a model group: each shard
    its query heads over its KV heads of the cross cache (its block by
    heads, or its heads' slice of a whole copy), ``wo``'s partials
    all-reduced."""
    b = x.shape[0]
    Hl, kv = head_split(cfg, group.size)
    parts = []
    for j, xj in enumerate(tp.broadcast(x, group)):
        q = _split_heads(xj @ p["wq"][j], Hl, cfg.head_dim)
        k, v = ck[j], cv[j]
        if ck.dim is None:
            k, v = k[:, :, kv[j][0]:kv[j][1]], v[:, :, kv[j][0]:kv[j][1]]
        valid = torch.ones(k.shape[:2], dtype=torch.bool, device=q.device)
        out = decode_attention(q, k, v, valid)
        parts.append(out.reshape(b, 1, Hl * cfg.head_dim) @ p["wo"][j])
    return tp.all_reduce(parts, group)
