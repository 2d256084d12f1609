"""ICQ-KV: the paper's interleaved two-step machinery applied to the
decode-time KV cache (twin of ``repro.quant.kv_cache``).

  - psi (the high-variance subspace) -> the d_fast key dimensions of
    largest per-dimension key variance, per kv-head, from the prefill
    keys; a per-head permutation gathers them to the front once, when
    the cache is written, so the crude scorer reads a contiguous
    (S, d_fast) slab;
  - the crude comparison (eq. 2) -> q_fast . k_fast over all S cached
    keys;
  - the refinement (eq. 1) -> the ``top_c`` survivors by crude score
    are gathered, dequantized from their int8 full-width codes and
    scored exactly; softmax and the value mix run over them only.

Plain PyTorch on both devices (no Pallas kernel in the reference
either).  The top-c is the first ``top_c`` of a stable descending sort,
so equal crude scores keep the lowest position first, as ``lax.top_k``
does.  ``icq_kv_append`` writes in place at ``pos`` (the reference
donates the cache), and ``pos`` may be a 0-d device tensor, so a decode
step does not synchronise the host.  The cross-shard combine
(``combine_attention_partials``) is the reference's collective in the
single-controller form: each shard's partials are gathered to the
mesh's lead device and merged there.

A decode step reads S * d_fast crude values and top_c int8 K and V rows
per kv-head instead of S full-width K and V rows.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.index.base import resolve_device
from repro_torch.models.nn import as_dtype
from repro_torch.quant.int8 import dequantize_int8, quantize_int8

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class ICQKVConfig:
    d_fast: int = 64             # |psi| dims per head used for crude scores
    top_c_frac: float = 1 / 16   # survivor fraction of the cache length
    min_top_c: int = 128


def _variance_perm(k):
    """Per-head permutation sorting head_dim by descending key variance
    (over n, pooled over batch and positions; stable, so equal variances
    keep their order).  k: (b, s, kvh, dh) -> perm (kvh, dh) int32."""
    var = torch.var(k.float(), dim=(0, 1), correction=0)        # (kvh, dh)
    return torch.argsort(-var, dim=-1, stable=True).to(torch.int32)


def _apply_perm(x, perm):
    """Gather head_dim by per-head perm.  x: (b,s,kvh,dh), perm: (kvh,dh)."""
    return torch.gather(x, -1, perm.long()[None, None].expand(x.shape))


def _top_c(scores, top_c: int):
    """Indices of the ``top_c`` largest along the last axis, equal
    scores lowest index first (``lax.top_k``'s order)."""
    return torch.sort(scores, dim=-1, descending=True,
                      stable=True).indices[..., :top_c]


def init_icq_kv_cache(cfg_kv: ICQKVConfig, batch: int, max_len: int,
                      kvh: int, dh: int, dtype=torch.bfloat16,
                      device=None) -> Dict:
    dev = resolve_device(device)
    z = dict(device=dev)
    return {
        "perm": torch.arange(dh, dtype=torch.int32, **z)[None].repeat(kvh, 1),
        "k_fast": torch.zeros((batch, max_len, kvh, cfg_kv.d_fast),
                              dtype=as_dtype(dtype), **z),
        "kq": torch.zeros((batch, max_len, kvh, dh), dtype=torch.int8, **z),
        "ks": torch.zeros((batch, max_len, kvh, 1), **z),
        "vq": torch.zeros((batch, max_len, kvh, dh), dtype=torch.int8, **z),
        "vs": torch.zeros((batch, max_len, kvh, 1), **z),
        "len": torch.zeros((), dtype=torch.int32, **z),
    }


def build_icq_kv_cache(cfg_kv: ICQKVConfig, k, v, max_len: int,
                       dtype=torch.bfloat16) -> Dict:
    """Quantize prefill K/V into an ICQ-KV cache on k's device.
    k/v: (b,s,kvh,dh)."""
    b, s, kvh, dh = k.shape
    perm = _variance_perm(k)
    k_rot = _apply_perm(k, perm)
    kq, ks = quantize_int8(k_rot)
    vq, vs = quantize_int8(v)
    k_fast = k_rot[..., : cfg_kv.d_fast].to(as_dtype(dtype))

    def pad(x):
        return torch.nn.functional.pad(x, (0, 0) * (x.ndim - 2)
                                       + (0, max_len - s))

    return {"perm": perm, "k_fast": pad(k_fast),
            "kq": pad(kq), "ks": pad(ks), "vq": pad(vq), "vs": pad(vs),
            "len": torch.tensor(s, dtype=torch.int32, device=k.device)}


def icq_kv_append(cache: Dict, cfg_kv: ICQKVConfig, k_new, v_new,
                  pos) -> Dict:
    """Append one decode step's K/V at ``pos``, in place.
    k_new/v_new: (b,1,kvh,dh).  Returns the cache with its new ``len``."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=k_new.device)
    at = pos.long().reshape(1)
    for name, val in quantized_rows(cache["perm"], cfg_kv, k_new,
                                    v_new).items():
        cache[name].index_copy_(1, at, val.to(cache[name].dtype))
    return dict(cache, len=torch.maximum(cache["len"], pos + 1))


def quantized_rows(perm, cfg_kv: ICQKVConfig, k_new, v_new) -> Dict:
    """The cache rows of new K / V (b, t, kvh, dh) under the per-head
    ``perm``: the crude slab and the int8 codes with their scales."""
    k_rot = _apply_perm(k_new, perm)
    kq, ks = quantize_int8(k_rot)
    vq, vs = quantize_int8(v_new)
    return {"k_fast": k_rot[..., : cfg_kv.d_fast], "kq": kq, "ks": ks,
            "vq": vq, "vs": vs}


def _rotated(q, cache: Dict, cfg_kv: ICQKVConfig):
    """(q by kv head, permuted: (b,kvh,g,dh); its d_fast crude dims)."""
    b, _, h, dh = q.shape
    kvh = cache["perm"].shape[0]
    qg = q[:, 0].reshape(b, kvh, h // kvh, dh)           # head h -> kv h//g
    q_rot = torch.gather(qg, -1, cache["perm"].long()[None, :, None, :]
                         .expand(qg.shape))
    return q_rot, q_rot[..., : cfg_kv.d_fast]


def _crude(q_fast, cache: Dict, valid):
    """Phase 1: crude scores (b,kvh,g,S) over the cache's S positions,
    invalid ones at NEG_INF."""
    scale = cache["kq"].shape[-1] ** -0.5
    crude = torch.einsum("bkgf,bskf->bkgs", q_fast.float(),
                         cache["k_fast"].float()) * scale
    return torch.where(valid[:, None, None, :], crude, NEG_INF)


def _refine(q_rot, cache: Dict, cand, cand_valid):
    """Phase 2: the survivors at ``cand`` (b,kvh,g,c) positions of the
    cache gathered, dequantized and scored exactly: (scores f32 with
    those not ``cand_valid`` at NEG_INF, V rows (b,kvh,g,c,dh))."""
    b, kvh, g, dh = q_rot.shape

    def gather(buf):                                     # (b,S,kvh,x)
        bf = buf.transpose(1, 2)[:, :, None]             # (b,kvh,1,S,x)
        bf = bf.expand(b, kvh, g, *bf.shape[3:])
        return torch.gather(bf, 3, cand[..., None].expand(
            *cand.shape, bf.shape[-1]))                  # (b,kvh,g,c,x)

    k_sel = dequantize_int8(gather(cache["kq"]), gather(cache["ks"]))
    v_sel = dequantize_int8(gather(cache["vq"]), gather(cache["vs"]))
    s = torch.einsum("bkgd,bkgcd->bkgc", q_rot.float(), k_sel) * dh ** -0.5
    return torch.where(cand_valid, s, NEG_INF), v_sel


def _crude_mag(q_fast, cache: Dict):
    """A row's largest sum of |products|: max over positions of sum_f
    |q_f k_f|, scaled as the crude scores (b,kvh,g), the unit that bounds
    a score's rounding (a cached bf16 ``k_fast`` value one rounding step
    away moves a score by at most 2^-7 of it)."""
    return torch.einsum("bkgf,bskf->bkgs", q_fast.float().abs(),
                        cache["k_fast"].float().abs()).amax(dim=-1) \
        * cache["kq"].shape[-1] ** -0.5


def _crude_gap(crude, mag, top_c: int):
    """The crude score at rank ``top_c`` less the next one, over ``mag``
    (``_crude_mag``; inf when no position is left out): how far the
    top-c set is from a tie."""
    vals = torch.sort(crude, dim=-1, descending=True, stable=True).values
    if vals.shape[-1] <= top_c:
        return torch.full(vals.shape[:-1], float("inf"), device=vals.device)
    return (vals[..., top_c - 1] - vals[..., top_c]) / torch.clamp(mag,
                                                                   1e-30)


def _survivors(q, cache: Dict, cfg_kv: ICQKVConfig, valid, top_c: int,
               record=None):
    """Phases 1 and 2 up to the masked exact scores: (scores (b,kvh,g,c)
    f32 with invalid survivors at NEG_INF, dequantized V rows
    (b,kvh,g,c,dh)).  ``record``: a list that takes (the survivors'
    positions, ``_crude_gap``, the crude scores (b,kvh,g,S),
    ``_crude_mag``)."""
    q_rot, q_fast = _rotated(q, cache, cfg_kv)
    crude = _crude(q_fast, cache, valid)
    cand = _top_c(crude, top_c)                          # (b,kvh,g,c)
    if record is not None:
        mag = _crude_mag(q_fast, cache)
        record.append((cand, _crude_gap(crude, mag, top_c), crude, mag))
    cand_valid = torch.gather(valid[:, None, None, :].expand(crude.shape), 3,
                              cand)
    return _refine(q_rot, cache, cand, cand_valid)


def icq_kv_decode_attention(q, cache: Dict, cfg_kv: ICQKVConfig, pos,
                            top_c: int, *, record=None):
    """Two-step decode attention.  q: (b, 1, H, dh) -> (b, 1, H, dh).

    Phase 1: crude scores over all S from the d_fast high-variance dims.
    Phase 2: exact scores + softmax over the top_c survivors.
    ``record``: a list that takes the survivors' positions, the crude
    gap, the crude scores and the row's magnitude (``_survivors``).
    """
    b, _, h, dh = q.shape
    S = cache["kq"].shape[1]
    valid = (torch.arange(S, device=q.device) <= pos)[None, :]   # (1,S)
    s, v_sel = _survivors(q, cache, cfg_kv, valid, top_c, record)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgc,bkgcd->bkgd", p, v_sel)     # (b,kvh,g,dh)
    return out.reshape(b, 1, h, dh).to(q.dtype)


def reference_decode_attention(q, k, v, pos):
    """Oracle: exact attention over the raw (unquantized) cache."""
    b, _, h, dh = q.shape
    kvh = k.shape[2]
    S = k.shape[1]
    qg = q.reshape(b, kvh, h // kvh, dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) * dh ** -0.5
    s = torch.where(torch.arange(S, device=q.device)[None, None, None, :]
                    <= pos, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return out.reshape(b, 1, h, dh).to(q.dtype)


# ------------------------------------------------------- context-parallel --

def icq_kv_attention_partial(q, cache: Dict, cfg_kv: ICQKVConfig, pos,
                             top_c_local: int, *, shard_offset=0):
    """Shard-local two-step attention over a position-sharded cache
    slice: crude-first over its own S_local positions, the local
    ``top_c_local`` survivors refined, and the *unnormalized* softmax
    partials (m, l, o) returned for a combine across shards."""
    S_local = cache["kq"].shape[1]
    local_pos = shard_offset + torch.arange(S_local, device=q.device)
    valid = (local_pos <= pos)[None, :]                  # (1,S_local)
    s, v_sel = _survivors(q, cache, cfg_kv, valid, top_c_local)
    m = s.amax(dim=-1)                                   # (b,kvh,g)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bkgc,bkgcd->bkgd", p, v_sel)       # unnormalized
    return m, l, o


def combine_partials_local(ms, ls, os_):
    """Merge stacked per-shard (m, l, o) partials (leading shard axis)."""
    m_g = ms.amax(dim=0)
    corr = torch.exp(ms - m_g[None])
    l_g = torch.sum(ls * corr, dim=0)
    o_g = torch.sum(os_ * corr[..., None], dim=0)
    return o_g / torch.clamp(l_g, min=1e-30)[..., None]


def combine_attention_partials(m, l, o, axis_name: str = "model", *,
                               mesh=None):
    """Merge per-shard (m, l, o) softmax partials across the shards of
    ``axis_name``: ``m``, ``l``, ``o`` one tensor per shard, in shard
    order, each on its shard's device.  The reference's pmax / psum over
    the axis become a gather of every shard's partials to the lead
    device (``mesh.lead``, shard 0's device without a mesh) and the
    local merge there, ``combine_partials_local`` of the stacked
    partials.  Returns o / l on the lead device."""
    if not len(m) == len(l) == len(o) or not len(m):
        raise ValueError(f"one (m, l, o) a shard of {axis_name!r}: got "
                         f"{len(m)}, {len(l)}, {len(o)}")
    dev = mesh.lead if mesh is not None else m[0].device
    return combine_partials_local(*(torch.stack([t.to(dev) for t in part])
                                    for part in (m, l, o)))


def icq_kv_decode_attention_tp(q, blocks, cfg_kv: ICQKVConfig, pos,
                               top_c: int, group, *, record=None):
    """``icq_kv_decode_attention`` over a cache split by positions over a
    model group: ``blocks`` each shard's cache (its positions of every
    buffer, the whole ``perm``), q (b, 1, H, dh) on the first device.
    It computes the unsplit result: the *global* top-c over all S.

    1. Each shard scores its positions crudely and keeps its local top-c
       (all of them where it holds fewer), with their global positions.
    2. The union is all-gathered on the first device in shard order and
       merged by a stable descending sort: equal scores keep the lowest
       position first, ``_top_c``'s order (``lax.top_k``'s).  A global
       survivor ranks below at most top_c - 1 others of its shard, so
       the global top-c lies inside the union: the merge is exact.
    3. The survivors are broadcast; each shard refines those it owns
       (the others masked), and the softmax partials are merged by
       ``combine_attention_partials``.

    (``icq_kv_attention_partial`` keeps ``top_c_local`` survivors a
    shard, another result, which no entry point of the reference
    calls.)  ``record``: as ``icq_kv_decode_attention``'s, the gap
    None: the scores are every shard's crude scores of its positions,
    concatenated on the first device (the global crude scores the merge
    ranks), the magnitude the largest of the shards'.  Returns (b, 1, H,
    dh) on the first device."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.models.attention import combine_partials_tp
    b, _, h, dh = q.shape
    qs, poss = tp.broadcast(q, group), tp.broadcast(pos, group)
    rot, vals, where, crudes, mags = [], [], [], [], []
    for j, (qj, cj, pj) in enumerate(zip(qs, blocks, poss)):
        n = cj["kq"].shape[1]
        at = j * n + torch.arange(n, device=qj.device)
        q_rot, q_fast = _rotated(qj, cj, cfg_kv)
        crude = _crude(q_fast, cj, (at <= pj)[None, :])
        if record is not None:
            crudes.append(crude.to(group.lead))
            mags.append(_crude_mag(q_fast, cj).to(group.lead))
        top = torch.sort(crude, dim=-1, descending=True, stable=True)
        c = min(top_c, n)
        rot.append(q_rot)
        vals.append(top.values[..., :c])
        where.append((top.indices[..., :c] + j * n).to(torch.int32))
    vals = tp.all_gather(vals, group, dim=-1)
    where = tp.all_gather(where, group, dim=-1)
    order = torch.sort(vals, dim=-1, descending=True,
                       stable=True).indices[..., :top_c]
    cand = torch.gather(where, -1, order).long()         # (b,kvh,g,c)
    if record is not None:
        record.append((cand, None, torch.cat(crudes, -1),
                       torch.stack(mags).amax(0)))
    parts = []
    for j, (q_rot, cj, pj, cd) in enumerate(zip(
            rot, blocks, poss, tp.broadcast(cand, group))):
        n = cj["kq"].shape[1]
        local = cd - j * n
        mine = (local >= 0) & (local < n) & (cd <= pj)
        s, v_sel = _refine(q_rot, cj, torch.clamp(local, 0, n - 1), mine)
        m = s.amax(dim=-1)
        e = torch.exp(s - m[..., None])
        parts.append((m, e.sum(dim=-1),
                      torch.einsum("bkgc,bkgcd->bkgd", e, v_sel)))
    o = combine_partials_tp(parts, group)                # (b,kvh,g,dh)
    return o.reshape(b, 1, h, dh).to(q.dtype)
