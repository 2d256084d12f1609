"""Multi-head Latent Attention (twin of ``repro.models.mla``,
DeepSeek-V2).

Prefill: queries through a low-rank bottleneck (q_lora), keys and values
decompressed per head from a shared kv_lora latent plus a head-shared
rope key.  Decode: the *absorbed* form, W_uk folded into the query and
W_uv into the output, so the cache is the (kv_lora + rope)-wide latent
per token, written in place.

Which attention runs where:

* prefill with s <= ``attn_chunk``: K = [k_nope, k_rope] and V are
  materialized per head and ``full_attention`` runs, as in the
  reference; on the card that is one flash launch at (dqk, dv) = (nope
  + rope, v), e.g. (192, 128).
* prefill with s > ``attn_chunk``: the reference decompresses one KV
  block at a time inside an online softmax (``mla_chunked_attention``),
  so only (b, chunk, h, d) of K ever exists.  On the CPU the port twins
  it block for block.  On the card (``mla_blockwise_attention``, the
  autograd Function ``_MLABlockwise``) it keeps the reference's block
  structure: for each query block, each key block at or before it is
  decompressed from the latent and the flash kernel runs once over it
  with its rows' log-sum-exp (the diagonal block causal, the earlier
  ones not, the later ones skipped), and the partials merge in f32 by
  their log-sum-exps; nothing of (b, s, h, ·) exists in K or V, only one
  block's.  s = 32 blocks take 528 launches a layer.  Under autograd
  the forward keeps only the merged output O and log-sum-exp L; the
  backward re-decompresses each pair's key block (the reference's
  ``jax.checkpoint``) and runs the flash backward kernels once a pair
  with O, dO and L of the query block: P = exp(S - L) and D =
  rowsum(dO O) are then those of the whole softmax, so the pairs'
  gradients sum to the whole attention's, and no gradient of the
  log-sum-exp is needed.  dK and dV of the pair go back through the
  decompression at once (d latent, dW_uk, dW_uv, d k_rope), into f32
  buffers the size of the latent and the weights.  A meta tensor (the
  dry run) takes the card's branches, its backward the flash backward's
  meta op.
* decode: plain PyTorch on both devices, as the reference's is not a
  kernel.

Split over a mesh's ``model`` axis (``*_tp``): the query bottleneck and
the latent once on the group's first device, each shard its heads'
``w_uq`` / ``w_uk`` / ``w_uv`` columns (head-aligned, checked) by the
branch above, ``wo``'s rows of them a partial, all-reduced; the absorbed
decode over a latent cache split by sequence all-gathers the absorbed
queries and merges each shard's softmax partials.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels import ops
from repro_torch.models import nn
from repro_torch.models.attention import NEG_INF, full_attention, on_card


def mla_init(generator: torch.Generator, cfg, dtype=torch.float32):
    d = cfg.d_model
    h = cfg.num_heads
    qk_nope, qk_rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    v_dim = cfg.v_head_dim
    p = {
        "w_dkv": nn.dense_init(generator, d, cfg.kv_lora_rank + qk_rope,
                               dtype),
        "kv_norm": nn.rmsnorm_init(cfg.kv_lora_rank, dtype,
                                   generator.device),
        "w_uk": nn.dense_init(generator, cfg.kv_lora_rank, h * qk_nope,
                              dtype),
        "w_uv": nn.dense_init(generator, cfg.kv_lora_rank, h * v_dim, dtype),
        "wo": nn.dense_init(generator, h * v_dim, d, dtype),
    }
    if cfg.q_lora_rank:
        p["w_dq"] = nn.dense_init(generator, d, cfg.q_lora_rank, dtype)
        p["q_norm"] = nn.rmsnorm_init(cfg.q_lora_rank, dtype,
                                      generator.device)
        p["w_uq"] = nn.dense_init(generator, cfg.q_lora_rank,
                                  h * (qk_nope + qk_rope), dtype)
    else:
        p["w_q"] = nn.dense_init(generator, d, h * (qk_nope + qk_rope),
                                 dtype)
    return p


def _q_rank(p, x, cfg):
    """The rows the query heads project: the normed q_lora bottleneck,
    or x itself without one."""
    if cfg.q_lora_rank:
        return nn.rmsnorm(x @ p["w_dq"], p["q_norm"], cfg.norm_eps)
    return x


def _heads_q(q, positions, cfg):
    """(q_nope, q_rope) of projected queries (..., h (nope + rope)), the
    rope half rotated."""
    qk_nope, qk_rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = q.reshape(*q.shape[:-1], -1, qk_nope + qk_rope)
    q_nope, q_rope = q[..., :qk_nope], q[..., qk_nope:]
    q_rope = nn.apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _queries(p, x, cfg, positions):
    w = p["w_uq"] if cfg.q_lora_rank else p["w_q"]
    return _heads_q(_q_rank(p, x, cfg) @ w, positions, cfg)


def _latent(p, x, cfg, positions):
    ckv = x @ p["w_dkv"]                                 # (b,s,lora+rope)
    latent = nn.rmsnorm(ckv[..., : cfg.kv_lora_rank], p["kv_norm"],
                        cfg.norm_eps)
    k_rope = ckv[..., cfg.kv_lora_rank:][..., None, :]   # (b,s,1,rope)
    k_rope = nn.apply_rope(k_rope, positions, cfg.rope_theta)[..., 0, :]
    return latent, k_rope


def _materialize(p, q_nope, q_rope, latent, k_rope, cfg):
    """q, k (b, s, h, nope + rope) and v (b, s, h, v) of the whole
    sequence, each contiguous (what the flash kernel reads)."""
    b, s, h, qk_nope = q_nope.shape
    qk_rope = q_rope.shape[-1]
    k_nope = (latent @ p["w_uk"]).reshape(b, s, h, qk_nope)
    v = (latent @ p["w_uv"]).reshape(b, s, h, cfg.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, qk_rope)],
                  dim=-1)
    return q, k, v


def mla_attention_apply(p, x, cfg, positions):
    """Full-sequence causal MLA (prefill and training).  Short
    sequences take the dense path; long ones the lazy decompression:
    ``mla_chunked_attention`` on the CPU, ``mla_blockwise_attention``
    on the card, under autograd too (module docstring)."""
    q_nope, q_rope = _queries(p, x, cfg, positions)
    latent, k_rope = _latent(p, x, cfg, positions)
    out = _attend(p, q_nope, q_rope, latent, k_rope, cfg)
    return out.flatten(-2) @ p["wo"]


def _attend(p, q_nope, q_rope, latent, k_rope, cfg):
    """Causal MLA over q's heads (``p``'s ``w_uk`` / ``w_uv`` columns of
    them): (b, s, h, dv), by the branch the module docstring names."""
    if q_nope.shape[1] <= cfg.attn_chunk:
        q, k, v = _materialize(p, q_nope, q_rope, latent, k_rope, cfg)
        return full_attention(q, k, v, causal=True)
    if on_card(q_nope):
        return mla_blockwise_attention(p, q_nope, q_rope, latent, k_rope,
                                       cfg)
    return mla_chunked_attention(p, q_nope, q_rope, latent, k_rope, cfg)


def _block(s: int, chunk: int) -> int:
    """The reference's block: ``attn_chunk`` reduced until it divides s."""
    c = min(chunk, s)
    while s % c:
        c -= 1
    return c


def mla_blockwise_attention(p, q_nope, q_rope, latent, k_rope_seq, cfg):
    """Causal MLA over (query block, key block <= it) pairs with the key
    block decompressed from the latent per pair (``_MLABlockwise``:
    differentiable, the backward once a pair too).  Runs on either
    device (on the CPU through the flash kernel's plain versions);
    returns (b, s, h, dv) in the latent's type."""
    return _MLABlockwise.apply(q_nope, q_rope, latent, k_rope_seq,
                               p["w_uk"], p["w_uv"],
                               _block(q_nope.shape[1], cfg.attn_chunk))


def _key_block(lat_blk, kr_blk, w_uk, w_uv, h, dn):
    """One key block's K (b, c, h, dn + dr) and V (b, c, h, dv),
    decompressed from its latent rows (b, c, lora) and rope keys (b, c,
    dr), each contiguous."""
    b, c, _ = lat_blk.shape
    dr = kr_blk.shape[-1]
    k_nope = (lat_blk @ w_uk).reshape(b, c, h, dn)
    v_blk = (lat_blk @ w_uv).reshape(b, c, h, w_uv.shape[1] // h)
    k_blk = torch.cat([k_nope, kr_blk[:, :, None, :].expand(b, c, h, dr)],
                      dim=-1)
    return k_blk, v_blk


class _MLABlockwise(torch.autograd.Function):
    """Block-wise causal MLA (module docstring): inputs q_nope, q_rope
    (b, s, h, ·), latent (b, s, lora), k_rope_seq (b, s, dr), w_uk (lora,
    h dn), w_uv (lora, h dv) and the block c (dividing s).

    Forward: for each query block, the flash call with its rows'
    log-sum-exp on each key block <= it (the diagonal causal: both
    blocks start at qi c, so the kernel's top-left mask is the causal
    one), merged into an f32 accumulator as ``lse = logaddexp(lse_run,
    lse_b)``, ``acc = exp(lse_run - lse) acc + exp(lse_b - lse) o_b``;
    saves the inputs, the merged O (b, s, h, dv) in the latent's type
    and L (b, h, s) f32.

    Backward, over the same pairs: the key block decompressed again, the
    flash backward with the query block's O, dO and L (exact per pair:
    P and D are the whole softmax's), dq summed over ascending key
    blocks in f32, dK and dV carried back through the decompression
    into f32 buffers at once: d latent += dK_nope W_uk^T + dV W_uv^T,
    dW_uk += latent^T dK_nope, dW_uv += latent^T dV, d k_rope += dK_rope
    summed over heads."""

    @staticmethod
    def forward(ctx, q_nope, q_rope, latent, k_rope_seq, w_uk, w_uv, c):
        b, s, h, dn = q_nope.shape
        dv = w_uv.shape[1] // h
        out = torch.empty((b, s, h, dv), dtype=latent.dtype,
                          device=latent.device)
        lse_out = torch.empty((b, h, s), dtype=torch.float32,
                              device=latent.device)
        for qi in range(s // c):
            rows = slice(qi * c, (qi + 1) * c)
            q_blk = torch.cat([q_nope[:, rows], q_rope[:, rows]], dim=-1)
            acc = lse_run = None
            for ki in range(qi + 1):
                keys = slice(ki * c, (ki + 1) * c)
                k_blk, v_blk = _key_block(latent[:, keys],
                                          k_rope_seq[:, keys], w_uk, w_uv,
                                          h, dn)
                o_b, lse_b = ops.flash_attention(q_blk, k_blk, v_blk,
                                                 causal=ki == qi,
                                                 with_lse=True)
                del k_blk, v_blk
                lse_b = lse_b.transpose(1, 2)[..., None]   # (b,c,h,1)
                if acc is None:
                    acc, lse_run = o_b.float(), lse_b
                    continue
                lse = torch.logaddexp(lse_run, lse_b)
                acc.mul_(torch.exp(lse_run - lse)).add_(
                    torch.exp(lse_b - lse) * o_b)
                lse_run = lse
            out[:, rows] = acc.to(out.dtype)
            lse_out[:, :, rows] = lse_run[..., 0].transpose(1, 2)
        ctx.save_for_backward(q_nope, q_rope, latent, k_rope_seq, w_uk, w_uv,
                              out, lse_out)
        ctx.c = c
        return out

    @staticmethod
    def backward(ctx, dout):
        q_nope, q_rope, latent, k_rope_seq, w_uk, w_uv, out, lse = \
            ctx.saved_tensors
        c = ctx.c
        b, s, h, dn = q_nope.shape
        dv = out.shape[-1]
        lora = latent.shape[-1]
        f32 = dict(dtype=torch.float32, device=latent.device)
        d_lat = torch.zeros(latent.shape, **f32)
        d_kr = torch.zeros(k_rope_seq.shape, **f32)
        d_wuk = torch.zeros(w_uk.shape, **f32)
        d_wuv = torch.zeros(w_uv.shape, **f32)
        d_qn = torch.empty(q_nope.shape, dtype=q_nope.dtype,
                           device=q_nope.device)
        d_qr = torch.empty(q_rope.shape, dtype=q_rope.dtype,
                           device=q_rope.device)
        for qi in range(s // c):
            rows = slice(qi * c, (qi + 1) * c)
            q_blk = torch.cat([q_nope[:, rows], q_rope[:, rows]], dim=-1)
            o_blk = out[:, rows].contiguous()
            do_blk = dout[:, rows].contiguous()
            l_blk = lse[:, :, rows].contiguous()
            dq_acc = torch.zeros(q_blk.shape, **f32)
            for ki in range(qi + 1):
                keys = slice(ki * c, (ki + 1) * c)
                lat_blk = latent[:, keys]
                k_blk, v_blk = _key_block(lat_blk, k_rope_seq[:, keys], w_uk,
                                          w_uv, h, dn)
                dq, dk, dvb = ops.flash_attention_bwd(
                    q_blk, k_blk, v_blk, o_blk, do_blk, l_blk,
                    causal=ki == qi)
                del k_blk, v_blk
                dq_acc += dq
                dk_nope = dk[..., :dn].reshape(b * c, h * dn)
                dvb = dvb.reshape(b * c, h * dv)
                lat2 = lat_blk.reshape(b * c, lora)
                d_lat[:, keys] += (dk_nope @ w_uk.T).reshape(b, c, lora)
                d_lat[:, keys] += (dvb @ w_uv.T).reshape(b, c, lora)
                d_wuk += lat2.T @ dk_nope
                d_wuv += lat2.T @ dvb
                d_kr[:, keys] += dk[..., dn:].float().sum(dim=2)
                del dq, dk, dvb, dk_nope
            d_qn[:, rows] = dq_acc[..., :dn]
            d_qr[:, rows] = dq_acc[..., dn:]
        return (d_qn, d_qr, d_lat.to(latent.dtype),
                d_kr.to(k_rope_seq.dtype), d_wuk.to(w_uk.dtype),
                d_wuv.to(w_uv.dtype), None)


def mla_chunked_attention(p, q_nope, q_rope, latent, k_rope_seq, cfg):
    """Online-softmax causal MLA with per-block latent decompression:
    for each query block, over key blocks in order, the nope and rope
    scores are two f32 products summed, then the reference's masked
    online softmax (CPU path; module docstring)."""
    b, s, h, dn = q_nope.shape
    dr = q_rope.shape[-1]
    dv = cfg.v_head_dim
    scale = (dn + dr) ** -0.5
    c = _block(s, cfg.attn_chunk)
    n = s // c
    dev = q_nope.device
    outs = []
    for qi in range(n):
        qn_blk = q_nope[:, qi * c:(qi + 1) * c].float()
        qr_blk = q_rope[:, qi * c:(qi + 1) * c].float()
        q_pos = qi * c + torch.arange(c, device=dev)
        m = torch.full((b, h, c), NEG_INF, device=dev)
        l = torch.zeros((b, h, c), device=dev)
        acc = torch.zeros((b, h, c, dv), device=dev)
        for ki in range(n):
            lat_blk = latent[:, ki * c:(ki + 1) * c]       # (b,c,lora)
            k_nope = (lat_blk @ p["w_uk"]).reshape(b, c, h, dn)
            v_blk = (lat_blk @ p["w_uv"]).reshape(b, c, h, dv)
            kr_blk = k_rope_seq[:, ki * c:(ki + 1) * c].float()
            k_pos = ki * c + torch.arange(c, device=dev)
            sc = (torch.einsum("bqhd,bkhd->bhqk", qn_blk, k_nope.float())
                  + torch.einsum("bqhr,bkr->bhqk", qr_blk, kr_blk)) * scale
            mask = q_pos[:, None] >= k_pos[None, :]
            sc = torch.where(mask, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            pr = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + pr.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", pr.to(v_blk.dtype), v_blk).float()
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]  # (b,h,c,dv)
        outs.append(out.transpose(1, 2).to(latent.dtype))
    return torch.cat(outs, dim=1)                        # (b,s,h,dv)


def mla_prefill_latent(p, x, cfg, positions):
    """Latent + rope-key streams to seed the decode cache."""
    return _latent(p, x, cfg, positions)


def mla_decode_attention(p, x, latent_cache, k_rope_cache, cfg, positions,
                         length_mask):
    """Absorbed decode: scores in latent space, cache = latent + rope
    key.  latent_cache: (b,S,kv_lora); k_rope_cache: (b,S,rope); x:
    (b,1,d); length_mask: (b or 1, S) bool."""
    b = x.shape[0]
    h = cfg.num_heads
    qk_nope, qk_rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    v_dim, lora = cfg.v_head_dim, cfg.kv_lora_rank
    q_nope, q_rope = _queries(p, x, cfg, positions)      # (b,1,h,·)
    # absorb W_uk: q_lat[b,h,lora] = q_nope . W_uk (head slice)
    w_uk = p["w_uk"].reshape(lora, h, qk_nope)
    q_lat = torch.einsum("bhd,lhd->bhl", q_nope[:, 0], w_uk)
    scores = (
        torch.einsum("bhl,bsl->bhs", q_lat.float(), latent_cache.float())
        + torch.einsum("bhr,bsr->bhs", q_rope[:, 0].float(),
                       k_rope_cache.float())
    ) * (qk_nope + qk_rope) ** -0.5
    scores = torch.where(length_mask[:, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out_lat = torch.einsum("bhs,bsl->bhl", probs.to(latent_cache.dtype),
                           latent_cache)
    # absorb W_uv
    w_uv = p["w_uv"].reshape(lora, h, v_dim)
    out = torch.einsum("bhl,lhv->bhv", out_lat, w_uv).reshape(b, 1,
                                                              h * v_dim)
    return out @ p["wo"]


# -------------------------------------------------- tensor parallelism ----

def _check_heads(p, cfg, M: int):
    """The per-head leaves must split over M head by head."""
    h = cfg.num_heads
    names = ("w_uq" if cfg.q_lora_rank else "w_q", "w_uk", "w_uv", "wo")
    if h % M or any(p[n].dim is None for n in names if n != "w_q"):
        raise ValueError(f"MLA's {h} heads do not split head by head "
                         f"over {M} model shards (w_uq, w_uk, w_uv, wo)")


def _shard_queries(p, x, cfg, positions, group):
    """Each shard's (q_nope, q_rope) of its heads: the query bottleneck
    (``w_dq``, ``q_norm``, whole) once on the first device, then
    ``w_uq``'s columns of the shard's heads (a whole ``w_q`` projects on
    the first device and each shard takes its heads' columns)."""
    lead = tp.shard(p, 0)
    rank = _q_rank(lead, x, cfg)
    M = group.size
    out = []
    if not cfg.q_lora_rank:
        q_all = rank @ lead["w_q"]
        w = q_all.shape[-1] // M
        for j, (qj, pos) in enumerate(zip(tp.broadcast(q_all, group),
                                          tp.broadcast(positions, group))):
            out.append(_heads_q(qj[..., j * w:(j + 1) * w], pos, cfg))
        return out
    for j, (rj, pos) in enumerate(zip(tp.broadcast(rank, group),
                                      tp.broadcast(positions, group))):
        out.append(_heads_q(rj @ p["w_uq"][j], pos, cfg))
    return out


def mla_attention_apply_tp(p, x, cfg, positions, group, latent=None):
    """``mla_attention_apply`` split over a model group (``p`` a
    ``Split`` tree, x replicated on the first device): the latent and
    rope key (``w_dkv``, ``kv_norm``, whole) once on the first device,
    each shard its heads (``w_uq`` / ``w_uk`` / ``w_uv`` columns, the
    head-aligned split checked) by the materialized, block-wise or
    chunked path, ``wo``'s rows of them giving a partial; the partials
    all-reduced.  ``latent``: (latent, k_rope) when the caller has them
    (the prefill)."""
    _check_heads(p, cfg, group.size)
    if latent is None:
        latent = _latent(tp.shard(p, 0), x, cfg, positions)
    qs = _shard_queries(p, x, cfg, positions, group)
    parts = []
    for j, (lat, kr) in enumerate(zip(tp.broadcast(latent[0], group),
                                      tp.broadcast(latent[1], group))):
        pj = tp.shard(p, j)
        out = _attend(pj, *qs[j], lat, kr, cfg)
        parts.append(out.flatten(-2) @ pj["wo"])
    return tp.all_reduce(parts, group)


def mla_decode_attention_tp(p, x, lat_c, kr_c, cfg, positions, pos, group):
    """``mla_decode_attention`` split over a model group, over a latent
    cache split by sequence (``lat_c``, ``kr_c``: ``Split``s, dim 1; the
    new token's rows already written): each shard builds its heads'
    absorbed queries, the queries are all-gathered (b, H, lora + rope),
    each shard computes the softmax partials of every head over its
    positions (<= ``pos``), ``combine_attention_partials`` merges them,
    each shard applies its heads' ``w_uv`` and ``wo`` rows, and the
    partials are all-reduced.  A whole cache: each shard its heads over
    all of it."""
    from repro_torch.models.attention import combine_partials_tp
    _check_heads(p, cfg, group.size)
    b = x.shape[0]
    M = group.size
    h, lora = cfg.num_heads, cfg.kv_lora_rank
    hl = h // M
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    scale = (dn + dr) ** -0.5
    q_lat, q_rope = [], []
    for j, (qn, qr) in enumerate(_shard_queries(p, x, cfg, positions,
                                                group)):
        w_uk = p["w_uk"][j].reshape(lora, hl, dn)
        q_lat.append(torch.einsum("bhd,lhd->bhl", qn[:, 0], w_uk))
        q_rope.append(qr[:, 0])
    poss = tp.broadcast(pos, group)

    def partials(ql, qr, lat, kr, start, pj):
        S = lat.shape[1]
        sc = (torch.einsum("bhl,bsl->bhs", ql.float(), lat.float())
              + torch.einsum("bhr,bsr->bhs", qr.float(), kr.float())) * scale
        mask = (start + torch.arange(S, device=lat.device) <= pj)
        sc = torch.where(mask[None, None, :], sc, NEG_INF)
        m = sc.amax(dim=-1)
        e = torch.exp(sc - m[..., None])
        return m, e.sum(dim=-1), torch.einsum("bhs,bsl->bhl", e,
                                              lat.float())

    if lat_c.dim == 1:
        S = lat_c[0].shape[1]
        ql_all = tp.broadcast(tp.all_gather(q_lat, group, dim=1), group)
        qr_all = tp.broadcast(tp.all_gather(q_rope, group, dim=1), group)
        o = combine_partials_tp(
            [partials(ql_all[i], qr_all[i], lat_c[j], kr_c[j], j * S,
                      poss[i]) for i, j in enumerate(group.shards)], group)
        o = o.to(lat_c[0].dtype)
        outs = [oj[:, j * hl:(j + 1) * hl]
                for j, oj in enumerate(tp.broadcast(o, group))]
    else:
        outs = []
        for j in group.shards:
            m, l, o = partials(q_lat[j], q_rope[j], lat_c[j], kr_c[j], 0,
                               poss[j])
            outs.append((o / torch.clamp(l, min=1e-30)[..., None])
                        .to(lat_c[j].dtype))
    parts = []
    for j, oj in enumerate(outs):
        w_uv = p["w_uv"][j].reshape(lora, hl, dv)
        out = torch.einsum("bhl,lhv->bhv", oj, w_uv).reshape(b, 1, hl * dv)
        parts.append(out @ p["wo"][j])
    return tp.all_reduce(parts, group)
