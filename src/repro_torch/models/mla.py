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
  it block for block.  On the card it materializes K and V for the
  whole sequence and launches the flash kernel once: the same causal
  softmax, to rounding, at the cost of K and V in device memory for one
  layer at a time (at DeepSeek-V2's 128 heads and s = 2048: K 101 MB
  and V 67 MB in bf16).  The per-block decompression on the card is
  open work.
* decode: plain PyTorch on both devices, as the reference's is not a
  kernel.
"""
from __future__ import annotations

import torch

from repro_torch.models import nn
from repro_torch.models.attention import NEG_INF, full_attention


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


def _queries(p, x, cfg, positions):
    h = cfg.num_heads
    qk_nope, qk_rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    if cfg.q_lora_rank:
        cq = nn.rmsnorm(x @ p["w_dq"], p["q_norm"], cfg.norm_eps)
        q = cq @ p["w_uq"]
    else:
        q = x @ p["w_q"]
    q = q.reshape(*x.shape[:-1], h, qk_nope + qk_rope)
    q_nope, q_rope = q[..., :qk_nope], q[..., qk_nope:]
    q_rope = nn.apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _latent(p, x, cfg, positions):
    ckv = x @ p["w_dkv"]                                 # (b,s,lora+rope)
    latent = nn.rmsnorm(ckv[..., : cfg.kv_lora_rank], p["kv_norm"],
                        cfg.norm_eps)
    k_rope = ckv[..., cfg.kv_lora_rank:][..., None, :]   # (b,s,1,rope)
    k_rope = nn.apply_rope(k_rope, positions, cfg.rope_theta)[..., 0, :]
    return latent, k_rope


def mla_qkv(p, x, cfg, positions):
    """The per-head q, K and V of a full-sequence MLA call: q, k (b, s,
    h, nope + rope) and v (b, s, h, v), each contiguous (what the flash
    kernel reads)."""
    b, s, _ = x.shape
    h = cfg.num_heads
    qk_nope, qk_rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q_nope, q_rope = _queries(p, x, cfg, positions)
    latent, k_rope = _latent(p, x, cfg, positions)
    k_nope = (latent @ p["w_uk"]).reshape(b, s, h, qk_nope)
    v = (latent @ p["w_uv"]).reshape(b, s, h, cfg.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, qk_rope)],
                  dim=-1)
    return q, k, v


def mla_attention_apply(p, x, cfg, positions):
    """Full-sequence causal MLA (prefill).  Short sequences, and every
    sequence on the card, take the dense path; long ones on the CPU the
    lazy decompression of ``mla_chunked_attention`` (module
    docstring)."""
    b, s, _ = x.shape
    h, v_dim = cfg.num_heads, cfg.v_head_dim
    if s <= cfg.attn_chunk or x.is_cuda:
        q, k, v = mla_qkv(p, x, cfg, positions)
        out = full_attention(q, k, v, causal=True)
    else:
        q_nope, q_rope = _queries(p, x, cfg, positions)
        latent, k_rope = _latent(p, x, cfg, positions)
        out = mla_chunked_attention(p, q_nope, q_rope, latent, k_rope, cfg)
    return out.reshape(b, s, h * v_dim) @ p["wo"]


def mla_chunked_attention(p, q_nope, q_rope, latent, k_rope_seq, cfg):
    """Online-softmax causal MLA with per-block latent decompression:
    for each query block, over key blocks in order, the nope and rope
    scores are two f32 products summed, then the reference's masked
    online softmax (CPU path; module docstring)."""
    b, s, h, dn = q_nope.shape
    dr = q_rope.shape[-1]
    dv = cfg.v_head_dim
    scale = (dn + dr) ** -0.5
    c = min(cfg.attn_chunk, s)
    while s % c:
        c -= 1
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
