"""Attention layers (twin of ``repro.models.attention``): GQA with
chunked online-softmax, the triangular chunk-pair scan, full einsum
attention and single-token decode against a KV cache.

On the CPU each function is the plain twin of the reference's.  On a
CUDA tensor the causal self-attention of ``full_attention``,
``chunked_attention`` and ``triangular_chunked_attention`` (query and
key positions both counted from 0, no window, no padding mask) is
exactly what the flash kernel computes, so there they launch
``kernels.ops.flash_attention`` and nothing else.  v may be narrower
than q and k (MLA's prefill: q/k 192, v 128; the output takes v's
width); a (q/k, v) width pair the kernel does not compile (it compiles
32, 64, 128 and 256 with v as wide, and (192, 128)) raises its
``ValueError``, and a call the kernel does not cover (a window, a query
offset, a key padding mask, a non-causal call) raises
``NotImplementedError``.  ``decode_attention``
is not a kernel in the reference either and stays plain PyTorch on both
devices.  Cross attention waits for ROADMAP item 21.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import nn

NEG_INF = -1e30
# what the card does not serve yet, by the ROADMAP item that brings it
_ITEM = {"window": "item 20 (the hybrid's local attention)",
         "non-causal": "item 21 (the encoder-decoder and the VLM)",
         "offset": "item 21 (the encoder-decoder and the VLM)"}


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


def _flash(q, k, v, *, causal, window=0, q_offset=0, masked=False):
    """The card's attention: the flash kernel for causal self-attention
    from position 0, a ``NotImplementedError`` naming its ROADMAP item
    for any other call."""
    for cond, what in ((window, "window"), (not causal, "non-causal"),
                       (q_offset or masked, "offset")):
        if cond:
            raise NotImplementedError(
                f"attention on the card serves causal self-attention from "
                f"position 0 only (the flash kernel); a {what} call waits "
                f"for ROADMAP {_ITEM[what]}")
    return ops.flash_attention(q, k, v, causal=True)


def chunked_attention(q, k, v, *, causal: bool, chunk: int,
                      q_offset: int = 0, window: int = 0,
                      kv_valid: int = 0):
    """Online-softmax attention over (query chunk, key chunk) pairs,
    carrying (running max, normalizer, accumulator).  ``window>0`` adds
    a sliding band mask, ``kv_valid>0`` masks keys at positions >=
    kv_valid.  On the card: the flash kernel (module docstring)."""
    if q.is_cuda:
        return _flash(q, k, v, causal=causal, window=window,
                      q_offset=q_offset, masked=bool(kv_valid))
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
    if q.is_cuda:
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
    if q.is_cuda:
        return _flash(q, k, v, causal=causal, window=window,
                      q_offset=q_offset, masked=mask is not None)
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
        m &= mask
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
    s = x.shape[1]
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
    return out.reshape(*x.shape[:-1], cfg.num_heads * cfg.head_dim) @ p["wo"]


def _pad_len(n: int, c: int) -> int:
    return ((n + c - 1) // c) * c
