"""Mamba-2 block (twin of ``repro.models.ssm``: SSD, state-space duality,
arXiv:2405.21060).

The prefill runs the chunked SSD algorithm: within a chunk a quadratic,
attention-like product under a decay mask; across chunks a linear
recurrence over the chunk states (a Python loop over the l / Q chunks,
the reference's ``lax.scan``).  Decode is the O(1) recurrent update of a
cached (heads, head_dim, state) tensor, written in place.  There is no
KV cache, so ICQ-KV does not apply.

The reference has no Pallas kernel here, so this module is plain
PyTorch on both devices, with the reference's types: ``dt`` and ``A``
cast to the input's type before the scan (in bf16 the decay mask is
computed in bf16), the cached state in the compute type.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import nn


def ssm_dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_head_dim
    conv_dim = d_in + 2 * cfg.ssm_state
    return d_in, nheads, conv_dim


def ssm_init(generator: torch.Generator, cfg, dtype=torch.float32):
    d = cfg.d_model
    d_in, nheads, conv_dim = ssm_dims(cfg)
    n = cfg.ssm_state
    dev = generator.device
    dt = nn.as_dtype(dtype)
    conv_w = torch.randn((cfg.ssm_conv_width, conv_dim), generator=generator,
                         device=dev, dtype=torch.float32) * 0.1
    return {
        # fused in-proj: [z (d_in), x (d_in), B (n), C (n), dt (nheads)]
        "w_in": nn.dense_init(generator, d, 2 * d_in + 2 * n + nheads, dtype),
        "conv_w": conv_w.to(dt),
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nheads, device=dev,
                                          dtype=torch.float32)),
        "dt_bias": torch.zeros((nheads,), dtype=torch.float32, device=dev),
        "D": torch.ones((nheads,), dtype=dt, device=dev),
        "norm": nn.rmsnorm_init(d_in, dtype, dev),
        "w_out": nn.dense_init(generator, d_in, d, dtype),
    }


def _segsum(dA):
    """Stable 'segment sum' for the intra-chunk decay mask.
    dA: (..., cl) -> (..., cl, cl) lower-tri cumulative sums."""
    cl = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]              # sum_{k+1..q}
    mask = torch.tril(torch.ones((cl, cl), dtype=torch.bool,
                                 device=dA.device))
    return torch.where(mask, diff, torch.tensor(float("-inf"),
                                                dtype=diff.dtype,
                                                device=diff.device))


def chunk_len(l: int, chunk: int) -> int:
    """The SSD chunk at length ``l``: ``chunk``, or for a ragged length
    the largest divisor of ``l`` below it (the reference's rule)."""
    Q = min(chunk, l)
    while l % Q:
        Q -= 1
    return Q


def ssd_chunked(x, dt, A, B, C, D, chunk: int, h0=None):
    """SSD scan.  x:(b,l,h,p) dt:(b,l,h) A:(h,) B,C:(b,l,n) D:(h,).
    Returns (y:(b,l,h,p), final state:(b,h,p,n))."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    Q = chunk_len(l, chunk)
    nc = l // Q
    xr = x.reshape(b, nc, Q, h, p)
    dtr = dt.reshape(b, nc, Q, h)
    Br = B.reshape(b, nc, Q, n)
    Cr = C.reshape(b, nc, Q, n)
    dA = dtr * A                                            # (b,nc,Q,h) <= 0
    dAh = dA.movedim(-1, -2)                                # (b,nc,h,Q)
    xdt = xr * dtr[..., None]                               # (b,nc,Q,h,p)

    # ---- intra-chunk: (scores * decay mask) . xdt, two contractions ----
    Lmask = torch.exp(_segsum(dAh))                         # (b,nc,h,Q,Q)
    scores = torch.einsum("bcqn,bckn->bcqk", Cr, Br)        # (b,nc,Q,Q)
    weights = scores[:, :, None] * Lmask                    # (b,nc,h,Q,Q)
    del Lmask
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", weights, xdt)
    del weights

    # ---- chunk states:  S_c = sum_k exp(cum_last - cum_k) B_k x_k^T ----
    cum = torch.cumsum(dAh, dim=-1)                         # (b,nc,h,Q)
    decay_to_end = torch.exp(cum[..., -1:] - cum)           # (b,nc,h,Q)
    S = torch.einsum("bcqhp,bcqn->bchpn",
                     xdt * decay_to_end.movedim(-1, -2)[..., None], Br)

    # ---- inter-chunk recurrence: the state *entering* each chunk ----
    chunk_decay = torch.exp(cum[..., -1])                   # (b,nc,h)
    state = (h0 if h0 is not None
             else torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device))
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + S[:, c]
    prev_states = torch.stack(prev, dim=1)                  # (b,nc,h,p,n)

    # ---- inter-chunk contribution: C . state, times the decay ----
    state_decay = torch.exp(cum)                            # (b,nc,h,Q)
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", Cr, prev_states) \
        * state_decay.movedim(-1, -2)[..., None]

    y = (y_intra + y_inter).reshape(b, l, h, p) + x * D[None, None, :, None]
    return y, state


def _block(p, x, cfg, h0=None):
    """The Mamba-2 block on x (b,l,d): (out, final state, the pre-conv
    xBC activations (b,l,conv_dim), whose last width - 1 rows are the
    decode's conv cache)."""
    b, l, _ = x.shape
    d_in, nheads, conv_dim = ssm_dims(cfg)
    n = cfg.ssm_state
    zxbcdt = x @ p["w_in"]
    z = zxbcdt[..., :d_in]
    xbc_raw = zxbcdt[..., d_in: d_in + d_in + 2 * n]
    dt_raw = zxbcdt[..., -nheads:]
    xbc = F.silu(nn.causal_conv(xbc_raw, p["conv_w"], p["conv_b"]))
    xs = xbc[..., :d_in].reshape(b, l, nheads, cfg.ssm_head_dim)
    B = xbc[..., d_in: d_in + n]
    C = xbc[..., d_in + n:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, hT = ssd_chunked(xs, dt.to(xs.dtype), A.to(xs.dtype), B, C, p["D"],
                        cfg.ssm_chunk, h0=h0)
    y = y.reshape(b, l, d_in)
    y = nn.rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["w_out"], hT, xbc_raw


def ssm_block_apply(p, x, cfg, *, h0=None, return_state=False):
    """Full Mamba-2 block: in-proj, conv, SSD, gated norm, out-proj."""
    out, hT, _ = _block(p, x, cfg, h0)
    if return_state:
        return out, hT
    return out


def ssm_init_cache(cfg, batch: int, dtype, device=None):
    d_in, nheads, conv_dim = ssm_dims(cfg)
    dt = nn.as_dtype(dtype)
    return {
        "state": torch.zeros((batch, nheads, cfg.ssm_head_dim, cfg.ssm_state),
                             dtype=dt, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim),
                            dtype=dt, device=device),
    }


def ssm_prefill(p, x, cfg, cache):
    """The block over a prompt x (b,l,d) that also fills its decode
    ``cache`` in place: the final SSD state and the last width - 1
    pre-conv rows (zeros before the prompt's start).  Returns out."""
    out, hT, xbc_raw = _block(p, x, cfg)
    cache["state"].copy_(hT)
    t = min(x.shape[1], cache["conv"].shape[1])
    cache["conv"].zero_()
    cache["conv"][:, -t:] = xbc_raw[:, -t:]
    return out


def ssm_decode_step(p, x, cache, cfg):
    """One-token recurrent update.  x: (b,1,d).  Writes ``cache``'s
    ``state`` and ``conv`` in place (no host sync); returns (out (b,1,d),
    cache)."""
    b = x.shape[0]
    d_in, nheads, conv_dim = ssm_dims(cfg)
    n = cfg.ssm_state
    zxbcdt = x[:, 0] @ p["w_in"]
    z = zxbcdt[..., :d_in]
    xbc_new = zxbcdt[..., d_in: d_in + d_in + 2 * n]
    dt_raw = zxbcdt[..., -nheads:]
    # conv over the cached window + the current token
    win = torch.cat([cache["conv"], xbc_new[:, None, :]], dim=1)
    xbc = F.silu(torch.einsum("bwc,wc->bc", win, p["conv_w"]) + p["conv_b"])
    xs = xbc[..., :d_in].reshape(b, nheads, cfg.ssm_head_dim)
    B = xbc[..., d_in: d_in + n]
    C = xbc[..., d_in + n:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A).to(xs.dtype)                     # (b,h)
    upd = torch.einsum("bhp,bn->bhpn", xs * dt[..., None].to(xs.dtype), B)
    state = cache["state"] * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, C) + xs * p["D"][None, :, None]
    y = y.reshape(b, d_in)
    y = nn.rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = (y @ p["w_out"])[:, None, :]
    cache["state"].copy_(state)
    cache["conv"].copy_(win[:, 1:])
    return out, cache
