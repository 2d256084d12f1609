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

from repro_torch.distributed import tensor_parallel as tp
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


def _in_proj(zx, di: int, nl: int, hl: int):
    """z, the pre-conv [x | B | C] rows and dt's raw columns of an
    in-projection ``zx`` (the whole mixer's, or one shard's in the
    segment layout: ``di``, ``nl``, ``hl`` its d_in, state columns and
    heads)."""
    return zx[..., :di], zx[..., di: 2 * di + 2 * nl], zx[..., -hl:]


def _bc(xbc, di: int, nl: int):
    """B and C of the post-conv [x | B | C] rows."""
    return xbc[..., di: di + nl], xbc[..., di + nl:]


def _dt_a(dt_raw, dt_bias, A_log):
    """softplus(dt + dt_bias) in f32, and A = -exp(A_log)."""
    return F.softplus(dt_raw.float() + dt_bias), -torch.exp(A_log)


def _scan(xbc, dt_raw, B, C, dt_bias, A_log, D, cfg, h0=None):
    """The SSD over the heads of ``dt_raw`` (b,l,h), their x the first
    columns of ``xbc``: (y (b,l,h*p), final state (b,h,p,n))."""
    b, l, h = dt_raw.shape
    xs = xbc[..., :h * cfg.ssm_head_dim].reshape(b, l, h, cfg.ssm_head_dim)
    dt, A = _dt_a(dt_raw, dt_bias, A_log)
    y, hT = ssd_chunked(xs, dt.to(xs.dtype), A.to(xs.dtype), B, C, D,
                        cfg.ssm_chunk, h0=h0)
    return y.reshape(b, l, h * cfg.ssm_head_dim), hT


def _conv_step(conv, new, conv_w, conv_b):
    """The conv over the cached window ``conv`` and the current token's
    pre-conv row ``new``: (the SiLU of it, the window)."""
    win = torch.cat([conv, new[:, None, :]], dim=1)
    return F.silu(torch.einsum("bwc,wc->bc", win, conv_w) + conv_b), win


def _recur(xbc, dt_raw, B, C, dt_bias, A_log, D, state, cfg):
    """One token's recurrent update of the heads of ``dt_raw`` (b,h):
    (y (b,h*p), the new state (b,h,p,n))."""
    b, h = dt_raw.shape
    xs = xbc[..., :h * cfg.ssm_head_dim].reshape(b, h, cfg.ssm_head_dim)
    dt, A = _dt_a(dt_raw, dt_bias, A_log)
    dA = torch.exp(dt * A).to(xs.dtype)                     # (b,h)
    upd = torch.einsum("bhp,bn->bhpn", xs * dt[..., None].to(xs.dtype), B)
    state = state * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, C) + xs * D[None, :, None]
    return y.reshape(b, h * cfg.ssm_head_dim), state


def _block(p, x, cfg, h0=None):
    """The Mamba-2 block on x (b,l,d): (out, final state, the pre-conv
    xBC activations (b,l,conv_dim), whose last width - 1 rows are the
    decode's conv cache)."""
    d_in, nheads, _ = ssm_dims(cfg)
    n = cfg.ssm_state
    z, xbc_raw, dt_raw = _in_proj(x @ p["w_in"], d_in, n, nheads)
    xbc = F.silu(nn.causal_conv(xbc_raw, p["conv_w"], p["conv_b"]))
    y, hT = _scan(xbc, dt_raw, *_bc(xbc, d_in, n), p["dt_bias"],
                  p["A_log"], p["D"], cfg, h0)
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
    d_in, nheads, _ = ssm_dims(cfg)
    n = cfg.ssm_state
    z, xbc_new, dt_raw = _in_proj(x[:, 0] @ p["w_in"], d_in, n, nheads)
    xbc, win = _conv_step(cache["conv"], xbc_new, p["conv_w"], p["conv_b"])
    y, state = _recur(xbc, dt_raw, *_bc(xbc, d_in, n), p["dt_bias"],
                      p["A_log"], p["D"], cache["state"], cfg)
    y = nn.rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = (y @ p["w_out"])[:, None, :]
    cache["state"].copy_(state)
    cache["conv"].copy_(win[:, 1:])
    return out, cache


# -------------------------------------------------- tensor parallelism ----

def _local_dims(p, cfg):
    """(d_in, state columns, heads) one shard holds of a mixer split over
    a model group (``distributed.tensor_parallel.shardings``' segment
    layout: ``w_in`` [z | x | B | C | dt], the conv [x | B | C], each
    segment split over the group); raises where a leaf is not split."""
    for k in ("w_in", "conv_w", "conv_b", "D", "w_out"):
        if p[k].dim is None:
            raise ValueError(f"the SSM's {k} does not split over the "
                             "model axis (ssm_state, the heads and d_inner "
                             "must each divide over it)")
    M = len(p["w_in"])
    d_in, nheads, _ = ssm_dims(cfg)
    return d_in // M, cfg.ssm_state // M, nheads // M


def _shard_heads(p, j: int, hl: int):
    """Shard j's heads of the replicated per-head leaves: (``dt_bias``,
    ``A_log``)."""
    return tuple(p[k][j][..., j * hl:(j + 1) * hl]
                 for k in ("dt_bias", "A_log"))


def _all_gather_bc(xbcs, di, nl, group):
    """B and C of every state column: each shard's post-conv slices,
    all-gathered in shard order, then on each shard's device."""
    bcs = [_bc(t, di, nl) for t in xbcs]
    B = tp.all_gather([t[0] for t in bcs], group, dim=-1)
    C = tp.all_gather([t[1] for t in bcs], group, dim=-1)
    return tp.broadcast(B, group), tp.broadcast(C, group)


def _out_tp(p, ys, zs, cfg, group):
    """The gated norm over the split ``d_in`` (``nn.rmsnorm_tp``), then
    ``w_out``'s rows of each shard, all-reduced."""
    normed = nn.rmsnorm_tp([y * F.silu(z) for y, z in zip(ys, zs)],
                           p["norm"], cfg.norm_eps, group)
    return tp.all_reduce([y @ p["w_out"][j] for j, y in enumerate(normed)],
                         group)


def _block_tp(p, x, cfg, group):
    """``_block`` split over a model group (``p`` a ``Split`` tree, x
    replicated on the first device): each shard its heads of z, x and
    dt and its state columns of B and C, convolved on its own channels;
    B and C all-gathered after the conv and SiLU; ``_scan`` over its
    heads with no collective; the gated norm's sums of squares and
    ``w_out``'s partials all-reduced.  Returns (out, [final state of
    each shard's heads], [each shard's pre-conv [x | B | C] rows])."""
    di, nl, hl = _local_dims(p, cfg)
    zs, raws, dts, xbcs = [], [], [], []
    for j, xj in enumerate(tp.broadcast(x, group)):
        z, raw, dt_raw = _in_proj(xj @ p["w_in"][j], di, nl, hl)
        zs.append(z)
        raws.append(raw)
        dts.append(dt_raw)
        xbcs.append(F.silu(nn.causal_conv(raw, p["conv_w"][j],
                                          p["conv_b"][j])))
    ys, states = [], []
    for j, (xbc, dt_raw, B, C) in enumerate(zip(
            xbcs, dts, *_all_gather_bc(xbcs, di, nl, group))):
        y, hT = _scan(xbc, dt_raw, B, C, *_shard_heads(p, j, hl), p["D"][j],
                      cfg)
        ys.append(y)
        states.append(hT)
    return _out_tp(p, ys, zs, cfg, group), states, raws


def ssm_block_apply_tp(p, x, cfg, group):
    """``ssm_block_apply`` split over a model group (``_block_tp``)."""
    return _block_tp(p, x, cfg, group)[0]


def ssm_prefill_tp(p, x, cfg, cache, group):
    """``ssm_prefill`` split over a model group: each shard writes its
    heads' final state and its [x | B | C] channels of the conv window
    into its blocks of ``cache`` (``Split``s: the state by heads, the
    conv window by segments)."""
    out, states, raws = _block_tp(p, x, cfg, group)
    for j, (hT, raw) in enumerate(zip(states, raws)):
        cache["state"][j].copy_(hT)
        conv = cache["conv"][j]
        t = min(x.shape[1], conv.shape[1])
        conv.zero_()
        conv[:, -t:] = raw[:, -t:]
    return out


def ssm_decode_step_tp(p, x, cache, cfg, group):
    """``ssm_decode_step`` split over a model group: each shard's conv
    window, heads and state in place; B and C all-gathered, the gated
    norm and ``w_out`` as in ``_block_tp``.  Returns (out (b,1,d),
    cache)."""
    di, nl, hl = _local_dims(p, cfg)
    zs, dts, xbcs = [], [], []
    for j, xj in enumerate(tp.broadcast(x[:, 0], group)):
        z, new, dt_raw = _in_proj(xj @ p["w_in"][j], di, nl, hl)
        xbc, win = _conv_step(cache["conv"][j], new, p["conv_w"][j],
                              p["conv_b"][j])
        cache["conv"][j].copy_(win[:, 1:])
        zs.append(z)
        dts.append(dt_raw)
        xbcs.append(xbc)
    ys = []
    for j, (xbc, dt_raw, B, C) in enumerate(zip(
            xbcs, dts, *_all_gather_bc(xbcs, di, nl, group))):
        y, state = _recur(xbc, dt_raw, B, C, *_shard_heads(p, j, hl),
                          p["D"][j], cache["state"][j], cfg)
        cache["state"][j].copy_(state)
        ys.append(y)
    return _out_tp(p, ys, zs, cfg, group)[:, None, :], cache
