"""RG-LRU recurrent block (twin of ``repro.models.rglru``: RecurrentGemma
/ Griffin, arXiv:2402.19427).

The linear recurrence h_t = a_t * h_{t-1} + b_t runs at prefill as a
log-depth prefix scan over the sequence (``_linear_scan``: ceil(log2 l)
doubling steps, each one elementwise pass, where the reference calls
``jax.lax.associative_scan``), and at decode as the O(1) update of the
cached f32 state, written in place.  The reference has no Pallas kernel
here, so this module is plain PyTorch on both devices.  The scan sums
in another order than XLA's tree, so the two agree to f32 rounding.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import nn

_C = 8.0  # Griffin's fixed recurrence-sharpness constant
CONV_WIDTH = 4


def _block_diag_init(generator: torch.Generator, width: int,
                     num_blocks: int, dtype):
    bw = width // num_blocks
    w = torch.randn((num_blocks, bw, bw), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return {"w": (w / math.sqrt(bw)).to(nn.as_dtype(dtype)),
            "b": torch.zeros((num_blocks, bw), dtype=nn.as_dtype(dtype),
                             device=generator.device)}


def _block_diag_apply(p, x):
    nb, bw, _ = p["w"].shape
    xb = x.reshape(*x.shape[:-1], nb, bw)
    return (torch.einsum("...ni,nio->...no", xb, p["w"]) + p["b"]) \
        .reshape(x.shape)


def rglru_init(generator: torch.Generator, cfg, dtype=torch.float32):
    d, w = cfg.d_model, cfg.lru_width
    nb = cfg.num_heads
    dev = generator.device
    # Lambda init so that a = sigmoid(L)^c lands in [0.9, 0.999]
    u = 0.9 + 0.099 * torch.rand((w,), generator=generator, device=dev,
                                 dtype=torch.float32)
    lam = torch.log(u ** (1 / _C) / (1 - u ** (1 / _C)))
    conv_w = torch.randn((CONV_WIDTH, w), generator=generator, device=dev,
                         dtype=torch.float32) * 0.1
    return {
        "w_x": nn.dense_init(generator, d, w, dtype),          # recurrent
        "w_gate_branch": nn.dense_init(generator, d, w, dtype),  # gelu
        "conv_w": conv_w.to(nn.as_dtype(dtype)),
        "conv_b": torch.zeros((w,), dtype=nn.as_dtype(dtype), device=dev),
        "rg": _block_diag_init(generator, w, nb, dtype),   # recurrence gate
        "ig": _block_diag_init(generator, w, nb, dtype),   # input gate
        "lambda": lam,                                       # stays f32
        "w_out": nn.dense_init(generator, w, d, dtype),
    }


def _linear_scan(a, b):
    """Inclusive prefix scan of h_t = a_t h_{t-1} + b_t (h_{-1} = 0) over
    axis 1: (aa, hh) with aa_t = a_0 ... a_t and hh_t = h_t.  Doubling
    steps d = 1, 2, 4, ...: element t takes in the segment ending at t -
    d, (a_t a_{t-d}, a_t b_{t-d} + b_t), the reference's ``combine``."""
    l = a.shape[1]
    d = 1
    while d < l:
        a, b = (torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], 1),
                torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], 1))
        d *= 2
    return a, b


def _gates(p, x):
    """(a, b_t) of the recurrence at x (post-conv input, any leading
    shape), in f32."""
    r = torch.sigmoid(_block_diag_apply(p["rg"], x).float())
    i = torch.sigmoid(_block_diag_apply(p["ig"], x).float())
    log_a = -_C * r * F.softplus(p["lambda"])               # <= 0
    a = torch.exp(log_a)
    gated_x = i * x.float()
    b_t = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * gated_x
    return a, b_t


def _rglru_core(p, x, h0=None):
    """x: (b,l,w) post-conv recurrent-branch input -> (y, h_last), both
    in x's type."""
    a, b_t = _gates(p, x)
    aa, hh = _linear_scan(a, b_t)
    if h0 is not None:
        hh = hh + aa * h0[:, None, :]
    return hh.to(x.dtype), hh[:, -1].to(x.dtype)


def _block(p, x, cfg, h0=None):
    """(out, h_last, the pre-conv recurrent branch (b,l,w), whose last
    three rows are the decode's conv cache)."""
    rec_raw = x @ p["w_x"]
    rec = nn.causal_conv(rec_raw, p["conv_w"], p["conv_b"])
    y, h_last = _rglru_core(p, rec, h0=h0)
    gate = F.gelu(x @ p["w_gate_branch"], approximate="tanh")
    return (y * gate) @ p["w_out"], h_last, rec_raw


def rglru_block_apply(p, x, cfg, *, h0=None, return_state: bool = False):
    """Full Griffin recurrent block (train / prefill)."""
    out, h_last, _ = _block(p, x, cfg, h0)
    if return_state:
        return out, h_last
    return out


def rglru_init_cache(cfg, batch: int, dtype, device=None):
    return {
        "h": torch.zeros((batch, cfg.lru_width), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, CONV_WIDTH - 1, cfg.lru_width),
                            dtype=nn.as_dtype(dtype), device=device),
    }


def rglru_prefill(p, x, cfg, cache):
    """The block over a prompt x (b,l,d) that also fills its decode
    ``cache`` in place: the last state (rounded through x's type, then
    f32, as the reference stores it) and the last three pre-conv rows
    (zeros before the prompt's start).  Returns out."""
    out, h_last, rec_raw = _block(p, x, cfg)
    cache["h"].copy_(h_last.float())
    t = min(x.shape[1], cache["conv"].shape[1])
    cache["conv"].zero_()
    cache["conv"][:, -t:] = rec_raw[:, -t:]
    return out


def rglru_decode_step(p, x, cache, cfg):
    """x: (b,1,d) -> (out (b,1,d), cache), the cache's ``h`` and ``conv``
    written in place (no host sync)."""
    rec_new = x[:, 0] @ p["w_x"]                            # (b,w)
    win = torch.cat([cache["conv"], rec_new[:, None]], dim=1)
    rec = torch.einsum("bwc,wc->bc", win, p["conv_w"]) + p["conv_b"]
    a, b_t = _gates(p, rec)
    h = a * cache["h"] + b_t
    gate = F.gelu(x[:, 0] @ p["w_gate_branch"], approximate="tanh")
    out = ((h.to(x.dtype) * gate) @ p["w_out"])[:, None]
    cache["h"].copy_(h)
    cache["conv"].copy_(win[:, 1:])
    return out, cache


# -------------------------------------------------- tensor parallelism ----

def _shard_params(p, j: int):
    """Shard j's block tree of a mixer split over a model group: its
    columns of ``w_x`` / ``w_gate_branch``, its conv channels, its gate
    blocks, its rows of ``w_out``, and its channels of the replicated
    ``lambda``."""
    for k in ("w_x", "w_gate_branch", "conv_w", "w_out"):
        if p[k].dim is None:
            raise ValueError(f"the RG-LRU's {k} does not split over the "
                             "model axis")
    if p["rg"]["w"].dim is None or p["ig"]["w"].dim is None:
        raise ValueError("the RG-LRU's gate blocks (num_heads) do not "
                         "split over the model axis")
    pj = tp.shard(p, j)
    w = pj["w_x"].shape[-1]
    pj["lambda"] = pj["lambda"][j * w:(j + 1) * w]
    return pj


def _block_tp(p, x, cfg, group):
    """``_block`` split over a model group (``p`` a ``Split`` tree, x
    replicated on the first device): each shard its channels of the
    recurrent and gate branches (the block-diagonal gates by blocks, so
    the recurrence is shard-local), ``w_out``'s rows of them giving a
    partial that is all-reduced.  Returns (out, [each shard's last
    state], [each shard's pre-conv recurrent rows])."""
    parts, hs, raws = [], [], []
    for j, xj in enumerate(tp.broadcast(x, group)):
        out, h_last, rec_raw = _block(_shard_params(p, j), xj, cfg)
        parts.append(out)
        hs.append(h_last)
        raws.append(rec_raw)
    return tp.all_reduce(parts, group), hs, raws


def rglru_block_apply_tp(p, x, cfg, group):
    """``rglru_block_apply`` split over a model group."""
    return _block_tp(p, x, cfg, group)[0]


def rglru_prefill_tp(p, x, cfg, cache, group):
    """``rglru_prefill`` split over a model group: each shard writes its
    channels of the state and the conv window (``cache`` ``Split``s by
    channels)."""
    out, hs, raws = _block_tp(p, x, cfg, group)
    for j, (h_last, raw) in enumerate(zip(hs, raws)):
        cache["h"][j].copy_(h_last.float())
        conv = cache["conv"][j]
        t = min(x.shape[1], conv.shape[1])
        conv.zero_()
        conv[:, -t:] = raw[:, -t:]
    return out


def rglru_decode_step_tp(p, x, cache, cfg, group):
    """``rglru_decode_step`` split over a model group: each shard its
    channels' step on its cache blocks in place, ``w_out``'s partials
    all-reduced."""
    parts = []
    for j, xj in enumerate(tp.broadcast(x, group)):
        out, _ = rglru_decode_step(_shard_params(p, j), xj,
                                   tp.shard(cache, j), cfg)
        parts.append(out)
    return tp.all_reduce(parts, group), cache
