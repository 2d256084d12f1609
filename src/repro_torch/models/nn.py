"""Module primitives (twin of ``repro.models.nn``), with the two
cross-entropy losses of LM training.

Params are nested dicts of tensors.  ``*_init`` builds params, the
matching functions apply them; dtypes are explicit.  Random draws come
from a ``torch.Generator``; the reference's JAX keys have no
counterpart, so the same seed gives other values than the reference's
(tests carry the reference's params across as numpy instead)."""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint as torch_checkpoint

from repro_torch.distributed import tensor_parallel as tp


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or its name (the configs' dtype
    fields are names: ``"float32"``, ``"bfloat16"``)."""
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype)


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               dtype=torch.float32, scale: Optional[float] = None):
    """Lecun-normal dense kernel (no bias); shape (in, out), drawn on
    the generator's device."""
    s = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = torch.randn((in_dim, out_dim), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return (w * s).to(as_dtype(dtype))


def bias_init(out_dim: int, dtype=torch.float32, device=None):
    return torch.zeros((out_dim,), dtype=as_dtype(dtype), device=device)


def embedding_init(generator: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32):
    w = torch.randn((vocab, d), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return (w * 0.02).to(as_dtype(dtype))


def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    return torch.ones((d,), dtype=as_dtype(dtype), device=device)


def rmsnorm(x, scale, eps: float = 1e-6):
    """In f32, cast back to x's type."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * scale.float()).to(dt)


def rmsnorm_tp(parts, scale, eps: float, group):
    """``rmsnorm`` over a last dim split across a model group: ``parts``
    the shards' slices (shard order, each on its device), ``scale`` the
    whole weight (a replicated ``Split``), sliced where it is used.  Each
    shard's f32 sum of squares is all-reduced in shard order, and each
    shard scales its own slice (the Mamba-2 gated norm over a split
    ``d_in``).  Returns the normed slices, each in its part's type."""
    d = sum(t.shape[-1] for t in parts) * (group.size // len(parts))
    ss = tp.all_reduce([torch.sum(torch.square(t.float()), dim=-1,
                                  keepdim=True) for t in parts], group)
    out = []
    for j, (t, tot, w) in enumerate(zip(parts, tp.broadcast(ss, group),
                                        scale)):
        n = t.shape[-1]
        lo = group.shards[j] * n
        y = t.float() * torch.rsqrt(tot / d + eps)
        out.append((y * w[lo:lo + n].float()).to(t.dtype))
    return out


def layernorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=as_dtype(dtype), device=device),
            "bias": torch.zeros((d,), dtype=as_dtype(dtype), device=device)}


def layernorm(x, p, eps: float = 1e-5):
    """In f32 with the variance over n (the reference's ``jnp.var``),
    cast back to x's type."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * p["scale"].float() + p["bias"].float()).to(dt)


# ---------------------------------------------------------------- RoPE ----

def rope_frequencies(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_frequencies_on(head_dim: int, theta: float, device: torch.device):
    """``rope_frequencies`` copied to ``device`` once: a copy from host
    memory at every call would wait for the card each time."""
    return torch.from_numpy(rope_frequencies(head_dim, theta)).to(device)


def apply_rope(x, positions, theta: float = 10000.0):
    """Half-split rotary embedding.  x: (..., seq, heads, head_dim);
    positions: (..., seq) integers; the angles in f32."""
    head_dim = x.shape[-1]
    freqs = _rope_frequencies_on(head_dim, theta, x.device)
    angles = positions[..., None].float() * freqs        # (..., s, hd/2)
    angles = angles[..., None, :]                        # (..., s, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------- activations ----

def gated_act(kind: str, gate, up):
    if kind == "swiglu":
        return F.silu(gate) * up
    if kind == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    raise ValueError(kind)


# ------------------------------------------------------------- conv ----

def causal_conv(x, w, b):
    """Per-channel causal conv1d of the SSM and the RG-LRU blocks.
    x:(b,l,c), w:(width,c): the shifted products summed in tap order,
    then the bias (the reference's two ``_causal_conv``s)."""
    width, l = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = pad[:, 0:l] * w[0]
    for i in range(1, width):
        out = out + pad[:, i:i + l] * w[i]
    return out + b


# ------------------------------------------------------------- MLP ----

def mlp_init(generator: torch.Generator, d_model: int, d_ff: int,
             activation: str, dtype=torch.float32):
    if activation in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(generator, d_model, d_ff, dtype),
            "w_up": dense_init(generator, d_model, d_ff, dtype),
            "w_down": dense_init(generator, d_ff, d_model, dtype),
        }
    return {  # plain gelu MLP (whisper)
        "w_up": dense_init(generator, d_model, d_ff, dtype),
        "b_up": bias_init(d_ff, dtype, generator.device),
        "w_down": dense_init(generator, d_ff, d_model, dtype),
        "b_down": bias_init(d_model, dtype, generator.device),
    }


def mlp_apply(p, x, activation: str):
    if activation in ("swiglu", "geglu"):
        h = gated_act(activation, x @ p["w_gate"], x @ p["w_up"])
        return h @ p["w_down"]
    h = F.gelu(x @ p["w_up"] + p["b_up"], approximate="tanh")
    return h @ p["w_down"] + p["b_down"]


def mlp_apply_tp(p, x, activation: str, group):
    """``mlp_apply`` split over a model group (``p`` a ``Split`` tree, x
    replicated on the group's first device): ``w_gate``, ``w_up`` and
    ``b_up`` column-split, ``w_down`` row-split, each shard's partial
    product all-reduced, ``b_down`` added once after.  A ``d_ff`` that
    the rule table leaves whole runs whole on the first device."""
    if p["w_down"].dim is None:
        return mlp_apply(tp.shard(p, 0), x, activation)
    xs = tp.broadcast(x, group)
    parts = []
    for j, xj in enumerate(xs):
        pj = tp.shard(p, j)
        if activation in ("swiglu", "geglu"):
            h = gated_act(activation, xj @ pj["w_gate"], xj @ pj["w_up"])
        else:
            h = F.gelu(xj @ pj["w_up"] + pj["b_up"], approximate="tanh")
        parts.append(h @ pj["w_down"])
    out = tp.all_reduce(parts, group)
    return out + p["b_down"].whole if "b_down" in p else out


# ------------------------------------------- vocabulary-parallel ends ----

def embed_tp(table, tokens, group):
    """The embedding rows of ``tokens`` from a vocabulary-parallel table
    (a ``Split`` over its rows): shard j holds rows [j V / M, (j + 1) V /
    M) and gives zero for an id outside them; the all-reduce sums.  A
    table the rule table leaves whole is read on the first device."""
    tokens = tokens.long()
    if table.dim is None:
        return table.whole[tokens.to(table.whole.device)]
    parts = []
    for j, t in enumerate(tp.broadcast(tokens, group)):
        rows = table[j].shape[0]
        local = t - j * rows
        inside = (local >= 0) & (local < rows)
        got = table[j][torch.clamp(local, 0, rows - 1)]
        parts.append(torch.where(inside[..., None], got,
                                 torch.zeros((), dtype=got.dtype,
                                             device=got.device)))
    return tp.all_reduce(parts, group)


def head_tp(x, w, group, *, tied: bool = False):
    """Logits of x (replicated on the first device) through a head split
    over the vocabulary: ``w`` the head (d, V) split on V, or with
    ``tied`` the embedding (V, d) split on V; each shard's logit slice,
    all-gathered in shard order.  A head the rule table leaves whole
    runs whole on the first device."""
    if w.dim is None:
        return x @ (w.whole.T.to(x.dtype) if tied else w.whole)
    parts = [xj @ (w[j].T.to(xj.dtype) if tied else w[j])
             for j, xj in enumerate(tp.broadcast(x, group))]
    return tp.all_gather(parts, group, dim=-1)


# ------------------------------------------------------------- losses ----

def _token_losses(logits, labels, z_loss: float):
    """Per-token CE (+ z-loss) of f32 logits (..., V) at labels (...)."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return loss


def cross_entropy(logits, labels, z_loss: float = 1e-4):
    """Mean token CE with optional z-loss; logits (..., V), labels (...);
    in f32."""
    return torch.mean(_token_losses(logits.float(), labels, z_loss))


def chunked_cross_entropy_head(x, w_head, labels, mask=None, *,
                               chunk: int = 2048, z_loss: float = 1e-4,
                               vocab_real: int = 0):
    """Fused head projection + CE over *sequence* chunks: only one
    chunk's (b, chunk, V) f32 logits live at a time, and each chunk is
    recomputed in the backward (``torch.utils.checkpoint``, the
    reference's ``jax.checkpoint``).  Padded vocab columns (at and past
    ``vocab_real``) are masked to -1e30.  x (b, s, d), labels (b, s),
    mask (b, s) float / bool or None -> mean CE over the masked tokens
    (the chunk sums added in order).  ``w_head`` may be a function of a
    chunk's rows giving its logits (the tensor-parallel head)."""
    b, s, d = x.shape
    c = min(chunk, s)
    while s % c:
        c -= 1
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=x.device)
    mask = mask.float()

    def one(xb, lb, mb):
        logits = (w_head(xb) if callable(w_head)
                  else xb @ w_head).float()                # (b, c, V)
        if vocab_real and vocab_real < logits.shape[-1]:
            pad = torch.arange(logits.shape[-1],
                               device=logits.device) < vocab_real
            logits = torch.where(pad, logits, torch.full_like(logits,
                                                              -1e30))
        return torch.sum(_token_losses(logits, lb, z_loss) * mb)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, c):
        total = total + torch_checkpoint.checkpoint(
            one, x[:, i:i + c], labels[:, i:i + c], mask[:, i:i + c],
            use_reentrant=False)
    return total / torch.clamp(torch.sum(mask), min=1.0)
