"""Mixture-of-Experts layer (twin of ``repro.models.moe``): top-k routing
and capacity-bounded sorted gather / scatter dispatch.

The dispatch is the reference's: (expert, slot) -> token indices from a
stable sort and an exclusive cumsum, the tokens gathered into an (E, C,
d) buffer, batched expert products (``torch.bmm`` over the expert axis:
one launch per product, whatever E), and the combine.  Every shape is
static and nothing reads a device value on the host, so the decode step
runs with no host synchronize.

Two places differ in how, not what, they compute:

* Router ties.  ``lax.top_k`` keeps the lower expert index on equal
  probabilities; ``torch.topk`` leaves the order unspecified on CUDA,
  so the top-k is the first k of a stable descending sort.
* The combine.  The reference scatter-adds every slot's gated output
  into its token in the output's type, in ascending slot order.
  ``index_add_`` on CUDA adds with atomics in an order that changes
  from run to run (bf16 sums then differ bit for bit), so instead each
  token's k slots are sorted ascending (dropped ones last, reading a
  zero row) and summed into zeros in that order: k adds of (T, d), the
  same on both devices, the same from run to run.
"""
from __future__ import annotations

import torch

from repro_torch.models import nn


def _experts_init(generator, e: int, in_dim: int, out_dim: int, dtype):
    """``e`` lecun-normal (in, out) kernels stacked on a leading expert
    axis, drawn one expert at a time (peak: the stack plus one f32
    expert)."""
    w = torch.empty((e, in_dim, out_dim), dtype=nn.as_dtype(dtype),
                    device=generator.device)
    for i in range(e):
        w[i] = nn.dense_init(generator, in_dim, out_dim, dtype)
    return w


def moe_init(generator: torch.Generator, cfg, dtype=torch.float32):
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    p = {
        "router": nn.dense_init(generator, d, e, torch.float32),  # f32
        "we_gate": _experts_init(generator, e, d, f, dtype),
        "we_up": _experts_init(generator, e, d, f, dtype),
        "we_down": _experts_init(generator, e, f, d, dtype),
    }
    if cfg.num_shared_experts:
        p["shared"] = nn.mlp_init(generator, d, cfg.num_shared_experts * f,
                                  "swiglu", dtype)
    return p


def router_topk(logits, k: int):
    """Softmax-then-topk (DeepSeek-style), gates renormalized over top-k;
    equal probabilities keep the lower expert first.  Returns (gates
    (T, k) f32, ids (T, k) int32, probs (T, E) f32)."""
    probs = torch.softmax(logits.float(), dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = top.values[..., :k], top.indices[..., :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, ids.to(torch.int32), probs


def load_balance_loss(probs, ids, num_experts: int):
    """Switch-transformer aux loss: E * sum_e f_e * P_e."""
    T = probs.shape[0]
    flat = ids.reshape(-1).long()
    counts = torch.zeros((num_experts,), dtype=torch.int32,
                         device=ids.device).scatter_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32)).float()
    f = counts / max(T * ids.shape[-1], 1)
    P = probs.mean(dim=0)
    return num_experts * torch.sum(f * P)


def _dispatch(ids, num_experts: int, capacity: int):
    """The reference's slot assignment: the flat (token, choice)
    assignments sorted stably by expert; each takes slot expert *
    capacity + its rank within its expert, or is dropped past the
    capacity.  Returns (token_of_slot (E*C,) int64: the flat assignment
    in each slot, -1 where empty; slot_of_flat (T*k,) int64: each
    assignment's slot, the sentinel E*C where dropped)."""
    fid = ids.reshape(-1).long()
    Tk, EC = fid.numel(), num_experts * capacity
    order = torch.argsort(fid, stable=True)
    fid_sorted = fid[order]
    group_sizes = torch.zeros((num_experts,), dtype=torch.long,
                              device=ids.device).scatter_add_(
        0, fid, torch.ones_like(fid))
    starts = torch.cumsum(group_sizes, 0) - group_sizes
    rank = torch.arange(Tk, device=ids.device) - starts[fid_sorted]
    slot_sorted = torch.where(rank < capacity, fid_sorted * capacity + rank,
                              EC)
    slot_of_flat = torch.empty_like(slot_sorted).scatter_(0, order,
                                                          slot_sorted)
    # every dropped assignment writes the sentinel slot, cut off below
    token_of_slot = torch.full((EC + 1,), -1, dtype=torch.long,
                               device=ids.device).scatter_(
        0, slot_of_flat, torch.arange(Tk, device=ids.device))
    return token_of_slot[:EC], slot_of_flat


def _dispatch_indices(ids, num_experts: int, capacity: int):
    """token->slot assignment.  Returns (token_of_slot (E*C,) int32: the
    flat (token, choice) index held by each slot, -1 where empty; valid
    (E*C,) bool), static shapes."""
    token_of_slot, _ = _dispatch(ids, num_experts, capacity)
    return token_of_slot.to(torch.int32), token_of_slot >= 0


def expert_capacity(tokens: int, cfg) -> int:
    """Slots per expert of one dispatch round over ``tokens`` tokens
    (the reference's ``max(int(T k cf / E), 4)``)."""
    return max(int(tokens * cfg.experts_per_token * cfg.capacity_factor
                   / cfg.num_experts), 4)


def moe_apply(p, x, cfg):
    """x: (..., d) -> (out (..., d), aux_loss scalar f32).

    Long sequences are processed in token chunks (the reference's
    ``lax.scan``): capacity scales with the chunk, so the (E, C, d)
    dispatch buffers stay O(chunk) and overflow drops stay local."""
    orig_shape = x.shape
    d = orig_shape[-1]
    xt_all = x.reshape(-1, d)
    T_all = xt_all.shape[0]
    chunk = getattr(cfg, "moe_token_chunk", 16384) or T_all
    if T_all > chunk:
        c = chunk
        while T_all % c:
            c -= 1
        outs, auxes = zip(*(_moe_apply_flat(p, xt_all[i:i + c], cfg)
                            for i in range(0, T_all, c)))
        return (torch.cat(outs).reshape(orig_shape),
                torch.stack(auxes).mean())
    out, aux = _moe_apply_flat(p, xt_all, cfg)
    return out.reshape(orig_shape), aux


def _activation(cfg) -> str:
    return cfg.activation if cfg.activation != "gelu" else "swiglu"


def _moe_apply_flat(p, xt, cfg):
    """One dispatch round over xt: (T, d) -> ((T, d), aux)."""
    T, d = xt.shape
    k = cfg.experts_per_token
    E = cfg.num_experts
    C = expert_capacity(T, cfg)

    logits = xt.float() @ p["router"]
    gates, ids, probs = router_topk(logits, k)
    aux = load_balance_loss(probs, ids, E) * cfg.router_aux_weight

    token_of_slot, slot_of_flat = _dispatch(ids, E, C)
    valid = token_of_slot >= 0
    src_token = torch.where(valid, token_of_slot // k, 0)
    gate_of_slot = torch.where(
        valid, gates.reshape(-1)[torch.clamp(token_of_slot, min=0)], 0.0)

    xe = xt[src_token].reshape(E, C, d)                  # gather
    xe = xe * valid.reshape(E, C, 1).to(xe.dtype)
    h = nn.gated_act(_activation(cfg), torch.bmm(xe, p["we_gate"]),
                     torch.bmm(xe, p["we_up"]))
    ye = torch.bmm(h, p["we_down"]).reshape(E * C, d)    # (E*C, d)
    ye = ye * gate_of_slot[:, None].to(ye.dtype)
    # combine: each token's kept slots in ascending order, then the zero
    # row (index E*C) for its dropped ones
    ye = torch.cat([ye, ye.new_zeros((1, d))])
    mine = torch.sort(slot_of_flat.reshape(T, k), dim=-1).values
    out = torch.zeros((T, d), dtype=ye.dtype, device=xt.device)
    for j in range(k):
        out = out + ye[mine[:, j]]

    if cfg.num_shared_experts:
        out = out + nn.mlp_apply(p["shared"], xt, "swiglu")
    return out, aux


def moe_apply_dense_reference(p, x, cfg):
    """Oracle: every expert on every token, weighted by (top-k) gates.
    Exact when capacity is unbounded; used by tests and checks only."""
    orig_shape = x.shape
    xt = x.reshape(-1, orig_shape[-1])
    logits = xt.float() @ p["router"]
    gates, ids, _ = router_topk(logits, cfg.experts_per_token)
    full_gates = torch.zeros((xt.shape[0], cfg.num_experts),
                             dtype=torch.float32, device=xt.device)
    full_gates.scatter_(1, ids.long(), gates)
    h = nn.gated_act("swiglu",
                     torch.einsum("td,edf->tef", xt, p["we_gate"]),
                     torch.einsum("td,edf->tef", xt, p["we_up"]))
    ye = torch.einsum("tef,efd->ted", h, p["we_down"])
    out = torch.einsum("ted,te->td", ye, full_gates.to(ye.dtype))
    if cfg.num_shared_experts:
        out = out + nn.mlp_apply(p["shared"], xt, "swiglu")
    return out.reshape(orig_shape)

