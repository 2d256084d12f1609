"""Cross-pod gradient compression with error feedback (twin of
``repro.quant.grad_compress``, in the single-controller form).

Within a pod, gradients reduce in full precision; across pods, where
the links are scarce, the combine runs compressed:

    1. error feedback:   e = g + residual;  q, s = int8(e);
                         residual' = e - dequant(q, s)
    2. every pod's int8 payload and scales go to the lead device
       (1 byte an element on the wire against 4 for an f32 mean)
    3. dequantize there and average over the pods, in pod order

The reference runs step 2 as ``all_gather`` over its ``pod`` mesh axis
inside a ``shard_map``.  The port drives every pod from one process, as
its sharded engines do (``distributed.sharding``): a pod's gradient
tree lives on its own device, and the gather is a ``.to()`` of the int8
codes and scales.  Each pod's residual stays on its device and carries
its quantization error into the next step.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.quant.int8 import dequantize_int8, quantize_int8
from repro_torch.train.optimizer import tree_map


def compress_state_init(grads):
    """Error-feedback residuals: f32 zeros shaped like ``grads``."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def ef_quantize(g, residual):
    """Error-feedback int8 quantization of one tensor: (q int8, scale
    f32 per trailing-axis slice, new residual).

    ``g`` and ``residual`` may also be lists: the shards of one tensor
    split along its last dim, in order, each on its own device (FSDP's
    blocks of a row, ``distributed.fsdp``).  Each row's scale is then
    taken over the whole row, the largest of the shards' row maxima (on
    the first shard's device, sent back to each), so that the codes,
    scales and residuals are the whole tensor's, bit for bit; the three
    come back as lists, one entry a shard."""
    if not isinstance(g, (list, tuple)):
        e = g.float() + residual
        q, s = quantize_int8(e, axis=-1)
        return q, s, e - dequantize_int8(q, s)
    es = [gi.float() + ri for gi, ri in zip(g, residual)]
    lead = es[0].device
    amax = None
    for e in es:          # quantize_int8's amax, over the whole row
        m = torch.amax(torch.abs(e), dim=-1, keepdim=True).to(lead)
        amax = m if amax is None else torch.maximum(amax, m)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    qs, ss, rs = [], [], []
    for e in es:
        s = scale.to(e.device)
        q = torch.clamp(torch.round(e / s), -127, 127).to(torch.int8)
        qs.append(q)
        ss.append(s)
        rs.append(e - dequantize_int8(q, s))
    return qs, ss, rs


def _pod_mean(parts, dtype):
    """Mean of equal-shaped f32 tensors, summed in pod order."""
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    return (acc / len(parts)).to(dtype)


def compressed_cross_pod_mean(grads: Sequence, residuals: Sequence,
                              lead: Optional[torch.device] = None):
    """The compressed mean of one gradient tree per pod (``grads``, in
    pod order; ``residuals`` one residual tree per pod, on the pods'
    devices).  Returns (the mean tree on ``lead``, pod 0's device by
    default, in each leaf's type; the new residual trees, one per pod).
    A leaf may be a list, the shards of a row (``ef_quantize``): its
    mean is then a list too, each shard's on ``lead`` or on pod 0's
    device of that shard."""
    if len(grads) != len(residuals) or not grads:
        raise ValueError(f"one residual tree per pod: {len(grads)} "
                         f"gradient trees, {len(residuals)} residual trees")
    out = [tree_map(ef_quantize, g, r) for g, r in zip(grads, residuals)]

    def gather_mean(g, *pods):
        """One leaf's (q, scale, residual) of every pod -> the mean of
        the dequantized payloads on the lead device, in g's type."""
        if isinstance(g, (list, tuple)):
            return [gather_mean(gi, *((q[i], s[i], None)
                                      for q, s, _ in pods))
                    for i, gi in enumerate(g)]
        dev = lead if lead is not None else pods[0][0].device
        return _pod_mean([dequantize_int8(q.to(dev), s.to(dev))
                          for q, s, _ in pods], g.dtype)
    means = tree_map(gather_mean, grads[0], *out)
    new_res: List = [tree_map(lambda t: t[2], o) for o in out]
    return means, new_res


def plain_cross_pod_mean(grads: Sequence,
                         lead: Optional[torch.device] = None):
    """The uncompressed control: the f32 mean of one gradient tree per
    pod on ``lead`` (pod 0's device by default), in pod order."""
    def mean(*leaves):
        dev = lead if lead is not None else leaves[0].device
        return _pod_mean([g.float().to(dev) for g in leaves],
                         leaves[0].dtype)
    return tree_map(mean, *grads)
