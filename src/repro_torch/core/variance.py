"""Online per-dimension variance estimation (paper §3.2, eq. 9; twin of
``repro.core.variance``).

The embeddings X change every step (W is being trained), so Lambda is
estimated across batches with the paper's incremental update:

    M_b = M_{b-1} + (m_b - M_{b-1}) / b
    L_b = L_{b-1} + (l_b - L_{b-1}) / b + (1/b)(1 - 1/b)(m_b - M_{b-1})^2

where (m_b, l_b) are the sample mean/variance (ddof 0) of batch b.
This is exact for equal-sized batches; ``welford_merge`` is the
count-weighted exact (Chan et al.) merge used when batch sizes differ.

State is a dict of f32 tensors: the paper's (mean, var, count) and the
exact (n, m2, _exact_mean) accumulators.
"""
from __future__ import annotations

from typing import Dict

import torch


def init_state(d: int, device=None) -> Dict:
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "mean": torch.zeros((d,), **f32),
        "var": torch.zeros((d,), **f32),
        "count": torch.zeros((), **f32),   # number of batches seen (b)
        "n": torch.zeros((), **f32),       # number of samples seen
        "m2": torch.zeros((d,), **f32),    # sum of squared deviations
        "_exact_mean": torch.zeros((d,), **f32),
    }


def batch_moments(x):
    """Sample mean/variance (ddof 0, as ``jnp.var``) of one batch of
    embeddings x: (b, d)."""
    x = x.to(torch.float32)
    return torch.mean(x, dim=0), torch.var(x, dim=0, correction=0)


def global_batch_moments(x, mesh=None):
    """Batch moments of the global batch of a data-parallel step.

    ``mesh`` None: exactly ``batch_moments(x)``.  Otherwise ``x`` is the
    global batch, one equal slice per shard of the mesh's ``data`` axis:
    a sequence of the shards' (b, d) embeddings (each on its device), or
    one tensor split into equal row blocks.  The moments are the mean
    over shards of the local means and second moments, gathered onto
    the mesh's first device, in the reference's order: for equal shards
    the exact global moments, ``E[x^2] - m^2`` for the variance.
    Differentiable (``.to()`` and the means are), so the straight-through
    Lambda gradient reaches every shard's embeddings."""
    if mesh is None:
        return batch_moments(x)
    if isinstance(x, torch.Tensor):
        devs = mesh.axis_devices("data")
        x = [part.to(d) for part, d in zip(torch.chunk(x, len(devs)), devs)]
    lead = mesh.lead
    D = len(x)
    m = sum(torch.mean(s.to(torch.float32), dim=0).to(lead) for s in x) / D
    ex2 = sum(torch.mean(torch.square(s.to(torch.float32)), dim=0).to(lead)
              for s in x) / D
    return m, ex2 - torch.square(m)


def update(state: Dict, x) -> Dict:
    """Paper eq. 9: the equal-weight incremental update with batch b's
    moments, beside the exact (n, m2) accumulators."""
    m_b, l_b = batch_moments(x)
    return update_from_moments(state, m_b, l_b, float(x.shape[0]))


def update_from_moments(state: Dict, m_b, l_b, nb) -> Dict:
    """``update`` with precomputed batch moments and sample count."""
    b = state["count"] + 1.0
    inv_b = 1.0 / b
    delta = m_b - state["mean"]
    new_mean = state["mean"] + delta * inv_b
    new_var = (state["var"] + (l_b - state["var"]) * inv_b
               + inv_b * (1.0 - inv_b) * torch.square(delta))

    # exact count-weighted merge (Chan) in parallel
    nb = torch.as_tensor(nb, dtype=torch.float32, device=b.device)
    n = state["n"]
    tot = n + nb
    d_exact = m_b - _exact_mean(state)
    m2 = (state["m2"] + l_b * nb
          + torch.square(d_exact) * n * nb / torch.clamp_min(tot, 1.0))
    exact_mean = _exact_mean(state) + d_exact * nb / torch.clamp_min(tot, 1.0)
    return {"mean": new_mean, "var": new_var, "count": b,
            "n": tot, "m2": m2, "_exact_mean": exact_mean}


def _exact_mean(state):
    return state.get("_exact_mean", state["mean"] * 0.0)


def welford_merge(a: Dict, b: Dict) -> Dict:
    """Exact merge of two variance states."""
    na, nb = a["n"], b["n"]
    tot = torch.clamp_min(na + nb, 1.0)
    ma, mb = _exact_mean(a), _exact_mean(b)
    delta = mb - ma
    m2 = a["m2"] + b["m2"] + torch.square(delta) * na * nb / tot
    mean = ma + delta * nb / tot
    return {"mean": mean, "var": m2 / tot, "count": a["count"] + b["count"],
            "n": na + nb, "m2": m2, "_exact_mean": mean}


def lambda_hat(state: Dict):
    """Current per-dimension variance estimate Lambda (the paper's)."""
    return state["var"]


def lambda_exact(state: Dict):
    """Exact pooled variance from the (n, m2) accumulators."""
    return state["m2"] / torch.clamp_min(state["n"], 1.0)
