"""Search budgets and result metadata — the vocabulary of
deadline-aware degraded search (docs/robustness.md).

A ``SearchBudget`` says how much a caller is willing to pay for one
query batch; a ``ResultMeta`` rides on every ``SearchResult`` and says
what was actually paid: which rung of the degradation ladder ran, which
stages executed, the measured wall time, and the fraction of the
database that was reachable (``coverage`` < 1.0 under dead shards).

The ladder (executed by ``repro.api.serving.AnnEngine``):

    level 0  full      the index's configured search (eq. 1 refine)
    level 1  capped    refine capped at ``refine_cap`` best-crude
                       survivors (jnp engines; the fused kernels bound
                       phase-2 work in-kernel and skip this rung)
    level 2  probes    IVF only: reduced ``n_probe``
    level 3  crude     crude-only ranking (eq. 2's fast subset) —
                       bitwise-identical to the crude ranking the full
                       path computes internally

Level choice is *measured*, not guessed: the engine keeps a per-level
EMA of warm wall times and picks the least-degraded rung whose measured
(or inherited-upper-bound) time fits the deadline; the crude floor is
always eligible.  ``ResultMeta.degraded`` flags anything above level 0
or any coverage < 1.0, so callers can always distinguish exact results
from approximate-under-pressure ones.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

# ladder rungs, least → most degraded (docs/robustness.md)
DEGRADE_LEVELS = ("full", "capped", "probes", "crude")


class SearchBudget(NamedTuple):
    """What one query batch may cost.

    deadline_ms   target wall time for the batch; the engine picks the
                  least-degraded ladder level whose *measured* time
                  fits (None = no deadline: caps alone pick the level).
    allow_refine  False forces the crude-only floor outright (Quick-ADC
                  style cheap-pass-only serving).
    max_n_probe   IVF: clamp the probe count for this batch.
    refine_cap    override the capped level's survivor cap.
    force_level   pin a ladder level by name ("full" | "capped" |
                  "probes" | "crude"), bypassing timing choice.
    """
    deadline_ms: Optional[float] = None
    allow_refine: bool = True
    max_n_probe: Optional[int] = None
    refine_cap: Optional[int] = None
    force_level: Optional[str] = None


class ResultMeta(NamedTuple):
    """What one search actually did (attached to ``SearchResult.meta``
    *outside* jit — it carries host types).

    ``degraded`` is True iff the result is anything less than the full
    configured search over the full database: a ladder level above 0,
    or coverage < 1.0 (dead shards).

    ``queue_ms`` / ``batch_fill`` stay ``None`` on the offline
    ``AnnEngine`` paths; only the async serving loop
    (``repro.serve.ServingLoop``, docs/serving.md) populates them —
    time spent coalescing in the request queue before the batch was
    dispatched, and the fraction of the dispatched tile occupied by
    real (non-padding) query rows.  They ride through the degradation
    ladder unchanged: the loop stamps them onto whatever meta the
    ladder produced for the batch.
    """
    level: int = 0                       # ladder rung index
    level_name: str = "full"             # DEGRADE_LEVELS[level]
    degraded: bool = False
    stages: Tuple[str, ...] = ()         # e.g. ("probe", "crude", "refine")
    wall_ms: float = -1.0                # measured batch wall time
    deadline_ms: Optional[float] = None  # the budget's deadline, if any
    deadline_exceeded: bool = False      # wall_ms > deadline_ms
    coverage: float = 1.0                # reachable fraction of the db
    backend: str = ""                    # engine backend that served it
    queue_ms: Optional[float] = None     # serving loop: coalescing wait
    batch_fill: Optional[float] = None   # serving loop: real rows / tile


def validate_budget(budget: SearchBudget) -> SearchBudget:
    """Sanity-check a budget (raises ``ValueError`` naming the field)."""
    if budget.deadline_ms is not None and budget.deadline_ms <= 0:
        raise ValueError(
            f"SearchBudget.deadline_ms must be > 0, got {budget.deadline_ms}")
    if budget.max_n_probe is not None and budget.max_n_probe < 1:
        raise ValueError(
            f"SearchBudget.max_n_probe must be >= 1, got {budget.max_n_probe}")
    if budget.refine_cap is not None and budget.refine_cap < 1:
        raise ValueError(
            f"SearchBudget.refine_cap must be >= 1, got {budget.refine_cap}")
    if budget.force_level is not None \
            and budget.force_level not in DEGRADE_LEVELS:
        raise ValueError(
            f"SearchBudget.force_level={budget.force_level!r} is not one "
            f"of {list(DEGRADE_LEVELS)}")
    return budget
