"""Multi-tenant sessions: several loaded indexes behind one serving
process (twin of ``repro.serve.tenants``).

A ``Tenant`` names one serving engine (a ``repro_torch.api.AnnEngine``,
optionally with an embedding model in front of it) plus its per-tenant
serving defaults: the default ``SearchBudget`` applied to requests that
do not carry one, and the coalescing tile/window the loop uses for its
lanes (read from the artifact's embedded ``ServeConfig`` when the
tenant is loaded from disk).

``load_tenants`` is the multi-artifact front door behind
``launch/serve.py --serve-loop --tenant name=dir``: each spec runs
through ``repro_torch.api.load_ann_engine`` on one device (the card
unless the caller names another), and duplicate or conflicting specs
fail up front with a one-line actionable error instead of silently
double-loading the same Artifacts directory.  A ``mesh`` shards every
tenant's index over its ``data`` axis (one shared mesh across all
tenants).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.resilience.budget import SearchBudget
from repro_torch.serve.coalescer import ServeError


@dataclasses.dataclass
class Tenant:
    """One tenant's serving surface inside a ``ServingLoop``.

    ``engine``      the query server (``repro_torch.api.AnnEngine``).
    ``model``       optional embedder: when set, raw request rows are
                    embedded at submit time (per request, before
                    coalescing — so batching never changes the math a
                    direct ``Searcher.search`` would run).
    ``budget``      default ``SearchBudget`` for requests without one
                    (on top of the engine's own ``ResilienceConfig``
                    deadline default).
    ``tile``        coalescing tile rows (None = the loop's default).
    ``window_ms``   coalescing window (None = the loop's default).
    """
    name: str
    engine: object
    model: Optional[object] = None
    budget: Optional[SearchBudget] = None
    tile: Optional[int] = None
    window_ms: Optional[float] = None

    def __post_init__(self):
        if not self.name or "=" in self.name:
            raise ServeError(
                f"tenant name {self.name!r} must be a non-empty string "
                "without '='")

    @property
    def d(self) -> int:
        """The engine-side (embedded) query dimension."""
        return int(self.engine.index.C.shape[-1])

    def embed(self, queries):
        """Raw request rows -> engine-space rows (identity without a
        model)."""
        if self.model is None:
            return queries
        out = self.model.embed(queries)
        if isinstance(out, torch.Tensor):
            out = out.detach().cpu().numpy()
        return out

    # ------------------------------------------------------ constructors --
    @classmethod
    def from_artifacts(cls, name: str, path: str, *, mesh=None,
                       overrides=None, budget: Optional[SearchBudget] = None,
                       fault_injector=None, device=None) -> "Tenant":
        """Open one saved artifact directory as a tenant: the engine via
        ``repro_torch.api.load_ann_engine`` on ``device`` (the card
        unless named; inheriting the embedded ``ResilienceConfig``), the
        coalescing knobs from the embedded ``ServeConfig``
        (``batch_tile`` / ``batch_window_ms``).  ``mesh`` serves the
        index sharded over it (``load_ann_engine(mesh=)``)."""
        from repro_torch.api import Artifacts, load_ann_engine

        engine = load_ann_engine(path, mesh=mesh, device=device,
                                 overrides=overrides,
                                 fault_injector=fault_injector)
        cfg = Artifacts.load_config(path, overrides=overrides)
        return cls(name=name, engine=engine, budget=budget,
                   tile=cfg.serve.batch_tile,
                   window_ms=cfg.serve.batch_window_ms)

    @classmethod
    def from_searcher(cls, name: str, searcher, *,
                      budget: Optional[SearchBudget] = None) -> "Tenant":
        """Wrap a live ``api.Searcher`` (model + engine; any object with
        ``.engine``, ``.model`` and ``.config.serve`` serves): the loop
        embeds raw rows as ``searcher.search`` would, with the
        searcher's own ``embed`` (on the engine's device) where it has
        one."""
        cfg = searcher.config.serve
        model = searcher if hasattr(searcher, "embed") else searcher.model
        return cls(name=name, engine=searcher.engine, model=model,
                   budget=budget, tile=cfg.batch_tile,
                   window_ms=cfg.batch_window_ms)


def parse_tenant_specs(specs: Sequence[str]) -> List[Tuple[str, str]]:
    """``["name=path", ...]`` -> ``[(name, path), ...]`` with the
    duplicate/conflict checks the CLI relies on (one-line errors):

      - malformed specs (no '=', empty halves) are rejected by name;
      - two specs with the same tenant name are rejected;
      - two specs whose paths resolve to the same directory are
        rejected — loading one Artifacts dir twice doubles device
        memory for bitwise-identical answers, so it is always a typo.
    """
    out: List[Tuple[str, str]] = []
    seen_names: Dict[str, str] = {}
    seen_paths: Dict[str, str] = {}
    for spec in specs:
        name, eq, path = str(spec).partition("=")
        if not eq or not name or not path:
            raise ServeError(
                f"tenant spec {spec!r} must be NAME=ARTIFACTS_DIR "
                "(e.g. --tenant prod=/models/prod)")
        if name in seen_names:
            raise ServeError(
                f"duplicate tenant name {name!r} ({seen_names[name]!r} "
                f"vs {path!r}); give each --tenant a unique name")
        real = os.path.realpath(path)
        if real in seen_paths:
            raise ServeError(
                f"tenants {seen_paths[real]!r} and {name!r} both point "
                f"at {path!r}; load each Artifacts dir once and route "
                "requests by tenant name instead")
        seen_names[name] = path
        seen_paths[real] = name
        out.append((name, path))
    return out


def load_tenants(specs: Sequence[str], *, mesh=None, overrides=None,
                 fault_injector=None, device=None) -> Dict[str, Tenant]:
    """Validate + load ``NAME=DIR`` specs into a tenant map on one
    device (the card unless named).  Raises ``ServeError`` before any
    loading when the specs conflict (``parse_tenant_specs``)."""
    tenants: Dict[str, Tenant] = {}
    for name, path in parse_tenant_specs(specs):
        tenants[name] = Tenant.from_artifacts(
            name, path, mesh=mesh, overrides=overrides,
            fault_injector=fault_injector, device=device)
    return tenants
