"""The async serving loop: coalesced, multi-tenant request serving over
``repro_torch.api.AnnEngine`` (twin of ``repro.serve.loop``; DESIGN.md
§14, docs/serving.md).

``ServingLoop`` turns the synchronous batch engines into a request
path.  Callers ``submit`` single or small-batch queries and get a
future; a background worker coalesces arrivals per *lane* — one lane
per (tenant, topk, budget) static serving configuration — and flushes
them as fixed-shape tiles:

  - every flush is padded to the lane's ``tile`` rows, so **one**
    shape serves all arrival sizes (the warm cache ``warm``/``_warmed``
    is keyed per lane exactly like ``index/pipelined.py``'s
    per-instance plan cache: the key names the static configuration);
  - a flush fires on a full tile or on window expiry, whichever comes
    first (``serve/coalescer.py``); oversize bursts split across
    consecutive tiles and the loop routes result rows back to each
    caller FIFO.

Scheduling never changes math: each query row's result depends only on
its own row (the per-query independence the pipelined executor's
bitwise tests established, DESIGN.md §13), and padding rows are sliced
off before delivery — so a coalesced response is bitwise-identical
(ids AND distances) to calling the same ``Searcher``/``AnnEngine``
directly on that request's rows.  tests/test_torch_serve.py holds this
for all three index kinds on the CPU; ``chip_smoke.py`` phase 10
re-asserts it on the card under Poisson traffic.  The loop pins every
tenant engine's ``query_tile`` to its lane tile, so a direct call runs
the same (tile, d) shapes as the flushes: the LUT build's matrix
product (BLAS on the CPU, cuBLAS on the card), like XLA, may round
differently at another row count.

Each delivered ``SearchResult.meta`` is the engine's ``ResultMeta``
(degradation rung, wall time, backend — the ladder runs per *flush*,
so deadline budgets degrade real traffic) extended with the loop's own
accounting: ``queue_ms`` (submit -> flush dispatch of the request's
last part) and ``batch_fill`` (row-weighted real-rows/tile of the
flushes that served it).  The worker moves each flush's result rows to
the host (``.cpu().numpy()``) before routing them, so a delivered
``SearchResult`` holds numpy rows.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.index.base import SearchResult
from repro_torch.resilience.budget import SearchBudget
from repro_torch.serve.coalescer import (Coalescer, FlushBatch,
                                         PendingRequest, ServeError)
from repro_torch.serve.tenants import Tenant

_DEFAULT_TILE = 32
_DEFAULT_WINDOW_MS = 2.0
_DEFAULT_MAX_QUEUE = 4096


class _Lane:
    """One static serving configuration's queue: a coalescer plus the
    per-flush call options shared by every request in it."""

    __slots__ = ("tenant", "topk", "budget", "coal")

    def __init__(self, tenant: Tenant, topk: Optional[int],
                 budget: Optional[SearchBudget], tile: int,
                 window_s: float):
        self.tenant = tenant
        self.topk = topk
        self.budget = budget
        self.coal = Coalescer(tile, window_s)


class ServingLoop:
    """Coalescing multi-tenant serving front end (module docstring).

    ``tenants``    a ``Tenant``, an iterable of them, or a name->Tenant
                   mapping (``repro_torch.serve.load_tenants`` output).
    ``window_ms``  override every tenant's coalescing window (None =
                   per-tenant ``Tenant.window_ms``, falling back to the
                   ``ServeConfig`` default of 2 ms).
    ``tile``       override every tenant's flush tile rows likewise.
    ``max_queue``  queued-row backpressure bound across all lanes;
                   ``submit`` beyond it raises ``ServeError`` instead
                   of growing the queue without bound.

    Use as a context manager (``with ServingLoop(...) as loop:``) or
    call ``start()``/``close()`` explicitly; ``close`` drains every
    lane (pending requests are served, then the worker exits).
    """

    def __init__(self, tenants, *, window_ms: Optional[float] = None,
                 tile: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 clock=time.monotonic):
        self.tenants = self._as_tenant_map(tenants)
        self._window_ms = window_ms
        self._tile = tile
        # pin each engine's tile to the lane tile: direct engine/Searcher
        # calls now run the same (tile, d) shapes as coalesced flushes
        # (AnnEngine.query_tile), which is what makes the bitwise
        # coalesced-vs-direct invariant hold — the LUT build's matrix
        # product (BLAS, cuBLAS) may round differently at another row
        # count
        for t in self.tenants.values():
            t.engine.query_tile = self._tile_of(t)
        self._max_queue = (_DEFAULT_MAX_QUEUE if max_queue is None
                           else int(max_queue))
        self._clock = clock
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._lanes: Dict[Tuple, _Lane] = {}
        self._ready: deque = deque()         # FlushBatch FIFO
        self._warmed: Dict[Tuple, bool] = {}
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self.stats: Dict[str, float] = {
            "requests": 0, "rows": 0, "batches": 0, "padded_rows": 0,
            "flush_full": 0, "flush_window": 0, "flush_drain": 0}

    # ------------------------------------------------------------- setup --
    @staticmethod
    def _as_tenant_map(tenants) -> Dict[str, Tenant]:
        if isinstance(tenants, Tenant):
            tenants = [tenants]
        if isinstance(tenants, dict):
            items = list(tenants.values())
        else:
            items = list(tenants)
        if not items:
            raise ServeError("ServingLoop needs at least one tenant")
        out: Dict[str, Tenant] = {}
        for t in items:
            if not isinstance(t, Tenant):
                raise ServeError(
                    f"tenants must be repro_torch.serve.Tenant, got "
                    f"{type(t).__name__}; wrap engines with "
                    "Tenant(name=..., engine=...)")
            if t.name in out:
                raise ServeError(f"duplicate tenant name {t.name!r}")
            out[t.name] = t
        return out

    @classmethod
    def for_engine(cls, engine, *, name: str = "default",
                   budget: Optional[SearchBudget] = None,
                   **kwargs) -> "ServingLoop":
        """Single-tenant convenience over a bare ``AnnEngine``."""
        return cls(Tenant(name=name, engine=engine, budget=budget),
                   **kwargs)

    def _tile_of(self, tenant: Tenant) -> int:
        if self._tile is not None:
            return int(self._tile)
        return int(tenant.tile) if tenant.tile is not None else _DEFAULT_TILE

    def _window_s_of(self, tenant: Tenant) -> float:
        wm = self._window_ms
        if wm is None:
            wm = (tenant.window_ms if tenant.window_ms is not None
                  else _DEFAULT_WINDOW_MS)
        return float(wm) / 1000.0

    # --------------------------------------------------------- lifecycle --
    def start(self) -> "ServingLoop":
        if self._thread is not None:
            raise ServeError("ServingLoop already started")
        self._thread = threading.Thread(target=self._run,
                                        name="repro-torch-serve-loop",
                                        daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        """Drain every lane and stop the worker.  Safe on an already
        closed (or never started) loop; pending requests are served
        before the worker exits (clean-shutdown contract)."""
        if self._thread is None:
            with self._cond:
                self._drain_locked()
                self._stop = True
            # never started: execute the drained flushes inline
            while True:
                with self._cond:
                    if not self._ready:
                        break
                    batch = self._ready.popleft()
                self._execute(batch)
            return
        with self._cond:
            if not self._stop:
                self._drain_locked()
                self._stop = True
            self._cond.notify_all()
        self._thread.join()
        self._thread = None

    def _drain_locked(self):
        for lane in self._lanes.values():
            self._ready.extend(lane.coal.flush_all())

    def __enter__(self) -> "ServingLoop":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ submit --
    def _resolve_tenant(self, tenant: Optional[str]) -> Tenant:
        if tenant is None:
            if len(self.tenants) == 1:
                return next(iter(self.tenants.values()))
            raise ServeError(
                f"this loop serves {sorted(self.tenants)}; pass "
                "submit(..., tenant=NAME)")
        t = self.tenants.get(tenant)
        if t is None:
            raise ServeError(f"unknown tenant {tenant!r}; loaded: "
                             f"{sorted(self.tenants)}")
        return t

    def submit(self, queries, *, tenant: Optional[str] = None,
               k: Optional[int] = None,
               budget: Optional[SearchBudget] = None) -> Future:
        """Enqueue one request ((nq, d) raw rows, or (d,) for a single
        query) and return a future resolving to its ``SearchResult``
        (rows in request order, ``meta.queue_ms``/``meta.batch_fill``
        populated).  ``budget`` falls back to the tenant's default."""
        t = self._resolve_tenant(tenant)
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.ndim != 2:
            raise ServeError(
                f"queries must be (nq, d) or (d,), got shape {q.shape}")
        # embed BEFORE coalescing: per-request, so batching never
        # changes the numbers a direct Searcher.search would produce
        q = np.asarray(t.embed(q), dtype=np.float32)
        if q.shape[1] != t.d:
            raise ServeError(
                f"tenant {t.name!r} serves d={t.d} queries, got "
                f"d={q.shape[1]}")
        budget = budget if budget is not None else t.budget
        fut: Future = Future()
        with self._cond:
            if self._stop:
                raise ServeError("ServingLoop is closed")
            pending = sum(l.coal.pending_rows for l in self._lanes.values())
            if pending + q.shape[0] > self._max_queue:
                raise ServeError(
                    f"serving queue full ({pending} rows pending, "
                    f"max_queue={self._max_queue}); retry later or raise "
                    "serve.max_queue")
            now = self._clock()
            req = PendingRequest(t.name, q, k, budget, now, fut)
            lane_key = (t.name, k, budget)
            lane = self._lanes.get(lane_key)
            if lane is None:
                lane = _Lane(t, k, budget, self._tile_of(t),
                             self._window_s_of(t))
                self._lanes[lane_key] = lane
            self._ready.extend(lane.coal.submit(req, now))
            self.stats["requests"] += 1
            self.stats["rows"] += q.shape[0]
            self._cond.notify()
        return fut

    def search(self, queries, *, tenant: Optional[str] = None,
               k: Optional[int] = None,
               budget: Optional[SearchBudget] = None,
               timeout: Optional[float] = None) -> SearchResult:
        """Synchronous convenience: ``submit`` + wait."""
        return self.submit(queries, tenant=tenant, k=k,
                           budget=budget).result(timeout=timeout)

    # -------------------------------------------------------------- warm --
    def warm(self, tenant: Optional[str] = None,
             k: Optional[int] = None,
             budget: Optional[SearchBudget] = None) -> "ServingLoop":
        """Serve one zero tile on a lane's engine so the first real
        request finds the kernels built and loaded and the allocator
        warm.  Keyed per (tenant, tile, topk, budget) like the pipelined
        plan cache — warming twice is a no-op."""
        t = self._resolve_tenant(tenant)
        key = (t.name, self._tile_of(t), k, budget)
        if self._warmed.get(key):
            return self
        eff = budget if budget is not None else t.budget
        t.engine.warm(self._tile_of(t), k,
                      budget=eff if eff is not None else None)
        self._warmed[key] = True
        return self

    # ------------------------------------------------------------ worker --
    def _run(self):
        while True:
            batch = None
            with self._cond:
                while True:
                    now = self._clock()
                    for lane in self._lanes.values():
                        self._ready.extend(lane.coal.poll(now))
                    if self._ready:
                        batch = self._ready.popleft()
                        break
                    if self._stop:
                        return
                    deadlines = [lane.coal.next_deadline()
                                 for lane in self._lanes.values()]
                    deadlines = [d for d in deadlines if d is not None]
                    timeout = (max(min(deadlines) - now, 0.0)
                               if deadlines else None)
                    self._cond.wait(timeout=timeout)
            self._execute(batch)

    def _execute(self, batch: FlushBatch):
        """Serve one flush tile and route result rows back to each
        request; engine failures fail exactly the requests in the
        flush (the worker survives)."""
        lane_tenant = self.tenants[batch.slices[0].request.tenant]
        topk = batch.slices[0].request.topk
        budget = batch.slices[0].request.budget
        t_flush = self._clock()
        try:
            q = batch.queries()
            if batch.rows < batch.tile:         # pad to the compiled tile
                pad = np.zeros((batch.tile - batch.rows, q.shape[1]),
                               dtype=q.dtype)
                q = np.concatenate([q, pad], axis=0)
            res = lane_tenant.engine.search(q, topk, budget=budget)
            ids = res.indices.cpu().numpy()
            dists = res.distances.cpu().numpy()
        except Exception as e:                  # noqa: BLE001
            for s in batch.slices:
                if not s.request.future.done():
                    s.request.future.set_exception(e)
            return
        self.stats["batches"] += 1
        self.stats["padded_rows"] += batch.tile - batch.rows
        self.stats[f"flush_{batch.reason}"] += 1
        for s in batch.slices:
            req = s.request
            done = req.deliver(
                s.req_start,
                ids[s.batch_start:s.batch_start + s.rows],
                dists[s.batch_start:s.batch_start + s.rows],
                res, batch.fill)
            if not done:
                continue
            r_ids, r_dists, last, fill = req.assemble()
            meta = last.meta
            if meta is not None:
                meta = meta._replace(
                    queue_ms=(t_flush - req.t_submit) * 1000.0,
                    batch_fill=fill)
            req.t_done = self._clock()
            if not req.future.done():
                req.future.set_result(SearchResult(
                    indices=r_ids, distances=r_dists,
                    avg_ops=last.avg_ops, pass_rate=last.pass_rate,
                    meta=meta))
