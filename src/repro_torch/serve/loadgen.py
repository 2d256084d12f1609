"""Poisson load generation and latency measurement for the serving
loop (twin of ``repro.serve.loadgen``, copied: numpy and the standard
library only).

Everything random is seeded: arrival gaps, tenant choice, request
sizes, and query-row picks all come from one ``numpy`` generator, so
the same seed replays the same request stream row-for-row
(tests/test_torch_serve.py holds it).  Latency is wall-clock and never
part of that contract — ``summarize`` keeps timing and content fields
separate.

Two drivers:

  - ``run_open_loop``: arrivals fire on the Poisson schedule whether or
    not earlier requests finished (open-loop, the honest way to measure
    a queueing system — closed-loop drivers self-throttle and hide
    queueing delay);
  - ``run_closed_loop``: ``concurrency`` workers submit back-to-back,
    measuring saturated throughput rather than latency under a rate.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class RequestSpec:
    """One scheduled request of a generated workload."""
    t_arrival: float             # seconds from workload start
    tenant: str
    queries: np.ndarray          # (nq, d) float32


def poisson_arrivals(rate_hz: float, duration_s: float, *,
                     rng: np.random.Generator) -> np.ndarray:
    """Arrival times (seconds, sorted) of a Poisson process: i.i.d.
    exponential gaps at ``rate_hz``, truncated at ``duration_s``."""
    if rate_hz <= 0:
        raise ValueError(f"rate_hz must be > 0, got {rate_hz}")
    # draw in chunks until past the horizon; E[n] = rate * duration
    gaps: List[np.ndarray] = []
    total = 0.0
    while total < duration_s:
        chunk = rng.exponential(1.0 / rate_hz,
                                size=max(int(rate_hz * duration_s) + 1, 16))
        gaps.append(chunk)
        total += float(chunk.sum())
    times = np.cumsum(np.concatenate(gaps))
    return times[times < duration_s]


def make_workload(query_pools: Dict[str, np.ndarray], rate_hz: float,
                  duration_s: float, *, rng: np.random.Generator,
                  rows_choices: Sequence[int] = (1, 2, 4)) -> List[RequestSpec]:
    """A seeded Poisson request stream over ``query_pools``
    (tenant name -> (n, d) candidate query rows).  Tenants are drawn
    uniformly **in sorted-name order** so the stream is identical for
    the same seed regardless of dict insertion order."""
    names = sorted(query_pools)
    if not names:
        raise ValueError("make_workload needs at least one tenant pool")
    out: List[RequestSpec] = []
    for t in poisson_arrivals(rate_hz, duration_s, rng=rng):
        name = names[int(rng.integers(len(names)))]
        pool = query_pools[name]
        nq = int(rows_choices[int(rng.integers(len(rows_choices)))])
        rows = rng.integers(pool.shape[0], size=nq)
        out.append(RequestSpec(
            t_arrival=float(t), tenant=name,
            queries=np.asarray(pool[rows], dtype=np.float32)))
    return out


def _record(spec: RequestSpec, t_submit: float, t_done: float, result):
    meta = result.meta
    return {
        "tenant": spec.tenant,
        "nq": int(spec.queries.shape[0]),
        "latency_ms": (t_done - t_submit) * 1000.0,
        "queue_ms": None if meta is None else meta.queue_ms,
        "batch_fill": None if meta is None else meta.batch_fill,
        "degraded": bool(meta.degraded) if meta is not None else False,
        "level_name": meta.level_name if meta is not None else "",
        "ids": np.asarray(result.indices),
        "dists": np.asarray(result.distances),
    }


def run_open_loop(loop, workload: Sequence[RequestSpec], *,
                  clock=time.monotonic, sleep=time.sleep,
                  timeout_s: float = 120.0) -> List[dict]:
    """Fire the workload on its Poisson schedule against a *started*
    ``ServingLoop``; returns one record per request (workload order)
    with end-to-end latency and the delivered rows."""
    entries = []               # (spec, t_submit, future)
    t0 = clock()
    for spec in workload:
        delay = spec.t_arrival - (clock() - t0)
        if delay > 0:
            sleep(delay)
        t_submit = clock()
        done_times: List[float] = []
        fut = loop.submit(spec.queries, tenant=spec.tenant)
        fut.add_done_callback(
            lambda _f, _c=clock, _d=done_times: _d.append(_c()))
        entries.append((spec, t_submit, fut, done_times))
    records = []
    for spec, t_submit, fut, done_times in entries:
        res = fut.result(timeout=timeout_s)
        t_done = done_times[0] if done_times else clock()
        records.append(_record(spec, t_submit, t_done, res))
    return records


def run_closed_loop(loop, workload: Sequence[RequestSpec], *,
                    concurrency: int = 4, clock=time.monotonic,
                    timeout_s: float = 120.0) -> List[dict]:
    """Back-to-back driver: ``concurrency`` workers each keep one
    request in flight (arrival times ignored).  Records keep workload
    order."""
    records: List[Optional[dict]] = [None] * len(workload)
    next_i = [0]
    lock = threading.Lock()

    def worker():
        while True:
            with lock:
                i = next_i[0]
                if i >= len(workload):
                    return
                next_i[0] += 1
            spec = workload[i]
            t_submit = clock()
            res = loop.submit(spec.queries,
                              tenant=spec.tenant).result(timeout=timeout_s)
            records[i] = _record(spec, t_submit, clock(), res)

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(max(1, int(concurrency)))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return [r for r in records if r is not None]


def summarize(records: Sequence[dict], *, wall_s: float) -> dict:
    """Latency/throughput digest of one run: p50/p99 end-to-end
    latency, rows/requests per second over ``wall_s``, degraded-response
    rate, and mean coalescing stats.  Content (ids) is NOT summarized
    here — the bitwise gate compares rows directly."""
    if not records:
        return {"requests": 0, "rows": 0, "p50_ms": None, "p99_ms": None,
                "qps": 0.0, "rows_per_s": 0.0, "degraded_rate": 0.0,
                "mean_queue_ms": None, "mean_batch_fill": None}
    lat = np.asarray([r["latency_ms"] for r in records], dtype=np.float64)
    rows = int(sum(r["nq"] for r in records))
    queue = [r["queue_ms"] for r in records if r["queue_ms"] is not None]
    fill = [r["batch_fill"] for r in records if r["batch_fill"] is not None]
    return {
        "requests": len(records),
        "rows": rows,
        "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)),
        "qps": len(records) / wall_s if wall_s > 0 else 0.0,
        "rows_per_s": rows / wall_s if wall_s > 0 else 0.0,
        "degraded_rate": float(np.mean([r["degraded"] for r in records])),
        "mean_queue_ms": float(np.mean(queue)) if queue else None,
        "mean_batch_fill": float(np.mean(fill)) if fill else None,
    }
