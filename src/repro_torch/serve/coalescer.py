"""Query coalescing: the pure state machine under the async serving
loop (twin of ``repro.serve.coalescer``, copied: numpy and the standard
library only; DESIGN.md §14, docs/serving.md).

Arriving single/small-batch requests are queued FIFO *at row
granularity* and assembled into fixed-size flush tiles so one compiled
program shape serves every arrival size:

  - a flush fires the moment ``tile`` rows are pending (**full tile**),
    never waiting out the window;
  - otherwise the oldest pending row may wait at most ``window_s``
    before a **window-expiry** flush ships whatever is queued (padded
    up to the tile by the serving loop);
  - a request larger than the remaining tile capacity is **split**
    across consecutive flushes — each flush records the row spans it
    carries (``FlushSlice``) so the loop can route result rows back to
    the right caller and reassemble them in order.

The class is deliberately *pure*: it never reads a clock or touches a
thread — every method takes ``now`` (seconds, any monotonic origin)
explicitly.  ``ServingLoop`` owns the real clock and the condition
variable; the state-machine tests (tests/test_torch_serve.py) drive a
fake clock through the exact same transitions.

Invariant: after any ``submit`` returns, fewer than ``tile`` rows
remain queued (full tiles are emitted eagerly), so ``poll`` emits at
most one partial flush per expiry and ``flush_all`` at most one batch.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Callable, List, Optional

import numpy as np


class ServeError(RuntimeError):
    """A serving-loop usage or capacity error (never a search failure —
    engine exceptions propagate through the request's future)."""


_rid_counter = itertools.count()


class PendingRequest:
    """One caller's in-flight request: its query rows, routing options,
    and the accumulator the loop fills as flush slices complete."""

    __slots__ = ("rid", "tenant", "queries", "topk", "budget", "t_submit",
                 "future", "t_done", "_rows_done", "_parts", "_fills")

    def __init__(self, tenant: str, queries: np.ndarray,
                 topk: Optional[int], budget, t_submit: float, future):
        self.rid = next(_rid_counter)
        self.tenant = tenant
        self.queries = queries              # (nq, d) float32, host-side
        self.topk = topk
        self.budget = budget
        self.t_submit = t_submit
        self.future = future
        self.t_done: Optional[float] = None
        self._rows_done = 0
        self._parts: List = []              # (req_start, ids, dists, res)
        self._fills: List = []              # (rows, batch_fill) per part

    @property
    def nq(self) -> int:
        return self.queries.shape[0]

    def deliver(self, req_start: int, ids: np.ndarray, dists: np.ndarray,
                result, fill: float) -> bool:
        """Accept one flush slice's result rows; True when the request
        is complete (all parts arrived)."""
        self._parts.append((req_start, ids, dists, result))
        self._fills.append((ids.shape[0], fill))
        self._rows_done += ids.shape[0]
        return self._rows_done >= self.nq

    def assemble(self):
        """(ids, dists, last_part_result, row-weighted mean fill) in
        request-row order — call only once complete."""
        parts = sorted(self._parts, key=lambda p: p[0])
        ids = np.concatenate([p[1] for p in parts], axis=0)
        dists = np.concatenate([p[2] for p in parts], axis=0)
        rows = sum(r for r, _ in self._fills)
        fill = sum(r * f for r, f in self._fills) / max(rows, 1)
        return ids, dists, parts[-1][3], fill


@dataclasses.dataclass(frozen=True)
class FlushSlice:
    """One request's contiguous span inside a flush tile."""
    request: PendingRequest
    req_start: int               # first row of the span in the request
    batch_start: int             # first row of the span in the tile
    rows: int


@dataclasses.dataclass(frozen=True)
class FlushBatch:
    """An assembled flush: the concatenated real query rows (<= tile)
    and the spans that map result rows back to their requests."""
    slices: tuple                # of FlushSlice
    rows: int                    # real rows (tile fill numerator)
    tile: int
    reason: str                  # "full" | "window" | "drain"

    @property
    def fill(self) -> float:
        return self.rows / self.tile

    def queries(self) -> np.ndarray:
        return np.concatenate(
            [s.request.queries[s.req_start:s.req_start + s.rows]
             for s in self.slices], axis=0)


class Coalescer:
    """The per-lane request queue (one lane = one tenant + one static
    (topk, budget) serving configuration; see ``ServingLoop``)."""

    def __init__(self, tile: int, window_s: float):
        if tile < 1:
            raise ServeError(f"coalescer tile must be >= 1, got {tile}")
        if window_s < 0:
            raise ServeError(
                f"coalescer window must be >= 0 s, got {window_s}")
        self.tile = int(tile)
        self.window_s = float(window_s)
        # FIFO of [request, rows_consumed_by_prior_flushes]
        self._queue: deque = deque()
        self._pending_rows = 0
        self._oldest_t: Optional[float] = None   # submit time of queue head

    # ------------------------------------------------------------- state --
    @property
    def pending_rows(self) -> int:
        return self._pending_rows

    @property
    def pending_requests(self) -> int:
        return len(self._queue)

    def next_deadline(self) -> Optional[float]:
        """Absolute time the oldest pending row must flush by (None =
        queue empty)."""
        if self._oldest_t is None:
            return None
        return self._oldest_t + self.window_s

    # ------------------------------------------------------- transitions --
    def submit(self, request: PendingRequest,
               now: float) -> List[FlushBatch]:
        """Enqueue a request; returns the full-tile flushes it
        triggered (possibly several for an oversize burst, possibly
        none)."""
        self._queue.append([request, 0])
        self._pending_rows += request.nq
        if self._oldest_t is None:
            self._oldest_t = now
        flushes = []
        while self._pending_rows >= self.tile:
            flushes.append(self._take(self.tile, "full"))
        return flushes

    def poll(self, now: float) -> List[FlushBatch]:
        """Window-expiry check: flush the (partial) queue if the oldest
        pending row has waited ``window_s``."""
        dl = self.next_deadline()
        if dl is None or now < dl:
            return []
        return [self._take(min(self._pending_rows, self.tile), "window")]

    def flush_all(self) -> List[FlushBatch]:
        """Drain everything pending (loop shutdown) regardless of the
        window."""
        flushes = []
        while self._pending_rows > 0:
            flushes.append(
                self._take(min(self._pending_rows, self.tile), "drain"))
        return flushes

    # ------------------------------------------------------------ packing --
    def _take(self, rows: int, reason: str) -> FlushBatch:
        """Pop ``rows`` queued rows FIFO into one flush, splitting the
        request at the boundary if it does not fit whole."""
        slices, taken = [], 0
        while taken < rows:
            entry = self._queue[0]
            req, consumed = entry
            span = min(req.nq - consumed, rows - taken)
            slices.append(FlushSlice(request=req, req_start=consumed,
                                     batch_start=taken, rows=span))
            taken += span
            entry[1] += span
            if entry[1] >= req.nq:
                self._queue.popleft()
        self._pending_rows -= rows
        # the window re-arms from the new head's submit time; a split
        # head keeps its original arrival time (its rows are oldest)
        self._oldest_t = (self._queue[0][0].t_submit if self._queue
                          else None)
        return FlushBatch(slices=tuple(slices), rows=rows, tile=self.tile,
                          reason=reason)
