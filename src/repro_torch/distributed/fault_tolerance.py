"""Fault tolerance (twin of ``repro.distributed.fault_tolerance``):
heartbeat/straggler monitoring and a supervised train-loop wrapper with
checkpoint-restart, with the reference's rules.

  ``HeartbeatMonitor``  — per-host step heartbeats; a host is a straggler
      when its step latency exceeds ``straggler_factor`` x the rolling
      median of the fleet, and dead when silent for ``dead_after`` s.
  ``TrainSupervisor``   — wraps a step function with: auto-resume from
      the newest valid checkpoint, periodic (async) checkpointing, NaN
      step quarantine (the update is dropped), bounded restart attempts
      on injected or real faults, and an ``on_remesh`` hook.

Recovery always funnels through "restore checkpoint -> replay from the
step index".  The rules, kept exactly: a step saves when
``step % save_every == 0 and step > start`` (never the step a run
starts or resumes at), a non-finite ``metrics["loss"]`` drops the
update, a fault restores the newest checkpoint (or, with none, keeps the
current state and restarts at step 0) up to ``max_restarts`` times,
and the final step is always saved.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.distributed.checkpoint import CheckpointManager


class HeartbeatMonitor:
    def __init__(self, num_hosts: int, straggler_factor: float = 3.0,
                 dead_after: float = 300.0, window: int = 32):
        self.num_hosts = num_hosts
        self.straggler_factor = straggler_factor
        self.dead_after = dead_after
        self.window = window
        self._latency: Dict[int, List[float]] = {h: [] for h in range(num_hosts)}
        self._last_seen: Dict[int, float] = {h: time.time() for h in range(num_hosts)}

    def beat(self, host: int, step_latency: float, now: Optional[float] = None):
        now = time.time() if now is None else now
        lat = self._latency[host]
        lat.append(step_latency)
        if len(lat) > self.window:
            del lat[: len(lat) - self.window]
        self._last_seen[host] = now

    def fleet_median(self) -> float:
        all_lat = [l for ls in self._latency.values() for l in ls[-8:]]
        return float(np.median(all_lat)) if all_lat else 0.0

    def stragglers(self) -> List[int]:
        med = self.fleet_median()
        if med <= 0:
            return []
        out = []
        for h, ls in self._latency.items():
            if ls and np.median(ls[-4:]) > self.straggler_factor * med:
                out.append(h)
        return out

    def dead(self, now: Optional[float] = None) -> List[int]:
        now = time.time() if now is None else now
        return [h for h, t in self._last_seen.items()
                if now - t > self.dead_after]


@dataclasses.dataclass
class SupervisorReport:
    final_step: int
    restarts: int
    nan_skips: int
    resumed_from: Optional[int]


class TrainSupervisor:
    """Checkpoint-restart wrapper around a pure step function.

    step_fn(state, step_idx) -> (state, metrics) — metrics must contain
    'loss'.  ``fault_hook(step)`` may raise to simulate node loss (tests).
    """

    def __init__(self, ckpt: CheckpointManager, *, save_every: int = 50,
                 max_restarts: int = 3, async_save: bool = True,
                 on_remesh: Optional[Callable[[], None]] = None):
        self.ckpt = ckpt
        self.save_every = save_every
        self.max_restarts = max_restarts
        self.async_save = async_save
        self.on_remesh = on_remesh

    def run(self, state: Any, step_fn: Callable, num_steps: int, *,
            fault_hook: Optional[Callable[[int], None]] = None
            ) -> "tuple[Any, SupervisorReport]":
        resumed_from, state = self.ckpt.restore_latest(state)
        start = (resumed_from + 1) if resumed_from is not None else 0
        restarts = 0
        nan_skips = 0
        step = start
        while step < num_steps:
            try:
                if fault_hook is not None:
                    fault_hook(step)
                new_state, metrics = step_fn(state, step)
                loss = float(metrics.get("loss", 0.0))
                if not np.isfinite(loss):
                    nan_skips += 1      # quarantine: drop the update
                else:
                    state = new_state
                if step % self.save_every == 0 and step > start:
                    if self.async_save:
                        self.ckpt.save_async(step, state)
                    else:
                        self.ckpt.save(step, state)
                step += 1
            except Exception:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                self.ckpt.wait()
                if self.on_remesh is not None:
                    self.on_remesh()    # elastic: drop dead hosts, re-lower
                prev, state = self.ckpt.restore_latest(state)
                step = (prev + 1) if prev is not None else 0
        self.ckpt.wait()
        self.ckpt.save(num_steps - 1, state)
        return state, SupervisorReport(final_step=num_steps - 1,
                                       restarts=restarts,
                                       nan_skips=nan_skips,
                                       resumed_from=resumed_from)
