"""Deterministic fault injection (the port's copy of
``repro.resilience.faults``, which is framework-free; the kernel hook
installs on ``repro_torch.kernels.ops``).

``FaultInjector`` is a *seeded* chaos harness: every probabilistic
decision comes from one ``np.random.default_rng(seed)`` stream, so a
fixed seed + a fixed call sequence reproduces the exact same faults —
the property that lets the chaos tests assert specific failover paths
instead of flaking.

Stages are plain strings (``"kernels.batched_crude_topk"``,
``"engine.search"``, ``"artifacts.save"`` …).  A spec's ``targets``
tuple selects stages by prefix (empty = all).  Three fault modes, drawn
independently per ``check``:

  raise     raise ``InjectedFault`` (simulated kernel/node failure)
  delay     sleep ``delay_ms`` (simulated straggler / slow device)
  corrupt   arm byte corruption: the *next* ``corrupt_bytes`` /
            ``corrupt_array`` call flips deterministic bytes (simulated
            bit rot; artifact tests feed saved tensors through it)

Install points:

  - ``repro_torch.kernels.ops`` calls the module hook at every public
    kernel entry — ``injector.install_kernels()`` /
    ``uninstall_kernels()`` (or the ``installed()`` context manager)
    attach the injector there.  PyTorch runs eagerly, so every batch
    re-enters the hook.
  - ``AnnEngine(fault_injector=...)`` checks ``engine.search`` before
    each attempt of a batch.
  - ``injector.wrap(stage, fn)`` wraps any callable.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Tuple

import numpy as np


class InjectedFault(RuntimeError):
    """A fault raised by ``FaultInjector`` (never by real code paths)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Per-stage fault probabilities.  ``targets`` are stage-name
    prefixes (empty tuple = every stage)."""
    p_raise: float = 0.0
    p_delay: float = 0.0
    p_corrupt: float = 0.0
    delay_ms: float = 1.0
    targets: Tuple[str, ...] = ()

    def __post_init__(self):
        for name in ("p_raise", "p_delay", "p_corrupt"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"FaultSpec.{name}={p} outside [0, 1]")


class FaultInjector:
    """Seeded, deterministic fault source.  See the module docstring.

    ``counts`` tallies injected faults per ``"stage:mode"`` so tests
    and the chaos benchmark can report what actually fired."""

    def __init__(self, seed: int, spec: FaultSpec = FaultSpec(), *,
                 sleep=time.sleep):
        self.spec = spec
        self._rng = np.random.default_rng(seed)
        self._sleep = sleep
        self._corrupt_armed = False
        self.counts: Dict[str, int] = {}

    # ------------------------------------------------------------ check --
    def matches(self, stage: str) -> bool:
        t = self.spec.targets
        return not t or any(stage.startswith(p) for p in t)

    def check(self, stage: str) -> None:
        """Draw this stage's fate: maybe raise, maybe delay, maybe arm
        corruption.  Call at stage entry.  Deterministic in (seed, call
        sequence)."""
        if not self.matches(stage):
            return
        u_raise, u_delay, u_corrupt = self._rng.random(3)
        if self.spec.p_corrupt > 0.0 and u_corrupt < self.spec.p_corrupt:
            self._corrupt_armed = True
            self._count(stage, "corrupt")
        if self.spec.p_delay > 0.0 and u_delay < self.spec.p_delay:
            self._count(stage, "delay")
            self._sleep(self.spec.delay_ms / 1000.0)
        if self.spec.p_raise > 0.0 and u_raise < self.spec.p_raise:
            self._count(stage, "raise")
            raise InjectedFault(f"injected fault at stage {stage!r}")

    def _count(self, stage: str, mode: str) -> None:
        key = f"{stage}:{mode}"
        self.counts[key] = self.counts.get(key, 0) + 1

    @property
    def total_faults(self) -> int:
        return sum(self.counts.values())

    # -------------------------------------------------------- corruption --
    def corrupt_bytes(self, data: bytes, n_flips: int = 8) -> bytes:
        """Flip ``n_flips`` deterministic bytes of ``data`` (always
        corrupts — probability gating happens in ``check``)."""
        if not data:
            return data
        buf = bytearray(data)
        pos = self._rng.integers(0, len(buf), size=min(n_flips, len(buf)))
        for p in pos:
            buf[p] ^= 0xFF
        return bytes(buf)

    def corrupt_array(self, a: np.ndarray, n_flips: int = 8) -> np.ndarray:
        """A byte-flipped copy of ``a`` (same dtype/shape — the kind of
        corruption only checksums catch)."""
        a = np.ascontiguousarray(a)
        raw = self.corrupt_bytes(a.tobytes(), n_flips)
        return np.frombuffer(raw, dtype=a.dtype).reshape(a.shape).copy()

    def maybe_corrupt_array(self, a: np.ndarray) -> np.ndarray:
        """Corrupt ``a`` iff a prior ``check`` armed corruption (then
        disarm).  Lets wrapped stages corrupt their own outputs."""
        if not self._corrupt_armed:
            return a
        self._corrupt_armed = False
        return self.corrupt_array(a)

    # ------------------------------------------------------------- wraps --
    def wrap(self, stage: str, fn):
        """Wrap ``fn``: every call runs ``check(stage)`` first; ndarray
        returns pass through ``maybe_corrupt_array``."""
        def wrapped(*args, **kwargs):
            self.check(stage)
            out = fn(*args, **kwargs)
            if isinstance(out, np.ndarray):
                return self.maybe_corrupt_array(out)
            return out
        return wrapped

    def install_kernels(self):
        """Attach ``check`` to every ``repro_torch.kernels.ops`` entry
        point.
        Returns the previously installed hook (restore it via
        ``uninstall_kernels(prev)``)."""
        from repro_torch.kernels import ops
        return ops.set_fault_hook(self.check)

    @staticmethod
    def uninstall_kernels(prev=None):
        from repro_torch.kernels import ops
        ops.set_fault_hook(prev)

    @contextlib.contextmanager
    def installed(self):
        """``with injector.installed():`` — kernel hook attached for the
        block, previous hook restored after."""
        prev = self.install_kernels()
        try:
            yield self
        finally:
            self.uninstall_kernels(prev)
