"""Bounded retries with exponential backoff (the port's copy of
``repro.resilience.retry``, which is framework-free).

The one retry policy of the stack: the serving engine retries a failed
batch in place through this (``api.serving.AnnEngine``), and anything
else that faces transient faults (flaky storage, injected chaos) can
reuse it.  ``sleep`` is injectable so tests assert the exact backoff
schedule without waiting for it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Tuple, Type


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """Exponential backoff: attempt ``i`` (0-based) sleeps
    ``min(base_ms * multiplier**i, max_ms)`` before retrying; after
    ``max_retries`` failed retries the last error propagates
    (``max_retries=0`` = no retries: one attempt, fail fast)."""
    max_retries: int = 2
    base_ms: float = 10.0
    max_ms: float = 1000.0
    multiplier: float = 2.0

    def delay_ms(self, attempt: int) -> float:
        return min(self.base_ms * self.multiplier ** attempt, self.max_ms)


class RetriesExhausted(RuntimeError):
    """All retry attempts failed; ``__cause__`` is the last error."""


def retry_with_backoff(fn: Callable, *,
                       policy: BackoffPolicy = BackoffPolicy(),
                       retryable: Tuple[Type[BaseException], ...] = (Exception,),
                       sleep: Callable[[float], None] = time.sleep,
                       on_retry: Optional[Callable] = None):
    """Call ``fn()`` with up to ``policy.max_retries`` retries.

    Backoff sleeps run *between* attempts (seconds, from the policy's
    millisecond schedule).  ``on_retry(attempt, error, delay_ms)`` is
    invoked before each sleep — the engine uses it to count retries.
    Raises ``RetriesExhausted`` (chaining the last error) once the
    budget is spent; non-``retryable`` errors propagate immediately.
    """
    attempt = 0
    while True:
        try:
            return fn()
        except retryable as e:
            if attempt >= policy.max_retries:
                raise RetriesExhausted(
                    f"{attempt + 1} attempt(s) failed; last error: "
                    f"{type(e).__name__}: {e}") from e
            delay = policy.delay_ms(attempt)
            if on_retry is not None:
                on_retry(attempt, e, delay)
            sleep(delay / 1000.0)
            attempt += 1
