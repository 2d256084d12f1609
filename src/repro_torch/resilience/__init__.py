"""The port's resilience layer (twin of ``repro.resilience``):

  ``budget``  ``SearchBudget`` and ``ResultMeta``, the vocabulary of
              deadline-aware degraded search (the ladder runs in
              ``api.serving.AnnEngine``);
  ``retry``   ``retry_with_backoff`` / ``BackoffPolicy``: bounded
              retries with exponential backoff;
  ``faults``  ``FaultInjector``: a seeded, deterministic chaos harness
              that raises, delays or corrupts bytes.

Framework-free copies of the reference's modules (numpy only).
"""
from repro_torch.resilience.budget import (DEGRADE_LEVELS, ResultMeta,
                                           SearchBudget, validate_budget)
from repro_torch.resilience.faults import (FaultInjector, FaultSpec,
                                           InjectedFault)
from repro_torch.resilience.retry import (BackoffPolicy, RetriesExhausted,
                                          retry_with_backoff)

__all__ = [
    "SearchBudget", "ResultMeta", "DEGRADE_LEVELS", "validate_budget",
    "BackoffPolicy", "retry_with_backoff", "RetriesExhausted",
    "FaultInjector", "FaultSpec", "InjectedFault",
]
