"""Search budgets and result metadata (the port's copy of
``repro.resilience.budget``).  Retry and fault injection wait for the
resilience slice."""
from repro_torch.resilience.budget import (DEGRADE_LEVELS, ResultMeta,
                                           SearchBudget, validate_budget)

__all__ = ["SearchBudget", "ResultMeta", "DEGRADE_LEVELS", "validate_budget"]
