"""Fault injection, retry/backoff, circuit breaking and overload
defense for the port's serving path (copied from the JAX package's
``resilience``, stdlib only; its chaos drills are not ported):

* :mod:`faults`  — seeded deterministic fault injection at named sites
  (``engine.forward``, ``batcher.dispatch``, ``artifact.bitflip``),
  activated per process or via ``$ZNICZ_FAULT_PLAN``.
* :mod:`retry`   — bounded attempts, exponential backoff + jitter,
  per-attempt timeout, transient-vs-deterministic classifier.
* :mod:`breaker` — circuit breaker (closed→open→half_open→closed) with
  :class:`~breaker.EngineUnavailable` carrying Retry-After.
* :mod:`overload` — deadlines, the process-wide retry budget, hedging
  policy and the CoDel shed ladder the batcher admits through.
"""

from .breaker import CircuitBreaker, EngineUnavailable
from .faults import FaultInjected, FaultPlan, FaultSpec, inject
from .overload import (CoDelShedder, Deadline, DeadlineExceeded,
                       DoomedDeadline, Draining, EarlyReject,
                       HedgePolicy, RetryBudget, Shed)
from .retry import AttemptTimeout, RetryPolicy, default_transient

__all__ = ["AttemptTimeout", "CircuitBreaker", "CoDelShedder",
           "Deadline", "DeadlineExceeded", "DoomedDeadline",
           "Draining", "EarlyReject", "EngineUnavailable",
           "FaultInjected", "FaultPlan", "FaultSpec", "HedgePolicy",
           "RetryBudget", "RetryPolicy", "Shed", "default_transient",
           "inject"]
