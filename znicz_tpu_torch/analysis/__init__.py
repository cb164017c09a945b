"""znicz_tpu_torch.analysis — "zlint", the AST-based static analyzer of
the port (a port of ``znicz_tpu/analysis``; it imports nothing of it).

Rule families over the port's threaded and captured surfaces (serving,
resilience, telemetry, the CUDA-graph steps):

* ``lock-discipline`` — lock-guarded attributes accessed outside the
  lock (:mod:`.locks`);
* ``graph-host-sync`` / ``graph-tensor-branch`` — host syncs and Python
  branches on tensors inside captured CUDA-graph steps, plus
  ``unseeded-random`` for global-RNG draws, torch's global generator
  included (:mod:`.torchrules`, in the place of the reference's
  ``jaxrules``);
* ``handler-blocking`` — blocking calls on HTTP-handler and
  dispatch-thread paths (:mod:`.handlers`);
* ``metric-drift`` — metric names out of sync between code,
  docs/observability.md and tools/metrics_smoke.sh
  (:mod:`.metric_drift`);
* ``span-name-drift`` — span/stage names out of sync between code and
  docs/observability.md (:mod:`.span_drift`);
* ``duration-clock`` — durations computed from the wall clock
  (``time.time()`` arithmetic) instead of ``time.monotonic()`` /
  ``perf_counter`` (:mod:`.clocks`);
* ``deadline-discipline`` — unbounded blocking waits on the walked
  package's serving, resilience, fleet and online paths
  (:mod:`.deadlines`);
* ``lock-order-cycle`` / ``lock-leak`` / ``condition-wait-predicate``
  — the zsan static layer (:mod:`.concurrency`; runtime twin:
  :mod:`znicz_tpu_torch.sanitizer`);
* ``retry-after-discipline`` — 429/503/504 refusals in serving/ +
  fleet/ without a ``Retry-After`` header (:mod:`.retry_after`).

Run it: ``python -m znicz_tpu_torch lint``; gate: ``pytest -m lint
tests/test_torch_analysis.py``.  Suppress: ``# zlint: disable=RULE``
inline, or a justified entry in
``znicz_tpu_torch/analysis/zlint_baseline.json``.  ``Analyzer(...,
package="znicz_tpu")`` walks the reference instead, where the shared
rules give the reference's findings.
"""

from .clocks import DurationClockRule
from .concurrency import (ConditionWaitPredicateRule, LockLeakRule,
                          LockOrderCycleRule)
from .core import (Analyzer, Finding, ModuleInfo, RepoRule, Rule,
                   load_baseline, write_baseline)
from .cli import changed_paths, default_rules, main, run_repo, shared_rules
from .deadlines import DeadlineDisciplineRule
from .handlers import HandlerSafetyRule
from .locks import LockDisciplineRule
from .metric_drift import MetricDriftRule
from .retry_after import RetryAfterRule
from .span_drift import SpanNameDriftRule
from .torchrules import GraphHygieneRule, UnseededRandomRule, find_captured

__all__ = [
    "Analyzer", "Finding", "ModuleInfo", "Rule", "RepoRule",
    "load_baseline", "write_baseline", "default_rules", "shared_rules",
    "run_repo", "changed_paths", "main", "LockDisciplineRule",
    "GraphHygieneRule", "UnseededRandomRule", "find_captured",
    "HandlerSafetyRule", "MetricDriftRule", "DurationClockRule",
    "DeadlineDisciplineRule", "SpanNameDriftRule", "LockOrderCycleRule",
    "LockLeakRule", "ConditionWaitPredicateRule", "RetryAfterRule",
]
