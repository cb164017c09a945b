"""Observability for the port's serving path (copied from the JAX
package's ``telemetry``, stdlib only):

* :mod:`registry` — process-wide, thread-safe counters / gauges /
  bounded histograms, with JSON and Prometheus text exposition views.
* :mod:`tracing` — request ids and lightweight spans with monotonic
  timings feeding ``span_duration_ms`` histograms.
* :mod:`compilestats` — compile accounting at every executable-creation
  site; in this package a compile is a CUDA graph's first eager run
  plus its capture (``site="serving.engine"``).

The flight recorder, trace store, status pages, build info and profiler
of the JAX package come with the next serving slice.
"""

from .registry import (REGISTRY, Counter, Gauge, Histogram,
                       MetricsRegistry, PROMETHEUS_CONTENT_TYPE)
from .tracing import (Span, accept_request_id, current_request_id,
                      new_request_id, recent_spans, span)

__all__ = ["REGISTRY", "Counter", "Gauge", "Histogram",
           "MetricsRegistry", "PROMETHEUS_CONTENT_TYPE", "Span",
           "accept_request_id", "current_request_id", "new_request_id",
           "recent_spans", "span"]
