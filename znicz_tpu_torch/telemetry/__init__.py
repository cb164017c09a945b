"""Observability for the port's serving and training paths (from the
JAX package's ``telemetry``; stdlib only but the profiler):

* :mod:`registry` — process-wide, thread-safe counters / gauges /
  bounded histograms, with JSON and Prometheus text exposition views.
* :mod:`tracing` — request ids and lightweight spans with monotonic
  timings feeding ``span_duration_ms`` histograms.
* :mod:`compilestats` — compile accounting at every executable-creation
  site; in this package a compile is a CUDA graph's first eager run
  plus its capture (``site="serving.engine"``).
* :mod:`flightrecorder` — bounded rings of recent records (the fused
  loop's ``train_step`` rows) and the per-epoch ``TimelineWriter``.
* :mod:`profiler` — ``torch.profiler`` Chrome traces, whole-run or a
  window every N epochs.

The trace store, status pages and build info of the JAX package come
with the next serving slice.
"""

from .registry import (REGISTRY, Counter, Gauge, Histogram,
                       MetricsRegistry, PROMETHEUS_CONTENT_TYPE)
from .tracing import (Span, accept_request_id, current_request_id,
                      new_request_id, recent_spans, span)

__all__ = ["REGISTRY", "Counter", "Gauge", "Histogram",
           "MetricsRegistry", "PROMETHEUS_CONTENT_TYPE", "Span",
           "accept_request_id", "current_request_id", "new_request_id",
           "recent_spans", "span"]
