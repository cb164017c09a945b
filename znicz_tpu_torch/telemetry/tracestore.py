"""Tail-sampled trace store + cross-hop trace assembly (a copy of the JAX
package's ``telemetry/tracestore.py``, stdlib only).

:mod:`znicz_tpu_torch.telemetry.tracing` correlates spans inside ONE
process; a fleet request crosses two (``route → serve``) and its
latency story splits into two unjoinable halves.  This module is the
join:

* the **router** (the fleet tier, not ported yet) stamps a ``traceparent``-style context
  (``X-Znicz-Trace``, see :func:`tracing.format_traceparent`) on every
  forwarded request;
* the **backend** tags its span tree with that context and returns a
  compact span summary in-band on the response — the
  ``X-Znicz-Spans`` header for small trees, spilling into the binary
  wire trailer (:func:`znicz_tpu_torch.serving.wire.append_trailer`) for
  large ones;
* the router then **assembles** the hop-level trace
  (:func:`assemble`): the seven canonical stages in :data:`STAGES`
  with per-stage wall ms computed from span *gaps*, each side's gaps
  on its OWN monotonic clock (cross-machine stamp subtraction would
  import clock skew into every number).

Retention is **tail-based** (:class:`TraceStore`): every
error/shed/deadline trace is kept unconditionally, the slowest
fraction per tenant is kept as the tail, and the healthy bulk is
head-sampled at a configurable (deterministic — no RNG on the request
path) rate.  ``GET /tracez`` serves :meth:`TraceStore.snapshot`;
``trace_stage_ms{stage}`` makes "where did p99 go" a ``/metrics``
scrape; histogram exemplars (``observe_with_exemplar``) link latency
buckets back to concrete trace ids.
"""

from __future__ import annotations

import collections
import json
import threading

from . import tracing
from .registry import REGISTRY

#: the canonical hop-level stage names, in request order — the single
#: registration site the docs inventory and the zlint span-name-drift
#: rule check against.  ``router.recv`` / ``net.hop`` / ``batcher.wait``
#: are COMPUTED stages (span gaps), the rest are measured spans.
STAGES = ("router.recv", "router.pick_backend", "net.hop",
          "server.predict", "batcher.wait", "engine.forward",
          "server.encode")

#: request header carrying the traceparent-style context hop-to-hop
TRACE_HEADER = "X-Znicz-Trace"
#: response header carrying the backend's compact span summary
SPANS_HEADER = "X-Znicz-Spans"
#: largest summary the header form carries; bigger trees spill into
#: the binary wire trailer (or are pruned to the stage spans for JSON
#: responses — an over-long header would blow the client's header
#: buffer, which is worse than a truncated trace)
MAX_HEADER_BYTES = 1800

_stage_hist = REGISTRY.histogram(
    "trace_stage_ms",
    "assembled cross-hop trace stage wall time (router.recv / "
    "router.pick_backend / net.hop / server.predict / batcher.wait / "
    "engine.forward / server.encode), milliseconds")
_retained = REGISTRY.counter(
    "traces_retained_total",
    "traces kept by the tail-sampling store, by reason (error / shed / "
    "deadline / tail / head)")
_dropped = REGISTRY.counter(
    "traces_dropped_total",
    "traces sampled out by the store, by reason")
_exemplars_total = REGISTRY.counter(
    "trace_exemplars_total",
    "histogram observations that attached a trace-id exemplar, by "
    "metric family")


def observe_exemplar(hist, value_ms: float, ctx, **labels) -> None:
    """Observe into ``hist``; when ``ctx`` is a SAMPLED trace context,
    attach its trace id as the bucket exemplar (and count the
    attachment)."""
    if ctx is not None and getattr(ctx, "sampled", False):
        hist.observe(value_ms, exemplar=ctx.trace_id, **labels)
        _exemplars_total.inc(metric=hist.name)
    else:
        hist.observe(value_ms, **labels)


def observe_with_exemplar(hist, value_ms: float, **labels) -> None:
    """:func:`observe_exemplar` against the CURRENT context's trace."""
    observe_exemplar(hist, value_ms, tracing.current_trace(), **labels)


# -- backend side: compact span summary export ---------------------------

def export_spans(spans, server_predict_ms: float | None = None) -> dict:
    """The backend's in-band span summary: every finished span as
    ``{"n": name, "d": duration_ms, "s": status}`` (plus ``"q"`` for
    the batcher's queue wait), and — because the ``server.predict``
    span is still OPEN when the response is written — a synthetic
    entry for it from ``server_predict_ms`` (now − handler t0, the
    caller's monotonic gap)."""
    out = []
    for sp in spans:
        d = {"n": sp.name,
             "d": round(sp.duration_ms, 3)
             if sp.duration_ms is not None else None,
             "s": sp.status}
        qw = sp.attrs.get("queue_wait_ms")
        if qw is not None:
            d["q"] = round(float(qw), 3)
        out.append(d)
    if server_predict_ms is not None:
        out.append({"n": "server.predict",
                    "d": round(float(server_predict_ms), 3), "s": "ok"})
    return {"v": 1, "spans": out}


def encode_summary(summary: dict) -> bytes:
    return json.dumps(summary, separators=(",", ":")).encode()


def prune_summary(summary: dict) -> dict:
    """Shrink an over-long summary to the spans the stage split needs
    (bounded loss: the assembled trace keeps its seven stages, only
    the long per-span tail is dropped)."""
    keep = {"server.predict", "batcher.dispatch", "engine.forward",
            "server.encode"}
    return {"v": summary.get("v", 1),
            "truncated": True,
            "spans": [s for s in summary.get("spans", ())
                      if s.get("n") in keep][-8:]}


def decode_summary(raw) -> dict | None:
    """Parse a summary from header text or trailer bytes; ``None`` for
    anything malformed (a hostile or torn summary must not fail the
    response it rode in on)."""
    if not raw:
        return None
    try:
        if isinstance(raw, (bytes, bytearray)):
            raw = raw.decode("utf-8", "replace")
        summary = json.loads(raw)
    except (ValueError, UnicodeDecodeError):
        return None
    if not isinstance(summary, dict):
        return None
    # two legitimate shapes ride this channel: a backend's raw span
    # list, or a router's already-assembled per-stage split
    if not isinstance(summary.get("spans"), list) and \
            not isinstance(summary.get("stages"), dict):
        return None
    return summary


# -- router side: hop-level assembly -------------------------------------

def _span_ms(summary: dict, name: str) -> float | None:
    for sp in summary.get("spans", ()):
        if sp.get("n") == name and isinstance(sp.get("d"), (int, float)):
            return float(sp["d"])
    return None


def _queue_wait_ms(summary: dict) -> float | None:
    for sp in summary.get("spans", ()):
        if sp.get("n") == "batcher.dispatch" and \
                isinstance(sp.get("q"), (int, float)):
            return float(sp["q"])
    return None


def assemble(*, trace_id: str, request_id: str | None, model: str,
             backend: str, outcome: str, total_ms: float,
             pick_ms: float, forward_ms: float | None,
             summary: dict | None, started_at: float) -> dict:
    """Join the router's measured gaps with the backend's span summary
    into one seven-stage trace.  Every stage is a DURATION measured on
    one process's monotonic clock; the split stages are gaps between
    durations, clamped at zero (a gap can go slightly negative when
    the two clocks tick between reads — a clamp is honest, a negative
    millisecond is not).

    * ``router.recv``        = total − pick − forward (router overhead)
    * ``router.pick_backend`` = the pick_for call
    * ``net.hop``            = forward wall − backend server.predict
    * ``server.predict``     = backend total − queue − device − encode
    * ``batcher.wait``       = the batcher's measured queue wait
    * ``engine.forward``     = the device span
    * ``server.encode``      = the serialize span
    """
    stages: dict = dict.fromkeys(STAGES)
    pick = max(0.0, float(pick_ms))
    stages["router.pick_backend"] = round(pick, 3)
    if forward_ms is None:                 # never reached a backend
        stages["router.recv"] = round(max(0.0, total_ms - pick), 3)
    else:
        fwd = max(0.0, float(forward_ms))
        stages["router.recv"] = round(
            max(0.0, total_ms - pick - fwd), 3)
        spd = _span_ms(summary, "server.predict") if summary else None
        if spd is None:
            stages["net.hop"] = round(fwd, 3)
        else:
            stages["net.hop"] = round(max(0.0, fwd - spd), 3)
            bw = _queue_wait_ms(summary) or 0.0
            ef = _span_ms(summary, "engine.forward") or 0.0
            se = _span_ms(summary, "server.encode") or 0.0
            stages["batcher.wait"] = round(bw, 3)
            stages["engine.forward"] = round(ef, 3)
            stages["server.encode"] = round(se, 3)
            stages["server.predict"] = round(
                max(0.0, spd - bw - ef - se), 3)
    trace = {"trace_id": trace_id, "request_id": request_id,
             "model": model, "backend": backend, "outcome": outcome,
             "total_ms": round(float(total_ms), 3),
             "at": started_at, "stages": stages}
    if summary and summary.get("truncated"):
        trace["truncated"] = True
    return trace


def observe_stages(trace: dict) -> None:
    """Feed each present stage into ``trace_stage_ms{stage=...}``."""
    for name, ms in (trace.get("stages") or {}).items():
        if ms is not None:
            _stage_hist.observe(ms, stage=name)


# -- the bounded tail-sampling store --------------------------------------

class TraceStore:
    """Bounded assembled-trace retention with a tail-first policy:

    * outcome ``error`` / ``shed`` / ``deadline`` → ALWAYS retained
      (their own ring, so a healthy-traffic flood cannot evict them);
    * the slowest ``tail_fraction`` per tenant → retained as ``tail``
      (threshold from a sliding window of that tenant's totals);
    * the rest → deterministic head sampling at ``head_rate`` (every
      k-th healthy trace; no RNG on the request path).
    """

    def __init__(self, capacity: int = 512, error_capacity: int = 512,
                 tail_fraction: float = 0.05, head_rate: float = 0.05,
                 window: int = 256):
        self.tail_fraction = min(1.0, max(0.0, float(tail_fraction)))
        self.head_rate = min(1.0, max(0.0, float(head_rate)))
        self._lock = threading.Lock()
        self._traces: collections.deque = collections.deque(
            maxlen=max(1, int(capacity)))
        self._errors: collections.deque = collections.deque(
            maxlen=max(1, int(error_capacity)))
        self._windows: dict[str, collections.deque] = {}
        self._window = max(16, int(window))
        self._healthy_seen = 0

    def _tail_threshold(self, model: str) -> float | None:
        """The current p(1 − tail_fraction) of this tenant's recent
        totals — None until the window has enough mass to mean
        anything (an empty window keeping everything would defeat
        sampling exactly when traffic starts)."""
        win = self._windows.get(model)
        if not win or len(win) < 16 or self.tail_fraction <= 0.0:
            return None
        ordered = sorted(win)
        idx = min(len(ordered) - 1,
                  int(len(ordered) * (1.0 - self.tail_fraction)))
        return ordered[idx]

    def record(self, trace: dict) -> str | None:
        """Apply the retention policy; returns the retention reason
        (``error``/``shed``/``deadline``/``tail``/``head``) or None
        when sampled out."""
        outcome = str(trace.get("outcome") or "ok")
        model = str(trace.get("model") or "default")
        total = float(trace.get("total_ms") or 0.0)
        with self._lock:
            if outcome != "ok":
                reason = outcome if outcome in ("shed", "deadline") \
                    else "error"
                trace = dict(trace, retained=reason)
                self._errors.append(trace)
                _retained.inc(reason=reason)
                return reason
            threshold = self._tail_threshold(model)
            win = self._windows.setdefault(
                model, collections.deque(maxlen=self._window))
            win.append(total)
            if threshold is not None and total >= threshold:
                trace = dict(trace, retained="tail")
                self._traces.append(trace)
                _retained.inc(reason="tail")
                return "tail"
            self._healthy_seen += 1
            stride = (0 if self.head_rate <= 0.0
                      else max(1, round(1.0 / self.head_rate)))
            if stride and self._healthy_seen % stride == 0:
                trace = dict(trace, retained="head")
                self._traces.append(trace)
                _retained.inc(reason="head")
                return "head"
            _dropped.inc(reason="sampled_out")
            return None

    def snapshot(self, model: str | None = None,
                 min_ms: float | None = None,
                 outcome: str | None = None, n: int = 64) -> dict:
        """Newest-first filtered view (the ``/tracez`` body)."""
        with self._lock:
            traces = list(self._errors) + list(self._traces)
        if model is not None:
            traces = [t for t in traces if t.get("model") == model]
        if outcome is not None:
            traces = [t for t in traces if t.get("outcome") == outcome]
        if min_ms is not None:
            traces = [t for t in traces
                      if float(t.get("total_ms") or 0.0) >= min_ms]
        traces.sort(key=lambda t: float(t.get("at") or 0.0),
                    reverse=True)
        return {"retained": len(traces),
                "stages": list(STAGES),
                "traces": traces[:max(1, int(n))]}

    def stats(self) -> dict:
        with self._lock:
            return {"stored": len(self._traces),
                    "errors": len(self._errors),
                    "healthy_seen": self._healthy_seen,
                    "head_rate": self.head_rate,
                    "tail_fraction": self.tail_fraction}
