"""Flight recorder: bounded ring of recent request / train-step records
(a copy of the JAX package's ``telemetry/flightrecorder.py``, stdlib
only, on the port's ``telemetry/registry.py``).

``predict_latency_ms`` aggregates hide exactly the things an operator
debugging a live replica needs: WHICH request was slow, what stage
burned the time, what shape it carried, what the error actually said.
The flight recorder keeps the full per-event record for a bounded
recent window — like an aircraft FDR, it is always on, cheap, and
survives being read (scraped) without unbounded growth:

* **recent ring** — the last ``capacity`` records of any kind, newest
  last (a deque: overflow drops the oldest, never blocks a recorder);
* **slow ring** — records whose ``duration_ms`` cleared
  ``slow_threshold_ms`` are ALSO retained in their own bounded ring,
  so a burst of fast traffic cannot flush the one outlier you are
  hunting out of the window;
* **error ring** — the last ``error_capacity`` records that failed,
  with the traceback text when the recorder was given one.

Records are plain dicts (JSON-able by construction — ``/debug/
flightrecorder`` serves ``snapshot()`` verbatim).  A request record
carries the request id, HTTP code, input shape/rows, the span tree the
request touched (``server.predict`` → ``batcher.dispatch`` →
``engine.forward``, plus ``compile`` when it paid for one) and the
stage breakdown derived from it; a train-step record carries the
host-vs-device wall split the MFU work needs.

Lock discipline: every ring mutation AND read happens under one lock;
``snapshot`` copies out under the lock and serializes outside it, so a
scrape never races a recorder into torn state.

Memory is bounded by construction: three fixed-size deques of dicts;
the JAX package's 10k-request hammer test pins it.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time

from .registry import REGISTRY

#: spans whose durations make up the request stage breakdown
_STAGE_SPANS = ("server.predict", "batcher.dispatch", "engine.forward",
                "compile", "server.encode")

_records_g = REGISTRY.gauge(
    "flightrecorder_records",
    "records currently retained, by ring (recent | slow | error)")
_recorded = REGISTRY.counter(
    "flightrecorder_recorded_total",
    "records ever taken, by kind (request | train_step | ...)")
_dropped = REGISTRY.counter(
    "flightrecorder_dropped_total",
    "records aged out of a full ring, by ring — bounded-memory "
    "overflow, not data loss of live traffic")


def timeline_path_from_env() -> str | None:
    """``$ZNICZ_TIMELINE_JSONL`` — the train-side per-step timeline
    sink, reachable without touching the launch script (same pattern
    as ``$ZNICZ_PROFILE_DIR``)."""
    return os.environ.get("ZNICZ_TIMELINE_JSONL") or None


class TimelineWriter:
    """Append-only JSONL sink for the train side's per-step
    host-vs-device time breakdown (``--timeline-jsonl`` /
    ``$ZNICZ_TIMELINE_JSONL``) — the raw material the MFU work needs:
    a step whose wall time is host-dominated is a data-pipeline
    problem, not a kernel problem, and no profiler trace is required
    to see which.  One JSON object per line, flushed per write (a
    killed run keeps every completed step); never raises into the
    training loop."""

    def __init__(self, path: str):
        self.path = os.fspath(path)
        self._lock = threading.Lock()
        try:
            self._fh = open(self.path, "a", encoding="utf-8")
        except OSError as e:
            # a bad --timeline-jsonl / stale $ZNICZ_TIMELINE_JSONL must
            # not kill a training job for a telemetry-only sink — warn
            # loudly, record nothing
            import logging
            logging.getLogger("TimelineWriter").warning(
                "cannot open timeline sink %s (%s); per-step timeline "
                "disabled for this run", self.path, e)
            self._fh = None

    def write(self, row: dict) -> None:
        try:
            line = json.dumps(row, default=float)
        except (TypeError, ValueError):
            return
        with self._lock:
            if self._fh is None:
                return
            try:
                self._fh.write(line + "\n")
                self._fh.flush()
            except OSError:
                pass        # a full disk must not take training down

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


def stage_breakdown(spans: list, rows: int | None = None) -> dict:
    """Queue/compile/forward stage timings (ms) out of a request's
    span dicts.  ``queue_ms`` is the handler wall not accounted to the
    dispatch stage — time the request sat in the admission queue plus
    parse/serialize overhead; negative residue (spans from a coalesced
    batch overlap several requests) clamps to 0.

    ``device_ms`` is the measured fenced device time the engine
    stamped onto its forward spans (cost attribution).  A forward span
    covers the WHOLE coalesced batch; with ``rows`` (this request's
    row count) the device bill is split pro-rata by rows across the
    batch's riders — the per-request figure ``bench.py --serve`` and
    the per-tenant flight records report."""
    by_name: dict[str, float] = {}
    device_ms = None
    for s in spans:
        d = s.get("duration_ms")
        if s.get("name") in _STAGE_SPANS and d is not None:
            # a batch may compile + forward more than once (chunking):
            # stages sum
            by_name[s["name"]] = by_name.get(s["name"], 0.0) + float(d)
        dev = s.get("device_ms")
        if s.get("name") == "engine.forward" and dev is not None:
            share = float(dev)
            span_rows = s.get("rows")
            if rows is not None and span_rows:
                share *= min(1.0, float(rows) / float(span_rows))
            device_ms = (device_ms or 0.0) + share
    out = {}
    if "engine.forward" in by_name:
        out["forward_ms"] = round(by_name["engine.forward"], 3)
    if device_ms is not None:
        out["device_ms"] = round(device_ms, 3)
    if "compile" in by_name:
        out["compile_ms"] = round(by_name["compile"], 3)
    if "server.encode" in by_name:
        # the response-serialization share (JSON buffer encoder or
        # binary tensor header+bytes) — the before/after figure for
        # the wire-protocol work rides the same breakdown as
        # queue/dispatch/forward
        out["encode_ms"] = round(by_name["server.encode"], 3)
    if "batcher.dispatch" in by_name:
        out["dispatch_ms"] = round(by_name["batcher.dispatch"], 3)
        if "server.predict" in by_name:
            out["queue_ms"] = round(
                max(0.0, by_name["server.predict"]
                    - by_name["batcher.dispatch"]), 3)
    return out


class FlightRecorder:
    """The bounded three-ring recorder; one process-wide default
    (:data:`RECORDER`) serves the debug endpoints, tests build their
    own for isolation."""

    def __init__(self, capacity: int = 256,
                 slow_threshold_ms: float = 250.0,
                 slow_capacity: int = 64, error_capacity: int = 32):
        if capacity < 1 or slow_capacity < 1 or error_capacity < 1:
            raise ValueError("ring capacities must be >= 1")
        self.capacity = int(capacity)
        self.slow_threshold_ms = float(slow_threshold_ms)
        self.slow_capacity = int(slow_capacity)
        self.error_capacity = int(error_capacity)
        self._lock = threading.Lock()
        self._recent: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._slow: collections.deque = collections.deque(
            maxlen=self.slow_capacity)
        self._errors: collections.deque = collections.deque(
            maxlen=self.error_capacity)
        self._seq = 0

    # -- write side -------------------------------------------------------
    def record(self, kind: str, *, duration_ms: float | None = None,
               outcome: str = "ok", error: str | None = None,
               **fields) -> dict:
        """Take one record.  ``outcome`` other than ``"ok"`` (or a
        non-None ``error``) lands it in the error ring too; clearing
        the slow threshold lands it in the slow ring.  Returns the
        record dict (already sealed — mutating it later won't corrupt
        the rings' invariants, they share the object by design)."""
        rec = {"kind": kind, "at": time.time(),
               "duration_ms": (round(float(duration_ms), 3)
                               if duration_ms is not None else None),
               "outcome": outcome, **fields}
        if error is not None:
            rec["error"] = str(error)[:4000]
        slow = (duration_ms is not None
                and float(duration_ms) >= self.slow_threshold_ms)
        failed = outcome != "ok" or error is not None
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            n0 = len(self._recent)
            if n0 == self._recent.maxlen:
                _dropped.inc(ring="recent")
            self._recent.append(rec)
            # gauge writes only on a length CHANGE: once a ring fills
            # (steady state on the serve hot path) its length never
            # moves again, and three labeled gauge sets per request
            # are measurable at bench request rates
            if len(self._recent) != n0:
                _records_g.set(len(self._recent), ring="recent")
            if slow:
                if len(self._slow) == self._slow.maxlen:
                    _dropped.inc(ring="slow")
                self._slow.append(rec)
                _records_g.set(len(self._slow), ring="slow")
            if failed:
                if len(self._errors) == self._errors.maxlen:
                    _dropped.inc(ring="error")
                self._errors.append(rec)
                _records_g.set(len(self._errors), ring="error")
        _recorded.inc(kind=kind)
        return rec

    # -- read side --------------------------------------------------------
    def snapshot(self, n: int | None = None,
                 model: str | None = None) -> dict:
        """JSON-able state: the three rings newest-last (``n`` bounds
        the recent ring's slice), config, and totals — what
        ``GET /debug/flightrecorder`` serves.  ``model`` slices every
        ring to one tenant's records (``?model=`` on the endpoint) —
        records carrying no ``model`` field (train steps, single-model
        servers) are excluded from a model-scoped view."""
        with self._lock:
            recent = list(self._recent)
            slow = list(self._slow)
            errors = list(self._errors)
            seq = self._seq
        if model is not None:
            recent = [r for r in recent if r.get("model") == model]
            slow = [r for r in slow if r.get("model") == model]
            errors = [r for r in errors if r.get("model") == model]
        if n is not None:
            recent = recent[-int(n):]
        out = {"config": {"capacity": self.capacity,
                          "slow_threshold_ms": self.slow_threshold_ms,
                          "slow_capacity": self.slow_capacity,
                          "error_capacity": self.error_capacity},
               "recorded_total": seq,
               "recent": recent, "slow": slow, "errors": errors}
        if model is not None:
            out["model"] = model
        return out

    def stage_breakdown(self, model: str | None = None) -> dict:
        """Aggregate per-stage timings over the retained request
        records (recent + slow rings, deduplicated), optionally scoped
        to one zoo ``model`` — "where does THIS tenant's time go"
        without exporting the raw rings.  Each stage reports total /
        mean ms and how many records carried it."""
        with self._lock:
            pool = {id(r): r for r in self._recent}
            pool.update((id(r), r) for r in self._slow)
        agg: dict[str, list] = {}
        n = 0
        for r in pool.values():
            if r.get("kind") != "request":
                continue
            if model is not None and r.get("model") != model:
                continue
            n += 1
            for stage, ms in (r.get("stages") or {}).items():
                if isinstance(ms, (int, float)):
                    entry = agg.setdefault(stage, [0.0, 0])
                    entry[0] += float(ms)
                    entry[1] += 1
        return {"model": model, "requests": n,
                "stages": {stage: {"total_ms": round(total, 3),
                                   "mean_ms": round(total / count, 3),
                                   "records": count}
                           for stage, (total, count)
                           in sorted(agg.items())}}

    def slowest(self, n: int = 10) -> list:
        """The ``n`` slowest retained records, slowest first — the
        /statusz slow-request table."""
        with self._lock:
            pool = {id(r): r for r in self._recent}
            pool.update((id(r), r) for r in self._slow)
        return sorted(pool.values(),
                      key=lambda r: r.get("duration_ms") or 0.0,
                      reverse=True)[:n]

    def shape_census(self) -> list:
        """Observed SERVED request sample shapes, most frequent first:
        ``[(shape_tuple, count), ...]`` over the retained request
        records (recent + slow rings).  The serving engine's
        census-driven warmup reads this to precompile what traffic
        actually sends instead of an operator-guessed
        ``--warmup-shape`` — bounded by construction because the
        rings are.  Failed requests are excluded: a client hammering
        a wrong-geometry shape (every attempt a 400) must not occupy
        warm slots, let alone outrank the real traffic shape."""
        census: collections.Counter = collections.Counter()
        with self._lock:
            pool = {id(r): r for r in self._recent}
            pool.update((id(r), r) for r in self._slow)
        for r in pool.values():
            shape = r.get("shape")
            if r.get("kind") == "request" and shape \
                    and r.get("outcome") == "ok":
                try:
                    census[tuple(int(d) for d in shape)] += 1
                except (TypeError, ValueError):
                    continue
        return census.most_common()

    def counts(self) -> dict:
        with self._lock:
            return {"recent": len(self._recent),
                    "slow": len(self._slow),
                    "errors": len(self._errors),
                    "recorded_total": self._seq}

    def clear(self) -> None:
        """Drop every ring (test isolation)."""
        with self._lock:
            self._recent.clear()
            self._slow.clear()
            self._errors.clear()


#: the process-wide default recorder the serving/debug surfaces share
RECORDER = FlightRecorder()
# publish the empty-ring lengths ONCE for the process singleton:
# record() only writes the gauges on a length change, so the series
# must exist (at 0) before the first record — but zeroing inside
# FlightRecorder.__init__ would let a test-local recorder clobber the
# live singleton's gauge, which the skip-on-unchanged write could
# then never repair for a ring already at capacity
for _ring in ("recent", "slow", "error"):
    _records_g.set(0, ring=_ring)
del _ring
