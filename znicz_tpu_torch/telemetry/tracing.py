"""Request tracing: propagated request ids + lightweight spans.

The serving path spans three threads — HTTP handler → micro-batcher
dispatch → engine forward — and before this module there was no way to
answer "where did this 503 come from": the handler knew the client, the
batcher knew the coalesced batch, the engine knew the device error, and
nothing tied them together.

* Every ``POST /predict`` gets a **request id**: taken from the
  client's ``X-Request-Id`` header when present (so ids propagate
  across service hops), else generated.  The id is stamped into the
  response header, every structured log line
  (``logger.configure`` + ``ZNICZ_LOG_JSON=1``), and every span the
  request touches.
* A **span** is a named monotonic timing with attributes — created via
  the :func:`span` context manager, recorded into a bounded in-process
  ring (:func:`recent_spans`) and observed into the registry histogram
  ``span_duration_ms{span=...}`` so p50/p99 per stage fall out of the
  same ``/metrics`` scrape.

Propagation is ``contextvars``-based, which covers the single-thread
case for free; the batcher crosses a thread boundary, so the dispatch
loop re-installs the batch's ids via :func:`set_request_ids` — a span
opened inside (e.g. ``engine.forward``) then tags itself with every
request riding the batch.

Cross-process propagation (fleet tracing): a hop can carry a
``traceparent``-style **trace context** — ``00-<32hex trace id>-<16hex
parent span id>-<2hex flags>``, flags bit 0 = sampled — stamped by the
router into the ``X-Znicz-Trace`` request header and installed here via
:func:`parse_traceparent` + :func:`request`.  The context rides the
same ``contextvars`` plumbing as the request ids (including the
batcher's thread hop via :func:`set_request_ids`), so every span a
request touches tags itself with the trace id and the router can join
its half of the request with the backend's
(:mod:`znicz_tpu_torch.telemetry.tracestore`).  Still deliberately small:
no clock-skew correction (hop timings are computed from span GAPS on
one process's monotonic clock, never by subtracting stamps across
machines), and the wire format is two headers, not a collector
protocol.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import hashlib
import itertools
import threading
import time
import uuid

from .registry import REGISTRY

#: ids of every request the current context is working for — one for a
#: handler thread, many for a dispatch thread running a coalesced batch
_request_ids: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "znicz_request_ids", default=())

#: trace contexts riding the current context, aligned with
#: ``_request_ids`` (entry i belongs to request i; ``None`` where a
#: request carries no trace) — a separate var so the id fast path
#: never pays for tracing when no hop stamped a context
_trace_ctxs: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "znicz_trace_ctxs", default=())

_MAX_ID_LEN = 120

_lock = threading.Lock()
_recent: collections.deque = collections.deque(maxlen=512)
#: request id -> live collector lists (see :func:`collect`): finished
#: spans carrying that id append themselves, so the serving hot path
#: reads its OWN spans in O(request's spans) instead of rescanning the
#: whole ring per request (measured on the bench.py serve trajectory)
_collectors: dict = {}

_span_hist = REGISTRY.histogram(
    "span_duration_ms",
    "span wall time by stage (server.predict / batcher.dispatch / "
    "engine.forward / ...), milliseconds")


#: generated ids are a random process prefix + a monotonic counter —
#: unique like the old per-request uuid4, without paying an
#: os.urandom syscall per request (it sampled at ~7% of handler time
#: on the serve bench); format stays 16 hex chars
_ID_PREFIX = uuid.uuid4().hex[:8]
_id_counter = itertools.count(1)


def new_request_id() -> str:
    return f"{_ID_PREFIX}{next(_id_counter) & 0xFFFFFFFF:08x}"


def accept_request_id(raw) -> str:
    """A client-supplied ``X-Request-Id`` value, sanitized (printable,
    bounded length) — or a fresh id when absent/unusable.  Sanitizing
    matters because the id is echoed into headers and log lines: a
    hostile header must not smuggle newlines into either.

    Over-long ids are truncated WITH a hash suffix: a plain
    ``rid[:120]`` would silently collide two client ids sharing a long
    prefix, cross-wiring their spans in the ring (and their traces in
    the store); the suffix keeps distinct inputs distinct while the
    result stays ≤ ``_MAX_ID_LEN`` and deterministic (retries echoing
    the same long id still correlate)."""
    if raw:
        rid = "".join(c for c in str(raw).strip() if c.isprintable())
        if len(rid) > _MAX_ID_LEN:
            suffix = hashlib.sha1(rid.encode("utf-8",
                                             "surrogatepass")).hexdigest()[:8]
            rid = rid[:_MAX_ID_LEN - 9] + "." + suffix
        if rid:
            return rid
    return new_request_id()


class TraceContext:
    """One hop's view of a distributed trace: the fleet-wide trace id,
    the id of the span that forwarded to us (our parent), and the
    sampling decision — exactly the W3C ``traceparent`` triple."""

    __slots__ = ("trace_id", "parent_id", "sampled")

    def __init__(self, trace_id: str, parent_id: str,
                 sampled: bool = True):
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.sampled = bool(sampled)

    def __repr__(self):
        return (f"<TraceContext {self.trace_id[:8]}… "
                f"parent={self.parent_id} sampled={self.sampled}>")

    def __eq__(self, other):
        return (isinstance(other, TraceContext)
                and self.trace_id == other.trace_id
                and self.parent_id == other.parent_id
                and self.sampled == other.sampled)


#: generated trace/span ids reuse the request-id recipe (random
#: process prefix + monotonic counter — no per-request urandom)
_TRACE_PREFIX = uuid.uuid4().hex[:24]


def new_trace_id() -> str:
    return f"{_TRACE_PREFIX}{next(_id_counter) & 0xFFFFFFFF:08x}"


def new_span_id() -> str:
    return f"{_ID_PREFIX}{next(_id_counter) & 0xFFFFFFFF:08x}"


_HEX = set("0123456789abcdef")


def parse_traceparent(raw) -> TraceContext | None:
    """Parse a ``00-<32hex>-<16hex>-<2hex>`` header value; ``None`` for
    anything malformed (an unparseable header means "untraced", never
    an error — tracing must not be able to fail a request)."""
    if not raw:
        return None
    parts = str(raw).strip().lower().split("-")
    if len(parts) != 4 or parts[0] != "00":
        return None
    trace_id, parent_id, flags = parts[1], parts[2], parts[3]
    if (len(trace_id) != 32 or len(parent_id) != 16 or len(flags) != 2
            or not _HEX.issuperset(trace_id)
            or not _HEX.issuperset(parent_id)
            or not _HEX.issuperset(flags)
            or trace_id == "0" * 32 or parent_id == "0" * 16):
        return None
    return TraceContext(trace_id, parent_id,
                        sampled=bool(int(flags, 16) & 0x1))


def format_traceparent(ctx: TraceContext) -> str:
    return (f"00-{ctx.trace_id}-{ctx.parent_id}-"
            f"{0x1 if ctx.sampled else 0x0:02x}")


def current_traces() -> tuple:
    """Trace contexts riding the current context, aligned with
    :func:`current_request_ids` (``None`` where a rider is untraced)."""
    return _trace_ctxs.get()


def current_trace() -> TraceContext | None:
    ctxs = _trace_ctxs.get()
    return ctxs[0] if ctxs else None


def current_request_ids() -> tuple:
    return _request_ids.get()


def current_request_id() -> str | None:
    ids = _request_ids.get()
    return ids[0] if ids else None


def set_request_ids(ids, traces=None):
    """Install ``ids`` as the current context's request ids; returns
    the token for :func:`reset_request_ids`.  Used where propagation
    crosses a thread boundary (the batcher's dispatch loop).

    ``traces`` (optional) carries each rider's :class:`TraceContext`
    (or ``None``), aligned with ``ids`` — the dispatch thread must
    re-install BOTH, or spans recorded under the batch (engine.forward)
    would lose their trace tags exactly where coalescing happens."""
    ids = tuple(ids)
    if traces is None:
        traces = (None,) * len(ids)
    return (_request_ids.set(ids), _trace_ctxs.set(tuple(traces)))


def reset_request_ids(token) -> None:
    if isinstance(token, tuple):
        id_tok, trace_tok = token
        _request_ids.reset(id_tok)
        _trace_ctxs.reset(trace_tok)
    else:                       # pre-trace single-token callers
        _request_ids.reset(token)


@contextlib.contextmanager
def request(request_id: str | None = None,
            trace: TraceContext | None = None):
    """Scope one request id (and optionally its trace context) over
    the current context (handler-thread form).  Yields the effective
    id."""
    rid = request_id or new_request_id()
    token = _request_ids.set((rid,))
    trace_token = _trace_ctxs.set((trace,))
    try:
        yield rid
    finally:
        _trace_ctxs.reset(trace_token)
        _request_ids.reset(token)


class Span:
    """One finished (or in-flight) timing record."""

    __slots__ = ("name", "request_ids", "trace_ids", "attrs",
                 "started_at", "_t0", "duration_ms", "status", "error")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.request_ids = current_request_ids()
        self.trace_ids = tuple(c.trace_id
                               for c in current_traces() if c)
        self.attrs = attrs
        self.started_at = time.time()
        self._t0 = time.monotonic()
        self.duration_ms: float | None = None
        self.status = "in_flight"
        self.error: str | None = None

    def finish(self, error: BaseException | None = None) -> "Span":
        self.duration_ms = (time.monotonic() - self._t0) * 1e3
        self.status = "error" if error is not None else "ok"
        if error is not None:
            self.error = f"{type(error).__name__}: {error}"[:300]
        return self

    def to_dict(self) -> dict:
        d = {"name": self.name, "request_ids": list(self.request_ids),
             "started_at": self.started_at,
             "duration_ms": self.duration_ms, "status": self.status,
             "error": self.error, **self.attrs}
        if self.trace_ids:
            d["trace_ids"] = list(self.trace_ids)
        return d

    def __repr__(self):
        return (f"<Span {self.name} {self.status} "
                f"{self.duration_ms and round(self.duration_ms, 3)}ms "
                f"ids={list(self.request_ids)}>")


@contextlib.contextmanager
def span(name: str, **attrs):
    """Time a stage; record it on exit (status ``error`` when the body
    raises — the exception itself propagates unchanged)."""
    sp = Span(name, attrs)
    try:
        yield sp
    except BaseException as e:
        _record(sp.finish(error=e))
        raise
    else:
        _record(sp.finish())


def _record(sp: Span) -> None:
    with _lock:
        _recent.append(sp)
        if _collectors:
            for rid in sp.request_ids:
                for lst in _collectors.get(rid, ()):
                    lst.append(sp)
    _span_hist.observe(sp.duration_ms, span=sp.name)


@contextlib.contextmanager
def collect(request_id: str):
    """Collect every span finished inside this context that carries
    ``request_id`` (including spans recorded by OTHER threads — the
    batcher dispatch and engine forward spans tag every rider of the
    coalesced batch).  Yields the live list.  This is the hot-path
    replacement for per-request :func:`recent_spans` scans: the ring
    keeps serving the debug endpoints, but a request only pays for
    its own spans."""
    spans: list = []
    with _lock:
        _collectors.setdefault(request_id, []).append(spans)
    try:
        yield spans
    finally:
        with _lock:
            lists = _collectors.get(request_id)
            if lists is not None:
                try:
                    lists.remove(spans)
                except ValueError:
                    pass
                if not lists:
                    del _collectors[request_id]


def recent_spans(n: int | None = None, name: str | None = None,
                 request_id: str | None = None,
                 since: float | None = None) -> list[Span]:
    """Newest-last slice of the span ring, optionally filtered by span
    name and/or by a request id appearing in the span's batch.
    ``since`` is a ``time.monotonic()`` stamp: only spans STARTED at or
    after it match — request ids are client-supplied and reusable (a
    retry echoes its first attempt's id), so an id filter alone would
    blend both attempts' spans into one stage breakdown."""
    with _lock:
        spans = list(_recent)
    if name is not None:
        spans = [s for s in spans if s.name == name]
    if request_id is not None:
        spans = [s for s in spans if request_id in s.request_ids]
    if since is not None:
        spans = [s for s in spans if s._t0 >= since]
    return spans[-n:] if n is not None else spans


def clear() -> None:
    """Drop the ring (test isolation)."""
    with _lock:
        _recent.clear()
