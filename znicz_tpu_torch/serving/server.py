"""HTTP serving front: POST /predict, GET /healthz, GET /metrics (a port
of the JAX package's ``serving/server.py``: the same routes, status
codes, headers and bodies, over the port's engine on the CUDA card).

A stdlib ``ThreadingHTTPServer`` — no tornado/twisted/asgi; each
connection gets a thread that blocks on the micro-batcher, which is
exactly the shape the batcher wants (many waiting producers, one
dispatching consumer per model).

Wire protocol (JSON by default, binary by negotiation —
docs/serving.md "Wire protocol"):

* ``POST /predict``  body ``{"inputs": [[...], ...],
  "deadline_ms": optional, "model": optional}`` →
  ``{"outputs": [[...], ...]}``.
  With ``Content-Type: application/x-znicz-tensor`` the body is
  instead ONE binary tensor (fixed little-endian header + raw
  row-major bytes; serving.wire) decoded with a single zero-copy
  ``np.frombuffer`` — request fields then travel as headers only
  (``X-Model``/``X-Deadline-Ms``/``X-Criticality``), and a malformed
  binary body is a 400 exactly like unparseable JSON.  A client
  sending ``Accept: application/x-znicz-tensor`` gets its outputs in
  the same binary format; everyone else keeps the byte-identical JSON
  contract.  Connections are HTTP/1.1 persistent: a closed-loop
  client pays the TCP+thread setup once, not per request.
  With ``--memoize N``, repeat inputs under an unchanged model
  generation answer from a bounded per-model response cache without
  a device call (serving.memo; a hot reload swaps the key space, so
  a new generation can never serve its predecessor's outputs).
  A 1-D ``inputs`` is treated as a single sample.  Errors: 400
  (malformed), 404 (unknown model name), 429 + ``Retry-After`` header
  (admission queue full, or a model's token-bucket quota breached),
  504 (request deadline passed while queued), 503 (engine failure).
  Multi-tenant routing (serving.zoo; docs/serving.md): the
  ``X-Model`` header (beats the body ``model`` field) picks which
  registered model answers; absent → the default model, preserving
  the single-model contract.  Each model carries its own criticality
  class and deadline default (applied when the request sends
  neither), its own micro-batcher/queue/shed ladder, and rides the
  weight-residency LRU — the request that wakes an evicted model
  pays its page-in.
  Overload defense (docs/resilience.md): ``X-Deadline-Ms`` attaches
  an end-to-end deadline at admission (header beats the body field;
  ``--default-deadline-ms`` applies when neither is sent) that every
  downstream hop checks — a budget the measured backlog cannot fit is
  refused EARLY as 503 + ``Retry-After`` instead of doing doomed
  work; ``X-Criticality: sheddable|default|critical`` places the
  request on the adaptive (CoDel) shed ladder, and a shed or a
  draining replica also answers 503 + ``Retry-After``.
* ``GET /healthz``   liveness + model/backend summary.  ``status`` is
  the engine's resilience state — ``ok`` | ``degraded`` (circuit open,
  native CPU fallback serving) | ``open`` (circuit open, no fallback:
  predicts answer 503 + Retry-After) — so a load balancer can rotate a
  degraded replica out BEFORE clients see 503s.  Also carries
  ``model_generation`` and ``last_reload`` (outcome of the most recent
  hot reload), so a rollout controller can poll whether its swap landed;
  with an in-process promotion controller attached
  (:meth:`ServingServer.attach_promotion`) a ``promotion`` block
  reports its status next to those fields.  ``mesh`` is ``1x1``: the
  engine serves on one device (``tp > 1`` is not ported).
* ``POST /admin/reload``  zero-downtime hot reload: body
  ``{"model": optional path, "wait": optional bool}``; the new
  artifact is verified (``durability``) and canaried on a
  background thread while the old generation keeps serving, then
  atomically swapped — failure rolls back — and the bucket graphs of
  every request shape the flight recorder saw served are built before
  the reload returns (the census warm-up), off the request path.  202 started / 200 waited /
  409 already in flight (with ``Retry-After``, like the 429/503
  backpressure paths) / 403 bad ``X-Admin-Token`` (required whenever
  a token is configured via ``--admin-token`` / ``$ZNICZ_ADMIN_TOKEN``
  — set one on any listener reachable beyond localhost).  ``SIGHUP``
  triggers the same path from the ``serve`` CLI without a token.
* ``GET /statusz``   the human-readable one-pager (text/plain): build
  rev, uptime, backend/breaker/generation, promotion state, compile
  accounting, the flight recorder's slow-request table — it exists to
  be curl'd by a human mid-incident (telemetry.debugz).  When an admin
  token is configured, ``/statusz`` and both ``/debug/*`` routes
  require the same ``X-Admin-Token`` as ``/admin/reload`` — stack
  dumps, request shapes and error tracebacks are operator data.
* ``GET /alertz``   the SLO engine's judgment surface (JSON): every
  declared objective's fast/slow-window burn rates, error budget
  remaining, and the currently-firing alerts — open like ``/healthz``
  (an alerting probe is monitoring infrastructure); ``enabled: false``
  when no SLO engine is attached (``serve --slo`` /
  :meth:`ServingServer.attach_slo`; telemetry.sloengine,
  docs/observability.md "SLO engine").
* ``GET /debug/flightrecorder``  the bounded ring of recent request /
  train-step records as JSON (``?n=`` bounds the recent slice,
  ``?model=`` scopes every ring to one zoo tenant) — per-request span
  trees, stage timings (incl. the measured per-request device-time
  share), retained slow outliers, last errors with tracebacks
  (telemetry.flightrecorder).
* ``GET /debug/threadz``  every live thread with its current Python
  stack (JSON) — diagnosing a live hang; ``kill -USR1 <pid>`` dumps
  the same to stderr when the HTTP threads themselves are what hung.
* ``GET /metrics``   content-negotiated (``telemetry``): the
  default JSON view is the single-model shape — batcher counters (queue depth,
  batch-size histogram, p50/p99 latency, rejected/expired) merged with
  engine counters (executable-cache hits/misses/evictions, forward
  calls, breaker state/trips/probes, retry and fallback counts) — plus
  a ``rev`` build stamp and the registry's request totals;
  ``Accept: text/plain`` (or ``?format=prometheus``) answers the SAME
  numbers as Prometheus text exposition v0.0.4, including the
  ``predict_latency_ms`` histogram and ``breaker_state``.

Traffic tap (``--capture-dir``; docs/online.md): every SERVED
``/predict`` answer is appended to a bounded, fsync'd segment ring
(``online.capture.CaptureLog``) that ``python -m znicz_tpu_torch
online-train`` replays.  The tap is fail-open by construction (it only
enqueues; a capture failure of ANY kind is a counted drop, never a
failed or delayed answer) and seeded-sampled (``--capture-sample``).
Served 200s also carry an ``X-Model-Generation`` header —
the backend-reported generation a fleet router's response memoization
keys on.

Request correlation: every ``POST /predict`` carries an
``X-Request-Id`` (client-supplied or generated) echoed in the response
and threaded through the batcher/engine spans
(``telemetry.tracing.recent_spans``) and structured log lines — "where
did this 503 come from" is answerable from the id alone.

Degradation contract (pinned by the chaos tests): a persistent engine
fault must never surface as a hang or a raw 500 — every request
resolves as a native-fallback 200 or a 503 carrying Retry-After.
"""

from __future__ import annotations

import hmac
import http.client as _http_client
import json
import os
import threading
import time
import traceback
from http import HTTPStatus
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..resilience import overload
from ..resilience.breaker import EngineUnavailable
from ..telemetry import (buildinfo, debugz, flightrecorder, tracestore,
                         tracing)
from ..telemetry.registry import (PROMETHEUS_CONTENT_TYPE, REGISTRY,
                                  DEFAULT_LATENCY_BUCKETS_MS)
from . import wire
from . import zoo as zoo_mod
from .batcher import DeadlineExceeded, MicroBatcher, QueueFull
from .engine import ServingEngine
from .memo import ResponseCache

#: routes with their own label value in requests_total/errors_total —
#: anything else pools under "other" (label cardinality stays bounded
#: no matter what paths clients probe)
_ROUTES = ("/predict", "/healthz", "/metrics", "/admin/reload",
           "/admin/placement", "/statusz", "/alertz", "/tracez",
           "/debug/flightrecorder", "/debug/threadz")

#: the serving mesh the port reports: one device (``tp > 1`` is not
#: ported), the value the reference reports at tp=1
ONE_DEVICE_MESH = "1x1"
#: the port's engine fields that the reference's engine lacks: they stay
#: in the JSON view, so the Prometheus families are the reference's (each
#: build is also a sample of ``compiles_total{site="serving.engine"}``)
PORT_ENGINE_FIELDS = ("builds", "warmup_failures")

_wire_requests = REGISTRY.counter(
    "wire_requests_total",
    "successfully decoded POST /predict payloads, by wire format "
    "(json | binary — Content-Type: application/x-znicz-tensor)")


def _json_object(raw: bytes) -> dict:
    """Parse ONE request body as a JSON object — the single parse
    site both POST legs thread their dict from (the payload used to
    be decoded ad hoc per leg)."""
    payload = json.loads(raw or b"{}")
    if not isinstance(payload, dict):
        raise ValueError("body must be a JSON object")
    return payload


class _FastHeaders(dict):
    """Case-insensitive single-valued request headers (keys stored
    lowercased).  The stdlib parses request headers through the full
    ``email.parser`` MIME machinery — ~0.15 ms per request, a third
    of the non-forward budget of a small request — and the
    serving front only ever asks ``headers.get(name)``."""

    __slots__ = ()

    def get(self, name, default=None):
        return dict.get(self, name.lower(), default)


#: (second, formatted) cache for the response Date header — strftime
#: per response is measurable at high request rates; GIL-guarded,
#: and a same-second race merely formats the same string twice
_date_cache: list = [None, ""]


class FastHTTPHandler(BaseHTTPRequestHandler):
    """Keep-alive HTTP/1.1 handler base with the fast header path.

    A base of its own so a fleet router — which fronts N of these
    servers and pays the same per-request parse costs — can share ONE
    copy of the machinery instead of drifting its own: persistent connections,
    single-write responses (subclasses build on the stdlib writers),
    the cached ``Date`` header, and the ``email.parser``-free request
    header parse.  Behavior pins (request-line validation, HTTP/0.9
    and 2.0 handling, ``Connection``/``Expect`` semantics, the ``//``
    path reduction) are copied verbatim from CPython 3.10.
    """

    # persistent connections: a closed-loop client pays TCP setup +
    # thread spawn ONCE instead of per request — connection churn is a
    # top non-forward cost of a small request.  Every response must send Content-Length,
    # which is what HTTP/1.1 keep-alive requires; clients sending
    # Connection: close (urllib does) keep the old one-shot behavior.
    protocol_version = "HTTP/1.1"
    #: socket read timeout: bounds how long an idle keep-alive
    #: connection can pin its handler thread after the client
    #: went away without closing
    timeout = 120
    #: small request/response ping-pong over a persistent connection
    #: is exactly the pattern Nagle + delayed-ACK penalizes — answers
    #: must leave NOW
    disable_nagle_algorithm = True

    def log_message(self, *args):         # keep serving logs clean
        pass

    def date_time_string(self, timestamp=None):
        # per-second cache of the Date header (RFC format via the
        # stdlib formatter, computed once a second instead of once a
        # response)
        if timestamp is not None:
            return super().date_time_string(timestamp)
        t = int(time.time())
        if _date_cache[0] != t:
            _date_cache[1] = super().date_time_string(t)
            _date_cache[0] = t
        return _date_cache[1]

    def _read_headers_fast(self) -> _FastHeaders:
        """Request headers into a :class:`_FastHeaders` dict with the
        stdlib's bounds (64 KiB line, 100 headers; folded continuation
        lines appended, duplicate names first-wins like
        ``email.Message.get``)."""
        headers = _FastHeaders()
        last = None
        count = 0
        while True:
            line = self.rfile.readline(65537)
            if len(line) > 65536:
                raise _http_client.LineTooLong("header line")
            if line in (b"\r\n", b"\n", b""):
                break
            count += 1
            if count > 100:
                raise _http_client.HTTPException(
                    "got more than 100 headers")
            s = line.decode("iso-8859-1").rstrip("\r\n")
            if s[:1] in " \t":
                # obs-fold continuation of the previous field
                if last is not None:
                    headers[last] += " " + s.strip()
                continue
            key, sep, value = s.partition(":")
            if not sep:
                continue           # junk line: skip, as email
                #                    .parser tolerates it
            key = key.strip().lower()
            if key not in headers:
                headers[key] = value.strip()
                last = key
            else:
                # duplicate dropped (first-wins) — a fold following it
                # must NOT append to the RETAINED first value
                last = None
        return headers

    def parse_request(self):
        """CPython 3.10 ``BaseHTTPRequestHandler.parse_request`` with
        ONE change: headers parse through :meth:`_read_headers_fast`
        instead of the ``email.parser`` MIME machinery."""
        self.command = None
        self.request_version = version = self.default_request_version
        self.close_connection = True
        requestline = str(self.raw_requestline, "iso-8859-1")
        requestline = requestline.rstrip("\r\n")
        self.requestline = requestline
        words = requestline.split()
        if len(words) == 0:
            return False
        if len(words) >= 3:         # enough to determine version
            version = words[-1]
            try:
                if not version.startswith("HTTP/"):
                    raise ValueError
                base_version_number = version.split("/", 1)[1]
                version_number = base_version_number.split(".")
                if len(version_number) != 2:
                    raise ValueError
                version_number = (int(version_number[0]),
                                  int(version_number[1]))
            except (ValueError, IndexError):
                self.send_error(
                    HTTPStatus.BAD_REQUEST,
                    "Bad request version (%r)" % version)
                return False
            if version_number >= (1, 1) \
                    and self.protocol_version >= "HTTP/1.1":
                self.close_connection = False
            if version_number >= (2, 0):
                self.send_error(
                    HTTPStatus.HTTP_VERSION_NOT_SUPPORTED,
                    "Invalid HTTP version (%s)"
                    % base_version_number)
                return False
            self.request_version = version
        if not 2 <= len(words) <= 3:
            self.send_error(
                HTTPStatus.BAD_REQUEST,
                "Bad request syntax (%r)" % requestline)
            return False
        command, path = words[:2]
        if len(words) == 2:
            self.close_connection = True
            if command != "GET":
                self.send_error(
                    HTTPStatus.BAD_REQUEST,
                    "Bad HTTP/0.9 request type (%r)" % command)
                return False
        self.command, self.path = command, path
        if self.path.startswith("//"):
            # gh-87389 open-redirect hardening, as upstream
            self.path = "/" + self.path.lstrip("/")
        try:
            self.headers = self._read_headers_fast()
        except _http_client.LineTooLong as err:
            self.send_error(
                HTTPStatus.REQUEST_HEADER_FIELDS_TOO_LARGE,
                "Line too long", str(err))
            return False
        except _http_client.HTTPException as err:
            self.send_error(
                HTTPStatus.REQUEST_HEADER_FIELDS_TOO_LARGE,
                "Too many headers", str(err))
            return False
        conntype = self.headers.get("Connection", "")
        if conntype.lower() == "close":
            self.close_connection = True
        elif (conntype.lower() == "keep-alive"
                and self.protocol_version >= "HTTP/1.1"):
            self.close_connection = False
        expect = self.headers.get("Expect", "")
        if (expect.lower() == "100-continue"
                and self.protocol_version >= "HTTP/1.1"
                and self.request_version >= "HTTP/1.1"):
            if not self.handle_expect_100():
                return False
        return True


class DeepBacklogHTTPServer(ThreadingHTTPServer):
    #: accept-backlog depth: the stdlib default of 5 turns a burst of
    #: simultaneous NEW connections (a fleet's clients reconnecting
    #: after a rollout, the barrier-released e2e tests) into kernel
    #: connection resets under load — observed as a rare pre-existing
    #: ConnectionResetError flake in the concurrency tests
    request_queue_size = 128


def _memo_generation(engine) -> int | None:
    """The generation a memo key may safely pin — or ``None`` for a
    MIXED-generation replica set (mid-roll, or a roll stopped by a
    failed canary): the set's ``generation`` property is the fleet
    minimum, so two replicas serving different models would share one
    key space and the cache could pin either model's answer.  The
    cache is bypassed until the fleet converges; correctness beats
    hit rate during a roll."""
    replicas = getattr(engine, "replicas", None)
    if replicas is None:
        return engine.generation
    gens = {e.generation for e in replicas}
    return gens.pop() if len(gens) == 1 else None


def _outcome_of(code: int) -> str:
    """Final HTTP status → the trace-store outcome vocabulary: 504 is
    a deadline, 429/503 are sheds (quota, queue, brownout, breaker),
    other 4xx/5xx are errors — the classes the tail-based retention
    policy never samples out."""
    code = int(code)
    if code < 400:
        return "ok"
    if code == 504:
        return "deadline"
    if code in (429, 503):
        return "shed"
    return "error"


def _tracez_filters(query: str) -> dict:
    """``/tracez`` query → snapshot kwargs (shared with the fleet
    router's handler; junk values are ignored, not 400s — a debug
    surface should answer with its defaults, not argue)."""
    out: dict = {}
    for part in query.split("&"):
        if part.startswith("model="):
            out["model"] = part[len("model="):] or None
        elif part.startswith("outcome="):
            out["outcome"] = part[len("outcome="):] or None
        elif part.startswith("min_ms="):
            try:
                out["min_ms"] = float(part[len("min_ms="):])
            except ValueError:
                pass
        elif part.startswith("n="):
            try:
                out["n"] = max(1, int(part[2:]))
            except ValueError:
                pass
    return out


class ServingServer:
    """Engine + batcher behind an HTTP front (start()/stop()/url)."""

    def __init__(self, engine: ServingEngine | None = None, *,
                 zoo: "zoo_mod.ModelZoo | None" = None,
                 host: str = "127.0.0.1", port: int = 0,
                 batcher: MicroBatcher | None = None,
                 max_batch: int | None = None,
                 max_wait_ms: float | None = None,
                 max_queue: int | None = None,
                 default_timeout_s: float = 60.0,
                 max_body_mb: float = 64.0,
                 admin_token: str | None = None,
                 default_deadline_ms: float | None = None,
                 shed_target_ms: float | None = None,
                 shed_interval_ms: float = 500.0,
                 memo_entries: int = 0,
                 memo_mb: float = 32.0,
                 capture=None,
                 trace_sample: float = 0.0):
        knobs = (max_batch, max_wait_ms, max_queue, shed_target_ms)
        if batcher is not None and any(k is not None for k in knobs):
            # silently dropping the knobs would look like they applied
            raise ValueError("pass batching knobs OR a prebuilt "
                             "batcher, not both")
        if (engine is None) == (zoo is None):
            raise ValueError("pass exactly one of engine= or zoo=")
        if zoo is not None and batcher is not None:
            # each zoo entry needs its OWN batcher (coalescing across
            # models would mix tenants into one device call)
            raise ValueError("pass batching knobs, not a prebuilt "
                             "batcher, with a zoo")
        #: the model registry every /predict routes through.  A single
        #: engine wraps into an implicit one-entry zoo named "default"
        #: so routing, quota and residency logic have ONE code path —
        #: the multi-tenant surface (healthz models table, /metrics
        #: zoo block, per-model collector families) only renders for
        #: an EXPLICIT zoo, keeping every single-model contract
        #: byte-identical.
        self._zoo_explicit = zoo is not None
        if zoo is None:
            # labeled_metrics=False: a single-model server's /metrics
            # must not grow model_*{model="default"} series a scraper
            # pinned to the pre-zoo surface never asked for
            zoo = zoo_mod.ModelZoo(labeled_metrics=False)
            zoo.add("default", engine=engine)
        self.zoo = zoo
        self.engine = zoo.resolve().engine
        #: deadline attached to requests that carry neither an
        #: X-Deadline-Ms header nor a body deadline_ms (None = only
        #: explicit deadlines are enforced)
        self.default_deadline_ms = default_deadline_ms
        # /admin/reload shares the public listener with /predict, so
        # it gets its own gate: when a token is configured (flag or
        # $ZNICZ_ADMIN_TOKEN), reload requests must carry it in
        # X-Admin-Token or get a 403 — a client that can reach the
        # predict port must not be able to swap the model.  SIGHUP
        # remains the token-less local-operator channel.
        self.admin_token = admin_token if admin_token is not None \
            else os.environ.get("ZNICZ_ADMIN_TOKEN") or None
        self.max_body = int(max_body_mb * 1e6)
        if shed_target_ms is not None:
            wait = 5.0 if max_wait_ms is None else float(max_wait_ms)
            if shed_target_ms <= wait:
                # the coalescing window IS queue wait on a healthy
                # server: a target at or under max_wait_ms would read
                # normal batching patience as standing overload and
                # brown out an idle replica
                raise ValueError(
                    f"shed_target_ms ({shed_target_ms}) must exceed "
                    f"max_wait_ms ({wait}): every under-filled batch "
                    f"waits up to max_wait_ms by design")
        #: batchers this server built (and therefore closes) — one per
        #: zoo entry; a caller-attached batcher stays the caller's
        self._built_batchers: list[MicroBatcher] = []
        for entry in zoo.entries():
            if entry.batcher is None and batcher is not None:
                # the prebuilt-batcher escape hatch (single-model only,
                # rejected above for zoos)
                entry.batcher = batcher
            elif entry.batcher is None:
                # one batcher (and dispatch thread) per model: requests
                # of different tenants must never coalesce into one
                # device call, and each tenant gets its own queue
                # bound, shed ladder and backpressure — a hot tenant's
                # 429s cannot starve a quiet one.  Adaptive shedding
                # stays opt-in at construction (None = the fixed queue
                # bound only); the serve CLI enables it by default.
                entry.batcher = MicroBatcher(
                    entry.predict,
                    max_batch=32 if max_batch is None else max_batch,
                    max_wait_ms=(5.0 if max_wait_ms is None
                                 else max_wait_ms),
                    max_queue=128 if max_queue is None else max_queue,
                    # unnamed for the implicit single-model wrapper:
                    # the name surfaces in the /metrics JSON and the
                    # dispatch thread's name, and the single-model
                    # surface must stay byte-identical to pre-zoo
                    name=(entry.name if self._zoo_explicit else None),
                    shedder=(overload.CoDelShedder(
                        target_ms=shed_target_ms,
                        interval_ms=shed_interval_ms)
                        if shed_target_ms is not None else None))
                self._built_batchers.append(entry.batcher)
        #: generation-keyed response memoization (serving.memo) —
        #: opt-in (``--memoize``); one bounded LRU per zoo entry so
        #: tenants stay isolated, label-free on the single-model
        #: surface (the same rule as every model_* family)
        self.memo_entries = int(memo_entries)
        if self.memo_entries > 0:
            for entry in zoo.entries():
                if entry.response_cache is None:
                    entry.response_cache = ResponseCache(
                        max_entries=self.memo_entries,
                        max_bytes=int(memo_mb * 1e6),
                        model=(entry.name if self._zoo_explicit
                               else None))
        #: optional traffic tap (an object with ``append(x, y,
        #: model=)`` and ``metrics()``): every SERVED /predict answer —
        #: memo hits included, they are real traffic — appends one
        #: (input, outputs) record for the continual trainer to
        #: replay.  Fail-open by the tap's own contract: append never
        #: raises and never does file I/O on this thread.  Caller owns
        #: the lifecycle (close), same rule as an attached SLO engine.
        self.capture = capture
        #: the DEFAULT model's batcher — the single-model surface
        #: (metrics, statusz, overload status) keeps reading it
        self.batcher = zoo.resolve().batcher
        self.default_timeout_s = default_timeout_s
        self._draining = False
        self._stopped = False
        #: build stamp for scraped metrics; computed once — forking git
        #: per scrape
        #: would make /metrics the hottest endpoint on the box
        self.rev = buildinfo.cached_rev()
        self._requests = REGISTRY.counter(
            "requests_total",
            "HTTP requests answered, by route and status code")
        self._errors = REGISTRY.counter(
            "errors_total",
            "HTTP responses with status >= 400, by route and status "
            "code")
        self._latency = REGISTRY.histogram(
            "predict_latency_ms",
            "POST /predict wall time at the HTTP front (parse + queue "
            "+ batch + forward), milliseconds",
            buckets=DEFAULT_LATENCY_BUCKETS_MS)
        #: distributed tracing: requests arriving with an
        #: X-Znicz-Trace context tag their span tree with it and
        #: return the compact span summary in-band (header or wire
        #: trailer) for the router to assemble; ``trace_sample`` > 0
        #: additionally ROOTS a deterministic fraction of untraced
        #: requests locally, so a router-less replica still fills its
        #: own /tracez
        self.trace_sample = min(1.0, max(0.0, float(trace_sample)))
        self.tracestore = tracestore.TraceStore(head_rate=1.0)
        self._trace_seen = 0
        outer = self

        class Handler(FastHTTPHandler):
            # keep-alive + fast header parse come from the shared
            # FastHTTPHandler base (also the fleet router's handler
            # base — one copy of the wire machinery, two tiers)

            def _route(self) -> str:
                path = self.path
                if path in _ROUTES:     # hot case: no query, no slash
                    return path
                path = path.split("?")[0].rstrip("/")
                return path if path in _ROUTES else "other"

            def _trace_export(self, body: bytes, ctype: str):
                """The in-band span summary for the active traced
                /predict: every span the request collected so far plus
                a synthetic ``server.predict`` total (the span itself
                is still open while the response is written — now − t0
                is its honest duration).  Small summaries ride the
                X-Znicz-Spans header; big ones spill into the binary
                wire trailer, or are pruned to the stage spans when
                the response is JSON."""
                spans = [s for s in (self._trace_collected or ())
                         if s._t0 >= self._trace_t0]
                spd_ms = (time.monotonic() - self._trace_t0) * 1e3
                summary = tracestore.export_spans(
                    spans, server_predict_ms=spd_ms)
                payload = tracestore.encode_summary(summary)
                if len(payload) > tracestore.MAX_HEADER_BYTES:
                    if ctype == wire.CONTENT_TYPE:
                        try:
                            return (wire.append_trailer(body, payload),
                                    None)
                        except wire.WireError:
                            pass
                    payload = tracestore.encode_summary(
                        tracestore.prune_summary(summary))
                    if len(payload) > tracestore.MAX_HEADER_BYTES:
                        return body, None
                return body, payload.decode()

            def _send(self, code: int, body: bytes, ctype: str,
                      headers: dict | None = None):
                ctx = getattr(self, "_trace_ctx", None)
                if ctx is not None and ctx.sampled:
                    try:
                        body, spans_hdr = self._trace_export(body,
                                                             ctype)
                    except Exception:
                        spans_hdr = None    # tracing never fails a
                    if spans_hdr is not None:  # response it rides on
                        headers = dict(headers or {})
                        headers[tracestore.SPANS_HEADER] = spans_hdr
                self._status_code = code    # flight-record outcome
                route = self._route()
                outer._requests.inc(route=route, code=str(code))
                if code >= 400:
                    outer._errors.inc(route=route, code=str(code))
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                rid = tracing.current_request_id()
                if rid is not None:
                    self.send_header("X-Request-Id", rid)
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                if self.close_connection:
                    # under HTTP/1.1 a reply without this header
                    # advertises reuse — a client pipelining its next
                    # request onto a socket we are about to close
                    # would see a spurious reset (the 413/400/501/403
                    # legs all close without reading the body)
                    self.send_header("Connection", "close")
                # one syscall per response: ride the body on the
                # header buffer end_headers() flushes (wfile is
                # unbuffered, so a separate body write would be a
                # second segment — and with keep-alive ping-pong,
                # a second chance at a TCP stall).  HTTP/0.9 requests
                # have no status line or headers (the stdlib writers
                # above were all no-ops and no buffer exists) — the
                # body goes out bare, as the ancient protocol wants
                if self.request_version != "HTTP/0.9":
                    self._headers_buffer.append(b"\r\n")
                    self._headers_buffer.append(body)
                    self.flush_headers()
                else:
                    self.wfile.write(body)

            def _reply(self, code: int, obj: dict,
                       headers: dict | None = None):
                self._send(code, json.dumps(obj, default=float).encode(),
                           "application/json", headers)

            def _read_body(self) -> bytes | None:
                """Read the Content-Length-bounded request body ONCE
                (both POST legs thread the bytes — and the parsed
                dict — from here).  Replies itself and returns None on
                a junk/oversized length; any reply made WITHOUT
                consuming the body also closes the connection, so the
                unread bytes can never be misread as the next
                keep-alive request's head."""
                if self.headers.get("Transfer-Encoding"):
                    # chunked (or any transfer coding) is not spoken
                    # here: silently reading Content-Length=0 would
                    # leave the chunk bytes in the buffer to be parsed
                    # as the NEXT request's head — a desync, and
                    # behind a proxy a request-smuggling vector.
                    # Refuse loudly and drop the connection.
                    self.close_connection = True
                    self._reply(501, {
                        "error": "Transfer-Encoding is not supported; "
                                 "send a Content-Length body"})
                    return None
                try:
                    n = int(self.headers.get("Content-Length", 0) or 0)
                except (TypeError, ValueError):
                    self.close_connection = True
                    self._reply(400, {"error": "bad request: junk "
                                               "Content-Length"})
                    return None
                if n < 0:
                    self.close_connection = True
                    self._reply(400, {"error": "bad request: negative "
                                               "Content-Length"})
                    return None
                if n > outer.max_body:
                    # bounded admission extends to the body: a huge
                    # request must 413, not OOM the server
                    self.close_connection = True
                    self._reply(413, {
                        "error": f"body of {n} bytes exceeds the "
                                 f"{outer.max_body}-byte limit"})
                    return None
                return self.rfile.read(n) if n > 0 else b""

            def _reply_outputs(self, y: np.ndarray, binary: bool,
                               generation: int | None = None) -> None:
                """The 200 leg, content-negotiated: binary tensor for
                ``Accept: application/x-znicz-tensor``, else JSON
                bytes BYTE-IDENTICAL to the historical
                ``json.dumps({"outputs": y.tolist()})`` — built by the
                single-buffer encoder (serving.wire).  The encode is
                its own span so the flight-recorder stage breakdown
                prices it next to queue/dispatch/forward.

                ``generation`` rides out as ``X-Model-Generation`` —
                the backend-reported generation the fleet router's
                response memoization keys on (a stale health probe
                must not let the router cache one generation's answer
                under another's key)."""
                with tracing.span("server.encode"):
                    if binary:
                        body = wire.encode_tensor(
                            np.ascontiguousarray(y, np.float32))
                        ctype = wire.CONTENT_TYPE
                    else:
                        body = wire.encode_json_outputs(y)
                        ctype = "application/json"
                headers = ({"X-Model-Generation": str(int(generation))}
                           if generation is not None else None)
                self._send(200, body, ctype, headers)

            def _capture(self, entry, x: np.ndarray,
                         y: np.ndarray) -> None:
                """The traffic tap: one (input, outputs) record per
                SERVED answer, enqueued AFTER the response bytes went
                out.  append is fail-open by contract (no raise, no
                file I/O on this thread) — a full disk or slow fsync
                costs a dropped capture record, never a /predict
                answer (pinned by the capture.append fault test)."""
                cap = outer.capture
                if cap is not None:
                    cap.append(x, y,
                               model=(entry.name if outer._zoo_explicit
                                      else None))

            def _admin_authorized(self) -> bool:
                """True when no admin token is configured, or the
                request's ``X-Admin-Token`` matches it.  Shared by
                ``/admin/reload`` and the introspection surface
                (``/statusz``, ``/debug/*``): stack dumps, request
                payloads' shapes and error tracebacks are operator
                data — a token configured to protect reloads protects
                reads too."""
                if outer.admin_token is None:
                    return True
                supplied = self.headers.get("X-Admin-Token", "")
                # compare bytes: compare_digest(str, str) raises
                # TypeError on non-ASCII input, and header values
                # arrive latin-1-decoded — a stray high byte must
                # 403, not crash the handler.  supplied.encode
                # (latin-1) recovers the client's exact wire bytes;
                # the configured token is a Python str whose wire
                # form is its UTF-8 encoding, so a non-ASCII token
                # still matches the client that sends it.
                return hmac.compare_digest(
                    supplied.encode("latin-1", "replace"),
                    outer.admin_token.encode("utf-8"))

            def do_GET(self):
                if self.headers.get("Content-Length") \
                        or self.headers.get("Transfer-Encoding"):
                    # no GET route reads a body: leftover body bytes
                    # on a kept-alive connection would be parsed as
                    # the NEXT request's head (desync / smuggling) —
                    # answer, then drop the connection
                    self.close_connection = True
                path = self.path.split("?")[0].rstrip("/")
                if (path in ("/statusz", "/debug/flightrecorder",
                             "/debug/threadz")
                        and not self._admin_authorized()):
                    self._reply(403, {
                        "error": "admin token required (supply "
                                 "X-Admin-Token)"})
                    return
                if path == "/healthz":
                    self._reply(200, outer.health())
                elif path == "/alertz":
                    # the SLO engine's judgment surface: active burn-
                    # rate alerts + per-SLO burns/budgets.  Open like
                    # /healthz — an alerting probe is monitoring
                    # infrastructure, not operator data
                    self._reply(200, outer.alertz())
                elif path == "/statusz":
                    # the human one-pager: text, because it exists to
                    # be curl'd mid-incident, not parsed
                    self._send(200, debugz.statusz_text(outer).encode(),
                               "text/plain; charset=utf-8")
                elif path == "/debug/flightrecorder":
                    query = (self.path.split("?", 1)[1]
                             if "?" in self.path else "")
                    n = None
                    model = None
                    for part in query.split("&"):
                        if part.startswith("n="):
                            try:
                                n = max(1, int(part[2:]))
                            except ValueError:
                                pass
                        elif part.startswith("model="):
                            # slice the rings to one tenant (records
                            # carry `model` since the zoo landed);
                            # names are URL-safe by the registry's
                            # grammar, so no decoding is needed
                            model = part[len("model="):] or None
                    self._reply(200,
                                flightrecorder.RECORDER.snapshot(
                                    n, model=model))
                elif path == "/tracez":
                    # open like /healthz: trace timings are monitoring
                    # infrastructure (request ids and stage splits, no
                    # payloads).  Filters mirror the store snapshot.
                    query = (self.path.split("?", 1)[1]
                             if "?" in self.path else "")
                    self._reply(200, outer.tracez(
                        **_tracez_filters(query)))
                elif path == "/debug/threadz":
                    self._reply(200, debugz.threadz())
                elif path == "/metrics":
                    # content negotiation: Prometheus scrapers send
                    # Accept: text/plain (and curl can force either
                    # view with ?format=...); JSON stays the default
                    query = (self.path.split("?", 1)[1]
                             if "?" in self.path else "")
                    accept = self.headers.get("Accept", "")
                    want_text = ("format=prometheus" in query
                                 or ("text/plain" in accept
                                     and "format=json" not in query))
                    if want_text:
                        self._send(200,
                                   outer.prometheus_metrics().encode(),
                                   PROMETHEUS_CONTENT_TYPE)
                    else:
                        self._reply(200, outer.metrics())
                else:
                    self._reply(404, {"error": f"no route {self.path!r}"})

            def do_POST(self):
                route = self.path.split("?")[0].rstrip("/")
                if route == "/admin/reload":
                    self._admin_reload()
                    return
                if route == "/admin/placement":
                    self._admin_placement()
                    return
                if route != "/predict":
                    # body never read on this leg — keep-alive framing
                    # would misread it as the next request's head
                    self.close_connection = True
                    self._reply(404, {"error": f"no route {self.path!r}"})
                    return
                # the request id lives in a contextvar for the rest of
                # this handler thread's work: _reply echoes it, spans
                # record it, and the batcher carries it across the
                # dispatch-thread hop
                rid = tracing.accept_request_id(
                    self.headers.get("X-Request-Id"))
                # cross-hop trace context: the router's
                # X-Znicz-Trace stamp, or — at a configured sample
                # rate — a locally-rooted trace so a router-less
                # replica still decomposes its own tail
                trace = tracing.parse_traceparent(
                    self.headers.get(tracestore.TRACE_HEADER))
                rooted = False
                if trace is None and outer.trace_sample > 0.0:
                    outer._trace_seen += 1
                    stride = max(1, round(1.0 / outer.trace_sample))
                    if outer._trace_seen % stride == 0:
                        trace = tracing.TraceContext(
                            tracing.new_trace_id(),
                            tracing.new_span_id())
                        rooted = True
                t0 = time.monotonic()
                started_at = time.time()
                self._status_code = None
                self._rec_shape = self._rec_rows = None
                self._rec_error = None
                self._model_name = None
                self._trace_ctx = trace
                self._trace_t0 = t0
                try:
                    with tracing.collect(rid) as collected:
                        self._trace_collected = collected
                        with tracing.request(rid, trace=trace):
                            with tracing.span("server.predict"):
                                self._predict()
                finally:
                    self._trace_ctx = None
                    self._trace_collected = None
                dt_ms = (time.monotonic() - t0) * 1e3
                tracestore.observe_exemplar(outer._latency, dt_ms,
                                            trace)
                # flight record, AFTER the handler span closed so the
                # record's span tree includes it (telemetry.
                # flightrecorder; served on /debug/flightrecorder)
                code = self._status_code or 500
                if self._model_name is not None \
                        and outer._zoo_explicit:
                    # per-tenant outcome accounting — counted once,
                    # with the FINAL status, so quota 429s and shed
                    # 503s attribute to the tenant that caused them
                    # (explicit zoos only: the single-model surface
                    # stays label-free).  The wall latency rides along
                    # into model_latency_ms{model} — the per-tenant
                    # histogram the SLO engine's latency objectives
                    # judge
                    zoo_mod.note_model_request(self._model_name, code,
                                               dt_ms, trace=trace)
                if rooted:
                    # this replica is the trace's root hop: assemble
                    # its local stage split (no router stages) and
                    # apply the store's tail-first retention
                    summary = tracestore.export_spans(
                        [s for s in collected if s._t0 >= t0],
                        server_predict_ms=dt_ms)
                    local = tracestore.assemble(
                        trace_id=trace.trace_id, request_id=rid,
                        model=self._model_name or "default",
                        backend="local", outcome=_outcome_of(code),
                        total_ms=dt_ms, pick_ms=0.0, forward_ms=dt_ms,
                        summary=summary, started_at=started_at)
                    tracestore.observe_stages(local)
                    outer.tracestore.record(local)
                # the collector gathered this request's own spans in
                # O(own spans) — no per-request ring rescan.  The
                # since=t0 filter still applies: a straggler span of a
                # PRIOR attempt reusing this X-Request-Id (its batch
                # finishing late) must not double-count into this
                # attempt's stage timings
                spans = [s.to_dict() for s in collected
                         if s._t0 >= t0]
                flightrecorder.RECORDER.record(
                    "request", duration_ms=dt_ms,
                    outcome="ok" if code < 400 else "error",
                    error=self._rec_error,
                    request_id=rid, code=code,
                    rows=self._rec_rows, shape=self._rec_shape,
                    model=self._model_name,
                    stages=flightrecorder.stage_breakdown(
                        spans, rows=self._rec_rows),
                    spans=spans)

            def _admin_reload(self):
                """``POST /admin/reload`` — zero-downtime model swap.

                Body (all optional): ``{"model": "/path/new.znn",
                "wait": true}``.  The reload itself runs on a
                background thread (verify + canary can take seconds —
                a handler thread must not hold a connection hostage for
                them unless the client asked to ``wait``); traffic
                keeps flowing on the OLD generation throughout, and a
                verify/canary failure rolls back.
                202 = started, 200 = waited and finished (see
                ``outcome``), 409 = one already in flight, 403 =
                missing/wrong ``X-Admin-Token`` when the server has
                one configured."""
                if not self._admin_authorized():
                    self.close_connection = True   # body left unread
                    self._reply(403, {
                        "error": "admin token required (supply "
                                 "X-Admin-Token)"})
                    return
                raw = self._read_body()
                if raw is None:
                    return
                try:
                    payload = _json_object(raw)
                    model = payload.get("model")
                    if model is not None and not isinstance(model, str):
                        raise ValueError("'model' must be a path string")
                    # zoo: "name" selects WHICH registered model swaps
                    # (absent → the default model, the single-model
                    # contract); "model" stays the artifact path
                    name = payload.get("name")
                    if name is not None and not isinstance(name, str):
                        raise ValueError("'name' must be a model name "
                                         "string")
                    wait = bool(payload.get("wait", False))
                except Exception as e:
                    self._reply(400, {"error": f"bad request: {e}"})
                    return
                try:
                    outer.zoo.resolve(name)
                except zoo_mod.UnknownModel as e:
                    self._reply(404, {"error": str(e)})
                    return
                worker = outer.reload_async(model, name=name)
                if worker is None:
                    # honest come-back time, consistent with the
                    # 429/503 paths.  The single-flight lock spans the
                    # WHOLE zoo, so the in-flight reload may be some
                    # other model's — size the estimate on the worst
                    # last duration any entry has seen, not on the
                    # named model's (whose "never reloaded" would
                    # suggest an instant 1s retry against a slow roll)
                    ra = outer.reload_retry_after()
                    self._reply(409, {
                        "error": "a reload is already in progress",
                        "retry_after_s": ra,
                        **outer.reload_status(name)},
                        {"Retry-After": str(ra)})
                    return
                if wait:
                    worker.join(outer.default_timeout_s)   # bounded
                    status = outer.reload_status(name)
                    code = 200 if not worker.is_alive() else 202
                    self._reply(code, {"status": "done"
                                       if code == 200 else "running",
                                       **status})
                else:
                    self._reply(202, {"status": "reload started",
                                      **outer.reload_status(name)})

            def _admin_placement(self):
                """``POST /admin/placement`` — the fleet router's
                eviction hint.

                Body: ``{"models": ["a", "b"]}`` = the tenants PLACED
                on this backend, or ``{"models": null}`` to clear the
                hint.  Non-placed device copies release immediately
                and evict first under budget pressure
                (``ModelZoo.set_placement_hint``); unknown names are
                reported, not fatal — the router's registry view may
                briefly lead or lag ours.  403 = missing/wrong
                ``X-Admin-Token`` when one is configured, 400 = junk
                body."""
                if not self._admin_authorized():
                    self.close_connection = True   # body left unread
                    self._reply(403, {
                        "error": "admin token required (supply "
                                 "X-Admin-Token)"})
                    return
                raw = self._read_body()
                if raw is None:
                    return
                try:
                    payload = _json_object(raw)
                    models = payload.get("models")
                    if models is not None and (
                            not isinstance(models, list)
                            or not all(isinstance(m, str)
                                       for m in models)):
                        raise ValueError("'models' must be a list of "
                                         "model-name strings, or null "
                                         "to clear the hint")
                except Exception as e:
                    self._reply(400, {"error": f"bad request: {e}"})
                    return
                self._reply(200, {"status": "ok",
                                  **outer.zoo.set_placement_hint(models)})

            def _predict(self):
                raw = self._read_body()
                if raw is None:
                    return
                # content negotiation for the RESPONSE is independent
                # of the request format: a JSON client may ask for
                # binary outputs and vice versa
                want_binary = wire.CONTENT_TYPE in (
                    self.headers.get("Accept") or "")
                try:
                    ctype = (self.headers.get("Content-Type") or "")
                    ctype = ctype.split(";", 1)[0].strip().lower()
                    binary_in = ctype == wire.CONTENT_TYPE
                    if binary_in:
                        # zero-copy leg: one bounds-checked
                        # np.frombuffer over the raw bytes — request
                        # fields travel as headers only (the payload
                        # IS the tensor), so `payload` stays empty
                        # and the field precedence below is unchanged
                        payload = {}
                        x = wire.decode_tensor(raw)
                        if x.dtype != np.float32:
                            x = x.astype(np.float32)
                    else:
                        # parse ONCE; the dict threads through the
                        # rest of the leg (model/deadline fields)
                        payload = _json_object(raw)
                        x = np.asarray(payload["inputs"], np.float32)
                    _wire_requests.inc(
                        format="binary" if binary_in else "json")
                    if x.ndim == 1:
                        x = x[None]
                    self._rec_rows = int(len(x))
                    self._rec_shape = [int(d) for d in x.shape[1:]]
                    # zoo routing: X-Model beats the body's "model"
                    # (same precedence rule as the deadline — a proxy
                    # can pin a tenant without rewriting bodies);
                    # neither → the default model (single-model contract)
                    model_name = self.headers.get("X-Model")
                    if model_name is not None:
                        # an empty header is "unset" (same reading as
                        # X-Criticality below): fall through to the
                        # body field / default model, never a 404 on
                        # the literal name ""
                        model_name = model_name.strip() or None
                    if model_name is None:
                        model_name = payload.get("model")
                        if model_name is not None \
                                and not isinstance(model_name, str):
                            raise ValueError(
                                "'model' must be a model name string")
                    deadline_ms = payload.get("deadline_ms")
                    # X-Deadline-Ms beats the body field (a proxy can
                    # tighten a budget without rewriting the body)
                    hdr = self.headers.get("X-Deadline-Ms")
                    if hdr is not None:
                        deadline_ms = hdr
                    if deadline_ms is not None:   # junk → 400, not 503
                        deadline_ms = float(deadline_ms)
                    criticality = self.headers.get("X-Criticality")
                    if criticality is not None:
                        criticality = criticality.strip().lower()
                        if not criticality:
                            # an empty header is "unset", exactly as
                            # pre-zoo `(header or "default")` read it
                            # — the tenant default applies, not a 400
                            criticality = None
                        elif criticality not in overload.CRITICALITIES:
                            # a typo'd class is a client bug: silently
                            # demoting (or promoting) it would be worse
                            raise ValueError(
                                f"X-Criticality {criticality!r}; "
                                f"expected one of "
                                f"{overload.CRITICALITIES}")
                except Exception as e:
                    # ANY parse/shape failure is the client's error: a
                    # JSON 400 body, never a raw 500 traceback (ragged
                    # rows, non-dict payloads, unparseable JSON, junk
                    # Content-Length all land here)
                    self._rec_error = f"bad request: {e}"
                    self._reply(400, {"error": f"bad request: {e}"})
                    return
                try:
                    entry = outer.zoo.resolve(model_name)
                except zoo_mod.UnknownModel as e:
                    # a routing miss, not a client-syntax error and not
                    # a server fault: 404, like any unknown resource
                    self._rec_error = str(e)
                    self._reply(404, {"error": str(e)})
                    return
                self._model_name = entry.name
                # tenant policy: explicit request values win; the
                # registry's criticality class and deadline default
                # cover the (typical) header-less majority of a
                # tenant's traffic — this is how a sheddable tenant
                # browns out before a critical one without every
                # client cooperating.  The server-wide default
                # deadline stays the last resort.
                criticality, deadline_ms = entry.effective_policy(
                    criticality, deadline_ms)
                if deadline_ms is None:
                    deadline_ms = outer.default_deadline_ms
                try:
                    outer.zoo.admit(entry)
                except zoo_mod.QuotaExceeded as e:
                    # per-tenant token bucket: same contract as the
                    # queue-full 429 — honest come-back time, never a
                    # silent drop
                    self._rec_error = str(e)
                    self._reply(429, {"error": str(e),
                                      "retry_after_s": e.retry_after},
                                {"Retry-After": str(e.retry_after)})
                    return
                # response memoization (serving.memo): an identical
                # input under an unchanged generation answers from the
                # per-model LRU without touching the batcher or the
                # device.  Keyed AFTER admission — quota policy still
                # governs the tenant's call rate — and BEFORE the
                # residency touch: a memo hit must not page an evicted
                # model back in to not use it.
                cache = entry.response_cache
                ckey = None
                if cache is not None:
                    memo_gen = _memo_generation(entry.engine)
                    if memo_gen is not None:
                        ckey = cache.key_for(memo_gen, x)
                        y = cache.get(ckey)
                        if y is not None:
                            self._reply_outputs(y, want_binary,
                                                generation=memo_gen)
                            self._capture(entry, x, y)
                            return
                # residency: the request that wakes a cold model pays
                # its page-in here (single-flight — a concurrent
                # eviction race parks on the generation lock), and
                # colder tenants are evicted to fit the budget
                outer.zoo.touch(entry)
                try:
                    y = entry.batcher.predict(
                        x, deadline_ms=deadline_ms,
                        timeout=outer.default_timeout_s,
                        criticality=criticality or "default")
                except QueueFull as e:
                    self._rec_error = str(e)
                    self._reply(429, {"error": str(e),
                                      "retry_after_s": e.retry_after},
                                {"Retry-After": str(e.retry_after)})
                except overload.EarlyReject as e:
                    # draining / adaptive shed / doomed deadline: the
                    # request was refused BEFORE any work — 503 with
                    # an honest come-back time, same contract as the
                    # breaker's refusals (never a hang, never a 500)
                    self._rec_error = str(e)
                    self._reply(503, {"error": str(e),
                                      "retry_after_s": e.retry_after},
                                {"Retry-After": str(e.retry_after)})
                except DeadlineExceeded as e:
                    # the deadline died in the queue: the honest
                    # come-back time is the routed tenant's backlog —
                    # a fresh deadline submitted into the same backlog
                    # would die the same way
                    self._rec_error = str(e)
                    ra = entry.batcher.retry_after()
                    self._reply(504, {"error": str(e),
                                      "retry_after_s": ra},
                                {"Retry-After": str(ra)})
                except TimeoutError as e:
                    # server-side wait timeout (e.g. a slow first graph
                    # capture): retryable, and NOT an engine failure.
                    # The come-back time is the ROUTED tenant's
                    # backlog, not the default model's
                    self._rec_error = f"answer timeout: {e}"
                    ra = entry.batcher.retry_after()
                    self._reply(503, {"error": f"timed out waiting "
                                               f"for an answer: {e}",
                                      "retry_after_s": ra},
                                {"Retry-After": str(ra)})
                except ValueError as e:        # bad geometry for model
                    self._rec_error = str(e)
                    self._reply(400, {"error": str(e)})
                except EngineUnavailable as e:
                    # circuit open / fallback missing: graceful refusal
                    # with an honest come-back time, never a hang
                    self._rec_error = str(e)
                    self._reply(503, {"error": str(e),
                                      "retry_after_s": e.retry_after},
                                {"Retry-After": str(e.retry_after)})
                except Exception as e:
                    # the one genuinely unexpected leg: keep the FULL
                    # traceback for the flight recorder's error ring
                    # (the exception object came back from the batcher
                    # thread with its original raise site intact)
                    self._rec_error = "".join(
                        traceback.format_exception(
                            type(e), e, e.__traceback__))
                    ra = entry.batcher.retry_after()
                    self._reply(503, {"error": f"inference failed: "
                                               f"{e!r}"[:300],
                                      "retry_after_s": ra},
                                {"Retry-After": str(ra)})
                else:
                    y = np.asarray(y)
                    if not np.isfinite(y).all():
                        # bare NaN/Infinity tokens are not valid JSON —
                        # strict clients would choke on a 200 body
                        # (the binary format COULD carry them, but one
                        # contract across both formats beats a format-
                        # dependent error surface)
                        self._rec_error = ("model produced non-finite "
                                           "outputs")
                        self._reply(500, {
                            "error": "model produced non-finite "
                                     "outputs (inf/nan) for these "
                                     "inputs"})
                    else:
                        if ckey is not None:
                            # memoize only finite, served answers — a
                            # 500 must re-judge on the next attempt
                            # (ckey is None when the cache is off OR
                            # bypassed for a mixed-generation fleet)
                            cache.put(ckey, y)
                        self._reply_outputs(y, want_binary,
                                            generation=entry.generation)
                        self._capture(entry, x, y)

        self.server = DeepBacklogHTTPServer((host, port), Handler)
        # collector registration comes AFTER the bind: if the socket
        # constructor raises (port in use), __init__ unwinds and
        # stop() — the only unregister site — never runs, which would
        # leak a dead server's families into every later scrape
        REGISTRY.register_collector(self._collect_components)
        self.port = self.server.server_address[1]
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True,
                                        name="znicz-serving-http")
        # hot-reload worker bookkeeping (single-flight at the server
        # tier too, so /admin/reload can answer 409 without consuming
        # the engine's own non-blocking lock)
        self._reload_mu = threading.Lock()
        self._reload_thread: threading.Thread | None = None
        #: optional status() of an in-process promotion controller —
        #: surfaced on /healthz when attached
        self.promotion_status = None
        #: optional attached SLOEngine (telemetry.sloengine) — serves
        #: GET /alertz and the /statusz SLO section; caller-owned
        #: lifecycle, same contract as the promotion attach
        self.slo_engine = None
        #: engine_busy_ratio bookkeeping: (monotonic stamp, device ms
        #: total) of the previous scrape, so the collector reports the
        #: scrape-to-scrape busy fraction instead of a lifetime average
        self._busy_lock = threading.Lock()
        self._busy_prev = (time.monotonic(), self._device_ms_now())

    def attach_promotion(self, status_fn) -> None:
        """Surface a promotion controller's ``status()`` on
        ``/healthz`` — a rollout controller or load
        balancer polls one endpoint for breaker, generation, AND
        promotion state."""
        self.promotion_status = status_fn

    def attach_slo(self, engine) -> None:
        """Attach a :class:`~znicz_tpu_torch.telemetry.sloengine.SLOEngine`
        so ``GET /alertz`` and the ``/statusz`` SLO section render its
        judgment.  The caller
        keeps lifecycle ownership (``start``/``stop``), exactly like
        the promotion attach."""
        self.slo_engine = engine

    def slo_status(self) -> dict | None:
        """The attached SLO engine's ``status()`` (None when no
        engine is attached); a wedged engine must not take the
        introspection surfaces down with it."""
        eng = self.slo_engine
        if eng is None:
            return None
        try:
            return eng.status()
        except Exception:
            return {"error": "slo engine status probe failed"}

    def alertz(self) -> dict:
        """The ``GET /alertz`` payload: active burn-rate alerts plus
        every SLO's current readings — ``enabled: false`` (and no
        alerts) when no SLO engine is attached, so probers can hit the
        route unconditionally."""
        status = self.slo_status()
        if status is None:
            return {"enabled": False, "alerts": []}
        return {"enabled": True, **status}

    def _device_ms_now(self) -> float:
        """Measured device ms across every tenant's engine right now
        (the engine_busy_ratio collector's numerator source)."""
        total = 0.0
        for entry in self.zoo.entries():
            fn = getattr(entry.engine, "device_ms_total", None)
            if fn is not None:
                total += fn()
        return total

    # -- hot reload -------------------------------------------------------
    def reload_status(self, name: str | None = None) -> dict:
        """One model's generation + last reload outcome (None = the
        default model — the single-model shape, unchanged)."""
        entry = self.zoo.resolve(name)
        status = entry.engine.reload_status()
        if self._zoo_explicit:
            status["model"] = entry.name
        return status

    def reload_retry_after(self) -> int:
        """Come-back estimate while a reload holds the single-flight
        slot: the worst last-reload duration across every zoo entry
        (the busy reload may be any model's), bounded [1, 30]s."""
        worst_ms = 0.0
        for entry in self.zoo.entries():
            last = (entry.engine.reload_status() or {}
                    ).get("last_reload") or {}
            worst_ms = max(worst_ms,
                           float(last.get("duration_ms") or 0.0))
        return max(1, min(30, int(worst_ms / 1e3) + 1))

    def reload_async(self, model: str | None = None, *,
                     name: str | None = None
                     ) -> threading.Thread | None:
        """Start a background hot reload of ``model`` (None = re-read
        the entry's current artifact path) for zoo entry ``name``
        (None = the default model).  Returns the worker thread, or
        None when a reload is already in flight.  The old generation
        serves throughout; outcomes land in the engine's
        ``last_reload`` / ``/healthz`` / ``model_reloads_total`` —
        and only THAT entry's generation/caches move: tenants are
        separate engines by construction."""
        with self._reload_mu:
            if self._reload_thread is not None \
                    and self._reload_thread.is_alive():
                return None
            worker = threading.Thread(
                target=self._reload_worker, args=(model, name),
                daemon=True, name="znicz-model-reload")
            self._reload_thread = worker
            worker.start()
            return worker

    def reload_all_async(self) -> threading.Thread | None:
        """Re-read EVERY zoo artifact in place, rolling one model at a
        time (the SIGHUP channel); single-flight with
        :meth:`reload_async`.  On a single-model server this is
        exactly the old SIGHUP behavior."""
        with self._reload_mu:
            if self._reload_thread is not None \
                    and self._reload_thread.is_alive():
                return None
            worker = threading.Thread(
                target=self._reload_all_worker, daemon=True,
                name="znicz-model-reload")
            self._reload_thread = worker
            worker.start()
            return worker

    def _reload_worker(self, model: str | None,
                       name: str | None = None) -> None:
        # engine.reload never raises for artifact problems (they are
        # outcomes, not crashes); anything else must not kill the
        # worker silently either — the server keeps serving regardless
        try:
            # census-driven warmup of the new generation rides the
            # engine reload itself (every reload channel — admin,
            # SIGHUP, promotion controller — gets it uniformly); the
            # zoo wrapper re-stamps recency and re-balances residency
            self.zoo.reload(name, model)
        except Exception:
            import logging
            logging.getLogger("ServingServer").exception(
                "hot reload worker failed")

    def _reload_all_worker(self) -> None:
        try:
            self.zoo.reload_all()
        except Exception:
            import logging
            logging.getLogger("ServingServer").exception(
                "zoo-wide hot reload worker failed")

    # -- payloads -----------------------------------------------------------
    def health(self) -> dict:
        state = self.engine.resilience_state()
        if self._draining:
            # a draining replica must drop out of rotation BEFORE its
            # refusals reach clients — the probe is how balancers learn
            state = "draining"
        out = {"status": state, "backend": self.engine.backend,
               "n_layers": self.engine.n_layers,
               "buckets": list(self.engine.buckets),
               "queue_depth": self.batcher.queue_depth(),
               # build + age at the health tier: fleet tooling spots a
               # stale (wrong rev) or flapping (uptime keeps resetting)
               # replica from the probe it already makes, without
               # scraping /metrics
               "rev": self.rev,
               "uptime_s": round(debugz.process_uptime_s(), 1)}
        # generation + last reload outcome: a rollout controller polls
        # /healthz to learn whether its /admin/reload landed
        out.update(self.engine.reload_status())
        # the serving mesh: one device (the reference's value at tp=1)
        # and, behind a replica set, every replica's breaker — a
        # degraded replica is visible from the probe a balancer already
        # makes
        out["mesh"] = ONE_DEVICE_MESH
        replica_status = getattr(self.engine, "replica_status", None)
        if replica_status is not None:
            out["replicas"] = replica_status()
        if self._zoo_explicit:
            # the per-model table: generation, residency, criticality
            # class, queue depth and state per tenant — a rollout
            # controller or balancer learns the whole zoo from the probe
            # it already makes
            out["models"] = self.zoo.status()
            out["default_model"] = self.zoo.default_name
            # device bytes actually held, fleet-visible: the router's
            # placement tier sums this across backends to prove the
            # ≤ (1 + replication) × zoo footprint bound
            out["resident_bytes"] = self.zoo.resident_bytes()
        ps = self.promotion_status
        if ps is not None:
            try:
                out["promotion"] = ps()
            except Exception:
                # a wedged controller must not take /healthz down —
                # the probe is exactly how you notice it wedged
                out["promotion"] = {"state": "unknown"}
        if state != "ok":      # give probers the why + the come-back
            out["breaker"] = self.engine.breaker.metrics()
            out["retry_after_s"] = int(self.engine.breaker.retry_after())
        return out

    def overload_status(self, bm: dict | None = None) -> dict:
        """The overload-defense snapshot /statusz renders (and the
        JSON /metrics view embeds): drain state, default deadline,
        measured queue wait, shed ladder, hedge policy, and the
        process retry budget's level.  ``bm`` lets :meth:`metrics`
        reuse its already-computed batcher snapshot instead of
        sorting the latency deques twice under the batcher lock."""
        if bm is None:
            bm = self.batcher.metrics()
        out = {"draining": self._draining,
               "default_deadline_ms": self.default_deadline_ms,
               "queue_wait_p50_ms": bm.get("queue_wait_p50_ms"),
               "queue_wait_p95_ms": bm.get("queue_wait_p95_ms"),
               "shed": bm.get("shedder"),
               "doomed": bm.get("doomed", 0),
               "expired": bm.get("expired", 0)}
        hedge_status = getattr(self.engine, "hedge_status", None)
        if hedge_status is not None:
            out["hedge"] = hedge_status()
        budget = overload.process_budget()
        if budget is not None:
            out["retry_budget"] = budget.metrics()
        return out

    def zoo_status(self) -> dict | None:
        """The zoo snapshot /statusz renders as a per-model table
        (None on a single-model server — nothing to tabulate)."""
        return self.zoo.metrics() if self._zoo_explicit else None

    def engine_metrics(self) -> dict:
        """The default model's engine metrics with the serving layout
        the reference's engine reports: one device, ``tensor_parallel``
        1 and ``mesh`` ``1x1`` (the port's engine has no mesh)."""
        em = self.engine.metrics()
        em.setdefault("tensor_parallel", 1)
        em.setdefault("mesh", ONE_DEVICE_MESH)
        return em

    def metrics(self) -> dict:
        m = self.batcher.metrics()
        m["engine"] = self.engine_metrics()
        m["overload"] = self.overload_status(bm=m)
        rc = self.zoo.resolve().response_cache
        if rc is not None:
            # only when memoization is ON: the pre-memo JSON surface
            # must not grow keys under scrapers pinned to it
            m["response_cache"] = rc.metrics()
        if self.capture is not None:
            # same opt-in rule as the response cache: the capture
            # block only exists when the tap does
            m["capture"] = self.capture.metrics()
        slo = self.slo_status()
        if slo is not None:
            m["slo"] = slo
        if self._zoo_explicit:
            # top-level fields stay the DEFAULT model's (the
            # single-model shape); the zoo block carries every tenant
            m["zoo"] = self.zoo.metrics()
        # build attribution + the registry's request totals: the same
        # Counter objects back the Prometheus text view, so the two
        # formats can never disagree
        m["rev"] = self.rev
        # NOTE: these are PROCESS totals (the registry counters are
        # process-wide by design) — with several servers in one
        # process they aggregate across all of them
        m["requests"] = {
            "requests_total": int(self._requests.total()),
            "errors_total": int(self._errors.total()),
            # per-route/code children, same label keys as the text
            # view — comparing the views on a specific route sidesteps
            # the one-off skew the scrape requests themselves introduce
            "requests_by_route_code": self._requests.as_dict(),
            "errors_by_route_code": self._errors.as_dict()}
        return m

    def prometheus_metrics(self) -> str:
        """The registry (first-class instruments + this server's
        component collector) as Prometheus text exposition v0.0.4."""
        return REGISTRY.render_prometheus()

    def tracez(self, model: str | None = None,
               min_ms: float | None = None,
               outcome: str | None = None, n: int = 64) -> dict:
        """``GET /tracez`` body: the tail-sampled store's filtered
        snapshot, the store's retention stats, and the latency
        histogram's bucket exemplars (trace ids a dashboard can join
        back to the stored traces)."""
        out = self.tracestore.snapshot(model=model, min_ms=min_ms,
                                       outcome=outcome, n=n)
        out["store"] = self.tracestore.stats()
        out["exemplars"] = {"predict_latency_ms":
                            self._latency.exemplars()}
        return out

    def _collect_components(self):
        """Registry collector: flatten the batcher/engine JSON scalars
        into ``serving_batcher_*`` / ``serving_engine_*`` gauges and
        the breaker into a state enum + trip/probe counters — sampled
        at scrape time from the SAME dicts the JSON view serves."""
        fams = []
        em = self.engine_metrics()
        for prefix, d in (("serving_batcher_", self.batcher.metrics()),
                          ("serving_engine_", em)):
            for k, v in sorted(d.items()):
                if isinstance(v, bool) or not isinstance(v, (int, float)) \
                        or (d is em and k in PORT_ENGINE_FIELDS):
                    continue              # dicts/strings/None stay JSON
                fams.append(("gauge", prefix + k,
                             f"mirror of the /metrics JSON field {k!r}",
                             [(None, float(v))]))
        breaker = em.get("breaker") or {}
        state = breaker.get("state")
        if state:
            fams.append((
                "gauge", "breaker_state",
                "circuit breaker state (the sample valued 1 is "
                "current)",
                [({"state": s}, 1.0 if s == state else 0.0)
                 for s in ("closed", "open", "half_open")]))
            fams.append(("counter", "breaker_trips_total",
                         "closed/half_open -> open transitions",
                         [(None, float(breaker.get("trips", 0)))]))
            fams.append(("counter", "breaker_probes_total",
                         "half-open probe attempts granted",
                         [(None, float(breaker.get("probes", 0)))]))
        # scrape-to-scrape busy fraction: measured device ms spent
        # since the previous scrape over the wall time elapsed — the
        # "is the chip the bottleneck" one-number answer (a lifetime
        # average would bury today's overload under yesterday's idle)
        now = time.monotonic()
        total_ms = self._device_ms_now()
        with self._busy_lock:
            prev_t, prev_ms = self._busy_prev
            self._busy_prev = (now, total_ms)
        wall_ms = (now - prev_t) * 1e3
        busy = (max(0.0, min(1.0, (total_ms - prev_ms) / wall_ms))
                if wall_ms > 0 else 0.0)
        fams.append((
            "gauge", "engine_busy_ratio",
            "fraction of wall time since the previous scrape spent "
            "inside fenced engine forwards (all tenants; > 1 clamps "
            "— replicas can overlap)",
            [(None, round(busy, 4))]))
        if self._zoo_explicit:
            # per-model families, sampled from the same rows /healthz
            # serves — a scraper sees every tenant without N scrape
            # targets (model-labeled, bounded by registry size)
            rows = self.zoo.status()
            fams.append((
                "gauge", "model_queue_depth",
                "queued requests per zoo model's own batcher",
                [({"model": r["model"]}, float(r["queue_depth"]))
                 for r in rows]))
            fams.append((
                "gauge", "model_weight_bytes",
                "host/device byte size of each zoo model's serving "
                "generation (what the residency budget accounts)",
                [({"model": r["model"]}, float(r["weight_bytes"]))
                 for r in rows]))
            fams.append((
                "gauge", "zoo_model_generation",
                "serving generation per zoo model (the unlabeled "
                "model_generation gauge is last-swap-wins across "
                "tenants)",
                [({"model": r["model"]}, float(r["generation"]))
                 for r in rows]))
        return fams

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "ServingServer":
        self._thread.start()
        return self

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Graceful shutdown: stop admitting (new ``/predict`` work is
        refused 503 + ``Retry-After`` and ``/healthz`` turns
        ``draining`` so balancers rotate this replica out), wait —
        bounded by ``timeout_s`` — for every already-admitted request
        to be answered, then :meth:`stop`.  Returns True when the
        queue fully drained before the bound.  This is what the serve
        CLI runs on SIGTERM."""
        self._draining = True
        overload.set_drain_state(overload.DRAIN_DRAINING)
        # every tenant's batcher drains, sharing ONE deadline — a
        # multi-model replica must not hold its eviction slot N times
        # longer than a single-model one
        deadline = time.monotonic() + float(timeout_s)
        drained = True
        for entry in self.zoo.entries():
            if entry.batcher is None:
                continue
            left = max(0.0, deadline - time.monotonic())
            drained = entry.batcher.drain(left) and drained
        # the batcher answered every request (events set), but the
        # handler threads still have to wake and WRITE the responses —
        # give them a beat before the listener goes away, or a CLI
        # exit right after drain() can cut the last bytes off
        time.sleep(0.25)
        self.stop()
        if drained:
            # a timed-out drain stays at 1: the gauge exists to tell
            # an orchestrator whether the shutdown was clean, and a
            # cut-off in-flight request is exactly the case it must
            # not mask
            overload.set_drain_state(overload.DRAIN_DRAINED)
        return drained

    def stop(self) -> None:
        if self._stopped:
            return          # drain() already stopped us; idempotent
        self._stopped = True
        REGISTRY.unregister_collector(self._collect_components)
        self.server.shutdown()
        self.server.server_close()
        # close every batcher THIS server built (one per zoo entry);
        # caller-attached batchers stay the caller's to close
        for b in self._built_batchers:
            b.close()

    @property
    def url(self) -> str:
        host, port = self.server.server_address[:2]
        return f"http://{host}:{port}/"


def main(argv=None) -> int:
    """CLI entry for ``python -m znicz_tpu_torch serve``: every flag of the
    reference's ``serve``.  ``--backend auto`` means the CUDA card and
    raises without one; ``cpu`` (torch on the host) and ``native`` (the
    C++ engine) are chosen explicitly.  ``--tp`` above 1 parses and
    raises, naming the ROADMAP.md queue 1 item that brings it.
    ``--compile-cache-dir`` points the kernel builds at a directory
    later starts share; at exit the process prints its compiler runs."""
    import argparse

    p = argparse.ArgumentParser(
        prog="znicz_tpu_torch serve",
        description="serve trained models (.znn) over HTTP with "
                    "dynamic micro-batching — one model or a whole "
                    "multi-tenant zoo (docs/serving.md)")
    p.add_argument("--model", action="append", metavar="SPEC",
                   help="model to serve: a bare .znn path "
                        "(single-model mode, the historical contract) "
                        "or NAME=PATH[,criticality=sheddable|default|"
                        "critical][,deadline-ms=N][,quota-rps=N]"
                        "[,quota-burst=N][,default] — repeatable, "
                        "combines with --zoo (a NAME=... spec "
                        "overrides the scanned entry of that name)")
    p.add_argument("--zoo", default=None, metavar="DIR",
                   help="serve every *.znn in DIR as a model named by "
                        "its file stem; /predict routes by the "
                        "X-Model header / body 'model' field "
                        "(docs/serving.md 'Multi-tenant model zoo')")
    p.add_argument("--memory-budget-mb", type=float, default=None,
                   help="weight-residency budget across the zoo: when "
                        "resident device weights exceed it, the "
                        "coldest models' copies are evicted and paged "
                        "back in on demand (default: no eviction)")
    p.add_argument("--default-model", default=None, metavar="NAME",
                   help="model served when a request names none "
                        "(default: the first registered; a spec's "
                        "',default' flag does the same)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8100)
    p.add_argument("--backend", default="auto",
                   choices=("auto", "cuda", "cpu", "native"),
                   help="auto = cuda (raises without a card); cpu = "
                        "torch on the host; native = the C++ engine")
    p.add_argument("--buckets", default="1,8,32,128",
                   help="comma-separated pad-to batch buckets")
    p.add_argument("--cache-size", type=int, default=8,
                   help="max cached per-bucket executables (LRU)")
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--max-queue", type=int, default=128,
                   help="admission-queue bound (rows) before 429s")
    p.add_argument("--timeout-s", type=float, default=60.0,
                   help="per-request server-side answer timeout "
                        "(raise for models whose first graph capture "
                        "is slow)")
    p.add_argument("--max-body-mb", type=float, default=64.0,
                   help="largest accepted /predict body (413 beyond)")
    p.add_argument("--quantize", default="none",
                   choices=("none", "int8"),
                   help="int8 quantized serving for the fc-heavy "
                        "families: per-generation symmetric "
                        "per-channel int8 weight copies with fp32 "
                        "accumulation, VERIFIED at load against the "
                        "fp32 forward on a seeded batch — a tolerance "
                        "breach falls back to fp32 (counted in "
                        "quantize_fallback_total).  Per-model "
                        "override: --model NAME=PATH,quantize=int8")
    p.add_argument("--memoize", type=int, default=0, metavar="N",
                   help="response memoization: keep up to N recent "
                        "(generation, input-digest) → output entries "
                        "PER MODEL and answer repeat inputs without a "
                        "device call (0 = off, the historical "
                        "contract; a hot reload swaps the key space, "
                        "so a new generation never serves its "
                        "predecessor's outputs)")
    p.add_argument("--memoize-mb", type=float, default=32.0,
                   help="byte bound per model's response cache "
                        "(entries evict LRU-first under either bound)")
    p.add_argument("--capture-dir", default=None, metavar="DIR",
                   help="traffic tap for the live-data loop: append "
                        "every served /predict (input, outputs) pair "
                        "to a bounded fsync'd segment ring in DIR — "
                        "fail-open (a capture failure never fails or "
                        "delays an answer; drops are counted in "
                        "capture_dropped_total), replayed by `python "
                        "-m znicz_tpu_torch online-train` "
                        "(docs/online.md)")
    p.add_argument("--capture-sample", type=float, default=1.0,
                   help="fraction of served answers captured "
                        "(seeded; the rest count as "
                        "capture_dropped_total{reason=sampled})")
    p.add_argument("--capture-mb", type=float, default=64.0,
                   help="byte budget of the capture ring: past it the "
                        "oldest closed segment files are deleted")
    p.add_argument("--default-deadline-ms", type=float, default=None,
                   help="end-to-end deadline attached to requests "
                        "that send neither X-Deadline-Ms nor a body "
                        "deadline_ms (default: none — only explicit "
                        "deadlines are enforced); every hop checks "
                        "it and doomed work is refused early "
                        "(docs/resilience.md)")
    p.add_argument("--shed-target-ms", type=float, default=None,
                   help="adaptive (CoDel) load shedding: queue wait "
                        "standing above this target escalates the "
                        "brownout ladder — sheddable traffic first, "
                        "then default, critical never "
                        "(X-Criticality header; 0 disables shedding; "
                        "default: max(100, 2 x max-wait-ms), so a "
                        "long coalescing window never reads as "
                        "overload)")
    p.add_argument("--hedge", action="store_true",
                   help="hedged dispatch (needs --replicas >= 2): a "
                        "batch that outlives the observed p95 forward "
                        "latency fires one budget-gated second "
                        "attempt on another healthy replica, first "
                        "result wins — collapses slow-replica tail "
                        "latency")
    p.add_argument("--hedge-after-ms", type=float, default=None,
                   help="fixed hedge trigger instead of the adaptive "
                        "p95 (useful when a known SLO bound beats the "
                        "observed tail)")
    p.add_argument("--retry-budget", type=float, default=0.1,
                   help="process-wide retry budget: retries AND "
                        "hedges are limited to this fraction of "
                        "successful traffic (SRE retry-budget rule; "
                        "0 disables the budget and restores "
                        "unconditional per-call retries)")
    p.add_argument("--drain-timeout-s", type=float, default=20.0,
                   help="SIGTERM graceful drain bound: stop admitting "
                        "(503 + Retry-After), finish in-flight "
                        "requests up to this long, then exit")
    p.add_argument("--retry-attempts", type=int, default=3,
                   help="attempts per forward for transient device "
                        "errors (1 disables retries)")
    p.add_argument("--breaker-threshold", type=int, default=5,
                   help="consecutive forward failures before the "
                        "circuit opens and serving degrades")
    p.add_argument("--breaker-cooldown-s", type=float, default=10.0,
                   help="seconds the circuit stays open before a "
                        "half-open probe retries the device engine")
    p.add_argument("--warmup-shape", default=None, metavar="D[,D...]",
                   help="build (capture) every bucket executable for "
                        "this sample shape (e.g. '4' or '28,28,1') "
                        "BEFORE accepting traffic, so the builds record "
                        "as cause=cold instead of ambushing first "
                        "requests as new_bucket latency spikes; once "
                        "traffic flows, reload warmup is driven by "
                        "the observed request-shape census instead "
                        "of this guess")
    p.add_argument("--tp", type=int, default=1, metavar="N",
                   help="tensor-parallel forward over N devices (not "
                        "ported: any N > 1 raises, ROADMAP.md queue 1 "
                        "item 9)")
    p.add_argument("--replicas", type=int, default=1, metavar="N",
                   help="N data-parallel engine replicas behind the "
                        "batcher, each with its own breaker, cache "
                        "and generation; round-robin dispatch routes "
                        "around a replica whose breaker is open")
    p.add_argument("--compile-cache-dir", default=None, metavar="DIR",
                   help="persistent kernel-build cache: the hand-written "
                        "kernels build into and load from DIR, so a "
                        "second cold start runs no compiler (also: "
                        "$ZNICZ_COMPILE_CACHE; an unusable DIR logs and "
                        "runs uncached)")
    p.add_argument("--slo", action="append", metavar="SPEC",
                   help="declare one SLO judged as rolling multi-"
                        "window burn rates: NAME[,model=M]"
                        "[,objective=availability|latency]"
                        "[,target=99.9][,threshold-ms=N][,fast-s=N]"
                        "[,slow-s=N][,burn=N] — repeatable; alerts "
                        "surface on GET /alertz, /statusz and "
                        "slo_*{slo=,model=,window=} metric families "
                        "(docs/observability.md 'SLO engine')")
    p.add_argument("--slo-interval-s", type=float, default=10.0,
                   help="SLO engine snapshot cadence (window "
                        "arithmetic resolution; alerts cannot react "
                        "faster than this)")
    p.add_argument("--admin-token", default=None,
                   help="require this token (X-Admin-Token header) on "
                        "POST /admin/reload; defaults to "
                        "$ZNICZ_ADMIN_TOKEN — set one whenever the "
                        "listener is reachable beyond localhost "
                        "(SIGHUP stays the token-less local channel)")
    p.add_argument("--fault-plan", default=None,
                   help="chaos: install a fault plan (inline JSON or "
                        "@file; see znicz_tpu_torch.resilience.faults)")
    p.add_argument("--trace-sample", type=float, default=0.0,
                   metavar="RATE",
                   help="root a deterministic RATE fraction [0,1] of "
                        "UNTRACED /predict requests as local "
                        "distributed traces (GET /tracez); requests "
                        "arriving with an X-Znicz-Trace context are "
                        "always honored regardless — the fleet "
                        "router, not this flag, decides fleet "
                        "sampling (docs/observability.md "
                        "'Distributed tracing')")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="capture a torch.profiler Chrome trace of the "
                        "serving process into DIR (also: "
                        "$ZNICZ_PROFILE_DIR; CPU and CUDA activity on "
                        "the card)")
    p.add_argument("--profile-secs", type=float, default=60.0,
                   help="bound the --profile-dir capture to this many "
                        "seconds after startup (0 = until shutdown; "
                        "bounded is the default because an unbounded "
                        "trace of a long-lived server grows without "
                        "limit and is only written out at stop)")
    args = p.parse_args(argv)
    if args.tp > 1:
        raise NotImplementedError(
            f"serve --tp {args.tp}: tensor-parallel serving is not ported "
            f"yet; it comes with the port's parallelism (ROADMAP.md queue "
            f"1 item 9)")
    backend = "cuda" if args.backend == "auto" else args.backend
    # -- the model set: --zoo DIR scanned first, --model specs second
    # (a NAME=PATH spec overrides the scanned entry of the same name;
    # a single bare PATH with no zoo flags is the historical
    # single-model mode, byte-identical behavior)
    specs: dict = {}                      # name -> (path, options)
    order: list = []
    bare: list = []
    if args.zoo:
        for nm, path in zoo_mod.scan_zoo_dir(args.zoo).items():
            specs[nm] = (path, {})
            order.append(nm)
    for spec in args.model or []:
        nm, path, opts = zoo_mod.parse_model_spec(spec)
        if nm is None:
            bare.append(path)
        else:
            if nm not in specs:
                order.append(nm)
            specs[nm] = (path, opts)
    if not specs and not bare:
        p.error("pass --model and/or --zoo")
    single_mode = (not specs and len(bare) == 1
                   and args.memory_budget_mb is None
                   and args.default_model is None)
    if not single_mode:
        for path in bare:                 # bare paths: named by stem
            nm = os.path.splitext(os.path.basename(path))[0]
            if not nm:
                p.error(f"cannot derive a model name from {path!r}; "
                        f"use --model NAME=PATH")
            if nm not in specs:
                order.append(nm)
            specs[nm] = (path, {})
        if args.default_model is not None \
                and args.default_model not in specs:
            p.error(f"--default-model {args.default_model!r} is not "
                    f"among the registered models "
                    f"({sorted(specs) or bare})")
    if args.fault_plan is not None:
        from ..resilience import faults as _faults
        _faults.install(_faults.parse_plan(args.fault_plan))
    # register the promotion metric families (promotions_total,
    # promotion_generation, slo_breaches_total) so every serving
    # process scrapes them from zero — a dashboard must not see the
    # series appear only once a controller starts driving this replica
    from .. import promotion as _promotion  # noqa: F401
    # same contract for the SLO families (slo_burn_rate /
    # slo_budget_remaining / slo_alerts_total): registered at import,
    # scraped from zero even on replicas serving without --slo
    from ..telemetry import sloengine
    slo_specs = []
    for raw in args.slo or []:
        try:
            slo_specs.append(sloengine.parse_slo_spec(raw))
        except ValueError as e:
            p.error(str(e))
    from ..resilience.breaker import CircuitBreaker
    from ..resilience.retry import RetryPolicy
    # the kernel-build cache must be live before any engine loads a
    # kernel (warm-up or the first request): a second cold start then
    # finds every library built
    from .. import compilecache, cuda_build
    compilecache.enable(args.compile_cache_dir)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    # the retry budget is deliberately ONE object shared by every
    # replica's RetryPolicy and the hedge policy: unlike breakers
    # (which isolate per-replica failure domains), the budget is a
    # fleet-process-wide resource — that is exactly what stops a
    # correlated failure from multiplying into a retry storm
    budget = (overload.RetryBudget(ratio=args.retry_budget)
              if args.retry_budget > 0 else None)
    overload.set_process_budget(budget)
    # the shedding default is DERIVED from the coalescing window: an
    # operator who raises --max-wait-ms must not have that deliberate
    # batching patience read as standing overload (an EXPLICIT target
    # at or under max-wait-ms still fails fast in ServingServer)
    if args.shed_target_ms is None:
        shed_target_ms = max(100.0, 2.0 * args.max_wait_ms)
    else:
        shed_target_ms = (args.shed_target_ms
                          if args.shed_target_ms > 0 else None)

    def _make_engine(_i, path, quantize):
        # per-replica construction: breaker/retry/cache must be FRESH
        # per engine — a shared breaker would collapse the failure
        # domains --replicas exists to separate.  Same delay budget as
        # the engine's own default: the retry sleeps ride the single
        # dispatch thread, so they must stay well under the batcher's
        # cadence even at high --retry-attempts
        return ServingEngine(
            path, backend=backend,
            buckets=buckets, cache_size=args.cache_size, tp=args.tp,
            quantize=quantize,
            retry=RetryPolicy(max_attempts=args.retry_attempts,
                              base_delay_s=0.02, max_delay_s=0.25,
                              budget=budget),
            breaker=CircuitBreaker(
                failure_threshold=args.breaker_threshold,
                cooldown_s=args.breaker_cooldown_s))

    if args.replicas < 1:
        p.error("--replicas must be >= 1")
    if args.hedge and args.replicas < 2:
        p.error("--hedge needs --replicas >= 2 (a hedge goes to "
                "ANOTHER replica)")
    def _build_engine(path, quantize=None):
        # the topology knobs (--replicas/--hedge and --quantize)
        # apply per model: each zoo entry is its own replica set / TP
        # engine — hedges and retries still share the ONE process
        # budget.  A per-spec quantize= beats the global flag.
        quantize = args.quantize if quantize is None else quantize
        if args.replicas > 1:
            from .replicas import EngineReplicaSet
            hedge = (overload.HedgePolicy(after_ms=args.hedge_after_ms,
                                          budget=budget)
                     if args.hedge else None)
            return EngineReplicaSet(
                lambda i, _p=path, _q=quantize: _make_engine(i, _p,
                                                             _q),
                args.replicas, hedge=hedge)
        return _make_engine(0, path, quantize)

    if single_mode:
        zoo = None
        engine = _build_engine(bare[0])
        closer = engine.close
    else:
        zoo = zoo_mod.ModelZoo(
            memory_budget_bytes=(int(args.memory_budget_mb * 1e6)
                                 if args.memory_budget_mb else None))
        for nm in order:
            path, opts = specs[nm]
            zoo.add(nm, engine=_build_engine(path,
                                             opts.get("quantize")),
                    criticality=opts.get("criticality", "default"),
                    deadline_ms=opts.get("deadline_ms"),
                    quota_rps=opts.get("quota_rps"),
                    quota_burst=opts.get("quota_burst"),
                    default=(opts.get("default", False)
                             or nm == args.default_model))
        engine = zoo.resolve().engine     # the default model's
        closer = zoo.close
    from ..telemetry import profiler
    profile_dir = args.profile_dir or profiler.dir_from_env()
    server = None
    slo_engine = None
    capture = None
    try:
        # the trace starts BEFORE the server exists: the profiler
        # hooks every live Python thread, and hooking a
        # request-handler thread that is mid-flight at that instant
        # has been observed to wedge the hook (and with it, external
        # signal delivery).  Pre-server there is nothing to race.
        profile_deadline = None
        if profile_dir and profiler.start_trace(
                profile_dir,
                device="cpu" if backend in ("cpu", "native") else None):
            if args.profile_secs > 0:
                profile_deadline = time.monotonic() + args.profile_secs
            print(f"profiling into {profile_dir} (torch.profiler; a "
                  f"Chrome trace)", flush=True)
        # live-hang escape hatch: `kill -USR1 <pid>` dumps every
        # thread's Python stack to stderr — works even when the HTTP
        # threads themselves are what hung (telemetry.debugz; the same
        # snapshot serves GET /debug/threadz)
        from ..telemetry import debugz as _debugz
        _debugz.install_stack_dump()
        if args.warmup_shape:
            # census-driven with the operator shape as bootstrap: a
            # fresh process has no census yet, so this warms
            # --warmup-shape.  In zoo mode the shape targets the
            # DEFAULT model (sample shapes are per-family); other
            # tenants census-warm once traffic has flowed.
            shape = tuple(int(d) for d in args.warmup_shape.split(","))
            n = engine.warmup_from_census(fallback_shape=shape)
            print(f"warmup: {n} bucket executable(s) built for "
                  f"sample shape {shape} (cause=cold, off the "
                  f"request path)", flush=True)
        # construct THEN start: if start() unwinds (KeyboardInterrupt),
        # `server` must already be bound so the finally below can stop
        # it — a skipped stop() leaks the registry collector
        if args.capture_dir:
            # the traffic tap (docs/online.md): built before the
            # server so the first served answer can already capture;
            # closed in the finally below — the ring outlives the
            # process (a restarted server appends after it)
            from ..online.capture import CaptureLog
            capture = CaptureLog(
                args.capture_dir,
                max_bytes=int(args.capture_mb * 1e6),
                sample=args.capture_sample)
            print(f"capturing served traffic into "
                  f"{args.capture_dir} (sample "
                  f"{args.capture_sample:g}, budget "
                  f"{args.capture_mb:g} MB)", flush=True)
        kwargs = dict(host=args.host, port=args.port,
                      max_batch=args.max_batch,
                      max_wait_ms=args.max_wait_ms,
                      max_queue=args.max_queue,
                      default_timeout_s=args.timeout_s,
                      max_body_mb=args.max_body_mb,
                      admin_token=args.admin_token,
                      default_deadline_ms=args.default_deadline_ms,
                      shed_target_ms=shed_target_ms,
                      memo_entries=args.memoize,
                      memo_mb=args.memoize_mb,
                      capture=capture,
                      trace_sample=args.trace_sample)
        server = (ServingServer(engine, **kwargs) if zoo is None
                  else ServingServer(zoo=zoo, **kwargs))
        server.start()
        if slo_specs:
            # a spec naming an unknown tenant would judge zeros
            # forever — that is a config bug, refuse to boot on it
            known = set(zoo.names()) if zoo is not None else set()
            for spec in slo_specs:
                if spec.model is not None and spec.model not in known:
                    p.error(f"--slo names unknown model "
                            f"{spec.model!r} (serving: "
                            f"{sorted(known) or ['<single-model>']})")
            slo_engine = sloengine.SLOEngine.for_server(
                server, slo_specs, interval_s=args.slo_interval_s)
            server.attach_slo(slo_engine)
            slo_engine.start()
            print(f"slo engine: {len(slo_specs)} objective(s), "
                  f"tick {args.slo_interval_s:g}s "
                  f"(GET /alertz)", flush=True)
        mesh = ONE_DEVICE_MESH
        if zoo is None:
            what = bare[0]
        else:
            what = (f"zoo of {len(zoo)} models "
                    f"{zoo.names()} (default {zoo.default_name!r}, "
                    f"budget "
                    f"{args.memory_budget_mb or 'unbounded'} MB)")
        print(f"serving {what} [{engine.backend}] at "
              f"{server.url} (mesh {mesh}, replicas {args.replicas}; "
              f"POST /predict, GET /healthz, "
              f"GET /metrics, GET /statusz, GET /alertz, "
              f"GET /debug/*)", flush=True)
        # explicit shutdown signaling with a short-tick wait: Python
        # runs signal handlers on the main thread only when it next
        # executes bytecode, and the OS may deliver the C-level signal
        # to ANY thread (with a profiler's or CUDA's extra threads
        # live, a SIGINT can land on a worker, and a main thread parked
        # in one long wait would never wake to see it).  The 0.5s
        # tick bounds shutdown latency; SIGTERM gets the same clean
        # path as Ctrl-C for container runtimes.
        import signal as _signal
        stop = threading.Event()
        term = threading.Event()
        hup = threading.Event()

        def _arm():
            # SIGINT = stop NOW (an operator's Ctrl-C); SIGTERM = the
            # orchestrator's polite eviction — stop ADMITTING, finish
            # in-flight requests (bounded by --drain-timeout-s), then
            # exit: a rolling restart must not cut answers off mid-
            # flight
            _signal.signal(_signal.SIGINT, lambda *_: stop.set())
            _signal.signal(_signal.SIGTERM, lambda *_: term.set())
            # the thread-dump handler rides the same re-arm loop (the
            # native-lib sigaction clobbering below hits it too)
            _debugz.install_stack_dump()
            if hasattr(_signal, "SIGHUP"):
                # operator hot reload: `kill -HUP <pid>` re-reads
                # --model in place, the config-reload idiom ops tooling
                # already speaks — same verify/canary/rollback path as
                # POST /admin/reload
                _signal.signal(_signal.SIGHUP, lambda *_: hup.set())
        _arm()
        while not stop.is_set() and not term.is_set():
            stop.wait(0.5)
            _arm()    # native libs (a profiler's) can clobber the
            #           process sigaction; re-arming each tick keeps
            #           Ctrl-C/SIGTERM working for the whole lifetime
            if hup.is_set():
                hup.clear()
                # zoo-aware: re-read EVERY registered artifact in
                # place, one model at a time (single-model servers
                # have exactly one entry — the old behavior)
                if server.reload_all_async() is not None:
                    print("SIGHUP: hot reload started "
                          f"(generation {engine.generation})",
                          flush=True)
            if profile_deadline is not None \
                    and time.monotonic() >= profile_deadline:
                # windowed capture complete: write the trace NOW (an
                # operator profiling a live replica should not have to
                # stop it to read the trace) and let the profiler
                # worker threads wind down
                profile_deadline = None
                print(f"profile capture complete: "
                      f"{profiler.stop_trace()}", flush=True)
        if term.is_set():
            # graceful SIGTERM drain: admission stops (503 + Retry-
            # After, /healthz flips to "draining"), in-flight requests
            # finish — bounded — and only then does the listener die.
            # Before this existed, SIGTERM just stopped the tick loop
            # and the process teardown cut in-flight answers off.
            print(f"SIGTERM: draining (bound "
                  f"{args.drain_timeout_s:.0f}s; new requests get "
                  f"503 + Retry-After)", flush=True)
            drained = server.drain(args.drain_timeout_s)
            print(f"drain {'complete' if drained else 'timed out'}; "
                  f"exiting", flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        if profile_dir:
            profiler.stop_trace()
        if slo_engine is not None:
            slo_engine.stop()
        if server is not None:
            server.stop()
        if capture is not None:
            # after server.stop(): no new appends, so the drain is
            # bounded and the tail fsync covers the last answers
            capture.close()
        closer()      # zoo.close() (every engine) or engine.close()
        print(f"kernel builds: {json.dumps(cuda_build.BUILDS)} "
              f"(build dir {cuda_build.BUILD_DIR})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
