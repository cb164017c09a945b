"""SLO evaluation over the live telemetry registry.

The promotion controller's watch window needs one question answered
repeatedly: "is the generation that just swapped in serving *worse*
than the objectives?"  The signals already exist — the serving
front's ``predict_latency_ms`` histogram, the ``errors_total{route,code}``
counter, and the breaker state — so this module adds no new
instrumentation on the serve path; it snapshots those instruments and
evaluates **deltas between two snapshots**, which is what makes the
verdict about the *candidate*: everything served before the swap sits
in the baseline sample and cancels out.

Two sample builders over the same normalized :class:`SLOSample` shape:

* :func:`registry_sample` — read the process-wide registry directly
  (the in-process :class:`~znicz_tpu_torch.promotion.controller.EngineTarget`);
* :func:`prometheus_sample` — parse a ``GET /metrics`` Prometheus text
  exposition (the cross-process
  :class:`~znicz_tpu_torch.promotion.controller.HttpTarget`), so the
  controller can watch a server it does not share a process with.

Quantiles come from the histogram's fixed bucket edges: the reported
p99 is the **upper edge** of the bucket the quantile lands in (the
conservative reading every scraper makes — there are no raw samples to
interpolate over, by the registry's bounded-memory design).  A
quantile landing in the ``+Inf`` overflow bucket reports ``inf`` and
breaches any finite limit.

Error rate counts **5xx only**: a client flooding ``/predict`` with
malformed bodies earns 400s, and rolling back a healthy model because
of someone else's bug would make the controller itself the outage.
"""

from __future__ import annotations

import dataclasses
import math
import re
import time

from ..telemetry.registry import (DEFAULT_LATENCY_BUCKETS_MS, REGISTRY,
                                  MetricsRegistry)

_breaches = REGISTRY.counter(
    "slo_breaches_total",
    "SLO watch-window breaches that triggered a promotion rollback, "
    "by objective (p99_latency_ms | error_rate | breaker)")

#: the route whose latency/error series the SLO watch judges
PREDICT_ROUTE = "/predict"


@dataclasses.dataclass
class SLOSample:
    """One normalized snapshot of the serving SLO signals.

    ``latency_cum`` maps bucket upper edges (floats, ``math.inf`` for
    the overflow bucket) to *cumulative* observation counts — the raw
    shape both the registry histogram and the text exposition speak,
    kept cumulative so two samples subtract cleanly per edge."""

    at: float
    latency_cum: dict
    latency_count: float
    requests: float
    errors_5xx: float
    breaker_state: str | None = None


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """Objectives + watch cadence for one promotion.

    ``max_p99_ms`` / ``max_error_rate`` of None disable that
    objective; ``min_samples`` gates both (a window that saw almost no
    traffic proves nothing — the watch simply runs its course and the
    candidate is promoted on the evidence available, which is the
    behaviour a canary with no traffic must have).
    ``require_breaker_closed`` fails the window the moment the engine
    breaker leaves ``closed`` — the breaker tripping *during* a watch
    is the strongest possible "this generation is hurting" signal."""

    window_s: float = 30.0
    probe_interval_s: float = 2.0
    max_p99_ms: float | None = 250.0
    max_error_rate: float | None = 0.01
    min_samples: int = 5
    quantile: float = 0.99
    require_breaker_closed: bool = True

    def evaluate(self, start: SLOSample, now: SLOSample) -> list:
        """Breaches of this policy over the (start, now) delta — an
        empty list means the window is (so far) clean.  Each breach is
        ``{"slo": ..., "value": ..., "limit": ...}`` with the bounded
        ``slo`` names ``p99_latency_ms`` | ``error_rate`` |
        ``breaker`` (the ``slo_breaches_total`` label set)."""
        breaches = []
        if self.require_breaker_closed and now.breaker_state not in (
                None, "closed"):
            breaches.append({"slo": "breaker",
                             "value": now.breaker_state,
                             "limit": "closed"})
        d_count = now.latency_count - start.latency_count
        if self.max_p99_ms is not None and d_count >= self.min_samples:
            p = delta_quantile(start, now, self.quantile)
            if p is not None and p > self.max_p99_ms:
                breaches.append({"slo": "p99_latency_ms", "value": p,
                                 "limit": self.max_p99_ms})
        d_req = now.requests - start.requests
        if self.max_error_rate is not None \
                and d_req >= self.min_samples:
            rate = (now.errors_5xx - start.errors_5xx) / d_req
            if rate > self.max_error_rate:
                breaches.append({"slo": "error_rate", "value": rate,
                                 "limit": self.max_error_rate})
        return breaches


def count_breach(breach: dict) -> None:
    """Bump ``slo_breaches_total`` for one *acted-on* breach — called
    by the controller at rollback time, not per probe, so a single bad
    window counts each objective once instead of once per probe."""
    _breaches.inc(slo=str(breach.get("slo", "unknown")))


class BurnRatePolicy:
    """Burn-rate canary watch: judge the candidate on rolling
    multi-window error-budget burn instead of one whole-window delta.

    :class:`SLOPolicy` asks "did the window's aggregate p99/error-rate
    cross a line"; this asks the SRE-Workbook question — "at the rate
    the candidate is burning its error budget, is it *sustained*?" —
    by requiring BOTH a fast window (the last ``fast_window_s`` of
    probes) and the slow window (the whole watch so far) to exceed
    ``max_burn_rate``.  A one-probe blip cannot roll a healthy
    candidate back, and a genuine regression is caught as soon as the
    fast window fills instead of only at whatever rate dilutes the
    full-window average.  The arithmetic is
    :func:`znicz_tpu_torch.telemetry.sloengine.burn_between` — the same code
    the serving-side SLO engine alerts on, so the canary judge and the
    production pager can never disagree about what "burning" means.

    Duck-type-compatible with :class:`SLOPolicy` where the controller
    touches a policy (``window_s``, ``probe_interval_s``,
    ``evaluate(start, now)``); breaches carry ``slo="burn_rate"`` into
    ``slo_breaches_total``.  The probe ring resets itself when a new
    watch begins (a fresh ``start`` sample object), so one policy
    instance serves every candidate the controller drives."""

    def __init__(self, *, objective: str = "availability",
                 target: float = 0.999,
                 threshold_ms: float | None = None,
                 window_s: float = 30.0,
                 probe_interval_s: float = 2.0,
                 fast_window_s: float | None = None,
                 max_burn_rate: float = 2.0, min_samples: int = 5,
                 require_breaker_closed: bool = True):
        from ..telemetry import sloengine
        if objective not in sloengine.OBJECTIVES:
            raise ValueError(f"objective {objective!r}; expected one "
                             f"of {sloengine.OBJECTIVES}")
        if objective == "latency" and threshold_ms is None:
            raise ValueError("a latency burn-rate watch needs "
                             "threshold_ms")
        if not 0.0 < target < 1.0:
            raise ValueError(f"target must be a fraction in (0, 1), "
                             f"got {target!r}")
        self._burn_between = sloengine.burn_between
        self.objective = objective
        self.target = float(target)
        self.threshold_ms = threshold_ms
        self.window_s = float(window_s)
        self.probe_interval_s = float(probe_interval_s)
        # default fast window: wide enough for a couple of probes,
        # narrow enough to react well inside the watch
        self.fast_window_s = (float(fast_window_s)
                              if fast_window_s is not None
                              else max(2.0 * self.probe_interval_s,
                                       self.window_s / 6.0))
        if self.fast_window_s > self.window_s:
            raise ValueError(f"fast_window_s ({self.fast_window_s}) "
                             f"must fit inside window_s "
                             f"({self.window_s})")
        self.max_burn_rate = float(max_burn_rate)
        self.min_samples = int(min_samples)
        self.require_breaker_closed = bool(require_breaker_closed)
        self._watch_start = None
        self._ring: list = []

    @property
    def budget(self) -> float:
        return 1.0 - self.target

    def evaluate(self, start: SLOSample, now: SLOSample) -> list:
        """Same contract as :meth:`SLOPolicy.evaluate`: the breaches
        of this probe, empty while clean.  ``start`` is the watch
        baseline the controller sampled once; each ``now`` probe joins
        the internal ring the fast window slides over."""
        if start is not self._watch_start:
            # a new watch began: the previous candidate's probes must
            # not leak into this one's fast window
            self._watch_start = start
            self._ring = [start]
        self._ring.append(now)
        breaches = []
        if self.require_breaker_closed and now.breaker_state not in (
                None, "closed"):
            breaches.append({"slo": "breaker",
                             "value": now.breaker_state,
                             "limit": "closed"})
        kw = dict(budget=self.budget, objective=self.objective,
                  threshold_ms=self.threshold_ms,
                  min_events=self.min_samples)
        slow, _ev = self._burn_between(start, now, **kw)
        fast_base = start
        cut = now.at - self.fast_window_s
        for s in self._ring:
            if s.at <= cut:
                fast_base = s
            else:
                break
        fast, _ev = self._burn_between(fast_base, now, **kw)
        if fast >= self.max_burn_rate and slow >= self.max_burn_rate:
            breaches.append({"slo": "burn_rate",
                             "value": round(max(fast, slow), 4),
                             "limit": self.max_burn_rate})
        return breaches


def delta_quantile(start: SLOSample, now: SLOSample,
                   q: float = 0.99) -> float | None:
    """The ``q`` quantile (bucket upper edge) of the observations made
    *between* the two samples, or None when the delta is empty."""
    d_count = now.latency_count - start.latency_count
    if d_count <= 0:
        return None
    need = q * d_count
    for edge in sorted(now.latency_cum):
        cum = (now.latency_cum.get(edge, 0.0)
               - start.latency_cum.get(edge, 0.0))
        # float-safe >=: bucket counts are integral in spirit but
        # arrive as floats from both sample paths
        if cum + 1e-9 >= need:
            return edge
    return math.inf


# -- sample builders -------------------------------------------------------
def _route_code_sum(child_dict, route: str, min_code: int = 0) -> float:
    """Sum a labeled counter's children for one route (and codes >=
    ``min_code``).  ``child_dict`` is ``Counter.as_dict()`` output —
    ``{"code=200,route=/predict": n, ...}``, or a scalar when the
    counter has no children yet."""
    if not isinstance(child_dict, dict):
        return 0.0
    total = 0.0
    for key, value in child_dict.items():
        parts = key.split(",")
        if f"route={route}" not in parts:
            continue
        code = next((p[5:] for p in parts if p.startswith("code=")), "")
        try:
            if int(code) < min_code:
                continue
        except ValueError:
            continue
        total += value
    return total


def _edge_of(label: str) -> float:
    return math.inf if label in ("+Inf", "inf") else float(label)


def registry_sample(breaker_state: str | None = None,
                    registry: MetricsRegistry = REGISTRY) -> SLOSample:
    """Snapshot the SLO signals straight from a metrics registry (the
    in-process path).  Instrument lookups are get-or-create, so a
    sample taken before the first request simply reads zeros."""
    hist = registry.histogram("predict_latency_ms",
                              buckets=DEFAULT_LATENCY_BUCKETS_MS)
    h = hist.as_dict()
    if "buckets" not in h:
        # labeled children would nest one dict per label set; the
        # serving front records this histogram unlabeled, so this only
        # happens for an empty registry in tests — read zeros
        h = {"buckets": {}, "count": 0.0}
    latency_cum = {_edge_of(k): float(v)
                   for k, v in h["buckets"].items()}
    requests = _route_code_sum(
        registry.counter("requests_total").as_dict(), PREDICT_ROUTE)
    errors = _route_code_sum(
        registry.counter("errors_total").as_dict(), PREDICT_ROUTE,
        min_code=500)
    return SLOSample(at=time.time(), latency_cum=latency_cum,
                     latency_count=float(h["count"]), requests=requests,
                     errors_5xx=errors, breaker_state=breaker_state)


#: one exposition sample line: name, optional {labels}, value
_SERIES = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)\s*$")
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> list:
    """Minimal v0.0.4 text-exposition reader →
    ``[(name, {label: value}, float)]``.  Unparseable non-comment lines
    raise — a half-written scrape must fail the probe (and be retried)
    rather than feed the SLO evaluator garbage."""
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SERIES.match(line)
        if m is None:
            raise ValueError(f"unparseable exposition line: {line!r}")
        labels = dict(_LABEL.findall(m.group(2) or ""))
        raw = m.group(3)
        value = (math.inf if raw == "+Inf"
                 else -math.inf if raw == "-Inf" else float(raw))
        out.append((m.group(1), labels, value))
    return out


def prometheus_sample(text: str) -> SLOSample:
    """Build an :class:`SLOSample` from a ``/metrics`` text scrape
    (the cross-process path).  Breaker state comes from the
    ``breaker_state{state=...}`` 0/1 enum the serving collector
    exports; absent series read as zero/unknown, same as an empty
    registry."""
    latency_cum: dict = {}
    latency_count = 0.0
    requests = errors = 0.0
    breaker = None
    for name, labels, value in parse_prometheus(text):
        if name == "predict_latency_ms_bucket" and "le" in labels:
            latency_cum[_edge_of(labels["le"])] = value
        elif name == "predict_latency_ms_count" and not labels:
            latency_count = value
        elif name in ("requests_total", "errors_total"):
            if labels.get("route") != PREDICT_ROUTE:
                continue
            try:
                code = int(labels.get("code", ""))
            except ValueError:
                continue
            if name == "requests_total":
                requests += value
            elif code >= 500:
                errors += value
        elif name == "breaker_state" and value == 1.0:
            breaker = labels.get("state")
    return SLOSample(at=time.time(), latency_cum=latency_cum,
                     latency_count=latency_count, requests=requests,
                     errors_5xx=errors, breaker_state=breaker)
