"""Per-model SLOs evaluated as rolling multi-window burn rates (a copy
of the JAX package's ``telemetry/sloengine.py``, stdlib only, over the
port's registry).

The serving stack's raw signals (the registry, the per-tenant
``model_*{model=...}`` families) do not by themselves answer the
operator question they exist for: *is this tenant's SLO actually burning, and how fast?*  A
point-in-time error-rate snapshot cannot answer it — a 30-second blip
and a sustained brownout read identically.  This module is the missing
judgment layer, following the multi-window burn-rate practice from
Google's SRE Workbook:

* :class:`SLOSpec` — one declarative objective per (slo, model):
  **availability** (fraction of non-5xx answers) or **latency**
  (fraction of requests answered under ``threshold_ms``), each with a
  target (e.g. ``0.999`` ⇒ an error budget of 0.1%).
* **Burn rate** — the observed bad-event rate over a window divided by
  the budget rate: burn 1.0 spends the budget exactly at the sustain
  rate; burn 14.4 over a 5m+1h pair exhausts a 30-day budget in ~2
  days (the Workbook's paging tier).  Window lengths are configurable
  so tests (and the chaos drill) run in seconds.
* **Multi-window alerting with hysteresis** — an alert fires only when
  the **fast** AND **slow** windows both exceed ``burn_threshold``
  (the fast window gives reaction time, the slow window keeps a
  transient spike from paging) and de-asserts cleanly once the fast
  window drops back under (recovery is visible quickly; the slow
  window alone cannot hold a resolved incident open).  Transitions
  count into ``slo_alerts_total{slo,model,severity}`` and are recorded
  into the flight recorder (``kind="slo_alert"``), so ``/debug/
  flightrecorder`` shows alerts inline with the requests that burned
  the budget.
* **Error budget** — ``slo_budget_remaining{slo,model}`` tracks the
  budget left over the (configurable) compliance window, computed over
  the engine's retained snapshot history — bounded by construction
  (one fixed-size ring per spec), so a 30-day budget window on a
  10-second tick degrades to "over retained history" rather than
  growing without bound.

The engine only *reads*: every tick snapshots the existing registry
counters (``model_requests_total`` / ``model_latency_ms`` for zoo
tenants, the route-level ``requests_total`` / ``predict_latency_ms``
for a single-model server) and evaluates deltas between retained
snapshots — no new instrumentation on the serve path, the same stance
as the promotion SLO watch.  Surfaces: ``slo_burn_rate{slo,model,
window}`` gauges, ``GET /alertz`` and a ``/statusz`` SLO section; the
reference's promotion controller (not ported yet) reuses
:func:`burn_between` for its burn-rate canary watch.

Serve CLI: ``--slo 'latency,model=mnist,objective=latency,
threshold-ms=100,target=99.9'`` (repeatable; :func:`parse_slo_spec`).
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import math
import threading
import time

from .registry import DEFAULT_LATENCY_BUCKETS_MS, REGISTRY

log = logging.getLogger("sloengine")

OBJECTIVES = ("availability", "latency")
SEVERITIES = ("page", "ticket")

#: bound on retained snapshots per spec — a 30-day budget window on a
#: 10 s tick would otherwise hold 259k samples; past the cap the budget
#: is honestly computed over the retained history instead
MAX_SNAPSHOTS = 4096

_burn_g = REGISTRY.gauge(
    "slo_burn_rate",
    "error-budget burn rate per SLO and rolling window (1.0 = "
    "spending the budget exactly at the sustain rate), by slo, model "
    "and window (fast | slow)")
_budget_g = REGISTRY.gauge(
    "slo_budget_remaining",
    "fraction of the SLO's error budget left over the compliance "
    "window (1 = untouched, <= 0 = exhausted), by slo and model")
_alerts_c = REGISTRY.counter(
    "slo_alerts_total",
    "burn-rate alert firings (fast AND slow windows both over the "
    "threshold), by slo, model and severity")


@dataclasses.dataclass
class TenantSample:
    """One snapshot of a tenant's SLO signals — the same field shapes
    as the promotion watch's ``SLOSample`` (``latency_cum`` maps bucket
    upper edges, ``math.inf`` for overflow, to *cumulative* counts), so
    :func:`burn_between` serves both consumers."""

    at: float
    requests: float = 0.0
    errors_5xx: float = 0.0
    latency_cum: dict = dataclasses.field(default_factory=dict)
    latency_count: float = 0.0


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One declarative objective for one tenant.

    ``model=None`` targets the route-level single-model surface
    (``requests_total{route="/predict"}`` / ``predict_latency_ms``);
    a name targets that zoo tenant's ``model_*{model=...}`` families.
    ``target`` is the GOOD fraction (0.999 ⇒ 0.1% error budget);
    ``threshold_ms`` (latency objective only) snaps up to the nearest
    histogram bucket edge at evaluation — the registry keeps bucket
    counts, not raw samples, by design."""

    name: str
    model: str | None = None
    objective: str = "availability"
    target: float = 0.999
    threshold_ms: float | None = None
    fast_window_s: float = 300.0
    slow_window_s: float = 3600.0
    burn_threshold: float = 14.4
    budget_window_s: float = 30 * 86400.0
    min_events: int = 10
    severity: str = "page"

    def __post_init__(self):
        if not self.name:
            raise ValueError("an SLO needs a name")
        if self.objective not in OBJECTIVES:
            raise ValueError(f"objective {self.objective!r}; expected "
                             f"one of {OBJECTIVES}")
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"target must be a fraction in (0, 1), "
                             f"got {self.target!r} (99.9% is 0.999)")
        if self.objective == "latency" and self.threshold_ms is None:
            raise ValueError(f"slo {self.name!r}: a latency objective "
                             f"needs threshold_ms")
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity {self.severity!r}; expected "
                             f"one of {SEVERITIES}")
        if not 0 < self.fast_window_s <= self.slow_window_s:
            raise ValueError(
                f"slo {self.name!r}: need 0 < fast_window_s "
                f"({self.fast_window_s}) <= slow_window_s "
                f"({self.slow_window_s})")
        if self.burn_threshold <= 0 or self.budget_window_s <= 0:
            raise ValueError(f"slo {self.name!r}: burn_threshold and "
                             f"budget_window_s must be positive")

    @property
    def budget(self) -> float:
        """The error-budget rate: the bad-event fraction the target
        tolerates (0.999 -> 0.001)."""
        return 1.0 - self.target

    @property
    def model_label(self) -> str:
        return self.model if self.model is not None else "default"


# -- burn arithmetic (shared with promotion.slo.BurnRatePolicy) -------------

def latency_good(latency_cum: dict, threshold_ms: float) -> float:
    """Cumulative GOOD count: observations at or under the smallest
    bucket edge >= ``threshold_ms`` (the conservative snap — the
    registry retains bucket counts, not samples).  A threshold beyond
    the last finite edge reads the +Inf bucket: everything is good,
    which is what an unachievably-lax threshold means."""
    best_edge = None
    for edge in latency_cum:
        if edge >= threshold_ms and (best_edge is None
                                     or edge < best_edge):
            best_edge = edge
    if best_edge is None:
        best_edge = math.inf
    return float(latency_cum.get(best_edge, 0.0))


def good_bad(sample, objective: str,
             threshold_ms: float | None) -> tuple[float, float]:
    """(total events, bad events) of one sample under one objective."""
    if objective == "availability":
        return float(sample.requests), float(sample.errors_5xx)
    total = float(sample.latency_count)
    return total, total - latency_good(sample.latency_cum,
                                       float(threshold_ms))


def burn_between(start, end, *, budget: float,
                 objective: str = "availability",
                 threshold_ms: float | None = None,
                 min_events: int = 1) -> tuple[float, float]:
    """(burn rate, events) of the window between two samples: the
    bad-event fraction of the delta divided by the budget rate.
    Fewer than ``min_events`` in the window proves nothing and burns
    0.0 — an idle tenant must neither page nor look healthy-by-alert,
    and a single unlucky request must not read as a 100% error rate."""
    t0, b0 = good_bad(start, objective, threshold_ms)
    t1, b1 = good_bad(end, objective, threshold_ms)
    events = t1 - t0
    if events < max(1, int(min_events)):
        return 0.0, max(0.0, events)
    bad = max(0.0, b1 - b0)
    return (bad / events) / max(budget, 1e-12), events


# -- samples over the live registry -----------------------------------------

def _edge_of(label: str) -> float:
    return math.inf if label in ("+Inf", "inf") else float(label)


def _labeled_counts(child_dict, want: str | None,
                    route: str | None = None) -> tuple[float, float]:
    """(total, 5xx) out of a labeled counter's ``as_dict()`` children.
    ``want`` filters on ``model=``; ``route`` on ``route=`` (the two
    readers share everything but the key)."""
    if not isinstance(child_dict, dict):
        return 0.0, 0.0
    total = errors = 0.0
    for key, value in child_dict.items():
        parts = key.split(",")
        if want is not None and f"model={want}" not in parts:
            continue
        if route is not None and f"route={route}" not in parts:
            continue
        code = next((p[5:] for p in parts if p.startswith("code=")), "")
        try:
            code_n = int(code)
        except ValueError:
            continue
        total += value
        if code_n >= 500:
            errors += value
    return total, errors


def _histogram_child(hist_dict, want: str | None) -> tuple[dict, float]:
    """(latency_cum, count) for one child of ``Histogram.as_dict()``
    output — the unlabeled child when ``want`` is None, the
    ``model=<want>`` child otherwise (absent -> zeros)."""
    if not isinstance(hist_dict, dict):
        return {}, 0.0
    if "buckets" in hist_dict:
        node = hist_dict if want is None else None
    else:
        node = hist_dict.get(f"model={want}" if want is not None
                             else None)
    if not node:
        return {}, 0.0
    cum = {_edge_of(k): float(v)
           for k, v in (node.get("buckets") or {}).items()}
    return cum, float(node.get("count", 0.0))


def route_sample(registry=REGISTRY) -> TenantSample:
    """The single-model (route-level) surface: ``requests_total{route=
    "/predict"}`` + the unlabeled ``predict_latency_ms`` histogram.
    Deliberately mirrors the promotion watch's ``registry_sample`` —
    telemetry cannot import promotion (layering), and the promotion
    module keeps its own normalized shape."""
    total, errors = _labeled_counts(
        registry.counter("requests_total").as_dict(), None,
        route="/predict")
    cum, count = _histogram_child(
        registry.histogram("predict_latency_ms",
                           buckets=DEFAULT_LATENCY_BUCKETS_MS).as_dict(),
        None)
    return TenantSample(at=time.time(), requests=total,
                        errors_5xx=errors, latency_cum=cum,
                        latency_count=count)


def model_sample(model: str, registry=REGISTRY) -> TenantSample:
    """One zoo tenant's surface: ``model_requests_total{model,code}``
    + ``model_latency_ms{model}`` (the labeled latency histogram)."""
    total, errors = _labeled_counts(
        registry.counter("model_requests_total").as_dict(), model)
    cum, count = _histogram_child(
        registry.histogram("model_latency_ms",
                           buckets=DEFAULT_LATENCY_BUCKETS_MS).as_dict(),
        model)
    return TenantSample(at=time.time(), requests=total,
                        errors_5xx=errors, latency_cum=cum,
                        latency_count=count)


def server_sample_fn(server, registry=REGISTRY):
    """The sample source for one
    :class:`~znicz_tpu_torch.serving.server.ServingServer`: zoo tenants read their ``model_*`` families, a
    spec with ``model=None`` (or an implicit single-model server,
    whose zoo emits no labeled families by contract) reads the
    route-level surface."""
    labeled = bool(getattr(server, "_zoo_explicit", False))

    def sample(model: str | None) -> TenantSample:
        if model is None or not labeled:
            return route_sample(registry)
        return model_sample(model, registry)

    return sample


# -- the engine -------------------------------------------------------------

class _SpecState:
    """Mutable evaluation state for one spec: the bounded snapshot
    ring plus the current alert/burn readings.  Touched only while the
    owning engine's lock is held."""

    def __init__(self, spec: SLOSpec, maxlen: int):
        self.spec = spec
        self.ring: "collections.deque[TenantSample]" = \
            collections.deque(maxlen=maxlen)
        self.firing = False
        self.burn_fast = 0.0
        self.burn_slow = 0.0
        self.events_fast = 0.0
        self.events_slow = 0.0
        self.budget_remaining = 1.0
        self.last_change_at: float | None = None

    def baseline(self, now: float, window_s: float) -> TenantSample:
        """The newest retained snapshot at least ``window_s`` old —
        or the oldest retained one while the engine is younger than
        the window (the ramping read: burn over available history)."""
        base = self.ring[0]
        cut = now - window_s
        for s in self.ring:
            if s.at <= cut:
                base = s
            else:
                break
        return base


class SLOEngine:
    """Evaluate a set of :class:`SLOSpec` every ``interval_s`` over
    periodic registry snapshots (module docstring).

    ``sample_fn(model_or_None) -> TenantSample`` is the signal source
    (:func:`server_sample_fn` for a live server; tests script their
    own).  ``clock`` is injectable so window arithmetic is
    deterministic under test.  All evaluation state sits behind one
    lock; the sampler and every metric write run outside it (the
    sampler takes registry locks of its own)."""

    def __init__(self, specs, sample_fn, *, interval_s: float = 10.0,
                 clock=time.monotonic, recorder=None,
                 max_snapshots: int = MAX_SNAPSHOTS):
        specs = list(specs)
        if not specs:
            raise ValueError("SLOEngine needs at least one SLOSpec")
        keys = [(s.name, s.model) for s in specs]
        if len(set(keys)) != len(keys):
            raise ValueError(f"duplicate (slo, model) spec: {keys}")
        if interval_s <= 0:
            raise ValueError(f"interval_s must be positive, "
                             f"got {interval_s!r}")
        self.specs = tuple(specs)
        self.interval_s = float(interval_s)
        self._sample_fn = sample_fn
        self._clock = clock
        if recorder is None:
            from . import flightrecorder
            recorder = flightrecorder.RECORDER
        self.recorder = recorder
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._ticks = 0
        self._states = {}
        for spec in self.specs:
            need = max(spec.slow_window_s, spec.budget_window_s)
            maxlen = min(int(max_snapshots),
                         int(math.ceil(need / self.interval_s)) + 2)
            self._states[(spec.name, spec.model)] = _SpecState(
                spec, max(2, maxlen))

    # -- one evaluation pass ----------------------------------------------
    def tick(self, now: float | None = None) -> list[dict]:
        """Snapshot every distinct tenant once, append to each spec's
        ring, recompute burn rates / budget, and run the alert state
        machine.  Returns the transition events (``fire``/``resolve``)
        of this pass — the loop records them; tests drive this
        directly with a scripted clock."""
        samples: dict = {}
        for spec in self.specs:
            if spec.model not in samples:
                samples[spec.model] = self._sample_fn(spec.model)
        transitions: list[dict] = []
        gauges: list[tuple] = []
        with self._lock:
            # stamp INSIDE the lock: a manual tick (the chaos drill,
            # tests) racing the loop thread must not append an
            # out-of-order sample — baseline()'s early-break scan
            # assumes a monotonic ring
            if now is None:
                now = self._clock()
            self._ticks += 1
            for spec in self.specs:
                st = self._states[(spec.name, spec.model)]
                s = samples[spec.model]
                # each spec's ring owns its own stamped copy: two
                # specs over one tenant must not tug one object's
                # ``at`` around.  Clamp to the ring tail so even an
                # injected test clock cannot go backwards.
                at = now if not st.ring else max(now,
                                                 st.ring[-1].at)
                s = dataclasses.replace(s, at=at)
                st.ring.append(s)
                kw = dict(budget=spec.budget,
                          objective=spec.objective,
                          threshold_ms=spec.threshold_ms,
                          min_events=spec.min_events)
                st.burn_fast, st.events_fast = burn_between(
                    st.baseline(at, spec.fast_window_s), s, **kw)
                st.burn_slow, st.events_slow = burn_between(
                    st.baseline(at, spec.slow_window_s), s, **kw)
                st.budget_remaining = self._budget_left(spec, st, s,
                                                        at)
                over = (st.burn_fast >= spec.burn_threshold
                        and st.burn_slow >= spec.burn_threshold)
                if not st.firing and over:
                    st.firing = True
                    st.last_change_at = at
                    transitions.append(self._transition("fire", st))
                elif st.firing \
                        and st.burn_fast < spec.burn_threshold:
                    # clean de-assert: the fast window is the recovery
                    # signal — the slow window alone must not hold a
                    # resolved incident open for its whole length
                    st.firing = False
                    st.last_change_at = at
                    transitions.append(self._transition("resolve", st))
                gauges.append((spec, st.burn_fast, st.burn_slow,
                               st.budget_remaining))
        # metric writes OUTSIDE the engine lock: the registry has its
        # own locks, and the flight recorder takes one too
        for spec, fast, slow, left in gauges:
            _burn_g.set(round(fast, 4), slo=spec.name,
                        model=spec.model_label, window="fast")
            _burn_g.set(round(slow, 4), slo=spec.name,
                        model=spec.model_label, window="slow")
            _budget_g.set(round(left, 4), slo=spec.name,
                          model=spec.model_label)
        for ev in transitions:
            if ev["transition"] == "fire":
                _alerts_c.inc(slo=ev["slo"], model=ev["model"],
                              severity=ev["severity"])
            # a firing alert lands in the recorder's error ring
            # (outcome != "ok"), so /debug/flightrecorder shows it
            # inline with the requests that burned the budget
            self.recorder.record(
                "slo_alert",
                outcome=("firing" if ev["transition"] == "fire"
                         else "ok"),
                **ev)
        return transitions

    def _budget_left(self, spec: SLOSpec, st: _SpecState,
                     s: TenantSample, now: float) -> float:
        """Budget remaining over the compliance window (clamped to
        [-1, 1]; <= 0 means exhausted — negative says by how much)."""
        base = st.baseline(now, spec.budget_window_s)
        t0, b0 = good_bad(base, spec.objective, spec.threshold_ms)
        t1, b1 = good_bad(s, spec.objective, spec.threshold_ms)
        events = t1 - t0
        if events <= 0:
            return 1.0
        spent = max(0.0, b1 - b0) / (events * spec.budget)
        return max(-1.0, min(1.0, 1.0 - spent))

    def _transition(self, kind: str, st: _SpecState) -> dict:
        spec = st.spec
        return {"transition": kind, "slo": spec.name,
                "model": spec.model_label, "severity": spec.severity,
                "objective": spec.objective,
                "burn_fast": round(st.burn_fast, 4),
                "burn_slow": round(st.burn_slow, 4),
                "burn_threshold": spec.burn_threshold,
                "budget_remaining": round(st.budget_remaining, 4)}

    # -- introspection ----------------------------------------------------
    def status(self) -> dict:
        """The ``/alertz`` payload (and the ``/statusz`` SLO
        section's source): every spec's current burns, budget and
        alert state, active alerts pulled out for the impatient."""
        rows = []
        with self._lock:
            ticks = self._ticks
            for spec in self.specs:
                st = self._states[(spec.name, spec.model)]
                rows.append({
                    "slo": spec.name, "model": spec.model_label,
                    "objective": spec.objective,
                    "target": spec.target,
                    "threshold_ms": spec.threshold_ms,
                    "fast_window_s": spec.fast_window_s,
                    "slow_window_s": spec.slow_window_s,
                    "burn_threshold": spec.burn_threshold,
                    "severity": spec.severity,
                    "burn_fast": round(st.burn_fast, 4),
                    "burn_slow": round(st.burn_slow, 4),
                    "events_fast": st.events_fast,
                    "events_slow": st.events_slow,
                    "budget_remaining": round(st.budget_remaining, 4),
                    "firing": st.firing,
                    "last_change_at": st.last_change_at})
        return {"at": time.time(), "ticks": ticks,
                "interval_s": self.interval_s, "slos": rows,
                "alerts": [r for r in rows if r["firing"]]}

    # -- lifecycle --------------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                # a torn scrape or a wedged sampler must not kill the
                # judge — the next tick retries with fresh state
                log.exception("slo tick failed")

    def start(self) -> "SLOEngine":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="znicz-sloengine")
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)

    @classmethod
    def for_server(cls, server, specs, **kw) -> "SLOEngine":
        """Engine over a live server's registry surfaces; the caller
        still owns lifecycle (``start``/``stop``) and should
        ``server.attach_slo(engine)`` to light up ``/alertz``."""
        return cls(specs, server_sample_fn(server), **kw)


# -- CLI spec grammar -------------------------------------------------------

def parse_slo_spec(spec: str) -> SLOSpec:
    """One ``--slo`` value -> :class:`SLOSpec`.

    Grammar: ``NAME[,model=M][,objective=availability|latency]
    [,target=99.9|0.999][,threshold-ms=N][,fast-s=N][,slow-s=N]
    [,burn=N][,budget-s=N][,min-events=N][,severity=page|ticket]``.
    A ``target`` above 1 reads as a percentage (99.9 ⇒ 0.999)."""
    parts = [p.strip() for p in spec.split(",") if p.strip()]
    if not parts or "=" in parts[0]:
        raise ValueError(f"--slo {spec!r}: the first token is the SLO "
                         f"name (e.g. 'availability,model=mnist')")
    kw: dict = {"name": parts[0]}
    keys = {"model": ("model", str),
            "objective": ("objective", str),
            "severity": ("severity", str),
            "target": ("target", float),
            "threshold_ms": ("threshold_ms", float),
            "fast_s": ("fast_window_s", float),
            "slow_s": ("slow_window_s", float),
            "burn": ("burn_threshold", float),
            "budget_s": ("budget_window_s", float),
            "min_events": ("min_events", int)}
    for part in parts[1:]:
        if "=" not in part:
            raise ValueError(f"--slo {spec!r}: bad option {part!r} "
                             f"(expected key=value)")
        k, v = part.split("=", 1)
        k = k.replace("-", "_")
        if k not in keys:
            raise ValueError(f"--slo {spec!r}: unknown option {k!r} "
                             f"(have {sorted(keys)})")
        field, cast = keys[k]
        kw[field] = cast(v)
    if "target" in kw and kw["target"] > 1.0:
        kw["target"] = kw["target"] / 100.0
    return SLOSpec(**kw)
