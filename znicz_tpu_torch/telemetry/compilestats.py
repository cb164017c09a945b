"""Compile accounting: make "zero request-path compiles" measurable.

In steady state no user request should pay for building an executable
(in this package: a CUDA graph of the serving forward) — a cold
executable would show up only as an unexplained `predict_latency_ms`
tail.  This module is the accounting layer every executable-creation
site reports through:

* ``compile_time_ms{site}`` — histogram of executable build cost per
  site (``serving.engine`` = the bucket LRU, ``serving.canary`` = the
  hot-reload canary).  Measured as **first-invocation wall time** of
  the fresh executable: on the card a CUDA graph's first eager run plus
  its capture (the kernels' first loads, cuDNN's plan and the graph
  itself), on the CPU the first eager forward; executables are built
  lazily, so the first call is where the cost actually lands on a
  request.  Coarse-bucketed up to minutes.
* ``compiles_total{site, cause}`` — why the executable had to be
  built: ``cold`` (explicit warmup / first engine construction, off
  the request path), ``new_bucket`` (request-path compile for a
  (bucket, shape, dtype) key never compiled before — the one the
  steady-state contract says must stay flat), ``reload`` (hot-reload
  canary compiles, amortized off the request path by cache seeding),
  ``fallback`` (request-path REcompile of a previously-compiled key —
  LRU eviction or a generation swap exposed a cold executable to
  traffic again).
* ``executable_cache_hits_total{site}`` / ``_misses_total{site}`` —
  the cache behavior those causes summarize.

Each timed first call also records a ``compile`` span
(:mod:`~znicz_tpu_torch.telemetry.tracing`), so a request that paid for a
compile shows the stage in its flight-recorder span tree.

Everything is stdlib-only and never raises into the instrumented path:
accounting must not take the hot path down.
"""

from __future__ import annotations

import threading
import time

from . import tracing
from .registry import REGISTRY

#: the causes `compiles_total` is allowed to carry (docs/observability.md)
CAUSES = ("cold", "new_bucket", "reload", "fallback")

#: compile-cost bucket edges (ms): first-call timings span sub-ms
#: native dispatches through multi-minute cold compiles of big models
COMPILE_BUCKETS_MS = (5.0, 25.0, 100.0, 250.0, 500.0, 1000.0, 2500.0,
                      5000.0, 15000.0, 60000.0, 300000.0)

_compile_ms = REGISTRY.histogram(
    "compile_time_ms",
    "executable build cost by site (first-invocation wall time of a "
    "fresh executable: a CUDA graph's eager run + capture, or the "
    "first eager forward), "
    "milliseconds", buckets=COMPILE_BUCKETS_MS)
_compiles = REGISTRY.counter(
    "compiles_total",
    "executables built, by site and cause (cold | new_bucket | reload "
    "| fallback); steady state means the request-path causes "
    "(new_bucket, fallback) stay flat")
_cache_hits = REGISTRY.counter(
    "executable_cache_hits_total",
    "executable-cache lookups served from the cache, by site")
_cache_misses = REGISTRY.counter(
    "executable_cache_misses_total",
    "executable-cache lookups that had to build, by site")


def record_compile(site: str, cause: str, duration_ms: float) -> None:
    """One executable build: bump the counter and the cost histogram."""
    _compiles.inc(site=site, cause=cause)
    _compile_ms.observe(float(duration_ms), site=site)


def record_cache(site: str, hit: bool) -> None:
    (_cache_hits if hit else _cache_misses).inc(site=site)


class timed:
    """Context manager timing one executable build in-line::

        with compilestats.timed("serving.canary", "reload"):
            y = forward(layers, x, params)   # the first eager run

    Records only on clean exit — a build that raised never produced an
    executable."""

    def __init__(self, site: str, cause: str):
        self.site = site
        self.cause = cause

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            record_compile(self.site, self.cause,
                           (time.perf_counter() - self._t0) * 1e3)
        return False


class FirstCallTimed:
    """Wrap a fresh executable so its FIRST successful invocation is
    recorded as the compile (a CUDA graph is captured at its first call;
    the first call is where the cost lands).  Subsequent calls delegate with one lock
    acquire of overhead — negligible next to a device forward.  A first
    call that raises (fault injection, bad geometry) stays armed: the
    compile is only accounted once it actually happened.  ``on_first``
    fires exactly once, after that successful first call is recorded —
    the hook the engine uses to mark a shape key as genuinely compiled
    (a build whose first call never succeeded produced no executable,
    so a retry must not classify as a REcompile)."""

    __slots__ = ("fn", "site", "cause", "on_first", "_lock", "_done")

    def __init__(self, fn, site: str, cause: str, on_first=None):
        self.fn = fn
        self.site = site
        self.cause = cause
        self.on_first = on_first
        self._lock = threading.Lock()
        self._done = False

    def __call__(self, *args, **kwargs):
        with self._lock:
            armed = not self._done
        if not armed:
            return self.fn(*args, **kwargs)
        t0 = time.perf_counter()
        with tracing.span("compile", site=self.site, cause=self.cause):
            out = self.fn(*args, **kwargs)
        dt_ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            first = not self._done
            self._done = True
        if first:       # two racing first calls account exactly once
            record_compile(self.site, self.cause, dt_ms)
            if self.on_first is not None:
                self.on_first()
        return out


def first_call_timed(fn, site: str, cause: str,
                     on_first=None) -> FirstCallTimed:
    if cause not in CAUSES:
        raise ValueError(f"unknown compile cause {cause!r}; "
                         f"expected one of {CAUSES}")
    return FirstCallTimed(fn, site, cause, on_first)


def snapshot() -> dict:
    """JSON-able view for /statusz and /debug consumers: per-site
    compile counts by cause, cost histogram summaries, cache ratios —
    read straight from the live registry instruments, so it can never
    disagree with /metrics."""
    compiles: dict[str, dict] = {}
    for labels, value in _compiles.samples():
        d = dict(labels)
        if not d:
            continue     # the empty placeholder sample of a fresh counter
        site = d.get("site", "?")
        compiles.setdefault(site, {})[d.get("cause", "?")] = int(value)
    cost: dict[str, dict] = {}
    hist = _compile_ms.as_dict()
    if "buckets" in hist:               # single unlabeled child: no sites
        hist = {}
    for key, child in hist.items():
        site = dict(kv.split("=", 1) for kv in key.split(",")
                    if "=" in kv).get("site", key)
        cost[site] = {"count": child["count"],
                      "total_ms": round(child["sum"], 3)}
    caches: dict[str, dict] = {}
    for counter, field in ((_cache_hits, "hits"),
                           (_cache_misses, "misses")):
        for labels, value in counter.samples():
            d = dict(labels)
            if not d:
                continue
            caches.setdefault(d.get("site", "?"),
                              {"hits": 0, "misses": 0})[field] = int(value)
    request_path = sum(by_cause.get("new_bucket", 0)
                       + by_cause.get("fallback", 0)
                       for by_cause in compiles.values())
    return {"compiles": compiles, "compile_cost": cost,
            "caches": caches,
            "request_path_compiles": int(request_path)}
