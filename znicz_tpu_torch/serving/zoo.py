"""Multi-tenant model-zoo serving: registry, residency LRU, quotas (a
port of the JAX package's ``serving/zoo.py``).

A **registry entry** is the routable unit:

* :class:`ModelZoo` — name → :class:`ModelEntry` (artifact +
  per-model :class:`~znicz_tpu_torch.serving.engine.ServingEngine` /
  :class:`~znicz_tpu_torch.serving.replicas.EngineReplicaSet`, its own
  micro-batcher and generation, a criticality class, a default
  deadline, a token-bucket quota).  ``POST /predict`` routes by the
  ``X-Model`` header / body ``model`` field; absent → the default
  model, preserving every single-model contract.
* **Weight-residency LRU** — under ``memory_budget_bytes`` the zoo
  evicts the coldest models' *device* weight copies
  (``ServingEngine.release_weights``, which also drops that
  generation's CUDA graphs: a graph holds the addresses of the weights
  it was captured with) and pages them back in on demand; the first
  request after a page-in captures its bucket's graph again.  Page-in
  is single-flight per generation: a request naming a model
  mid-eviction parks on the generation lock and adopts the first
  caller's copy, never a double device allocation.
  ``model_resident{model}`` / ``model_pagein_total{model,cause}`` /
  ``model_evictions_total`` make the churn visible.
* **Quotas** — per-model token bucket (requests/s + burst); a breach
  answers 429 + ``Retry-After`` (``model_quota_rejected_total``), so
  one tenant's client bug cannot starve the rest.
* **Criticality / deadline classes** — each entry carries the class
  its header-less traffic rides the shed ladder on (a
  cooperating client's explicit ``X-Criticality`` still wins) and the
  deadline attached when the request names none: a hot ``sheddable``
  tenant browns out before a ``critical`` one ever sheds.

Per-model chaos site ``zoo.model.<name>`` fires on every dispatched
forward of that entry, so a drill can latency-fault exactly one tenant
of a mixed fleet.

Layering: the zoo sits BETWEEN the server and the engines — it owns
no HTTP and no device code, only the registry, the residency budget
and the per-tenant policy; ``server.py`` consults it per request.
"""

from __future__ import annotations

import collections
import math
import os
import re
import threading
import time

import numpy as np

from ..resilience import faults, overload
from ..telemetry.registry import REGISTRY

#: model names double as metric label values and URL-safe tokens
_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")

#: demo families (distinct architectures AND input widths per family,
#: so a routing mistake is a shape error, not a coincidence): name ->
#: flat input feature count
DEMO_SHAPES = {"mnist": 16, "wine": 13, "kohonen": 6}
DEMO_FAMILIES = tuple(sorted(DEMO_SHAPES))

#: REAL trained families: briefly-but-actually-trained workflows of the
#: models/ package, exported through export_workflow — the autoencoder
#: exercises the DECODER path (conv/pool encoder mirrored by
#: depool/deconv) and mnist_rbm the RBM-pretrained sigmoid MLP.
#: name -> sample shape a /predict row must
#: carry (the AE is a conv chain: NHWC, not flat)
TRAINED_SAMPLE_SHAPES = {"autoencoder": (28, 28, 1),
                         "mnist_rbm": (784,)}
TRAINED_FAMILIES = tuple(sorted(TRAINED_SAMPLE_SHAPES))

_resident = REGISTRY.gauge(
    "model_resident",
    "whether a zoo model's device weight copy is resident (1) or "
    "evicted by the weight-residency LRU (0), by model")
_resident_bytes = REGISTRY.gauge(
    "zoo_resident_bytes",
    "device weight bytes currently resident across the whole zoo "
    "(compared against the --memory-budget-mb eviction threshold)")
_pageins = REGISTRY.counter(
    "model_pagein_total",
    "device weight page-ins, by model and cause (cold = a "
    "generation's first materialization | evicted = re-admission "
    "after an LRU eviction)")
_evictions = REGISTRY.counter(
    "model_evictions_total",
    "weight-residency LRU evictions (device copy dropped, host copy "
    "and executables kept), by model")
_model_requests = REGISTRY.counter(
    "model_requests_total",
    "/predict requests routed through the zoo, by model and final "
    "HTTP status code")
_quota_rejected = REGISTRY.counter(
    "model_quota_rejected_total",
    "requests refused 429 + Retry-After by a model's token-bucket "
    "quota, by model")
_model_latency = REGISTRY.histogram(
    "model_latency_ms",
    "POST /predict wall time at the HTTP front per routed zoo model, "
    "2xx answers only (the per-tenant twin of predict_latency_ms; "
    "the SLO engine's latency objectives judge this — a fast refusal "
    "must not read as a latency success), milliseconds")
_device_ms = REGISTRY.counter(
    "model_device_ms_total",
    "measured device time spent forwarding each zoo model's batches "
    "(wall time of the fenced forward: dispatch + compute + "
    "readback), milliseconds — the per-tenant chip cost ledger")


def note_model_request(name: str, code: int,
                       duration_ms: float | None = None,
                       trace=None) -> None:
    """Count one routed /predict outcome (the HTTP front calls this
    once per request, with the final status and wall latency).

    Latency observes SERVED answers (2xx) only: a shed/quota refusal
    answers in microseconds, and counting it as a fast event would
    make a server that is 503ing a tenant look latency-HEALTHY —
    refusals burn the availability SLO instead (found by the live
    drive: a latency-faulted sheddable tenant's burn rate fell as the
    shed ladder kicked in).

    ``trace`` (a sampled
    :class:`~znicz_tpu_torch.telemetry.tracing.TraceContext`, when the request rode one) attaches the trace id as
    the latency bucket's exemplar — the jump from "this tenant's p99
    bucket filled" to one concrete assembled trace."""
    _model_requests.inc(model=name, code=str(code))
    if duration_ms is not None and 200 <= int(code) < 300:
        from ..telemetry import tracestore
        tracestore.observe_exemplar(_model_latency, duration_ms,
                                    trace, model=name)


class UnknownModel(KeyError):
    """``/predict`` named a model the registry does not hold — the
    HTTP front answers 404 (a routing error, not a server fault)."""

    def __str__(self) -> str:          # KeyError repr-quotes its arg
        return self.args[0] if self.args else "unknown model"


class QuotaExceeded(Exception):
    """A model's token-bucket quota refused this request — 429 +
    ``Retry-After`` (the same contract as queue-full backpressure:
    never a silent drop, always an honest come-back time)."""

    def __init__(self, message: str, retry_after: float = 1.0):
        super().__init__(message)
        self.retry_after = max(1, int(math.ceil(retry_after)))


class TokenBucket:
    """Per-model request-rate quota: ``rate_per_s`` tokens accrue per
    second up to ``burst``; each request spends one.  Thread-safe and
    clock-injectable for deterministic tests."""

    def __init__(self, rate_per_s: float, burst: float | None = None,
                 clock=time.monotonic):
        if rate_per_s <= 0:
            raise ValueError(f"rate_per_s must be > 0, "
                             f"got {rate_per_s!r}")
        self.rate = float(rate_per_s)
        self.burst = float(burst) if burst is not None \
            else max(1.0, self.rate)
        if self.burst < 1.0:
            raise ValueError(f"burst must be >= 1, got {burst!r}")
        self._clock = clock
        self._lock = threading.Lock()
        self._tokens = self.burst
        self._last = self._clock()

    def try_take(self, n: float = 1.0) -> float | None:
        """Spend ``n`` tokens; None when admitted, else the seconds
        until enough tokens accrue (the 429's Retry-After)."""
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst, self._tokens
                               + (now - self._last) * self.rate)
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return None
            return (n - self._tokens) / self.rate

    def metrics(self) -> dict:
        with self._lock:
            return {"rate_per_s": self.rate, "burst": self.burst,
                    "tokens": round(self._tokens, 3)}


class ModelEntry:
    """One routable tenant: engine + policy.  Immutable config; the
    mutable pieces (generation, residency, batcher queue) live in the
    engine/batcher objects, which carry their own locks."""

    def __init__(self, name: str, engine, *,
                 criticality: str = "default",
                 deadline_ms: float | None = None,
                 quota: TokenBucket | None = None):
        if not _NAME_RE.match(name):
            raise ValueError(f"model name {name!r} must match "
                             f"{_NAME_RE.pattern}")
        if criticality not in overload.CRITICALITIES:
            raise ValueError(f"criticality {criticality!r}; expected "
                             f"one of {overload.CRITICALITIES}")
        if deadline_ms is not None and float(deadline_ms) < 0:
            raise ValueError(f"deadline_ms must be >= 0, "
                             f"got {deadline_ms!r}")
        self.name = name
        self.engine = engine
        self.criticality = criticality
        self.deadline_ms = (float(deadline_ms)
                            if deadline_ms is not None else None)
        self.quota = quota
        #: the entry's own micro-batcher — attached by the server
        #: (which owns the batching knobs); None until then
        self.batcher = None
        #: the entry's generation-keyed response memoization cache
        #: (serving.memo.ResponseCache) — attached by the server when
        #: ``--memoize`` is on; None = every request takes the full
        #: batcher/device path (the historical contract)
        self.response_cache = None

    def predict(self, x):
        """The batcher's dispatch target: one per-tenant chaos site in
        front of the engine, so a drill can latency-fault exactly one
        model of a mixed fleet (site family ``zoo.model.<name>``)."""
        faults.inject(f"zoo.model.{self.name}")
        return self.engine.predict(x)

    @property
    def generation(self) -> int:
        return self.engine.generation

    def effective_policy(self, criticality: str | None,
                         deadline_ms: float | None) -> tuple:
        """(criticality, deadline_ms) after tenant defaults: explicit
        request values win — a cooperating client may even claim a
        class above its tenant's (the header contract is unchanged) — and the registry class/deadline cover the silent
        majority that sends neither header."""
        crit = criticality if criticality else self.criticality
        dl = deadline_ms if deadline_ms is not None else self.deadline_ms
        return crit, dl


class ModelZoo:
    """The model registry + weight-residency LRU (module docstring).

    ``memory_budget_bytes=None`` disables eviction (every model stays
    resident — the single-tenant behavior).  All registry state is
    guarded by one lock; engine calls happen OUTSIDE it (the engines
    have their own locks, and holding both invites ordering cycles
    with the page-in observer, which runs engine-lock-free but takes
    the zoo lock)."""

    def __init__(self, memory_budget_bytes: int | None = None,
                 pagein_window: int = 256, labeled_metrics: bool = True):
        if memory_budget_bytes is not None \
                and int(memory_budget_bytes) <= 0:
            raise ValueError(f"memory_budget_bytes must be positive, "
                             f"got {memory_budget_bytes!r}")
        self.memory_budget = (int(memory_budget_bytes)
                              if memory_budget_bytes is not None
                              else None)
        #: whether this zoo emits the model-labeled registry families
        #: (model_resident / model_pagein_total / …).  The server's
        #: IMPLICIT one-entry wrapper around a plain engine passes
        #: False: a single-model server's /metrics must stay
        #: byte-identical to the pre-zoo surface — no new labeled
        #: series appearing under a scraper pinned to the old set.
        self.labeled_metrics = bool(labeled_metrics)
        self._lock = threading.Lock()
        self._entries: dict[str, ModelEntry] = {}
        self._last_used: dict[str, float] = {}
        self._default_name: str | None = None
        #: set by any page-in the zoo did not run an eviction pass
        #: for (a dispatch-thread straggler re-materializing after an
        #: eviction) — the next touch() re-balances even though it
        #: paged nothing in itself
        self._dirty = False
        self._pagein_ms = collections.deque(maxlen=int(pagein_window))
        #: the fleet placement layer's eviction hint: the
        #: tenants PLACED on this backend.  None = no placement tier
        #: above us (the historical pure-LRU behavior); a set biases
        #: eviction to drop non-placed device copies first — they are
        #: only ever served here in degraded mode, so their bytes are
        #: the cheapest to give back
        self._placement_hint: frozenset | None = None

    # -- registration -----------------------------------------------------
    def add(self, name: str, model=None, *, engine=None,
            criticality: str = "default",
            deadline_ms: float | None = None,
            quota_rps: float | None = None,
            quota_burst: float | None = None,
            default: bool = False, **engine_kw) -> ModelEntry:
        """Register one tenant.  ``model`` is a ``.znn`` path (or live
        workflow) used to build a fresh :class:`ServingEngine` with
        ``engine_kw``; pass a prebuilt ``engine=`` (e.g. an
        :class:`EngineReplicaSet`) instead for custom topologies.
        The first model added is the default route until one is
        registered with ``default=True``."""
        if engine is None:
            if model is None:
                raise ValueError("pass a model artifact or a prebuilt "
                                 "engine")
            from .engine import ServingEngine
            engine = ServingEngine(model, **engine_kw)
        elif engine_kw:
            raise ValueError("engine_kw only apply when the zoo builds "
                             "the engine itself")
        if quota_rps is None and quota_burst is not None:
            # a burst without a rate builds NO bucket — silently
            # serving an operator who believes a cap is in place
            # would be worse than refusing to boot
            raise ValueError(f"model {name!r}: quota_burst without "
                             f"quota_rps configures no quota — set "
                             f"quota_rps (the sustained rate) too")
        quota = (TokenBucket(quota_rps, quota_burst)
                 if quota_rps is not None else None)
        entry = ModelEntry(name, engine, criticality=criticality,
                           deadline_ms=deadline_ms, quota=quota)
        # page-in observer: the engine fires it for EVERY
        # materialization of whichever generation serves — zoo-initiated
        # or a dispatch-thread straggler racing an eviction
        engine.on_pagein = (lambda cause, ms, n=name:
                            self._note_pagein(n, cause, ms))
        if self.labeled_metrics:
            # cost attribution: every fenced forward of this entry's
            # engine (all replicas, hedges included) bills THIS tenant
            # — unlabeled zoos skip it, keeping the single-model
            # /metrics surface free of model_* series
            engine.on_device_time = (lambda ms, n=name:
                                     _device_ms.inc(ms, model=n))
        with self._lock:
            if name in self._entries:
                raise ValueError(f"model {name!r} already registered")
            self._entries[name] = entry
            self._last_used[name] = time.monotonic()
            if default or self._default_name is None:
                self._default_name = name
        if self.labeled_metrics:
            _resident.set(1.0 if engine.weights_resident() else 0.0,
                          model=name)
        return entry

    # -- routing ----------------------------------------------------------
    def resolve(self, name: str | None = None) -> ModelEntry:
        """The entry for ``name`` (None → the default model); raises
        :class:`UnknownModel` → HTTP 404."""
        with self._lock:
            looked = self._default_name if name is None else name
            entry = self._entries.get(looked)
            known = sorted(self._entries)
        if entry is None:
            raise UnknownModel(f"no model {looked!r} in the zoo "
                               f"(serving: {known})")
        return entry

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._entries)

    @property
    def default_name(self) -> str | None:
        with self._lock:
            return self._default_name

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- admission (quota) ------------------------------------------------
    def admit(self, entry: ModelEntry) -> None:
        """Token-bucket gate for one request; raises
        :class:`QuotaExceeded` → 429 + Retry-After.  Per REQUEST, not
        per row: the quota bounds a tenant's call rate — row volume is
        what the shared queue bound and deadline machinery govern."""
        if entry.quota is None:
            return
        wait = entry.quota.try_take(1.0)
        if wait is not None:
            if self.labeled_metrics:
                _quota_rejected.inc(model=entry.name)
            raise QuotaExceeded(
                f"model {entry.name!r} is over its "
                f"{entry.quota.rate:g} req/s quota", retry_after=wait)

    # -- weight residency -------------------------------------------------
    def _note_pagein(self, name: str, cause: str, dt_ms: float) -> None:
        if self.labeled_metrics:
            _pageins.inc(model=name, cause=cause)
            _resident.set(1.0, model=name)
        with self._lock:
            self._pagein_ms.append(float(dt_ms))
            # a page-in the zoo did not balance for (a dispatch-thread
            # straggler) grows residency behind touch()'s back — mark
            # it so the next request re-runs the eviction pass
            self._dirty = True
        if self.labeled_metrics:
            # keep the gauge live on budget-less zoos too: eviction
            # passes (its other writer) never run without a budget,
            # and an operator sizing --memory-budget-mb reads THIS
            _resident_bytes.set(self.resident_bytes())

    def touch(self, entry: ModelEntry) -> None:
        """Request-path residency: stamp recency, page the model in if
        evicted (the engine's single-flight materialization), then
        evict cold tenants until the budget holds again.  Runs on the
        HTTP handler thread — the request that wakes a cold model is
        the one that pays its page-in, not an innocent bystander on
        the dispatch thread.  Steady state (everything warm, nothing
        paged) skips the eviction scan entirely: residency only grows
        through page-ins, and every page-in sets the dirty flag."""
        with self._lock:
            self._last_used[entry.name] = time.monotonic()
        paged = entry.engine.ensure_weights()
        with self._lock:
            dirty, self._dirty = self._dirty, False
        if paged or dirty:
            self.evict_to_budget(keep=entry.name)

    def resident_bytes(self) -> int:
        """Bytes actually on device across the zoo (per replica, not
        per model: a partially re-materialized replica set bills only
        the copies it holds)."""
        with self._lock:
            entries = list(self._entries.values())
        return sum(e.engine.resident_weight_bytes() for e in entries)

    def evict_to_budget(self, keep: str | None = None) -> int:
        """Release the coldest resident models' device weights until
        the budget holds (``keep`` is exempt — never evict the model
        being served right now).  Returns models evicted.  Bounded
        loop: a concurrent page-in racing an eviction re-measures at
        most once per registered model."""
        if self.memory_budget is None:
            return 0
        evicted = 0
        for _round in range(len(self) + 1):
            with self._lock:
                hint = self._placement_hint
                # placement-aware victim order: non-placed tenants
                # evict first regardless of recency (degraded-mode
                # strays), then the plain LRU order among peers
                order = sorted(
                    self._entries,
                    key=lambda n: (0 if hint is None or n not in hint
                                   else 1,
                                   self._last_used.get(n, 0.0)))
                entries = dict(self._entries)
            resident = [(n, entries[n]) for n in order
                        if entries[n].engine.weights_resident()]
            total = sum(e.engine.resident_weight_bytes()
                        for _n, e in resident)
            _resident_bytes.set(total)
            if total <= self.memory_budget:
                return evicted
            victim = next(((n, e) for n, e in resident if n != keep),
                          None)
            if victim is None:
                # only the active model is resident: over budget but
                # nothing evictable — serving beats the budget
                return evicted
            name, entry = victim
            if entry.engine.release_weights():
                evicted += 1
                if self.labeled_metrics:
                    _evictions.inc(model=name)
                    _resident.set(0.0, model=name)
        return evicted

    def set_placement_hint(self, models) -> dict:
        """Accept the fleet placement layer's eviction hint: the
        tenants PLACED on this backend (``POST /admin/placement`` on
        the serve surface; the router pushes one after every
        recompute).  ``models=None`` clears the hint and restores pure
        LRU.  Non-placed device copies are released immediately — the
        footprint bound is enforced the moment the map changes, not on
        the next budget-pressure eviction — and any that survive (a
        release racing a page-in) evict first under pressure via the
        biased victim order in :meth:`evict_to_budget`.  A model can
        still be *served* here in degraded mode; it just pays its
        page-in again."""
        if models is None:
            with self._lock:
                self._placement_hint = None
            return {"placed": None, "released": [], "unknown": []}
        names = [str(m) for m in models]
        with self._lock:
            known = set(self._entries)
            hint = frozenset(n for n in names if n in known)
            self._placement_hint = hint
            entries = dict(self._entries)
        released = []
        for name, entry in sorted(entries.items()):
            if name in hint:
                continue
            if entry.engine.release_weights():
                released.append(name)
                if self.labeled_metrics:
                    _evictions.inc(model=name)
                    _resident.set(0.0, model=name)
        if self.labeled_metrics:
            _resident_bytes.set(self.resident_bytes())
        return {"placed": sorted(hint), "released": released,
                "unknown": sorted(set(names) - known)}

    # -- reload -----------------------------------------------------------
    def reload(self, name: str | None = None, path: str | None = None,
               *, canary: bool = True) -> dict:
        """Per-model hot reload (verify → canary → swap), fully
        isolated: model A's reload runs on A's engine only — B's
        generation, executable cache and residency are untouched by
        construction (separate objects)."""
        entry = self.resolve(name)
        rec = entry.engine.reload(path, canary=canary)
        # the canary just re-materialized the candidate — keep the
        # budget honest (and stamp recency: a freshly swapped model is
        # about to serve)
        with self._lock:
            self._last_used[entry.name] = time.monotonic()
        self.evict_to_budget(keep=entry.name)
        return {"model": entry.name, **rec}

    def reload_all(self, *, canary: bool = True) -> list[dict]:
        """Re-read EVERY artifact in place, one model at a time (the
        SIGHUP channel); a failed swap rolls that model back and the
        roll continues — tenants are independent."""
        return [self.reload(n, canary=canary) for n in self.names()]

    # -- introspection ----------------------------------------------------
    def status(self) -> list[dict]:
        """Per-model one-liners for /healthz and the /statusz table."""
        with self._lock:
            items = sorted(self._entries.items())
            default = self._default_name
            used = dict(self._last_used)
        now = time.monotonic()
        rows = []
        for name, e in items:
            eng = e.engine
            dev_fn = getattr(eng, "device_ms_total", None)
            row = {
                "model": name,
                "default": name == default,
                "device_ms": (round(dev_fn(), 1)
                              if dev_fn is not None else None),
                "generation": eng.generation,
                "criticality": e.criticality,
                "deadline_ms": e.deadline_ms,
                "quota": e.quota.metrics() if e.quota else None,
                "resident": eng.weights_resident(),
                "weight_bytes": eng.weight_nbytes(),
                "idle_s": round(now - used.get(name, now), 1),
                "queue_depth": (e.batcher.queue_depth()
                                if e.batcher is not None else 0),
                "state": eng.resilience_state()}
            if e.response_cache is not None:
                # memoization is opt-in: the row only grows the key
                # when a cache is attached, so probers pinned to the
                # pre-memo table see an unchanged shape
                row["response_cache"] = e.response_cache.metrics()
            rows.append(row)
        if self.labeled_metrics:
            # refresh on every scrape path (healthz/statusz/metrics/
            # collector): evictions also write it, but a budget-less
            # zoo would otherwise report 0 forever
            _resident_bytes.set(self.resident_bytes())
        return rows

    def metrics(self) -> dict:
        rows = self.status()
        out = {"models": {r["model"]: r for r in rows},
               "default_model": self.default_name,
               "memory_budget_bytes": self.memory_budget,
               "resident_bytes": self.resident_bytes()}
        with self._lock:
            lat = sorted(self._pagein_ms)
        if lat:
            out["pagein_p50_ms"] = round(lat[len(lat) // 2], 3)
            out["pagein_p99_ms"] = round(
                lat[min(len(lat) - 1, int(len(lat) * 0.99))], 3)
        else:
            out["pagein_p50_ms"] = out["pagein_p99_ms"] = None
        return out

    def entries(self) -> list[ModelEntry]:
        with self._lock:
            return [self._entries[n] for n in sorted(self._entries)]

    def close(self) -> None:
        """Close every engine (batchers belong to the server)."""
        first = None
        for entry in self.entries():
            try:
                entry.engine.close()
            except Exception as e:
                if first is None:
                    first = e
        if first is not None:
            raise first


# -- CLI spec parsing -------------------------------------------------------

def parse_model_spec(spec: str) -> tuple:
    """One ``--model`` value → ``(name | None, path, options)``.

    Grammar: ``NAME=PATH[,criticality=C][,deadline-ms=N]
    [,quota-rps=N][,quota-burst=N][,quantize=int8|none][,default]``.
    A bare ``PATH`` (no ``name=`` prefix) keeps the single-model CLI
    contract — ``(None, path, {})``."""
    head = spec.split(",", 1)[0]
    if "=" not in head or not _NAME_RE.match(head.split("=", 1)[0]):
        return None, spec, {}
    parts = spec.split(",")
    name, path = parts[0].split("=", 1)
    if not path:
        raise ValueError(f"--model {spec!r}: empty path")
    opts: dict = {}
    for part in parts[1:]:
        if part == "default":
            opts["default"] = True
            continue
        if "=" not in part:
            raise ValueError(f"--model {spec!r}: bad option {part!r} "
                             f"(expected key=value or 'default')")
        k, v = part.split("=", 1)
        k = k.replace("-", "_")
        if k == "criticality":
            opts["criticality"] = v
        elif k == "quantize":
            if v not in ("none", "int8"):
                raise ValueError(f"--model {spec!r}: quantize must be "
                                 f"'int8' or 'none', got {v!r}")
            opts["quantize"] = v
        elif k in ("deadline_ms", "quota_rps", "quota_burst"):
            opts[k] = float(v)
        else:
            raise ValueError(f"--model {spec!r}: unknown option {k!r}")
    return name, path, opts


def scan_zoo_dir(directory: str) -> dict:
    """``--zoo DIR``: every ``*.znn`` in ``DIR`` becomes a model named
    after its file stem."""
    out = {}
    for fn in sorted(os.listdir(directory)):
        if fn.endswith(".znn"):
            out[fn[: -len(".znn")]] = os.path.join(directory, fn)
    if not out:
        raise ValueError(f"no .znn artifacts in {directory!r}")
    return out


# -- demo zoo (tests, the card's smoke) ---------------------------------------

def write_demo_model(path: str, family: str = "wine",
                     seed: int = 7) -> str:
    """A tiny deterministic ``.znn`` of one model family, through the
    real atomic export path (manifest + ``artifact.bitflip`` chaos
    site).  The three families have distinct layer chains AND input
    widths (``DEMO_SHAPES``) so multi-tenant tests get real
    multi-family inputs: ``mnist`` = fc(16→12, tanh) → fc(12→10) →
    softmax; ``wine`` = fc(13→8, tanh) → fc(8→3) → softmax;
    ``kohonen`` = a 4-unit SOM head over 6 features (a different
    layer KIND entirely)."""
    from ..export import ACT, KIND, _commit_znn, _pack_layer, \
        _write_header
    # the MLP families share one writer, parameterized by geometry
    mlp = {"mnist": (DEMO_SHAPES["mnist"], 12, 10),
           "wine": (DEMO_SHAPES["wine"], 8, 3)}
    gen = np.random.default_rng(seed)
    with open(path + ".tmp", "wb") as fh:
        if family in mlp:
            fin, hidden, classes = mlp[family]
            _write_header(fh, 3)
            _pack_layer(fh, KIND["fc"], ACT["tanh"], [fin, hidden],
                        gen.standard_normal((fin, hidden),
                                            ).astype(np.float32),
                        gen.standard_normal(hidden).astype(np.float32))
            _pack_layer(fh, KIND["fc"], ACT["linear"],
                        [hidden, classes],
                        gen.standard_normal((hidden, classes),
                                            ).astype(np.float32))
            _pack_layer(fh, KIND["softmax"], 0, [])
        elif family == "kohonen":
            fin, units = DEMO_SHAPES["kohonen"], 4
            w = gen.standard_normal((units, fin)).astype(np.float32)
            _write_header(fh, 1)
            _pack_layer(fh, KIND["kohonen"], 0, list(w.shape), w)
        else:
            raise ValueError(f"unknown demo family {family!r} "
                             f"(have {DEMO_FAMILIES})")
    return _commit_znn(path)


def make_demo_zoo(directory: str, families=DEMO_FAMILIES,
                  seed: int = 7) -> dict:
    """Write one demo ``.znn`` per family into ``directory``; returns
    ``{family: path}`` (byte for byte the reference's for one seed)."""
    os.makedirs(directory, exist_ok=True)
    out = {}
    for i, fam in enumerate(families):
        p = os.path.join(directory, f"{fam}.znn")
        write_demo_model(p, fam, seed=seed + i)
        out[fam] = p
    return out


def write_trained_model(path: str, family: str, seed: int = 7,
                        epochs: int = 1, device=None) -> str:
    """A REAL (briefly) trained ``.znn`` of one ``models/`` family,
    exported through ``export_workflow``'s atomic publish.

    ``autoencoder`` trains the MNIST conv autoencoder (conv 5×5×16 →
    maxpool → depooling → deconv, MSE) on the unit graph — the decoder
    path the serving engine replays winner offsets for; ``mnist_rbm``
    runs the greedy CD-1 stack pretraining and the sigmoid-MLP fine-tune.
    The config trees are shrunk (synthetic data, one epoch, small hidden
    sizes) so each builds in seconds, then restored — the point is real
    trained weights through the real training path, not convergence.
    ``device`` is where it trains: the CUDA card by default (raising
    without one), ``"cpu"`` on the host."""
    from .. import prng
    from ..config import root
    from ..export import export_workflow

    if family == "autoencoder":
        from ..models import autoencoder as mod
        cfg = root.mnist_ae
        shrink = {"minibatch_size": 32}
        synthetic = {"n_train": 192, "n_valid": 32, "n_test": 0}
    elif family == "mnist_rbm":
        from ..models import mnist_rbm as mod
        cfg = root.mnist_rbm
        shrink = {"minibatch_size": 32, "hidden": [32, 16]}
        synthetic = {"n_train": 384, "n_valid": 64, "n_test": 0}
    else:
        raise ValueError(f"unknown trained family {family!r} "
                         f"(have {TRAINED_FAMILIES})")
    saved = cfg.to_dict()
    cfg.update(shrink)
    cfg.synthetic.update(synthetic)
    if family == "mnist_rbm":
        cfg.pretrain.update({"epochs": 1})
    cfg.decision.update({"max_epochs": epochs, "fail_iterations": 5})
    try:
        prng.seed_all(seed)
        wf = mod.run(device=device, epochs=epochs)
    finally:
        cfg.update(saved)
    return export_workflow(wf, path)


def make_full_zoo(directory: str, seed: int = 7, device=None) -> dict:
    """The demo trio plus both trained families, each trained on
    ``device`` (as :func:`write_trained_model`); returns ``{family:
    path}``."""
    out = make_demo_zoo(directory, seed=seed)
    for i, fam in enumerate(TRAINED_FAMILIES):
        p = os.path.join(directory, f"{fam}.znn")
        write_trained_model(p, fam, seed=seed + 10 + i, device=device)
        out[fam] = p
    return out
