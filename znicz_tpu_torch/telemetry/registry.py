"""Process-wide metrics registry: counters, gauges, bounded histograms.

Every production layer (batcher, engine, breaker, retry) needs shared
metric names, latency histograms and a single scrape point instead of
its own ad-hoc JSON counter dict.  This module is the one store they
all report through:

* :class:`Counter` — monotonic, optionally labeled (each distinct label
  combination is its own child series);
* :class:`Gauge`   — last-write-wins value, optionally labeled;
* :class:`Histogram` — fixed bucket edges chosen at creation (bounded
  memory by construction: observations only bump per-bucket counts and
  a running sum, never retain samples).

Two read-side views over the SAME instruments, guaranteed consistent
because both render at scrape time from the live objects:

* :meth:`MetricsRegistry.as_dict` — plain JSON-able dict, the shape the
  existing ``/metrics`` JSON consumers already speak;
* :meth:`MetricsRegistry.render_prometheus` — Prometheus text
  exposition format v0.0.4 (``# HELP`` / ``# TYPE`` / escaped labels /
  ``_bucket``/``_sum``/``_count`` histogram series), so a stock
  Prometheus scraper can consume ``GET /metrics`` with
  ``Accept: text/plain``.

Pre-existing per-component dicts (``MicroBatcher.metrics()``,
``ServingEngine.metrics()``) stay the source of truth for their own
counters — they join the text view through **collectors**
(:meth:`MetricsRegistry.register_collector`): callables sampled at
scrape time that flatten those dicts into metric families.  One
storage site per number, two formats, no double accounting.

``REGISTRY`` is the process-wide default every subsystem records into;
tests that need isolation instantiate their own
:class:`MetricsRegistry`.
"""

from __future__ import annotations

import math
import threading
import time

#: default bucket edges (milliseconds) for latency histograms — spans
#: the sub-ms jit-cache-hit path through cold-compile multi-second tails
DEFAULT_LATENCY_BUCKETS_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
                              250.0, 500.0, 1000.0, 2500.0, 5000.0)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label(value: str) -> str:
    """Label-value escaping per the exposition format: backslash,
    double-quote, and newline."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    """Prometheus sample value: integral floats print as ints (the
    format every scraper and the round-trip test expect for counts)."""
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_series(name: str, labels: tuple, value: float) -> str:
    if labels:
        inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in labels)
        return f"{name}{{{inner}}} {_fmt_value(value)}"
    return f"{name} {_fmt_value(value)}"


class _Instrument:
    """Shared child-series bookkeeping for Counter/Gauge."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._children: dict[tuple, float] = {}

    def value(self, **labels) -> float:
        with self._lock:
            return self._children.get(_label_key(labels), 0.0)

    def total(self) -> float:
        """Sum across every label combination (the JSON views report
        this as the headline number)."""
        with self._lock:
            return sum(self._children.values())

    def samples(self) -> list[tuple[tuple, float]]:
        with self._lock:
            if not self._children:
                return [((), 0.0)]
            return sorted(self._children.items())

    def as_dict(self):
        with self._lock:
            if not self._children:
                return 0
            if list(self._children) == [()]:
                return self._children[()]
            return {",".join(f"{k}={v}" for k, v in key): val
                    for key, val in sorted(self._children.items())}


class Counter(_Instrument):
    """Monotonic counter; ``inc(amount, **labels)``."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc {amount})")
        key = _label_key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + amount


class Gauge(_Instrument):
    """Last-write-wins value; ``set(v, **labels)`` / ``inc``/``dec``."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._children[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)


class Histogram:
    """Fixed-bucket histogram: cumulative bucket counts + sum + count
    per label combination.  Bucket edges are chosen once at creation —
    bounded memory regardless of traffic, the trade every production
    metrics pipeline makes (quantiles are then computed by the scraper
    across time/replicas, not by the process)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets=DEFAULT_LATENCY_BUCKETS_MS):
        edges = tuple(float(b) for b in buckets)
        if not edges or list(edges) != sorted(set(edges)):
            raise ValueError(f"histogram {name}: bucket edges must be "
                             f"unique ascending, got {buckets!r}")
        self.name = name
        self.help = help
        self.edges = edges
        self._lock = threading.Lock()
        # label key -> [per-edge counts..., +Inf count, sum]
        self._children: dict[tuple, list[float]] = {}
        # (label key, bucket index) -> (exemplar id, value, wall stamp)
        # — last-write-wins per bucket, so memory is bounded by
        # children × buckets regardless of traffic (the same trade the
        # bucket counts make); the wall stamp is a display field only,
        # never duration arithmetic
        self._exemplars: dict[tuple, tuple[str, float, float]] = {}

    def observe(self, value: float, exemplar: str | None = None,
                **labels) -> None:
        """Record ``value``; ``exemplar`` (e.g. a trace id) tags the
        bucket the observation lands in, so a dashboard can jump from
        a latency bucket to one concrete trace that filled it."""
        v = float(value)
        key = _label_key(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = \
                    [0.0] * (len(self.edges) + 1) + [0.0]
            for i, edge in enumerate(self.edges):
                if v <= edge:
                    child[i] += 1
                    bucket = i
                    break
            else:
                child[len(self.edges)] += 1
                bucket = len(self.edges)
            child[-1] += v
            if exemplar is not None:
                self._exemplars[(key, bucket)] = (str(exemplar)[:128],
                                                  v, time.time())

    def exemplars(self) -> dict:
        """``{"le,label=v": {"exemplar","value","at"}}`` snapshot of
        the per-bucket exemplars (``/tracez`` joins these back to the
        stored traces)."""
        with self._lock:
            items = sorted(self._exemplars.items())
        out = {}
        for (key, bucket), (ex, v, at) in items:
            le = (_fmt_value(self.edges[bucket])
                  if bucket < len(self.edges) else "+Inf")
            tag = ",".join([f"le={le}"]
                           + [f"{k}={val}" for k, val in key])
            out[tag] = {"exemplar": ex, "value": v, "at": at}
        return out

    def _cumulative(self, child):
        """(per-le cumulative counts incl. +Inf, total count, sum)."""
        cum, running = [], 0.0
        for c in child[:-1]:
            running += c
            cum.append(running)
        return cum, running, child[-1]

    def child_dict(self, child) -> dict:
        cum, count, total = self._cumulative(child)
        buckets = {_fmt_value(e): cum[i]
                   for i, e in enumerate(self.edges)}
        buckets["+Inf"] = cum[-1]
        return {"buckets": buckets, "count": count, "sum": total}

    def as_dict(self):
        with self._lock:
            if not self._children:
                return self.child_dict([0.0] * (len(self.edges) + 2))
            if list(self._children) == [()]:
                return self.child_dict(self._children[()])
            return {",".join(f"{k}={v}" for k, v in key):
                    self.child_dict(child)
                    for key, child in sorted(self._children.items())}

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                 f"# TYPE {self.name} histogram"]
        with self._lock:
            children = (sorted(self._children.items())
                        or [((), [0.0] * (len(self.edges) + 2))])
            exemplars = sorted(self._exemplars.items())
            for key, child in children:
                cum, count, total = self._cumulative(child)
                for i, edge in enumerate(self.edges):
                    lines.append(_fmt_series(
                        f"{self.name}_bucket",
                        key + (("le", _fmt_value(edge)),), cum[i]))
                lines.append(_fmt_series(f"{self.name}_bucket",
                                         key + (("le", "+Inf"),),
                                         cum[-1]))
                lines.append(_fmt_series(f"{self.name}_sum", key, total))
                lines.append(_fmt_series(f"{self.name}_count", key,
                                         count))
        # exemplars ride as comments: v0.0.4 has no exemplar syntax and
        # a bare `# {...}` OpenMetrics suffix would fail strict 0.0.4
        # parsers (tools/metrics_smoke.sh's included), so the trace-id
        # attachment stays scrape-safe while remaining greppable
        for (key, bucket), (ex, v, _at) in exemplars:
            le = (_fmt_value(self.edges[bucket])
                  if bucket < len(self.edges) else "+Inf")
            series = _fmt_series(f"{self.name}_bucket",
                                 key + (("le", le),), v)
            lines.append(f"# EXEMPLAR {series.rsplit(' ', 1)[0]} "
                         f"trace_id={ex} value={_fmt_value(v)}")
        return lines


class MetricsRegistry:
    """Get-or-create instrument store + the two scrape views.

    ``counter``/``gauge``/``histogram`` are idempotent by name —
    re-registering returns the existing instrument, re-registering
    under a different type raises (one name, one meaning).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[str, object] = {}
        self._collectors: list = []

    def _get_or_create(self, cls, name, help, **kwargs):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if not isinstance(inst, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{inst.kind}, not {cls.kind}")
                return inst
            inst = cls(name, help, **kwargs)
            self._instruments[name] = inst
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets=DEFAULT_LATENCY_BUCKETS_MS) -> Histogram:
        return self._get_or_create(Histogram, name, help,
                                   buckets=buckets)

    # -- collectors -------------------------------------------------------
    def register_collector(self, fn) -> None:
        """``fn()`` → iterable of ``(kind, name, help, samples)``
        families, ``samples`` = iterable of ``(labels_dict_or_None,
        value)`` — sampled at scrape time, so component-owned counter
        dicts surface in the text view without double accounting."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def unregister_collector(self, fn) -> None:
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def _collected(self):
        with self._lock:
            collectors = list(self._collectors)
        fams = []
        for fn in collectors:
            try:
                fams.extend(fn())
            except Exception:
                # a wedged component must not take /metrics down with
                # it — the scrape is exactly how you debug that
                continue
        return fams

    # -- views ------------------------------------------------------------
    def as_dict(self, collected: bool = False) -> dict:
        """JSON-able snapshot of every registered instrument (and,
        with ``collected=True``, collector families too)."""
        with self._lock:
            instruments = sorted(self._instruments.items())
        out = {name: inst.as_dict() for name, inst in instruments}
        if collected:
            for kind, name, _help, samples in self._collected():
                vals = {}
                for labels, value in samples:
                    key = (",".join(f"{k}={v}" for k, v in
                                    sorted((labels or {}).items()))
                           or None)
                    vals[key] = value
                out[name] = vals[None] if list(vals) == [None] else vals
        return out

    def render_prometheus(self) -> str:
        """The full registry in text exposition format v0.0.4."""
        lines = []
        with self._lock:
            instruments = sorted(self._instruments.items())
        for name, inst in instruments:
            if isinstance(inst, Histogram):
                lines.extend(inst.render())
            else:
                lines.append(f"# HELP {name} "
                             f"{_escape_help(inst.help)}")
                lines.append(f"# TYPE {name} {inst.kind}")
                for labels, value in inst.samples():
                    lines.append(_fmt_series(name, labels, value))
        by_name: dict[str, tuple[str, str, dict]] = {}
        for kind, name, help, samples in self._collected():
            fam = by_name.setdefault(name, (kind, help, {}))
            for labels, value in samples:
                key = _label_key(labels or {})
                # two collectors emitting the same series (e.g. two
                # live ServingServers) merge by sum — duplicate series
                # are invalid exposition and would fail every scraper
                fam[2][key] = fam[2].get(key, 0.0) + float(value)
        for name in sorted(by_name):
            kind, help, samples = by_name[name]
            lines.append(f"# HELP {name} {_escape_help(help)}")
            lines.append(f"# TYPE {name} {kind}")
            for labels, value in sorted(samples.items()):
                lines.append(_fmt_series(name, labels, value))
        return "\n".join(lines) + "\n"


#: the process-wide default registry every subsystem records into
REGISTRY = MetricsRegistry()

#: the Content-Type a v0.0.4 text exposition response must carry
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def counter(name: str, help: str = "") -> Counter:
    """Module-level convenience over :data:`REGISTRY`."""
    return REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return REGISTRY.gauge(name, help)


def histogram(name: str, help: str = "",
              buckets=DEFAULT_LATENCY_BUCKETS_MS) -> Histogram:
    return REGISTRY.histogram(name, help, buckets=buckets)
