"""Overload defense in depth: deadlines, retry budgets, hedging, shedding.

The serving stack (batcher + breaker, and in the JAX package replicas
and promotion) must stay *well-behaved when demand exceeds capacity*:
a deadline set at admission never reached the engine, retries were
per-call with no fleet-wide budget (a latency blip triggers a retry
storm that amplifies the overload that caused it), a slow-but-not-sick
replica dragged p99 for every request routed to it, and the only
admission signal was a fixed queue bound.  This module is the one
robustness context a request carries end to end; the serving stack
consults it at every hop (docs/resilience.md "Overload defense"):

* :class:`Deadline` — an absolute monotonic deadline + criticality
  attached at admission (``X-Deadline-Ms`` / ``X-Criticality`` or the
  server default) and propagated via a contextvar across the
  batcher's thread hop; every stage calls :func:`check_deadline` and a
  request whose remaining budget cannot cover the next stage is
  rejected *early* instead of doing doomed work
  (``deadline_exceeded_total{stage}``).
* :class:`RetryBudget` — a process-wide token bucket refilled as a
  fraction of *successful* traffic (the SRE retry-budget rule):
  :class:`~znicz_tpu_torch.resilience.retry.RetryPolicy` spends one token
  per retry, so under correlated failure retries self-limit at
  ``ratio`` of throughput instead of storming (``retry_budget_tokens``).
* :class:`HedgePolicy` — when a dispatch outlives the observed p95
  forward latency, a replica set (the reference's
  ``serving.replicas.EngineReplicaSet``) fires ONE hedge on another
  healthy replica;
  first result wins, the loser is discarded and counted
  (``hedges_total{outcome}``) — the slow-replica tail collapses to
  roughly the hedge threshold.
* :class:`CoDelShedder` — CoDel-style adaptive admission keyed on
  *measured queue wait* (the signal the flight recorder already
  records): sustained wait above target escalates a brownout ladder
  that sheds ``sheddable`` traffic first, then ``default``, and
  ``critical`` never (``shed_total{criticality}``); any wait back
  under target resets it.
* drain state — graceful SIGTERM: stop admitting (:class:`Draining`
  → 503 + Retry-After), finish in-flight, then exit
  (``drain_state``: 0 serving, 1 draining, 2 drained).

Layering: this module depends only on the telemetry registry, so both
``resilience.retry`` below it and every ``serving`` module above it
can import it without cycles.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import threading
import time

from ..telemetry.registry import REGISTRY

#: the brownout ladder, least- to most-protected (X-Criticality)
CRITICALITIES = ("sheddable", "default", "critical")

_deadline_exceeded = REGISTRY.counter(
    "deadline_exceeded_total",
    "requests rejected or expired by end-to-end deadline enforcement, "
    "by the stage that refused the doomed work (admission | queue | "
    "dispatch | forward | retry | router)")
_budget_tokens = REGISTRY.gauge(
    "retry_budget_tokens",
    "tokens left in the process-wide retry budget (refilled as a "
    "fraction of successful calls; each retry and each hedge spends "
    "one — empty means retries are being denied)")
_hedges = REGISTRY.counter(
    "hedges_total",
    "hedged replica dispatches, by outcome (won = hedge answered "
    "first | lost = primary answered first | denied = retry budget "
    "empty | no_replica = no second healthy replica)")
_shed = REGISTRY.counter(
    "shed_total",
    "requests refused by the adaptive (CoDel-style) admission ladder, "
    "by criticality class")
_drain_state = REGISTRY.gauge(
    "drain_state",
    "graceful-shutdown progress: 0 serving, 1 draining (admission "
    "stopped, in-flight finishing), 2 drained cleanly — a drain that "
    "timed out with work still in flight stays at 1")

DRAIN_SERVING, DRAIN_DRAINING, DRAIN_DRAINED = 0, 1, 2
_drain_state.set(DRAIN_SERVING)


def set_drain_state(state: int) -> None:
    """Publish drain progress (``DRAIN_*``) to the metrics gauge."""
    _drain_state.set(int(state))


# -- typed refusals ---------------------------------------------------------

class DeadlineExceeded(Exception):
    """The request's end-to-end deadline passed; ``stage`` names the
    hop that noticed (the HTTP front answers 504 — the work was
    admitted, then ran out of budget mid-flight)."""

    def __init__(self, message: str, stage: str = "unknown"):
        super().__init__(message)
        self.stage = stage


class EarlyReject(Exception):
    """Admission refused BEFORE any work was done — the HTTP front
    answers 503 + ``Retry-After`` (never a hang, never doomed work).
    Subclasses say why; ``retry_after`` is the honest come-back time."""

    def __init__(self, message: str, retry_after: int = 1):
        super().__init__(message)
        self.retry_after = max(1, int(retry_after))


class DoomedDeadline(EarlyReject):
    """The request's remaining budget cannot cover the measured queue
    backlog + service time: serving it would only burn a device slot
    producing an answer nobody is waiting for."""


class Shed(EarlyReject):
    """The adaptive admission ladder refused this criticality class
    while queue wait stays above target (brownout)."""


class Draining(EarlyReject):
    """This replica is draining for shutdown: in-flight work finishes,
    new work must go to a peer."""


# -- deadline context -------------------------------------------------------

class Deadline:
    """One request's robustness context: absolute monotonic deadline
    (None = unbounded) + criticality class.  Immutable; cheap enough
    to attach to every request."""

    __slots__ = ("at", "criticality")

    def __init__(self, at: float | None = None,
                 criticality: str = "default"):
        if criticality not in CRITICALITIES:
            raise ValueError(f"criticality {criticality!r}; expected "
                             f"one of {CRITICALITIES}")
        self.at = at
        self.criticality = criticality

    @classmethod
    def from_ms(cls, deadline_ms: float | None,
                criticality: str = "default") -> "Deadline":
        """``deadline_ms`` is a budget from NOW; 0 means "already due"
        (immediate-or-fail), None means no deadline — the same
        contract the batcher has always pinned."""
        at = (time.monotonic() + float(deadline_ms) / 1e3
              if deadline_ms is not None else None)
        return cls(at, criticality)

    def remaining_s(self) -> float:
        return (float("inf") if self.at is None
                else self.at - time.monotonic())

    def remaining_ms(self) -> float:
        return self.remaining_s() * 1e3

    def expired(self) -> bool:
        return self.at is not None and time.monotonic() > self.at

    def check(self, stage: str, need_s: float = 0.0) -> None:
        """Refuse the next hop when the remaining budget cannot cover
        it: raises :class:`DeadlineExceeded` (and counts the stage)
        when less than ``need_s`` remains."""
        if self.at is None:
            return
        if self.remaining_s() < need_s:
            note_deadline(stage)
            raise DeadlineExceeded(
                f"deadline exceeded at {stage} "
                f"({self.remaining_ms():.0f}ms of budget left, "
                f"{need_s * 1e3:.0f}ms needed)", stage=stage)


def note_deadline(stage: str) -> None:
    """Count one deadline refusal at ``stage`` (for callers that raise
    their own typed error, like the batcher's queue-expiry path)."""
    _deadline_exceeded.inc(stage=stage)


_deadline_var: contextvars.ContextVar[Deadline | None] = \
    contextvars.ContextVar("znicz_deadline", default=None)


def current_deadline() -> Deadline | None:
    """The deadline context of the current logical request, if any."""
    return _deadline_var.get()


@contextlib.contextmanager
def deadline_scope(deadline: Deadline | None):
    """Install ``deadline`` as the current context for this thread's
    work — the batcher enters it around each dispatched batch (using
    the LATEST rider deadline: the forward is still useful while any
    rider can use the result), and hedge workers re-enter it on their
    helper threads, where contextvars do not propagate by
    themselves."""
    token = _deadline_var.set(deadline)
    try:
        yield deadline
    finally:
        _deadline_var.reset(token)


def check_deadline(stage: str, need_s: float = 0.0) -> None:
    """The one call instrumented hops make — no-op without a
    deadline in context."""
    dl = _deadline_var.get()
    if dl is not None:
        dl.check(stage, need_s)


# -- retry budget -----------------------------------------------------------

class RetryBudget:
    """Process-wide token bucket bounding speculative work (retries
    AND hedges) to a fraction of successful traffic.

    The bucket starts full (``capacity`` tokens) so a fresh process
    can absorb its cold-start blips, then refills ``ratio`` tokens per
    recorded success — the steady-state invariant is the SRE rule
    «retries ≤ ratio × successes (+ the initial capacity)»: under a
    correlated failure where *nothing* succeeds, retries stop after
    ``capacity`` attempts fleet-process-wide instead of multiplying
    the overload.  Thread-safe; one instance per process is the
    intended topology (the serve CLI shares one across all replicas —
    a fleet-wide budget is the point, unlike breakers, which isolate
    per-replica failure domains)."""

    def __init__(self, ratio: float = 0.1, capacity: float = 100.0):
        if not 0.0 < ratio <= 1.0:
            raise ValueError(f"ratio must be in (0, 1], got {ratio}")
        if capacity < 1.0:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.ratio = float(ratio)
        self.capacity = float(capacity)
        self._lock = threading.Lock()
        self._tokens = self.capacity
        self._spent = 0
        self._denied = 0
        self._successes = 0
        _budget_tokens.set(self._tokens)

    def on_success(self) -> None:
        with self._lock:
            self._successes += 1
            self._tokens = min(self.capacity, self._tokens + self.ratio)
            tokens = self._tokens
        _budget_tokens.set(tokens)

    def try_spend(self, cost: float = 1.0) -> bool:
        """Take ``cost`` tokens for one retry/hedge; False (and a
        denied count) when the bucket cannot cover it — the caller
        must fail fast instead of storming."""
        with self._lock:
            if self._tokens < cost:
                self._denied += 1
                return False
            self._tokens -= cost
            self._spent += 1
            tokens = self._tokens
        _budget_tokens.set(tokens)
        return True

    def metrics(self) -> dict:
        with self._lock:
            return {"tokens": round(self._tokens, 3),
                    "capacity": self.capacity, "ratio": self.ratio,
                    "spent": self._spent, "denied": self._denied,
                    "successes": self._successes}


_process_budget: RetryBudget | None = None
_process_budget_lock = threading.Lock()


def set_process_budget(budget: RetryBudget | None) -> None:
    """Install the budget the serve CLI built so introspection
    (``/statusz``, ``overload_status``) can report its level without
    threading the object through every layer."""
    global _process_budget
    with _process_budget_lock:
        _process_budget = budget


def process_budget() -> RetryBudget | None:
    with _process_budget_lock:
        return _process_budget


# -- hedged dispatch policy -------------------------------------------------

class HedgePolicy:
    """When to fire a second (hedged) attempt on another replica.

    Auto mode (default): hedge once a dispatch outlives the observed
    ``quantile`` (p95) of recorded forward latencies — tail-chasing
    only, so at most ~5% of dispatches ever hedge and the added load
    is bounded by construction.  Until ``min_samples`` latencies are
    recorded there is no trustworthy tail and no hedging.
    ``after_ms`` pins a fixed threshold instead (operator knob
    ``--hedge-after-ms``; also what a drill uses for determinism).

    ``budget`` (a :class:`RetryBudget`) gates every hedge like a
    retry: speculative work must not multiply an overload."""

    def __init__(self, quantile: float = 0.95, min_samples: int = 16,
                 after_ms: float | None = None,
                 budget: RetryBudget | None = None,
                 window: int = 512):
        if not 0.5 <= quantile < 1.0:
            raise ValueError(f"quantile must be in [0.5, 1), "
                             f"got {quantile}")
        self.quantile = float(quantile)
        self.min_samples = int(min_samples)
        self.after_ms = None if after_ms is None else float(after_ms)
        self.budget = budget
        self._lock = threading.Lock()
        self._lat_ms: collections.deque = collections.deque(
            maxlen=int(window))
        self._outcomes = collections.Counter()

    def record_ms(self, ms: float) -> None:
        """One observed replica forward latency (every worker records
        its own completion, winners and losers both, so hedging cannot
        bias the quantile it keys on)."""
        with self._lock:
            self._lat_ms.append(float(ms))

    def threshold_ms(self) -> float | None:
        """Current hedge trigger, or None when hedging must not fire
        (auto mode without enough samples yet)."""
        if self.after_ms is not None:
            return self.after_ms
        with self._lock:
            if len(self._lat_ms) < self.min_samples:
                return None
            lat = sorted(self._lat_ms)
        return lat[min(len(lat) - 1, int(len(lat) * self.quantile))]

    def note_outcome(self, outcome: str) -> None:
        _hedges.inc(outcome=outcome)
        with self._lock:
            self._outcomes[outcome] += 1

    def allow_hedge(self) -> bool:
        """Budget gate for one hedge (no budget configured = allowed;
        the p95 trigger already bounds hedge volume)."""
        if self.budget is None:
            return True
        if self.budget.try_spend():
            return True
        self.note_outcome("denied")
        return False

    def metrics(self) -> dict:
        with self._lock:
            out = dict(self._outcomes)
            n = len(self._lat_ms)
        return {"threshold_ms": self.threshold_ms(), "samples": n,
                "outcomes": out}


# -- adaptive load shedding -------------------------------------------------

class CoDelShedder:
    """CoDel-style admission control keyed on measured queue wait.

    The batcher feeds :meth:`note_queue_wait` with each dispatched
    batch's oldest-rider wait (the figure the PR-7 flight recorder
    already measures).  Standing wait above ``target_ms`` for a full
    ``interval_ms`` means the queue is not absorbing a burst but
    hiding an overload — each further full interval escalates the
    brownout ladder one level; ANY wait back under target resets it
    (CoDel's "standing queue" test, not an average):

    ==== ===============================================
    0    admit everything (healthy)
    1    shed ``sheddable`` requests
    2    shed ``sheddable`` + ``default`` — ``critical`` only
    ==== ===============================================

    ``critical`` traffic is never shed here — when even level 2
    cannot keep up, the bounded queue's 429 is the backstop.

    De-escalation has TWO paths, because wait samples only exist when
    batches dispatch: a sample back under target resets the ladder
    immediately, and a *quiet* interval with no samples at all steps
    it down one level (checked at admission).  Without the second
    path the ladder could latch: at level 2 all non-critical traffic
    is refused at admission, the queue drains, nothing dispatches,
    and no sample would ever arrive to reset it."""

    def __init__(self, target_ms: float = 100.0,
                 interval_ms: float = 500.0, clock=time.monotonic):
        if target_ms <= 0 or interval_ms <= 0:
            raise ValueError("target_ms and interval_ms must be > 0")
        self.target_ms = float(target_ms)
        self.interval_s = float(interval_ms) / 1e3
        self._clock = clock
        self._lock = threading.Lock()
        self._level = 0
        self._above_since: float | None = None
        self._last_note: float | None = None
        self._last_wait_ms: float | None = None
        self._shed_counts = collections.Counter()

    @property
    def level(self) -> int:
        with self._lock:
            self._decay_locked(self._clock())
            return self._level

    def note_queue_wait(self, wait_ms: float) -> None:
        with self._lock:
            # no decay here: a sample IS dispatch activity, however
            # sparse — only sample-free silence (seen from the read
            # side) de-escalates
            now = self._clock()
            prev = self._last_note
            self._last_note = now
            self._last_wait_ms = float(wait_ms)
            if wait_ms < self.target_ms:
                self._above_since = None
                self._level = 0
                return
            if prev is not None and now - prev >= 2 * self.interval_s:
                # a sample GAP of two-plus intervals breaks
                # "standing": an anchor left over from before an idle
                # stretch must not let the first sample of a fresh
                # burst escalate on its own.  (One interval is not a
                # gap — dispatch cadence under slow batches can
                # legitimately run at interval scale.)
                self._above_since = None
            if self._above_since is None:
                self._above_since = now
            elif now - self._above_since >= self.interval_s:
                self._level = min(2, self._level + 1)
                self._above_since = now

    def _decay_locked(self, now: float) -> None:
        """One level down per full interval WITHOUT a wait sample —
        silence means the queue is empty (nothing dispatching),
        which is the opposite of standing overload."""
        while self._level > 0 and self._last_note is not None \
                and now - self._last_note >= self.interval_s:
            self._level -= 1
            self._above_since = None
            self._last_note += self.interval_s

    def admit(self, criticality: str) -> bool:
        """Admission verdict for one request; a False already counted
        ``shed_total{criticality}`` (the caller just raises)."""
        with self._lock:
            self._decay_locked(self._clock())
            level = self._level
            shed = ((level >= 1 and criticality == "sheddable")
                    or (level >= 2 and criticality != "critical"))
            if shed:
                self._shed_counts[criticality] += 1
        if shed:
            _shed.inc(criticality=criticality)
        return not shed

    def metrics(self) -> dict:
        with self._lock:
            self._decay_locked(self._clock())
            return {"level": self._level,
                    "target_ms": self.target_ms,
                    "last_queue_wait_ms": self._last_wait_ms,
                    "shed": dict(self._shed_counts)}
