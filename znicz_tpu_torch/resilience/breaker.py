"""Circuit breaker: stop hammering a failing dependency, probe for
recovery, degrade gracefully in between.

The serving problem this solves: one flaky device
made every ``ServingEngine.predict`` fail forever while ``/healthz``
kept answering "ok".  With a breaker, K consecutive forward failures
OPEN the circuit — requests stop paying the retry+failure latency and
route to the degraded path (native CPU fallback, or 503 + Retry-After)
— and after ``cooldown_s`` a single HALF-OPEN probe is let through; its
success closes the circuit, its failure re-arms the cooldown.  The
state machine is the clipper/triton-style serving pattern PAPERS.md
catalogues, sized down to one in-process dependency.

States: ``closed`` (normal), ``open`` (failing, cooling down),
``half_open`` (cooldown elapsed, probe in flight or awaited).
"""

from __future__ import annotations

import threading
import time

from ..telemetry.registry import REGISTRY

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

_transitions = REGISTRY.counter(
    "breaker_transitions_total",
    "circuit breaker state transitions (closed→open is a trip, "
    "open→half_open a probe grant, half_open→closed a recovery)")


def _note_transition(old: str, new: str) -> None:
    """Registry event for one state change — called OUTSIDE the
    breaker's lock (the registry has its own; never nest them)."""
    if old != new:
        _transitions.inc(**{"from": old, "to": new})


class EngineUnavailable(RuntimeError):
    """The protected dependency cannot serve and no fallback exists.
    Carries ``retry_after`` (seconds) so fronts can answer
    503 + Retry-After instead of hanging or 500ing."""

    def __init__(self, message: str, retry_after: float = 1.0):
        super().__init__(message)
        self.retry_after = max(1, int(round(retry_after)))


class CircuitBreaker:
    """Thread-safe closed→open→half_open→closed state machine.

    Protocol (the protected caller drives it):

    * ``allow()`` before an attempt — False means "don't touch the
      dependency, degrade now".  When open and the cooldown has
      elapsed it grants exactly ONE in-flight half-open probe.
    * ``record_success()`` / ``record_failure()`` after the attempt.
      Only attempts ``allow()`` approved should be recorded.
    * ``abandon()`` when an approved attempt never actually exercised
      the dependency (e.g. a non-retryable input error raised before
      the call) — frees the probe slot without changing state.
    """

    def __init__(self, failure_threshold: int = 5,
                 cooldown_s: float = 30.0, clock=time.monotonic):
        if failure_threshold < 1:
            raise ValueError(f"failure_threshold must be >= 1, "
                             f"got {failure_threshold}")
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at: float | None = None
        self._probe_inflight = False
        self._probe_owner: int | None = None   # thread ident of holder
        self._trips = 0          # closed/half_open → open transitions
        self._probes = 0         # half-open attempts granted

    # -- protocol ---------------------------------------------------------
    def allow(self) -> bool:
        old = None
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at < self.cooldown_s:
                    return False
                old = self._state
                self._state = HALF_OPEN       # cooldown over: probe time
            if self._probe_inflight:
                return False
            self._probe_inflight = True
            self._probe_owner = threading.get_ident()
            self._probes += 1
        if old is not None:
            _note_transition(old, HALF_OPEN)
        return True

    def record_success(self) -> None:
        with self._lock:
            old = self._state
            self._state = CLOSED
            self._consecutive = 0
            self._probe_inflight = False
            self._probe_owner = None
            self._opened_at = None
        _note_transition(old, CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            if self._state == OPEN:
                return   # a straggler admitted before the trip: the
                #          circuit is already open, don't re-arm the
                #          cooldown or double-count the trip
            if self._state == CLOSED:
                self._consecutive += 1
                if self._consecutive < self.failure_threshold:
                    return
            old = self._state
            self._state = OPEN               # trip, or failed probe
            self._opened_at = self._clock()
            self._probe_inflight = False
            self._probe_owner = None
            self._trips += 1
        _note_transition(old, OPEN)

    def trip(self) -> None:
        """Force the circuit open on an EXTERNAL verdict (e.g. the
        fleet tier's gray-failure demotion: probes green, real
        predicts sick — the failure count never reaches the
        threshold because transport-wise nothing failed).  Cooldown
        and the single half-open probe apply exactly as for a
        threshold trip, so recovery rides the existing path."""
        with self._lock:
            if self._state == OPEN:
                return
            old = self._state
            self._state = OPEN
            self._opened_at = self._clock()
            self._probe_inflight = False
            self._probe_owner = None
            self._trips += 1
        _note_transition(old, OPEN)

    def abandon(self) -> None:
        with self._lock:
            # only the thread HOLDING the half-open probe may free the
            # slot — a straggler admitted pre-trip that errors out must
            # not release someone else's in-flight probe (which would
            # admit a second concurrent probe)
            if self._probe_owner == threading.get_ident():
                self._probe_inflight = False
                self._probe_owner = None

    # -- introspection ----------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            if self._state == OPEN and \
                    self._clock() - self._opened_at >= self.cooldown_s:
                return HALF_OPEN             # probe available, not taken
            return self._state

    def retry_after(self) -> float:
        """Seconds until a probe could be admitted (>= 1 for headers)."""
        with self._lock:
            if self._state == CLOSED or self._opened_at is None:
                return 1.0
            left = self.cooldown_s - (self._clock() - self._opened_at)
        return max(1.0, left)

    def metrics(self) -> dict:
        st = self.state                      # resolves elapsed cooldown
        with self._lock:
            return {"state": st, "trips": self._trips,
                    "probes": self._probes,
                    "consecutive_failures": self._consecutive,
                    "failure_threshold": self.failure_threshold,
                    "cooldown_s": self.cooldown_s}
