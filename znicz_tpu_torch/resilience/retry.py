"""Reusable retry policy: bounded attempts, exponential backoff with
deterministic jitter, optional per-attempt timeout, and an exception
classifier separating transient faults (device hiccup, relay drop,
filesystem blip — retry) from deterministic bugs (bad geometry, type
errors — fail immediately; retrying a ValueError just repeats it).

Users: ``ServingEngine`` (transient errors around the device
forward); in the JAX package also the checkpoint recovery and the
distributed coordinator connect.
"""

from __future__ import annotations

import random
import threading
import time

from ..telemetry.registry import REGISTRY
from . import overload

_retry_attempts = REGISTRY.counter(
    "retry_attempts_total",
    "retries performed by RetryPolicy.call (first attempts are not "
    "counted), labeled by the retried callable")


class AttemptTimeout(TimeoutError):
    """A single attempt exceeded the policy's per-attempt budget."""


def default_transient(exc: BaseException) -> bool:
    """Default classifier: programming/shape errors are deterministic —
    retrying cannot help and hides the bug from the caller (the serving
    front maps them to 400, not 503).  A passed deadline is equally
    unretryable: the budget that ran out does not come back, and a
    retry would be exactly the doomed work deadline propagation
    exists to refuse.  Everything else (RuntimeError, OSError,
    injected faults, timeouts) is treated as possibly-transient.  The
    serving engine narrows this further
    (``serving.engine.engine_transient``): a kernel that does not build
    or launch, and any CUDA runtime error, is deterministic there."""
    return not isinstance(exc, (ValueError, TypeError, KeyError,
                                IndexError, AttributeError,
                                NotImplementedError, AssertionError,
                                overload.DeadlineExceeded,
                                overload.EarlyReject))


class RetryPolicy:
    """``call(fn, *args)`` with up to ``max_attempts`` tries.

    Backoff before attempt ``n`` (1-based retries) is
    ``min(max_delay_s, base_delay_s * 2**(n-1))`` scaled by a jitter
    factor drawn uniformly from ``[1-jitter, 1]`` — full-value sleeps
    synchronize retry storms across clients, which is exactly the
    thundering herd backoff exists to break.  The jitter stream is
    seeded per-policy, so tests replay the same schedule.

    ``attempt_timeout_s`` bounds ONE attempt by running it on a helper
    thread; on expiry the attempt counts as a transient
    :class:`AttemptTimeout` failure.  The abandoned thread is left to
    finish in the background (Python cannot safely kill it) — use only
    around calls that eventually return, like a slow collective or a
    hung filesystem write, where "stop waiting" is the required
    behavior and "stop computing" is impossible anyway.

    Overload defense (docs/resilience.md): with ``budget`` set (a
    process-wide :class:`~znicz_tpu_torch.resilience.overload.RetryBudget`)
    every retry spends one token — empty bucket means the LAST error
    surfaces instead of another attempt, so a correlated failure
    cannot turn into a fleet-wide retry storm.  Independent of the
    budget, when the current request carries a deadline
    (:func:`~znicz_tpu_torch.resilience.overload.current_deadline`), a
    retry whose backoff + observed attempt time cannot fit the
    remaining budget is refused as doomed work
    (``deadline_exceeded_total{stage="retry"}``).
    """

    def __init__(self, max_attempts: int = 3, base_delay_s: float = 0.05,
                 max_delay_s: float = 2.0, jitter: float = 0.5,
                 attempt_timeout_s: float | None = None,
                 retryable=default_transient, seed: int = 0,
                 sleep=time.sleep,
                 budget: "overload.RetryBudget | None" = None):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, "
                             f"got {max_attempts}")
        if not 0.0 <= jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {jitter}")
        self.max_attempts = int(max_attempts)
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.jitter = float(jitter)
        self.attempt_timeout_s = attempt_timeout_s
        self.retryable = retryable
        self.budget = budget
        self._rng = random.Random(seed)
        self._sleep = sleep

    def backoff_s(self, retry_index: int) -> float:
        """Delay before retry ``retry_index`` (1-based), jittered."""
        raw = min(self.max_delay_s,
                  self.base_delay_s * (2.0 ** (retry_index - 1)))
        return raw * (1.0 - self.jitter * self._rng.random())

    def _attempt(self, fn, args, kwargs):
        if self.attempt_timeout_s is None:
            return fn(*args, **kwargs)
        box: dict = {}

        def runner():
            try:
                box["result"] = fn(*args, **kwargs)
            except BaseException as e:
                box["error"] = e

        t = threading.Thread(target=runner, daemon=True,
                             name="znicz-retry-attempt")
        t.start()
        t.join(self.attempt_timeout_s)
        if t.is_alive():
            raise AttemptTimeout(
                f"attempt exceeded {self.attempt_timeout_s}s")
        if "error" in box:
            raise box["error"]
        return box.get("result")

    def call(self, fn, *args, on_retry=None, **kwargs):
        """Run ``fn(*args, **kwargs)``; retries transient failures with
        backoff.  ``on_retry(attempt, exc)`` fires before each sleep
        (metrics hook).  Raises the LAST exception when attempts run
        out, and non-retryable exceptions immediately."""
        for attempt in range(1, self.max_attempts + 1):
            t0 = time.monotonic()
            try:
                result = self._attempt(fn, args, kwargs)
            except Exception as e:     # KeyboardInterrupt/SystemExit
                #                        always propagate unretried
                attempt_s = time.monotonic() - t0
                if attempt >= self.max_attempts or not self.retryable(e):
                    raise
                backoff = self.backoff_s(attempt)
                dl = overload.current_deadline()
                if dl is not None and dl.at is not None \
                        and dl.remaining_s() < backoff + attempt_s:
                    # the sleep + another attempt of the size just
                    # observed cannot fit the remaining budget: the
                    # retry is doomed work, surface the error now
                    overload.note_deadline("retry")
                    raise
                if self.budget is not None \
                        and not self.budget.try_spend():
                    # fleet-wide budget empty: retrying would amplify
                    # the correlated failure that drained it
                    raise
                _retry_attempts.inc(fn=getattr(fn, "__name__", "?"))
                if on_retry is not None:
                    on_retry(attempt, e)
                self._sleep(backoff)
            else:
                if self.budget is not None:
                    self.budget.on_success()
                return result

    def wrap(self, fn, on_retry=None):
        """Decorator form of :meth:`call`."""
        def wrapped(*args, **kwargs):
            return self.call(fn, *args, on_retry=on_retry, **kwargs)
        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        return wrapped
