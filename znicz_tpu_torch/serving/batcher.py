"""Dynamic micro-batcher: coalesce concurrent requests into one call.

The serving engine's throughput comes from batching (one device call
amortizes dispatch and fills the card), but requests arrive one at a
time.  The batcher sits between the callers (the reference's HTTP
front; in-process callers here) and the engine:

* a bounded admission queue — when it is full, ``submit`` raises
  ``QueueFull`` carrying a ``retry_after`` estimate, which the server
  surfaces as HTTP 429 + ``Retry-After`` (loaded shedding, never a
  silent drop);
* a dispatch thread that takes the oldest request and waits up to
  ``max_wait_ms`` for more (same sample shape/dtype) until ``max_batch``
  rows are ready, then runs ONE engine forward for the whole group;
* per-request deadlines — a request that expires in the queue fails
  with ``DeadlineExceeded`` instead of wasting a device slot.

Overload defense (znicz_tpu_torch.resilience.overload; docs/resilience.md):
admission is a pipeline of typed refusals — draining → doomed deadline
(the measured backlog cannot fit the remaining budget: early 503
instead of doomed work) → adaptive shed (a CoDel
:class:`~znicz_tpu_torch.resilience.overload.CoDelShedder` keyed on the
measured queue wait, honoring ``X-Criticality``) → the hard queue
bound (429).  Each dispatched batch runs under a deadline scope (the
latest rider deadline), so the engine/replica/retry hops downstream
can refuse doomed work too; :meth:`MicroBatcher.drain` stops
admission and finishes in-flight work for graceful shutdown.

All latency/batch-size accounting for ``/metrics`` lives here.
"""

from __future__ import annotations

import collections
import math
import threading
import time

import numpy as np

from ..resilience import faults, overload
from ..resilience.overload import DeadlineExceeded   # noqa: F401  —
#   the historical home of this exception is this module; the
#   canonical class moved to resilience.overload so every hop (engine,
#   replicas, retry) can raise the SAME type the front maps to 504
from ..telemetry import tracing


class QueueFull(Exception):
    """Admission queue is full; retry after ``retry_after`` seconds."""

    def __init__(self, retry_after: int):
        super().__init__(f"admission queue full; retry after "
                         f"{retry_after}s")
        self.retry_after = retry_after


class _Request:
    __slots__ = ("x", "arrival", "deadline", "criticality", "event",
                 "result", "error", "done_at", "request_id", "trace")

    def __init__(self, x, deadline, criticality="default"):
        self.x = x
        self.arrival = time.monotonic()
        self.deadline = deadline          # absolute monotonic or None
        self.criticality = criticality
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.done_at = None
        # captured at submit: the dispatch thread re-installs the whole
        # batch's ids AND trace contexts so downstream spans
        # (engine.forward) stay correlated — and trace-tagged — across
        # the thread hop
        self.request_id = tracing.current_request_id()
        self.trace = tracing.current_trace()

    @property
    def shape_key(self):
        return (self.x.shape[1:], str(self.x.dtype))

    def finish(self, result=None, error=None):
        self.result, self.error = result, error
        self.done_at = time.monotonic()
        self.event.set()


class MicroBatcher:
    """Coalesce ``submit``-ed requests into batched ``predict`` calls.

    ``predict_fn`` is any callable ``(B, ...) -> (B, F)`` — normally
    ``ServingEngine.predict``.  ``max_queue`` bounds ADMITTED rows
    (requests not yet dispatched); the policy knobs are deliberately
    few: ``max_batch`` rows per device call, ``max_wait_ms`` of
    coalescing patience from the oldest queued request's arrival.
    """

    def __init__(self, predict_fn, *, max_batch: int = 32,
                 max_wait_ms: float = 5.0, max_queue: int = 128,
                 shedder: "overload.CoDelShedder | None" = None,
                 name: str | None = None):
        self._predict = (predict_fn.predict
                         if hasattr(predict_fn, "predict")
                         else predict_fn)
        #: owner label — a multi-tenant zoo runs one batcher (and one
        #: dispatch thread) per model, and a thread dump of N identical
        #: "znicz-microbatcher" threads is useless mid-incident
        self.name = name
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait_ms) / 1e3
        self.max_queue = int(max_queue)
        #: adaptive admission (None = fixed queue bound only): fed the
        #: measured queue wait of every dispatched batch, consulted on
        #: every submit (docs/resilience.md "Overload defense")
        self.shedder = shedder
        self._cond = threading.Condition()
        self._queue: collections.deque[_Request] = collections.deque()
        self._closed = False
        self._draining = False
        self._inflight = 0                # rows taken, not yet answered
        self._stats = collections.Counter()
        self._batch_hist = collections.Counter()    # rows -> n calls
        self._latencies = collections.deque(maxlen=1024)   # seconds
        self._step_times = collections.deque(maxlen=64)    # seconds
        self._queue_waits = collections.deque(maxlen=256)  # seconds
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name="znicz-microbatcher" + (f"-{name}" if name else ""))
        self._thread.start()

    # -- client side ------------------------------------------------------
    def submit(self, x, deadline_ms: float | None = None,
               criticality: str = "default") -> _Request:
        """Enqueue one request of 1+ rows.  Admission is a pipeline of
        typed refusals, cheapest-to-judge first: draining (503) →
        doomed deadline (503; the measured backlog cannot fit the
        remaining budget, so serving it would be doomed work) →
        adaptive shed (503, by criticality) → hard queue bound (429).
        Returns the request handle; wait on ``req.event`` or use
        ``predict`` for the blocking form."""
        x = np.ascontiguousarray(x, np.float32)
        if x.ndim < 2 or len(x) == 0:
            raise ValueError(f"expected a non-empty batched input, "
                             f"got shape {x.shape}")
        if criticality not in overload.CRITICALITIES:
            raise ValueError(f"criticality {criticality!r}; expected "
                             f"one of {overload.CRITICALITIES}")
        # deadline_ms=0 means "already due" (immediate-or-fail), not
        # "no deadline" — only None disables it
        deadline = (time.monotonic() + float(deadline_ms) / 1e3
                    if deadline_ms is not None else None)
        req = _Request(x, deadline, criticality)
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if self._draining:
                self._stats["drained_away"] += 1
                raise overload.Draining(
                    "draining for shutdown; retry against another "
                    "replica", retry_after=1)
            if deadline is not None and self._queue \
                    and self._step_times:
                # early rejection of doomed work: with a MEASURED
                # service rate and a real backlog, a budget that the
                # queue drain alone will outspend cannot be served in
                # time — refuse now, while the refusal is still cheap.
                # An idle queue (or a cold batcher with no step
                # history) never rejects here: the PR-1 contract that
                # a short-deadline request on an idle server dispatches
                # immediately (or expires to 504) is pinned by tests.
                step = sum(self._step_times) / len(self._step_times)
                backlog = math.ceil(
                    (self._queued_rows() + self._inflight + len(x))
                    / self.max_batch)
                est_s = backlog * step
                if deadline - time.monotonic() < est_s:
                    self._stats["doomed"] += 1
                    overload.note_deadline("admission")
                    raise overload.DoomedDeadline(
                        f"remaining deadline budget cannot cover the "
                        f"queued backlog (~{est_s * 1e3:.0f}ms)",
                        retry_after=self.retry_after())
            if self.shedder is not None \
                    and not self.shedder.admit(criticality):
                self._stats["shed"] += 1
                raise overload.Shed(
                    f"shedding {criticality!r} traffic: queue wait "
                    f"above target", retry_after=self.retry_after())
            # an oversized request on an IDLE queue is admitted (the
            # engine chunks arbitrarily large batches through its top
            # bucket) — rejecting it would 429 the same client forever
            if self._queue and \
                    self._queued_rows() + len(x) > self.max_queue:
                self._stats["rejected"] += 1
                raise QueueFull(self.retry_after())
            self._queue.append(req)
            self._cond.notify_all()
        return req

    def predict(self, x, deadline_ms: float | None = None,
                timeout: float = 60.0, criticality: str = "default"):
        """Blocking convenience wrapper around submit.  On timeout the
        request is cancelled if still queued, so an abandoned client
        doesn't consume a device slot later."""
        req = self.submit(x, deadline_ms=deadline_ms,
                          criticality=criticality)
        if not req.event.wait(timeout):
            self.cancel(req)
            raise TimeoutError("batcher did not answer in time")
        if req.error is not None:
            raise req.error
        return req.result

    def cancel(self, req: _Request) -> bool:
        """Remove a still-queued request (True) — a request already
        dispatched (or finished) is left alone (False)."""
        with self._cond:
            try:
                self._queue.remove(req)
            except ValueError:
                return False
            self._stats["cancelled"] += 1
        req.finish(error=TimeoutError("cancelled by caller"))
        return True

    def queue_depth(self) -> int:
        """Waiting request count — O(1), for health probes (metrics()
        assembles the full payload and is much heavier)."""
        with self._cond:
            return len(self._queue)

    def retry_after(self) -> int:
        """Suggested client back-off: how long the current backlog
        takes to drain at the observed per-batch service time.
        Re-entrant under the condition's RLock (submit calls it while
        holding; HTTP handler threads call it bare)."""
        with self._cond:
            step = (sum(self._step_times) / len(self._step_times)
                    if self._step_times else 0.05)
            backlog_batches = math.ceil(
                max(1, self._queued_rows()) / self.max_batch)
        return max(1, int(math.ceil(backlog_batches * step)))

    # -- dispatch side ----------------------------------------------------
    def _queued_rows(self) -> int:
        return sum(len(r.x) for r in self._queue)

    def _matching_rows(self, key) -> int:
        return sum(len(r.x) for r in self._queue if r.shape_key == key)

    def _take_batch(self):
        """Under the lock: wait for work, coalesce up to max_batch rows
        of the oldest request's shape, and pop them (queue order is
        preserved for non-matching shapes)."""
        with self._cond:
            while not self._queue and not self._closed:
                self._cond.wait(0.25)
            if not self._queue:
                return None
            first = self._queue[0]
            key = first.shape_key
            batch_deadline = first.arrival + self.max_wait
            while (not self._closed
                   and self._matching_rows(key) < self.max_batch):
                # the coalescing window also closes at the EARLIEST
                # queued deadline (less a dispatch margin, so the
                # request is served BEFORE it expires): a request with
                # deadline_ms shorter than max_wait_ms must dispatch
                # in time, not expire waiting for co-riders that
                # never come
                cutoff = min([batch_deadline]
                             + [r.deadline - 0.05 for r in self._queue
                                if r.shape_key == key
                                and r.deadline is not None])
                left = cutoff - time.monotonic()
                if left <= 0:
                    break
                self._cond.wait(left)
            batch, rows, keep = [], 0, collections.deque()
            for r in self._queue:
                if (r.shape_key == key
                        and (rows + len(r.x) <= self.max_batch
                             or not batch)):
                    batch.append(r)
                    rows += len(r.x)
                else:
                    keep.append(r)
            self._queue = keep
            # rows leave the queue but are not answered yet: drain()
            # and the doomed-deadline estimate both need to see them
            self._inflight = rows
            return batch

    def _loop(self):
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            try:
                self._serve_batch(batch)
            finally:
                with self._cond:
                    self._inflight = 0
                    # drain() polls on this condition — wake it the
                    # moment the last in-flight rows are answered
                    self._cond.notify_all()

    def _serve_batch(self, batch):
        now = time.monotonic()
        live = []
        for r in batch:
            if r.deadline is not None and now > r.deadline:
                with self._cond:
                    self._stats["expired"] += 1
                overload.note_deadline("queue")
                r.finish(error=DeadlineExceeded(
                    "deadline passed while queued", stage="queue"))
            else:
                live.append(r)
        if not live:
            return
        x = (live[0].x if len(live) == 1
             else np.concatenate([r.x for r in live]))
        t0 = time.monotonic()
        # queue_wait_ms: the oldest rider's time from submit to
        # dispatch — the flight recorder's request records get a
        # measured queue figure instead of only the
        # handler-minus-dispatch residual; the SAME figure drives the
        # CoDel shedder (fed BEFORE the forward, so admissions racing
        # this dispatch already see the fresh brownout level)
        queue_wait_s = t0 - min(r.arrival for r in live)
        with self._cond:
            self._queue_waits.append(queue_wait_s)
        if self.shedder is not None:
            self.shedder.note_queue_wait(queue_wait_s * 1e3)
        riders = [r for r in live if r.request_id]
        token = tracing.set_request_ids(
            [r.request_id for r in riders],
            traces=[r.trace for r in riders])
        # the batch's deadline scope uses the LATEST rider deadline:
        # the forward is still useful while ANY rider can consume the
        # result, and the downstream hops (replica dispatch, engine
        # forward, retry loop) refuse doomed work against it
        ats = [r.deadline for r in live if r.deadline is not None]
        scope = (overload.Deadline(at=max(ats))
                 if len(ats) == len(live) else None)
        try:
            with tracing.span("batcher.dispatch",
                              rows=int(len(x)), requests=len(live),
                              queue_wait_ms=round(queue_wait_s * 1e3,
                                                  3)):
                # chaos latency/error site: sits BEFORE the engine
                # so injected dispatch stalls exercise the deadline
                # and server-timeout paths without touching device
                # state
                faults.inject("batcher.dispatch")
                with overload.deadline_scope(scope):
                    y = self._predict(x)
        except DeadlineExceeded as e:
            # a downstream hop refused the whole batch as doomed —
            # every rider's budget is spent, not a server failure
            with self._cond:
                self._stats["expired"] += len(live)
            for r in live:
                r.finish(error=e)
            return
        except Exception as e:
            with self._cond:
                self._stats["failed"] += len(live)
            for r in live:
                r.finish(error=e)
            return
        finally:
            tracing.reset_request_ids(token)
        dt = time.monotonic() - t0
        with self._cond:
            self._stats["forward_calls"] += 1
            self._stats["completed"] += len(live)
            self._batch_hist[len(x)] += 1
            self._step_times.append(dt)
        off, lats = 0, []
        for r in live:
            r.finish(result=y[off:off + len(r.x)])
            lats.append(r.done_at - r.arrival)
            off += len(r.x)
        with self._cond:      # metrics() iterates the deque
            self._latencies.extend(lats)

    # -- introspection / lifecycle ---------------------------------------
    def metrics(self) -> dict:
        with self._cond:
            lat = sorted(self._latencies)
            waits = sorted(self._queue_waits)
            m = dict(self._stats)
            m["queue_depth"] = len(self._queue)
            m["queue_rows"] = self._queued_rows()
            m["batch_size_histogram"] = {
                str(k): v for k, v in sorted(self._batch_hist.items())}
            step = (sum(self._step_times) / len(self._step_times)
                    if self._step_times else None)
            m["draining"] = self._draining
        for k in ("completed", "rejected", "expired", "failed",
                  "cancelled", "forward_calls", "shed", "doomed",
                  "drained_away"):
            m.setdefault(k, 0)
        m["est_step_ms"] = round(step * 1e3, 3) if step else None
        if lat:
            m["latency_p50_ms"] = round(
                lat[len(lat) // 2] * 1e3, 3)
            m["latency_p99_ms"] = round(
                lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3, 3)
        else:
            m["latency_p50_ms"] = m["latency_p99_ms"] = None
        if waits:
            m["queue_wait_p50_ms"] = round(
                waits[len(waits) // 2] * 1e3, 3)
            m["queue_wait_p95_ms"] = round(
                waits[min(len(waits) - 1,
                          int(len(waits) * 0.95))] * 1e3, 3)
        else:
            m["queue_wait_p50_ms"] = m["queue_wait_p95_ms"] = None
        if self.shedder is not None:
            m["shedder"] = self.shedder.metrics()
        m["max_batch"] = self.max_batch
        m["max_wait_ms"] = self.max_wait * 1e3
        m["max_queue"] = self.max_queue
        if self.name is not None:
            m["model"] = self.name
        return m

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Graceful shutdown, phase one: stop admitting (new submits
        raise :class:`~znicz_tpu_torch.resilience.overload.Draining` → 503 +
        Retry-After at the front) and wait — bounded — until every
        already-admitted request has been answered.  Returns True when
        fully drained, False when ``timeout_s`` expired with work
        still in flight (the caller closes anyway: bounded drain is
        the contract, not a hostage situation).  Idempotent; the
        batcher still needs :meth:`close` afterwards."""
        deadline = time.monotonic() + float(timeout_s)
        with self._cond:
            self._draining = True
            self._cond.notify_all()
            while self._queue or self._inflight:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(min(left, 0.05))
            return True

    def close(self) -> None:
        with self._cond:
            self._closed = True
            pending = list(self._queue)
            self._queue = collections.deque()
            self._cond.notify_all()
        for r in pending:                  # never a silent drop
            r.finish(error=RuntimeError("batcher closed"))
        self._thread.join(timeout=5.0)
