"""EngineReplicaSet: N data-parallel serving engines behind one front (a
port of the JAX package's ``serving/replicas.py``).

N independent engine replicas sit behind the existing micro-batcher,
each with its OWN circuit breaker, retry policy, executable cache, and
model generation, so one replica's failure domain never takes the
fleet down:

* **round-robin dispatch** — each batched forward goes to the next
  replica in rotation, skipping *sick* replicas (breaker open): an
  open breaker means that replica's device engine is refusing work, so
  routing around it keeps tail latency flat while its cooldown runs;
* **sick-replica ejection with re-admission** — ejection is computed
  from live breaker state per dispatch, so a replica that heals
  (half-open probe succeeds, breaker closes) rejoins rotation with no
  operator action;
* **no empty-set failure** — when EVERY replica is sick the dispatch
  falls through to the scheduled replica anyway: a breaker-open engine
  still serves via its native CPU fallback (degraded 200s) or raises
  ``EngineUnavailable`` (503 + Retry-After), never a hang — the same
  degradation contract a single engine honors;
* **rolling reload** — ``reload`` swaps replicas one at a time, so
  traffic keeps flowing on not-yet-swapped generations throughout and
  a verify/canary failure stops the roll with the remaining replicas
  untouched;
* **hedged dispatch** (optional, ``hedge=HedgePolicy(...)`` /
  ``serve --hedge``) — a breaker only catches a replica that FAILS; a
  slow-but-not-sick replica drags p99 for every request routed to it.
  With hedging, a dispatch that outlives the policy threshold (the
  observed p95 forward latency, or a fixed ``--hedge-after-ms``)
  fires ONE second attempt on another healthy replica;
  first-result-wins, the loser's result is discarded and counted
  (``hedges_total{outcome}``), and every hedge is budget-gated
  through the process retry budget so speculative work cannot
  multiply an overload.

Chaos site ``replica.slow.<i>`` fires on every dispatch to replica
``i`` — a latency fault there is the deterministic "one slow replica"
the overload drill (``chaos --scenario overload``) keys on.

The set quacks like a single :class:`ServingEngine` where the HTTP
front (``ServingServer``), ``/statusz`` and the serve CLI touch one —
``predict``/``metrics``/``reload``/``warmup``/``resilience_state``/
``close`` — so ``--replicas N`` is a drop-in topology change.

All replicas share the one card (or the host, ``backend="cpu"``):
each holds its own weight copy and its own CUDA graphs, captured and
replayed from whichever thread dispatches to it, so the isolation being
bought is the failure domain (breaker, cache, generation), not the
FLOPs.  The engine has no tensor-parallel layout (``tp > 1`` is not
ported), so the set reports the one-device mesh ``1x1``.
"""

from __future__ import annotations

import queue
import threading
import time

from ..resilience import faults, overload
from ..telemetry import tracing
from ..telemetry.registry import REGISTRY
from .engine import ServingEngine

_replica_count = REGISTRY.gauge(
    "replica_count",
    "engine replicas configured in this process's EngineReplicaSet")
_replica_healthy = REGISTRY.gauge(
    "replica_healthy",
    "replicas currently in rotation (circuit breaker not open)")
_dispatches = REGISTRY.counter(
    "replica_dispatches_total",
    "batched forwards dispatched, by replica index")
_ejections = REGISTRY.counter(
    "replica_ejections_total",
    "dispatches that skipped a replica because its breaker was open, "
    "by (skipped) replica index")


class EngineReplicaSet:
    """N data-parallel :class:`ServingEngine` replicas, round-robin
    behind one ``predict`` — see the module docstring.

    ``factory(i)`` builds replica ``i`` and must return a FRESH engine
    per call (a shared breaker/retry across replicas would collapse
    the failure domains this set exists to separate); the convenience
    classmethod :meth:`of` covers the common "same model, default
    isolation" case.  ``hedge`` (a
    :class:`~znicz_tpu_torch.resilience.overload.HedgePolicy`, None =
    off) enables hedged dispatch — see the module docstring."""

    def __init__(self, factory, n_replicas: int,
                 hedge: "overload.HedgePolicy | None" = None):
        if not isinstance(n_replicas, int) or isinstance(
                n_replicas, bool) or n_replicas < 1:
            raise ValueError(f"n_replicas must be a positive int, got "
                             f"{n_replicas!r}")
        self.replicas: list[ServingEngine] = []
        try:
            for i in range(n_replicas):
                self.replicas.append(factory(i))
            if len({id(e) for e in self.replicas}) != n_replicas:
                raise ValueError("factory returned the same engine "
                                 "object for two replica slots")
        except Exception:
            # no half-built fleet leaks — covers factory failures AND
            # the duplicate-object validation above
            for eng in {id(e): e for e in self.replicas}.values():
                try:
                    eng.close()
                except Exception:
                    pass
            raise
        self._lock = threading.Lock()
        self._next = 0
        self.hedge = hedge
        #: set-level single-flight: two concurrent rolling reloads
        #: (e.g. a promotion controller's direct engine.reload racing
        #: an operator's /admin/reload) would interleave across
        #: replicas and could leave the fleet permanently serving two
        #: different models — same contract as a single engine's
        #: _reload_lock
        self._reload_lock = threading.Lock()
        _replica_count.set(n_replicas)
        self._update_health_gauge()

    @classmethod
    def of(cls, model, n_replicas: int, **engine_kw) -> \
            "EngineReplicaSet":
        """Replicas of one ``.znn`` with per-replica default breaker /
        retry / cache isolation.  Passing a shared ``breaker`` or
        ``retry`` object through ``engine_kw`` is rejected — build
        fresh ones in a custom ``factory`` instead."""
        if "breaker" in engine_kw or "retry" in engine_kw:
            raise ValueError("breaker/retry objects cannot be shared "
                             "across replicas; use the factory "
                             "constructor to build one per replica")
        return cls(lambda i: ServingEngine(model, **engine_kw),
                   n_replicas)

    # -- dispatch ---------------------------------------------------------
    def _update_health_gauge(self) -> None:
        _replica_healthy.set(
            sum(1 for e in self.replicas
                if e.breaker.state != "open"))

    def _pick(self) -> int:
        """Next replica index: round-robin over breaker-not-open
        replicas; all-sick falls through to the scheduled one (its own
        degraded path still answers)."""
        n = len(self.replicas)
        with self._lock:
            start = self._next
            self._next = (self._next + 1) % n
        for hop in range(n):
            idx = (start + hop) % n
            if self.replicas[idx].breaker.state != "open":
                if hop:
                    # count each sick replica we routed around
                    for skipped in range(hop):
                        _ejections.inc(
                            replica=str((start + skipped) % n))
                return idx
        return start

    def _pick_other(self, avoid: int) -> int | None:
        """A healthy replica other than ``avoid`` for a hedge, or None
        — a hedge re-sent to the replica that is already slow would be
        pure added load."""
        n = len(self.replicas)
        with self._lock:
            start = self._next
            self._next = (self._next + 1) % n
        for hop in range(n):
            idx = (start + hop) % n
            if idx != avoid \
                    and self.replicas[idx].breaker.state != "open":
                return idx
        return None

    def _call_replica(self, idx: int, x):
        """One replica forward — the ``replica.slow.<i>`` chaos site
        fires here, per dispatch, so a drill can latency-fault exactly
        one replica of the fleet."""
        faults.inject(f"replica.slow.{idx}")
        return self.replicas[idx].predict(x)

    def predict(self, x):
        # deadline hop "dispatch": refuse a batch whose budget already
        # ran out before it costs a replica forward
        overload.check_deadline("dispatch")
        idx = self._pick()
        if self.hedge is None or len(self.replicas) < 2:
            _dispatches.inc(replica=str(idx))
            t0 = time.monotonic()
            try:
                y = self._call_replica(idx, x)
            finally:
                self._update_health_gauge()
            if self.hedge is not None:
                self.hedge.record_ms((time.monotonic() - t0) * 1e3)
            return y
        try:
            return self._hedged_predict(idx, x)
        finally:
            self._update_health_gauge()

    # -- hedged dispatch --------------------------------------------------
    def _hedged_predict(self, primary: int, x):
        """First-result-wins dispatch with at most ONE hedge.

        The primary runs on a worker thread; if it has not answered
        within the policy threshold, a hedge fires on another healthy
        replica (budget- and deadline-gated).  The first *successful*
        result wins; an attempt that errors defers to the other one,
        and only when every fired attempt has failed does the
        primary's error surface (the same error the un-hedged path
        would have raised).  The loser keeps running on its daemon
        thread and its result is discarded — Python cannot cancel a
        device call — but it is counted (``hedges_total``), which is
        the honest cost ledger of hedging."""
        policy = self.hedge
        threshold_ms = policy.threshold_ms()
        results: queue.Queue = queue.Queue()
        dl = overload.current_deadline()
        ids = tracing.current_request_ids()

        def run(kind: str, idx: int):
            # helper threads: contextvars (request ids, deadline) do
            # not propagate — re-enter both so engine spans stay
            # correlated and downstream hops still see the budget
            token = tracing.set_request_ids(ids)
            t0 = time.monotonic()
            try:
                with overload.deadline_scope(dl):
                    y = self._call_replica(idx, x)
                policy.record_ms((time.monotonic() - t0) * 1e3)
                results.put((kind, None, y))
            except BaseException as e:
                results.put((kind, e, None))
            finally:
                tracing.reset_request_ids(token)

        def wait_bound() -> float:
            # every attempt terminates (bounded retries inside the
            # engine), but a blocking wait without a timeout is still
            # a hang waiting for a bug — bound by the deadline when
            # one exists, generously otherwise
            if dl is not None and dl.at is not None:
                return max(0.05, dl.remaining_s() + 5.0)
            return 600.0

        _dispatches.inc(replica=str(primary))
        threading.Thread(target=run, args=("primary", primary),
                         daemon=True,
                         name=f"znicz-replica-{primary}").start()
        first = None
        if threshold_ms is not None:
            try:
                first = results.get(timeout=threshold_ms / 1e3)
            except queue.Empty:
                first = None
        hedged = False
        if first is None and threshold_ms is not None:
            # the primary outlived the threshold: hedge if a second
            # healthy replica exists, the budget allows, and the
            # request's own budget isn't already spent
            idx2 = self._pick_other(primary)
            if idx2 is None:
                policy.note_outcome("no_replica")
            elif (dl is not None and dl.expired()):
                pass        # doomed either way; just await the primary
            elif policy.allow_hedge():   # counts "denied" on refusal
                hedged = True
                _dispatches.inc(replica=str(idx2))
                threading.Thread(target=run, args=("hedge", idx2),
                                 daemon=True,
                                 name=f"znicz-replica-{idx2}h").start()
        expected = 2 if hedged else 1
        errors: dict = {}
        for _ in range(expected):
            if first is None:
                try:
                    first = results.get(timeout=wait_bound())
                except queue.Empty:
                    break
            kind, err, y = first
            first = None
            if err is None:
                if hedged:
                    policy.note_outcome("won" if kind == "hedge"
                                        else "lost")
                return y
            errors[kind] = err
        # every fired attempt failed (or the bounded wait ran out):
        # surface the primary's error — the same one the un-hedged
        # path raises — so error semantics don't depend on hedging
        if "primary" in errors:
            raise errors["primary"]
        if errors:
            raise next(iter(errors.values()))
        overload.note_deadline("dispatch")
        raise overload.DeadlineExceeded(
            "hedged dispatch timed out waiting for any replica",
            stage="dispatch")

    # -- ServingEngine-compatible surface ---------------------------------
    @property
    def backend(self) -> str:
        return self.replicas[0].backend

    @property
    def buckets(self):
        return self.replicas[0].buckets

    @property
    def n_layers(self) -> int:
        return self.replicas[0].n_layers

    @property
    def layers(self):
        return self.replicas[0].layers

    @property
    def breaker(self):
        """The healthiest replica's breaker (the front consults it for
        Retry-After when the WHOLE set is refusing) — per-replica
        state lives in :meth:`replica_status`."""
        for eng in self.replicas:
            if eng.breaker.state != "open":
                return eng.breaker
        return self.replicas[0].breaker

    @property
    def generation(self) -> int:
        """The fleet's trailing generation: a rolling reload is done
        only when the LAST replica swapped."""
        return min(e.generation for e in self.replicas)

    def resilience_state(self) -> str:
        """Best state any replica can offer: ``ok`` while at least one
        replica's circuit is closed (the set routes around the rest),
        ``degraded``/``open`` only when every replica is down to its
        fallback / refusing."""
        states = [e.resilience_state() for e in self.replicas]
        for want in ("ok", "degraded"):
            if want in states:
                return want
        return "open"

    # -- weight residency (zoo LRU surface, summed over replicas) ---------
    def weight_nbytes(self) -> int:
        """Total device bytes the fleet's weight copies cost — each
        replica holds its OWN copy (failure-domain isolation), so the
        zoo's residency budget must account all of them."""
        return sum(e.weight_nbytes() for e in self.replicas)

    def weights_resident(self) -> bool:
        return any(e.weights_resident() for e in self.replicas)

    def resident_weight_bytes(self) -> int:
        """Bytes actually on device across the fleet — per-replica,
        so a partially re-materialized set (one dispatch-thread
        straggler paged its own copy back in) bills only what it
        holds, not n_replicas × the model."""
        return sum(e.resident_weight_bytes() for e in self.replicas)

    def release_weights(self) -> int:
        return sum(e.release_weights() for e in self.replicas)

    def ensure_weights(self) -> bool:
        # list first: any() short-circuits, and every replica must be
        # paged in, not just the first evicted one
        return any([e.ensure_weights() for e in self.replicas])

    @property
    def on_pagein(self):
        return self.replicas[0].on_pagein

    @on_pagein.setter
    def on_pagein(self, fn) -> None:
        # one zoo hook fans out to every replica: per-replica page-ins
        # are separate device allocations and each must be counted
        for eng in self.replicas:
            eng.on_pagein = fn

    @property
    def on_device_time(self):
        return self.replicas[0].on_device_time

    @on_device_time.setter
    def on_device_time(self, fn) -> None:
        # every replica's chip time bills the same tenant — a hedge's
        # losing attempt included: speculative work is real device
        # spend, and the cost ledger must say whose
        for eng in self.replicas:
            eng.on_device_time = fn

    def device_ms_total(self) -> float:
        """Fleet-wide measured device milliseconds (the per-replica
        engines each fence their own forwards)."""
        return sum(e.device_ms_total() for e in self.replicas)

    def warmup(self, sample_shape, dtype=None, buckets=None) -> int:
        kw = {} if dtype is None else {"dtype": dtype}
        return sum(e.warmup(sample_shape, buckets=buckets, **kw)
                   for e in self.replicas)

    def warmup_from_census(self, recorder=None, top: int = 4,
                           fallback_shape=None) -> int:
        return sum(e.warmup_from_census(recorder=recorder, top=top,
                                        fallback_shape=fallback_shape)
                   for e in self.replicas)

    # -- rolling reload ---------------------------------------------------
    def reload(self, path: str | None = None, *,
               canary: bool = True) -> dict:
        """Rolling swap, one replica at a time; the first failure
        stops the roll (the remaining replicas keep their generation
        — a mixed-generation fleet beats a fleet-wide bad swap).
        Returns the aggregate record shaped like a single engine's.
        Single-flight at the SET level, like a single engine: a
        concurrent roll raises
        :class:`~znicz_tpu_torch.serving.engine.ReloadInProgress` instead
        of interleaving models across replicas."""
        from .engine import ReloadInProgress
        if not self._reload_lock.acquire(blocking=False):
            raise ReloadInProgress("a rolling reload is already "
                                   "running on this replica set")
        try:
            outcome, error, records = "ok", None, []
            for i, eng in enumerate(self.replicas):
                # each engine's reload census-warms its own new
                # generation internally, so a partial roll never
                # leaves an already-swapped replica paying
                # request-path builds
                rec = eng.reload(path, canary=canary)
                records.append({"replica": i, **rec})
                if rec["outcome"] != "ok":
                    outcome, error = rec["outcome"], rec.get("error")
                    break
            return {"outcome": outcome, "error": error,
                    "generation": self.generation, "replicas": records}
        finally:
            self._reload_lock.release()

    def reload_status(self) -> dict:
        per = [e.reload_status() for e in self.replicas]
        # the front merges this into /healthz: keep a single engine's
        # keys (trailing generation, worst last outcome) plus detail
        worst = None
        for st in per:
            last = st.get("last_reload")
            if last and (worst is None or last["outcome"] != "ok"):
                worst = last
                if last["outcome"] != "ok":
                    break
        return {"model_generation": self.generation,
                "last_reload": worst,
                "replica_generations": [st["model_generation"]
                                        for st in per]}

    # -- introspection ----------------------------------------------------
    def replica_status(self) -> list:
        """Per-replica one-liners for /healthz and /statusz: index,
        generation, breaker state, resilience state — the view that
        makes a degraded replica visible without grepping logs."""
        return [{"replica": i, "generation": e.generation,
                 "breaker": e.breaker.state,
                 "state": e.resilience_state()}
                for i, e in enumerate(self.replicas)]

    def metrics(self) -> dict:
        per = [e.metrics() for e in self.replicas]
        agg: dict = {}
        for m in per:
            for k, v in m.items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                agg[k] = agg.get(k, 0) + v
        # non-additive fields follow the single-engine shape
        agg["generation"] = self.generation
        agg["backend"] = self.backend
        agg["buckets"] = list(self.buckets)
        agg["tensor_parallel"] = 1            # one device a replica
        agg["mesh"] = "1x1"
        agg["breaker"] = self.breaker.metrics()
        agg["resilience_state"] = self.resilience_state()
        agg["replica_count"] = len(self.replicas)
        agg["replicas_healthy"] = sum(
            1 for e in self.replicas if e.breaker.state != "open")
        agg["replicas"] = self.replica_status()
        if self.hedge is not None:
            agg["hedge"] = self.hedge.metrics()
        return agg

    def hedge_status(self) -> dict | None:
        """Hedging policy snapshot for /statusz (None = hedging off)."""
        return None if self.hedge is None else self.hedge.metrics()

    def close(self) -> None:
        # close EVERY replica even if one raises (each owns tmpdirs /
        # native handles); the first failure surfaces after the sweep
        first = None
        for eng in self.replicas:
            try:
                eng.close()
            except Exception as e:
                if first is None:
                    first = e
        if first is not None:
            raise first
