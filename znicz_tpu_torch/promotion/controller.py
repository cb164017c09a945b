"""The closed-loop promotion controller.

Drives the full arc the reference workflow engine ran in-process —
train → snapshot → evaluate → decide — at production scale against a
live serving fleet, autonomously:

.. code-block:: text

    idle ──poll──▶ verifying ──▶ exporting ──▶ canarying ──▶ watching
                      │              │             │            │
                      ▼              ▼             ▼            ├─ clean ──▶ [walking]* ──▶ promoted → idle
                verify_failed  export_failed  canary_failed     └─ breach ─▶ rolled_back
                      └──────────────┴─────────────┴──── failure streak ──▶ crash_loop (fail-fast)

    * fleet targets only: a target with a ``finalize`` hook (the
      reference's ``fleet.rollout.FleetTarget``; the port's fleet is
      ROADMAP.md queue 1 item 11) walks its remaining backends after
      the clean watch — a mid-walk breach rolls the whole fleet back
      (docs/fleet.md "Rolling promotion")

Every stage reuses a prior PR's machinery instead of re-implementing
it: candidates are durability-verified before export, the
export commits with the invalidate→blob→manifest protocol, the swap
rides the serving engine's verify+canary+rollback reload, the
watch window judges the live latency histograms through
:class:`~znicz_tpu_torch.promotion.slo.SLOPolicy`, transient faults retry
under :class:`~znicz_tpu_torch.resilience.retry.RetryPolicy`, the
inter-failure backoff reuses the same policy's jittered schedule, and
every transition lands in the persisted
:class:`~znicz_tpu_torch.promotion.ledger.PromotionLedger` so a restarted
controller resumes mid-history instead of replaying it.

Fault sites (``znicz_tpu_torch.resilience.faults``): ``promotion.export``
fires inside each export attempt, ``promotion.slo_probe`` inside each
watch-window probe — both are retried as transient, and both are how
``chaos --scenario promote`` proves the loop survives its own
infrastructure flaking.

Targets: :class:`EngineTarget` drives an in-process
``ServingEngine``/``ServingServer`` (and attaches the controller's
status to ``/healthz``); :class:`HttpTarget` drives a remote server
through ``POST /admin/reload`` + the Prometheus ``/metrics`` view —
the ``python -m znicz_tpu_torch promote`` CLI shape.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import urllib.error
import urllib.request

from .. import durability
from ..resilience import faults
from ..resilience.retry import RetryPolicy, default_transient
from ..telemetry.registry import REGISTRY
from .ledger import PromotionLedger
from .slo import (SLOPolicy, count_breach, prometheus_sample,
                  registry_sample)

log = logging.getLogger("promotion")

_promotions = REGISTRY.counter(
    "promotions_total",
    "promotion attempts driven to an outcome (promoted | verify_failed "
    "| export_failed | canary_failed | rolled_back | rollback_failed "
    "| aborted)")
_generation_g = REGISTRY.gauge(
    "promotion_generation",
    "serving generation installed by the most recent successful "
    "promotion (0 until the controller first promotes)")

#: bounded outcome vocabulary (the promotions_total label set)
PROMOTED = "promoted"
VERIFY_FAILED = "verify_failed"
EXPORT_FAILED = "export_failed"
CANARY_FAILED = "canary_failed"
ROLLED_BACK = "rolled_back"
ROLLBACK_FAILED = "rollback_failed"
#: the controller was stopped mid-watch: the candidate is live but was
#: never judged — neither a success (no rollback target install, no
#: promoted count) nor a pipeline failure (no crash-loop streak)
ABORTED = "aborted"


class CrashLoop(RuntimeError):
    """K consecutive promotions failed — the controller fails fast
    instead of hammering the serving fleet with a broken pipeline
    (same stance as the elastic runner's crash-loop guard)."""

    def __init__(self, failures: int):
        self.failures = failures
        super().__init__(
            f"promotion crash loop: {failures} consecutive failed "
            f"promotions — refusing to keep promoting")


class ReloadBusy(RuntimeError):
    """The target answered 409 (a reload already in flight) —
    transient by definition, the retry policy waits it out."""


class EngineTarget:
    """In-process target: a live ``ServingEngine`` (optionally behind
    its ``ServingServer``, which then gets the controller's status on
    ``/healthz``).  Reloads are synchronous engine calls; SLO samples
    read the process registry plus the engine's own breaker."""

    def __init__(self, server=None, engine=None):
        if engine is None:
            if server is None:
                raise ValueError("pass a server or an engine")
            engine = server.engine
        self.server = server
        self.engine = engine

    def attach(self, status_fn) -> None:
        if self.server is not None:
            self.server.attach_promotion(status_fn)

    def reload(self, path: str) -> dict:
        rec = self.engine.reload(path)
        return {"outcome": rec["outcome"], "error": rec["error"],
                "generation": rec["generation"]}

    def sample(self):
        return registry_sample(breaker_state=self.engine.breaker.state)


class HttpTarget:
    """Cross-process target: drive a remote serving replica through
    its admin/metrics surface.  The status attach is a no-op — a
    remote ``/healthz`` can only report promotion state when the
    controller runs inside the serving process (docs/promotion.md)."""

    def __init__(self, url: str, admin_token: str | None = None,
                 timeout_s: float = 60.0):
        self.url = url if url.endswith("/") else url + "/"
        self.admin_token = admin_token
        self.timeout_s = float(timeout_s)

    def attach(self, status_fn) -> None:
        pass

    def _request(self, path: str, payload: dict | None = None,
                 headers: dict | None = None):
        import json
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(
            self.url + path, data,
            {"Content-Type": "application/json", **(headers or {})})
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            return r.status, r.read()

    def reload(self, path: str) -> dict:
        import json
        headers = {}
        if self.admin_token is not None:
            headers["X-Admin-Token"] = self.admin_token
        # any record already on /healthz belongs to a PREVIOUS reload —
        # its ``at`` stamp is the freshness marker that keeps the poll
        # below from adopting a stale outcome as this candidate's
        # canary verdict
        try:
            _s, hb = self._request("healthz")
            before = (json.loads(hb).get("last_reload") or {}).get("at")
        except Exception:
            before = None

        def _fresh(record: dict) -> bool:
            return bool(record) and record.get("at") != before

        try:
            status, body = self._request(
                "admin/reload", {"model": path, "wait": True}, headers)
        except urllib.error.HTTPError as e:
            if e.code == 409:
                raise ReloadBusy("a reload is already in flight on "
                                 "the target") from e
            raise
        rec = json.loads(body or b"{}")
        last = rec.get("last_reload") or {}
        if status == 202 or not _fresh(last):
            # the server's bounded wait expired before the reload
            # finished — poll /healthz until THIS reload's outcome
            # lands (a pre-existing record stays un-fresh)
            deadline = time.monotonic() + self.timeout_s
            while time.monotonic() < deadline:
                time.sleep(0.2)
                _s, hb = self._request("healthz")
                rec = json.loads(hb)
                last = rec.get("last_reload") or {}
                if _fresh(last):
                    break
            else:
                last = {}
        return {"outcome": last.get("outcome", "load_failed"),
                "error": last.get("error", "reload outcome never "
                                           "surfaced on /healthz"),
                "generation": rec.get("model_generation")}

    def sample(self):
        _status, body = self._request("metrics?format=prometheus")
        return prometheus_sample(body.decode())


class PromotionController:
    """One promotion loop: ``source`` → verify → export → canary
    reload on ``target`` → SLO watch → promote or roll back, with a
    persisted ledger and crash-loop fail-fast.

    Run it as a background thread (:meth:`start`/:meth:`stop`), as a
    blocking loop (:meth:`run_forever` — raises :class:`CrashLoop`),
    or one step at a time (:meth:`run_once` — the chaos drill's and
    the tests' deterministic driver).
    """

    def __init__(self, source, target, *, deploy_dir: str,
                 policy: SLOPolicy | None = None,
                 ledger: PromotionLedger | str | None = None,
                 poll_interval_s: float = 2.0,
                 max_consecutive_failures: int = 3,
                 keep_deployed: int = 5,
                 reload_retry: RetryPolicy | None = None,
                 probe_retry: RetryPolicy | None = None,
                 backoff: RetryPolicy | None = None):
        self.source = source
        self.target = target
        self.deploy_dir = os.path.abspath(os.fspath(deploy_dir))
        os.makedirs(self.deploy_dir, exist_ok=True)
        self.policy = policy if policy is not None else SLOPolicy()
        if ledger is None:
            ledger = os.path.join(self.deploy_dir, "promotions.jsonl")
        self.ledger = (ledger if isinstance(ledger, PromotionLedger)
                       else PromotionLedger(ledger))
        self.poll_interval_s = float(poll_interval_s)
        self.max_consecutive_failures = int(max_consecutive_failures)
        self.keep_deployed = int(keep_deployed)
        # transient-failure policies: reloads and probes retry briefly;
        # the same jittered-backoff math (resilience.retry) paces the
        # gaps between FAILED promotions, where hammering the pipeline
        # is the crash-loop behaviour this controller exists to stop
        self.reload_retry = reload_retry if reload_retry is not None \
            else RetryPolicy(max_attempts=3, base_delay_s=0.2,
                             max_delay_s=2.0)
        # probes additionally retry ValueError: a torn /metrics scrape
        # surfaces as a parse error (slo.parse_prometheus), and the
        # parser's contract is "fail the probe and be retried" — the
        # default classifier would call that deterministic
        self.probe_retry = probe_retry if probe_retry is not None \
            else RetryPolicy(max_attempts=3, base_delay_s=0.1,
                             max_delay_s=1.0,
                             retryable=lambda e: (
                                 isinstance(e, ValueError)
                                 or default_transient(e)))
        self.backoff = backoff if backoff is not None else RetryPolicy(
            max_attempts=max(2, self.max_consecutive_failures),
            base_delay_s=1.0, max_delay_s=30.0)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # recover where the last controller left off: the ledger is
        # the one source of truth that survives restarts
        replay = self.ledger.replay()
        if hasattr(source, "resume"):
            source.resume(replay.attempted)
        prev = replay.last_promoted_path
        if prev is not None and not os.path.exists(prev):
            log.warning("ledger names rollback target %s but it is "
                        "gone — rollbacks disabled until the next "
                        "promotion", prev)
            prev = None
        self._lock = threading.Lock()
        with self._lock:
            self._state = "idle"
            self._last_outcome = replay.last_outcome
            self._last_candidate = replay.last_candidate
            self._consecutive = replay.consecutive_failures
            self._promotions_n = replay.promotions
            self._generation = replay.last_generation
            self._previous = prev
            self._seq = replay.attempts
        if replay.last_generation is not None:
            _generation_g.set(replay.last_generation)
        target.attach(self.status)

    # -- introspection ----------------------------------------------------
    def status(self) -> dict:
        """The /healthz payload: promotion state + last outcome next
        to the serving generation fields."""
        with self._lock:
            return {"state": self._state,
                    "last_outcome": self._last_outcome,
                    "last_candidate": self._last_candidate,
                    "generation": self._generation,
                    "consecutive_failures": self._consecutive,
                    "promotions": self._promotions_n}

    def _set_state(self, state: str, candidate=None) -> None:
        with self._lock:
            self._state = state
        self.ledger.append("state", state=state,
                           candidate=getattr(candidate, "name", None))

    # -- one promotion ----------------------------------------------------
    def run_once(self) -> str | None:
        """Poll the source once; drive any new candidate to an
        outcome.  Returns the outcome string, or None when there was
        nothing to do.  Raises :class:`CrashLoop` when this failure
        crosses the fail-fast threshold."""
        with self._lock:
            if self._state == "crash_loop":
                raise CrashLoop(self._consecutive)
        candidate, skipped = self.source.poll()
        if candidate is None:
            return None
        with self._lock:
            self._seq += 1
            seq = self._seq
            self._last_candidate = candidate.name
        self.ledger.append("candidate", candidate=candidate.name,
                           path=candidate.path, attempt=seq,
                           skipped=skipped or None)
        outcome, reason, extra = self._drive(candidate, seq)
        return self._conclude(candidate, outcome, reason, extra)

    def _drive(self, candidate, seq: int):
        """verify → export → canary reload → watch.  Returns
        ``(outcome, reason, extra)`` where extra carries the deployed
        path/generation/breaches for the ledger."""
        extra: dict = {}
        self._set_state("verifying", candidate)
        try:
            durability.verify_or_heal(candidate.path)
        except durability.ArtifactCorrupt as e:
            return VERIFY_FAILED, str(e), extra
        self._set_state("exporting", candidate)
        try:
            deployed = self._export(candidate, seq)
        except Exception as e:
            return EXPORT_FAILED, repr(e), extra
        extra["deployed"] = deployed
        self._set_state("canarying", candidate)
        try:
            rec = self.reload_retry.call(self.target.reload, deployed)
        except Exception as e:
            return CANARY_FAILED, repr(e), extra
        if rec["outcome"] != "ok":
            return (CANARY_FAILED,
                    f"{rec['outcome']}: {rec['error']}", extra)
        extra["generation"] = rec.get("generation")
        self._set_state("watching", candidate)
        try:
            breaches = self._watch()
        except Exception as e:
            # the window could not be judged at all (probe retries
            # exhausted, target metrics unreachable) — an UNJUDGED
            # candidate must not stay in front of steady-state
            # traffic, which is this controller's whole contract
            extra["watch_error"] = repr(e)
            return self._rollback(candidate, [], extra,
                                  why=f"SLO watch failed: {e!r}")
        if breaches == "aborted":
            return ABORTED, "controller stopped mid-watch", extra
        if breaches:
            extra["breaches"] = breaches
            return self._rollback(candidate, breaches, extra)
        walked = self._walk_fleet(candidate, deployed, extra)
        if walked is not None:
            return walked
        return PROMOTED, None, extra

    def _walk_fleet(self, candidate, deployed: str, extra: dict):
        """The promote-one-then-fleet hook: a target exposing
        ``finalize(path, previous=)`` (the reference's ``fleet.rollout.
        FleetTarget``) walks the REST of its fleet after the canary
        watch passed — weighted traffic splitting, mid-walk SLO
        judgment, fleet-wide rollback on breach all live in the
        target; the controller only ledgers the verdict.  Returns
        None on a clean walk (single-target EngineTarget/HttpTarget
        have no ``finalize`` — the hook is a no-op for them) or the
        ``(outcome, reason, extra)`` tuple of a failed one."""
        fin = getattr(self.target, "finalize", None)
        if fin is None:
            return None
        self._set_state("walking", candidate)
        with self._lock:
            prev = self._previous
        try:
            walk = fin(deployed, previous=prev)
        except Exception as e:
            # finalize's contract is "never raise" (it rolls back
            # internally); a crash here means the fleet may be mixed
            walk = {"outcome": "rollback_failed",
                    "error": f"fleet walk raised: {e!r}"}
        extra["walk"] = walk
        if walk.get("outcome") == "ok":
            return None
        for b in walk.get("breaches") or []:
            count_breach(b)
        self.ledger.append("fleet_rollback", candidate=candidate.name,
                           to=prev,
                           walked=walk.get("walked"),
                           breaches=walk.get("breaches"),
                           error=walk.get("error"))
        why = walk.get("error") or (f"mid-walk SLO breach: "
                                    f"{walk.get('breaches')}")
        if walk.get("outcome") == "rolled_back":
            return ROLLED_BACK, why, extra
        return ROLLBACK_FAILED, why, extra

    def _export(self, candidate, seq: int) -> str:
        """The export step: materialize the candidate's raw bytes and
        commit them into the deploy dir with the durability write
        protocol (invalidate → blob rename → manifest).  Sequence-
        numbered destination names keep the previous generation's
        artifact on disk — it IS the rollback target."""
        name = candidate.name if candidate.name.endswith(".znn") \
            else candidate.name + ".znn"
        dst = os.path.join(self.deploy_dir, f"{seq:06d}-{name}")

        def attempt():
            faults.inject("promotion.export")
            self.source.materialize(candidate, dst + ".tmp")
            durability.invalidate_manifest(dst)
            os.replace(dst + ".tmp", dst)
            # an exporter that commits its own sidecar at the tmp path
            # (export_workflow does) leaves it behind after the rename
            durability.invalidate_manifest(dst + ".tmp")
            durability.write_manifest(dst, kind="znn")
            return dst

        return self.reload_retry.call(attempt)

    def _sample(self):
        def probe():
            faults.inject("promotion.slo_probe")
            return self.target.sample()
        return self.probe_retry.call(probe)

    def _watch(self):
        """The SLO watch window: sample, then re-evaluate the deltas
        every ``probe_interval_s`` until ``window_s`` elapses.  First
        breach wins (rolling back fast beats a complete report —
        the regression is live traffic's problem RIGHT NOW); a clean
        window returns None."""
        start = self._sample()
        deadline = time.monotonic() + self.policy.window_s
        while not self._stop.is_set():
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            self._stop.wait(min(self.policy.probe_interval_s,
                                remaining))
            if self._stop.is_set():
                break
            breaches = self.policy.evaluate(start, self._sample())
            if breaches:
                return breaches
        # stopping mid-watch: no breach was observed, but the window
        # did not run its course either — the candidate was NOT
        # judged, and the caller must not record it as promoted
        self.ledger.append("watch_aborted")
        return "aborted"

    def _rollback(self, candidate, breaches, extra, why=None):
        with self._lock:
            prev = self._previous
        for b in breaches:
            count_breach(b)
        if prev is None:
            return (ROLLBACK_FAILED,
                    (why or "SLO breach") + " with no previous "
                    "generation to roll back to", extra)
        try:
            rec = self.reload_retry.call(self.target.reload, prev)
        except Exception as e:
            return ROLLBACK_FAILED, repr(e), extra
        if rec["outcome"] != "ok":
            return (ROLLBACK_FAILED,
                    f"rollback reload: {rec['outcome']}: "
                    f"{rec['error']}", extra)
        self.ledger.append("rollback", candidate=candidate.name,
                           to=prev, generation=rec.get("generation"),
                           breaches=breaches)
        extra["generation"] = rec.get("generation")
        return ROLLED_BACK, why or f"SLO breach: {breaches}", extra

    def _conclude(self, candidate, outcome: str, reason, extra):
        """Bookkeeping shared by every outcome: metrics, ledger,
        streak accounting, crash-loop fail-fast."""
        done = getattr(self.target, "conclude", None)
        if done is not None:
            # duck-typed fleet hook, fired WHATEVER the outcome: a
            # FleetTarget restores the canary's traffic weight here —
            # a failed canary/watch must not leave its backend
            # drained at canary weight (single targets have no hook)
            try:
                done(outcome)
            except Exception:
                log.exception("target conclude hook failed")
        _promotions.inc(outcome=outcome)
        self.ledger.append("outcome", outcome=outcome,
                           candidate=candidate.name, reason=reason,
                           **extra)
        with self._lock:
            self._last_outcome = outcome
            if outcome == PROMOTED:
                self._consecutive = 0
                self._promotions_n += 1
                self._previous = extra.get("deployed", self._previous)
                gen = extra.get("generation")
                if gen is not None:
                    self._generation = int(gen)
                    _generation_g.set(int(gen))
                self._state = "idle"
            elif outcome == ABORTED:
                # unjudged, not failed: the streak must not move
                self._state = "idle"
            else:
                self._consecutive += 1
                self._state = ("rolled_back" if outcome == ROLLED_BACK
                               else "idle")
            failures = self._consecutive
        if outcome == PROMOTED:
            self._prune_deployed()
        elif outcome != ABORTED \
                and failures >= self.max_consecutive_failures:
            self.ledger.append("crash_loop", failures=failures)
            with self._lock:
                self._state = "crash_loop"
            self._stop.set()
            raise CrashLoop(failures)
        return outcome

    def _prune_deployed(self) -> None:
        """Bound the deploy dir: keep the newest ``keep_deployed``
        sequence-numbered artifacts (and always the live rollback
        target), drop older blobs + their manifests."""
        with self._lock:
            keep_always = self._previous
        mine = sorted(
            name for name in os.listdir(self.deploy_dir)
            if name.endswith(".znn") and name[:6].isdigit())
        for name in mine[:-self.keep_deployed]:
            path = os.path.join(self.deploy_dir, name)
            if path == keep_always:
                continue
            try:
                durability.invalidate_manifest(path)
                os.unlink(path)
            except OSError:
                pass

    # -- the loop ---------------------------------------------------------
    def run_forever(self) -> None:
        """Blocking loop: poll, promote, back off after failures.
        Returns when :meth:`stop` is called; raises
        :class:`CrashLoop` on fail-fast."""
        while not self._stop.is_set():
            try:
                outcome = self.run_once()
            except CrashLoop:
                raise
            except Exception:
                # a bug in the loop must not kill the controller
                # silently — log it, count it as a failed attempt
                # (ledger'd, so the streak survives a supervisor
                # restarting a crash-looping controller), and let the
                # crash-loop guard decide
                log.exception("promotion attempt crashed")
                try:
                    self.ledger.append("attempt_crashed")
                except Exception:
                    log.exception("could not ledger the crash")
                with self._lock:
                    self._consecutive += 1
                    failures = self._consecutive
                if failures >= self.max_consecutive_failures:
                    self.ledger.append("crash_loop", failures=failures)
                    with self._lock:
                        self._state = "crash_loop"
                    self._stop.set()
                    raise CrashLoop(failures)
                outcome = "error"
            if outcome is None:
                self._stop.wait(self.poll_interval_s)
            elif outcome != PROMOTED:
                with self._lock:
                    failures = self._consecutive
                self._stop.wait(self.backoff.backoff_s(max(1, failures)))

    def _run(self) -> None:
        try:
            self.run_forever()
        except CrashLoop as e:
            log.error("%s", e)

    def start(self) -> "PromotionController":
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="znicz-promotion")
        self._thread.start()
        return self

    def stop(self, timeout: float | None = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
