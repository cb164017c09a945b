"""Live-process debug surface: /statusz, thread/stack dumps, SIGUSR1 (a
copy of the JAX package's ``telemetry/debugz.py``).

A handler-thread deadlock is hard to diagnose without a way to ask a
RUNNING server "what are your threads doing right now".  This module is
that introspection, deliberately boring and dependency-free:

* :func:`threadz` — every live thread with its current Python stack
  (``sys._current_frames``), as a JSON-able dict; served on
  ``GET /debug/threadz`` and dumped to stderr on **SIGUSR1**
  (:func:`install_stack_dump`) so a wedged replica can be inspected
  with one ``kill -USR1 <pid>`` even when its HTTP threads are the
  thing that hung.
* :func:`statusz_text` — the classic human-readable one-pager: build
  rev, uptime, the kernel build directory, backend/breaker/generation
  state, last reload, promotion state, compile accounting
  (:mod:`~znicz_tpu_torch.telemetry.compilestats`), and the flight
  recorder's slow-request table.  Text, not JSON: it exists to be
  curl'd by a human mid-incident.

Uptime is monotonic-based (wall clocks jump under NTP); the wall stamp
is reported alongside for correlation with logs.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback

from . import compilestats, flightrecorder

#: process clock anchors, taken at first import (the serve CLI imports
#: telemetry at startup, so this is process start for serving replicas)
_START_MONOTONIC = time.monotonic()
_START_WALL = time.time()


def process_uptime_s() -> float:
    """Seconds since this module was first imported — monotonic, so an
    NTP step never makes a replica look freshly flapped (or ancient)."""
    return time.monotonic() - _START_MONOTONIC


def started_at() -> float:
    """Wall-clock stamp of the uptime anchor (for log correlation)."""
    return _START_WALL


# -- thread introspection ---------------------------------------------------

def threadz() -> dict:
    """Every live thread with its current Python stack, JSON-able.
    ``sys._current_frames`` is a point-in-time snapshot taken without
    stopping the world — exactly what diagnosing a live hang needs
    (a deadlocked thread's stack shows the lock it is parked on)."""
    frames = sys._current_frames()
    by_ident = {t.ident: t for t in threading.enumerate()}
    threads = []
    for ident, frame in sorted(frames.items()):
        t = by_ident.get(ident)
        stack = [f"{fs.filename}:{fs.lineno} in {fs.name}"
                 + (f"\n    {fs.line.strip()}" if fs.line else "")
                 for fs in traceback.extract_stack(frame)]
        threads.append({
            "ident": ident,
            "name": t.name if t is not None else f"<unknown-{ident}>",
            "daemon": bool(t.daemon) if t is not None else None,
            "stack": stack})
    return {"count": len(threads), "at": time.time(),
            "threads": threads}


def format_threadz(snapshot: dict | None = None) -> str:
    """The thread snapshot as text (the SIGUSR1 dump format)."""
    snap = snapshot if snapshot is not None else threadz()
    lines = [f"==== znicz-tpu thread dump: {snap['count']} threads "
             f"(at {snap['at']:.3f}) ===="]
    for t in snap["threads"]:
        flags = " daemon" if t.get("daemon") else ""
        lines.append(f"-- {t['name']} (ident {t['ident']}{flags})")
        lines.extend(f"   {entry}" for entry in t["stack"])
    return "\n".join(lines) + "\n"


def install_stack_dump(signum=None, stream=None):
    """Install a signal handler (default **SIGUSR1**) that writes the
    thread dump to ``stream`` (default stderr).  Returns the previous
    handler (None when signals are unavailable — e.g. not the main
    thread — because a debug aid must never take the process down)."""
    import signal as _signal
    sig = signum if signum is not None \
        else getattr(_signal, "SIGUSR1", None)
    if sig is None:                      # platform without SIGUSR1
        return None

    def _dump(_signo, _frame):
        out = stream if stream is not None else sys.stderr
        out.write(format_threadz())
        out.flush()

    try:
        return _signal.signal(sig, _dump)
    except (ValueError, OSError):    # non-main thread / exotic platform
        return None


# -- /statusz ---------------------------------------------------------------

def _fmt_kv(d: dict) -> str:
    return "  ".join(f"{k}={v}" for k, v in d.items())


def statusz_text(server=None, *, recorder=None, extra: dict | None = None
                 ) -> str:
    """The human-readable status one-pager.  ``server`` is a
    :class:`~znicz_tpu_torch.serving.server.ServingServer` (engine, batcher,
    promotion hook all reachable from it); None renders the
    process-level sections only, so the training side can serve the
    same page."""
    from . import buildinfo
    rec = recorder if recorder is not None else flightrecorder.RECORDER
    lines = ["znicz-tpu /statusz", "=" * 18, ""]
    rev = (server.rev if server is not None
           else buildinfo.cached_rev())
    lines.append(f"rev: {rev or 'unknown'}")
    lines.append(f"uptime_s: {process_uptime_s():.1f} "
                 f"(started at {started_at():.3f})")
    # where this checkout's hand-written kernels are built (the
    # reference prints its XLA compile cache here)
    from .. import cuda_build
    lines.append(f"kernel_build_dir: {cuda_build.BUILD_DIR}")
    if extra:
        lines.append(_fmt_kv(extra))
    if server is not None:
        eng = server.engine
        em = server.engine_metrics()
        lines += ["", "serving", "-" * 7]
        lines.append(_fmt_kv({
            "backend": eng.backend,
            "status": em.get("resilience_state"),
            "generation": em.get("generation"),
            "buckets": ",".join(str(b) for b in eng.buckets),
            "cached_executables": em.get("cached_executables")}))
        mesh = em.get("mesh")
        if mesh:
            # the SPMD topology: serving mesh (1x1 = single device)
            # and, behind a replica set, one line per replica so a
            # degraded one is visible without grepping logs
            lines.append(f"mesh: {mesh}  "
                         f"tp={em.get('tensor_parallel', 1)}  "
                         f"replicas={em.get('replica_count', 1)}")
        for r in (em.get("replicas") or []):
            lines.append("replica: " + _fmt_kv(r))
        breaker = em.get("breaker") or {}
        lines.append("breaker: " + _fmt_kv(breaker))
        last = (eng.reload_status() or {}).get("last_reload")
        lines.append(f"last_reload: {last or 'never'}")
        zoo_fn = getattr(server, "zoo_status", None)
        zoo = zoo_fn() if zoo_fn is not None else None
        if zoo:
            # the per-tenant table: which models this replica serves,
            # whose weights are resident, who is shedding/queueing —
            # the first question a multi-tenant 503 spike raises
            lines += ["", "model zoo", "-" * 9]
            lines.append(
                f"budget_bytes={zoo.get('memory_budget_bytes')}  "
                f"resident_bytes={zoo.get('resident_bytes')}  "
                f"pagein_p50_ms={zoo.get('pagein_p50_ms')}  "
                f"pagein_p99_ms={zoo.get('pagein_p99_ms')}")
            lines.append(f"  {'model':<16} {'gen':>4} {'crit':<10} "
                         f"{'res':<4} {'bytes':>10} {'queue':>6} "
                         f"{'idle_s':>8}  state")
            for r in (zoo.get("models") or {}).values():
                name = r["model"] + ("*" if r.get("default") else "")
                lines.append(
                    f"  {name:<16} {r['generation']:>4} "
                    f"{r['criticality']:<10} "
                    f"{'yes' if r['resident'] else 'no':<4} "
                    f"{r['weight_bytes']:>10} {r['queue_depth']:>6} "
                    f"{r['idle_s']:>8.1f}  {r['state']}")
        ps = server.promotion_status
        if ps is not None:
            try:
                lines.append("promotion: " + _fmt_kv(ps()))
            except Exception:
                lines.append("promotion: <status probe failed>")
        bm = server.batcher.metrics()
        lines.append("batcher: " + _fmt_kv(
            {k: bm.get(k) for k in ("queue_depth", "completed",
                                    "rejected", "expired",
                                    "latency_p50_ms",
                                    "latency_p99_ms")}))
        ov_fn = getattr(server, "overload_status", None)
        if ov_fn is not None:
            # the overload-defense snapshot: is this replica shedding,
            # hedging, draining, or denying retries RIGHT NOW — the
            # questions a 503 spike raises mid-incident
            try:
                ov = ov_fn()
            except Exception:
                ov = None
            if ov:
                lines += ["", "overload", "-" * 8]
                lines.append(_fmt_kv({
                    "draining": ov.get("draining"),
                    "default_deadline_ms":
                        ov.get("default_deadline_ms"),
                    "queue_wait_p50_ms": ov.get("queue_wait_p50_ms"),
                    "queue_wait_p95_ms": ov.get("queue_wait_p95_ms"),
                    "doomed": ov.get("doomed"),
                    "expired": ov.get("expired")}))
                shed = ov.get("shed")
                if shed:
                    lines.append("shed ladder: " + _fmt_kv(shed))
                hedge = ov.get("hedge")
                if hedge:
                    lines.append("hedge: " + _fmt_kv(hedge))
                budget = ov.get("retry_budget")
                if budget:
                    lines.append("retry budget: " + _fmt_kv(budget))
        capture = getattr(server, "capture", None)
        if capture is not None:
            # the traffic tap feeding the live-data loop: is the ring
            # filling, dropping, or erroring — the first question when
            # the continual trainer reports starved rounds
            try:
                cm = capture.metrics()
            except Exception:
                cm = None
            if cm:
                lines += ["", "traffic capture", "-" * 15]
                lines.append(_fmt_kv({
                    "dir": cm.get("directory"),
                    "records": cm.get("records"),
                    "bytes": cm.get("bytes"),
                    "segments": cm.get("segments"),
                    "sample": cm.get("sample")}))
                lines.append(_fmt_kv({
                    "queued": cm.get("queued"),
                    "dropped_sampled": cm.get("dropped_sampled"),
                    "dropped_backlog": cm.get("dropped_backlog"),
                    "dropped_error": cm.get("dropped_error"),
                    "fsync_errors": cm.get("fsync_errors")}))
        slo_fn = getattr(server, "slo_status", None)
        slo = slo_fn() if slo_fn is not None else None
        if slo and slo.get("slos"):
            # the SLO engine's verdict, one row per objective: is a
            # tenant's budget burning RIGHT NOW, and how fast — the
            # first question a paging alert raises (the full payload
            # lives on GET /alertz)
            lines += ["", "slo burn rates", "-" * 14]
            lines.append(f"  {'slo':<14} {'model':<12} "
                         f"{'objective':<13} {'burn_fast':>9} "
                         f"{'burn_slow':>9} {'budget':>7}  state")
            for r in slo["slos"]:
                lines.append(
                    f"  {r['slo']:<14} {r['model']:<12} "
                    f"{r['objective']:<13} {r['burn_fast']:>9} "
                    f"{r['burn_slow']:>9} "
                    f"{r['budget_remaining']:>7}  "
                    f"{'FIRING' if r['firing'] else 'ok'}")
    snap = compilestats.snapshot()
    lines += ["", "compile accounting", "-" * 18]
    if not snap["compiles"]:
        lines.append("no executables built yet")
    for site, causes in sorted(snap["compiles"].items()):
        cost = snap["compile_cost"].get(site, {})
        lines.append(f"site={site}  " + _fmt_kv(causes)
                     + f"  total_ms={cost.get('total_ms', 0)}")
    for site, cm in sorted(snap["caches"].items()):
        lines.append(f"cache site={site}  " + _fmt_kv(cm))
    lines.append(f"request_path_compiles: "
                 f"{snap['request_path_compiles']}")
    counts = rec.counts()
    lines += ["", "flight recorder", "-" * 15]
    lines.append(_fmt_kv(counts))
    slowest = rec.slowest(10)
    if slowest:
        lines.append("slowest retained requests/steps:")
        lines.append(f"  {'seq':>6} {'kind':<11} {'ms':>10} "
                     f"{'outcome':<8} {'age_s':>8}  detail")
        for r in slowest:
            # wall-to-wall difference of stamps, deliberately: record
            # stamps are wall-clock for cross-process log correlation,
            # and a human reading the table wants "how long ago"
            age = time.time() - r["at"]
            detail = r.get("request_id") or r.get("epoch", "")
            lines.append(f"  {r['seq']:>6} {r['kind']:<11} "
                         f"{(r['duration_ms'] or 0):>10.2f} "
                         f"{r['outcome']:<8} {age:>8.1f}  {detail}")
    lines += ["", "endpoints: /healthz /metrics /statusz "
                  "/debug/flightrecorder /debug/threadz "
                  "(kill -USR1 <pid> dumps threads to stderr)", ""]
    return "\n".join(lines)


def fleet_statusz_text(router, *, recorder=None) -> str:
    """The fleet router's ``/statusz`` one-pager: one row per backend
    (breaker state, weight, generation, last probe), the rollout
    controller's state when attached, and the router's own flight-recorder
    summary.  Text, like :func:`statusz_text`: it exists to be curl'd
    by a human mid-incident.  Its caller, the fleet router, is not
    ported yet."""
    rec = recorder if recorder is not None else flightrecorder.RECORDER
    lines = ["znicz-tpu fleet /statusz", "=" * 24, ""]
    lines.append(f"rev: {router.rev or 'unknown'}")
    lines.append(f"uptime_s: {process_uptime_s():.1f} "
                 f"(started at {started_at():.3f})")
    health = router.health()
    lines.append(f"fleet: {health['status']}  "
                 f"healthy={health['healthy_backends']}/"
                 f"{health['backend_count']}")
    ha = health.get("ha")
    if ha is not None:
        # mid-failover the first question is "who is the primary and
        # what epoch are we on"
        extra = ""
        if ha.get("primary_url"):
            extra = f"  primary={ha['primary_url']}"
        lines.append(f"ha: role={ha.get('role', '?')} "
                     f"epoch={ha.get('epoch', '?')} "
                     f"takeovers={ha.get('takeovers', 0)} "
                     f"demotions={ha.get('demotions', 0)}{extra}")
    rc = health.get("reconcile")
    if rc is not None:
        # mid-incident the first question after a restart is "is it
        # still reconciling and how long will clients see 503s"
        extra = (f"  retry_after_s={rc['retry_after_s']}"
                 if "retry_after_s" in rc else "")
        degraded = "  DEGRADED (journal unwritable: mutations " \
                   "refused, reads serving)" if rc.get("degraded") \
                   else ""
        lines.append(f"control-plane: {rc['state']}{extra}  "
                     f"journal={rc['journal']}{degraded}")
    lines += ["", "backends", "-" * 8]
    lines.append(f"  {'name':<16} {'weight':>7} {'eff':>6} "
                 f"{'breaker':<10} {'gen':>4} {'ewma_ms':>8} "
                 f"{'probe_age_s':>11} {'status':<12} url")
    for r in router.backend_rows():
        age = r.get("probe_age_s")
        gray = r.get("gray") or {}
        eff = r.get("effective_weight", r["weight"])
        ewma = gray.get("ewma_ms")
        lines.append(
            f"  {r['name']:<16} {r['weight']:>7.2f} {eff:>6.2f} "
            f"{r['breaker']['state']:<10} "
            f"{r['generation'] if r['generation'] is not None else '?':>4} "
            f"{f'{ewma:.1f}' if ewma is not None else '-':>8} "
            f"{age if age is not None else '-':>11} "
            f"{(r.get('backend_status') or '?'):<12} {r['url']}")
    rs = router.rollout_status
    if rs is not None:
        try:
            lines.append("rollout: " + _fmt_kv(rs()))
        except Exception:
            lines.append("rollout: <status probe failed>")
    if getattr(router, "placement", None) is not None:
        # the placement map, tenant by tenant — mid-incident the
        # question is "where does model X live RIGHT NOW"
        try:
            ps = router.placement_status()
            lines += ["", "placement", "-" * 9]
            lines.append(
                f"  replication={ps['replication']} "
                f"generation={ps['generation']} "
                f"cause={ps['last_cause'] or '-'} "
                f"moves_total={ps['moves_total']}")
            for model, names in sorted(
                    (ps.get("assignments") or {}).items()):
                pin = " (pinned)" if model in (ps.get("pins") or {}) \
                    else ""
                lines.append(f"  {model:<24} -> "
                             f"{', '.join(names) or '-'}{pin}")
        except Exception:
            lines.append("placement: <status probe failed>")
    asf = getattr(router, "autoscale_status", None)
    if asf is not None:
        try:
            lines.append("autoscale: " + _fmt_kv(asf()))
        except Exception:
            lines.append("autoscale: <status probe failed>")
    counts = rec.counts()
    lines += ["", "flight recorder", "-" * 15]
    lines.append(_fmt_kv(counts))
    slowest = rec.slowest(10)
    if slowest:
        lines.append("slowest retained forwards:")
        lines.append(f"  {'seq':>6} {'ms':>10} {'outcome':<8} "
                     f"{'backend':<16} detail")
        for r in slowest:
            lines.append(f"  {r['seq']:>6} "
                         f"{(r['duration_ms'] or 0):>10.2f} "
                         f"{r['outcome']:<8} "
                         f"{(r.get('backend') or '-'):<16} "
                         f"{r.get('request_id') or ''}")
    lines += ["", "endpoints: /healthz /metrics /statusz "
                  "POST /admin/weight POST /admin/placement", ""]
    return "\n".join(lines)
