"""Elastic multi-process training by supervised coordinated restart (port
of ``znicz_tpu/parallel/elastic.py``).

``torch.distributed`` fixes its process set at ``init_process_group``, so a
fleet that lost a member cannot take a replacement in: this supervisor
launches the fleet, watches it, and on any member's death restarts ALL
processes on a fresh rendezvous port; the workers resume from the newest
*verified* checkpoint (``parallel.checkpoint.TrainerCheckpointer``,
``distributed.CheckpointRecovery``; a checkpoint the dying fleet tore or
rotted is quarantined and the scan falls back to the one before, see
``durability``).  A replacement worker receives the current weights by
loading the checkpoint — the reference's rejoin over the wire, at
checkpoint rather than packet granularity.

Scope: single-host supervision (every worker is a local subprocess
against a loopback rendezvous).  Each worker gets ``--coordinator
HOST:PORT --process-id I --num-processes N`` and passes them to
``parallel.distributed.initialize``; on the card its ranks share
``cuda:0`` over gloo unless the host has a card for each rank."""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time

from ..logger import Logger
from ..resilience.retry import RetryPolicy
from ..telemetry.registry import REGISTRY

_restarts = REGISTRY.counter(
    "elastic_restarts_total",
    "full-fleet coordinated restarts performed by ElasticRunner")
_failures = REGISTRY.counter(
    "elastic_failures_total",
    "fleet rounds that died, by kind (crash | timeout)")
_backoff_s = REGISTRY.counter(
    "elastic_backoff_seconds_total",
    "seconds spent sleeping between fleet restarts")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ElasticRunner(Logger):
    """Launch ``num_processes`` workers; coordinated-restart on death.

    ``make_argv(coordinator, process_id, num_processes)`` returns the
    argv for one worker.  Workers are expected to (a) bootstrap through
    ``parallel.distributed.initialize`` with those coordinates, (b)
    checkpoint at their own granularity, (c) resume from the newest
    checkpoint when one exists, and (d) exit 0 when training completes.

    The supervisor restarts the WHOLE fleet when any member exits
    nonzero, or when a round exceeds ``round_timeout`` (the stall
    guard — OFF unless set: a hung collective can only be detected by
    a deadline the caller chooses) — a partial fleet cannot make
    progress in a fixed process group, and a full restart from the last
    checkpoint is the coordination-free equivalent of the reference's
    per-slave rejoin.

    Worker stdout/stderr stream to per-worker files under ``log_dir``
    (a pipe would deadlock a chatty worker once the OS buffer fills).

    Restart pacing: a dead fleet restarts after a bounded-exponential
    jittered backoff (``backoff_base_s * 2**n`` capped at
    ``backoff_max_s`` — a hot restart loop against a dead rendezvous
    just burns the restart budget in seconds), and
    ``crash_loop_threshold`` failures inside ``crash_loop_window_s``
    fail FAST with every worker's log tail aggregated — a
    deterministic crash (bad config, OOM-on-init) should page the
    operator, not exhaust ``max_restarts`` slowly.  ``status()``
    exposes restarts + the structured last failure for callers.
    Every worker of a round is stopped (killed and waited for) before
    the next round starts and when ``run`` returns or raises."""

    def __init__(self, make_argv, num_processes: int,
                 max_restarts: int = 5, round_timeout: float | None = None,
                 env: dict | None = None, poll_interval: float = 0.2,
                 log_dir: str | None = None,
                 backoff_base_s: float = 0.5, backoff_max_s: float = 15.0,
                 crash_loop_threshold: int = 3,
                 crash_loop_window_s: float = 30.0, sleep_fn=time.sleep):
        super().__init__()
        self.make_argv = make_argv
        self.num_processes = int(num_processes)
        self.max_restarts = int(max_restarts)
        self.round_timeout = round_timeout
        self.env = env
        self.poll_interval = poll_interval
        self.log_dir = log_dir or tempfile.mkdtemp(prefix="elastic_")
        #: restarts actually performed (observable for tests/metrics)
        self.restarts = 0
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.crash_loop_threshold = int(crash_loop_threshold)
        self.crash_loop_window_s = float(crash_loop_window_s)
        self._sleep = sleep_fn
        # ONE backoff implementation repo-wide: the restart schedule is
        # resilience.RetryPolicy's capped-exponential-with-jitter curve
        self._backoff = RetryPolicy(
            max_attempts=max(2, self.max_restarts + 1),
            base_delay_s=self.backoff_base_s,
            max_delay_s=self.backoff_max_s, jitter=0.5, seed=0xE1A5)
        #: structured failure records, newest last (bounded)
        self.failures: list[dict] = []
        self.last_failure: dict | None = None
        self._state = "idle"

    # -- one fleet round ---------------------------------------------------
    def _log_path(self, pid: int) -> str:
        return os.path.join(self.log_dir,
                            f"worker{pid}.round{self.restarts}.log")

    def _launch(self) -> list[subprocess.Popen]:
        coord = f"127.0.0.1:{free_port()}"
        os.makedirs(self.log_dir, exist_ok=True)
        procs = []
        for pid in range(self.num_processes):
            argv = self.make_argv(coord, pid, self.num_processes)
            with open(self._log_path(pid), "w") as log:
                procs.append(subprocess.Popen(
                    [str(a) for a in argv], env=self.env,
                    stdout=log, stderr=subprocess.STDOUT))
        self.info("fleet up: %d workers on %s (logs: %s)", len(procs),
                  coord, self.log_dir)
        return procs

    @staticmethod
    def _reap(procs) -> None:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass

    def _log_tail(self, pid: int, nbytes: int = 400) -> str:
        try:
            with open(self._log_path(pid), "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - nbytes))
                return f.read().decode("utf-8", "replace").strip()
        except OSError:
            return "<no log>"

    def _record_failure(self, kind: str, workers: list[dict]) -> None:
        rec = {"kind": kind, "round": self.restarts,
               "at": time.time(), "monotonic": time.monotonic(),
               "workers": workers}
        self.failures.append(rec)
        del self.failures[:-20]            # bound the history
        self.last_failure = rec
        _failures.inc(kind=kind)

    def _watch(self, procs) -> bool:
        """True = every worker exited 0 (training complete); False =
        somebody died or timed out (caller restarts the fleet).  EVERY
        non-zero exit gets its tail logged and recorded — in one process
        group the first death is usually a symptom (peer lost a collective),
        and the root cause is in one of the OTHER tails."""
        deadline = (time.monotonic() + self.round_timeout
                    if self.round_timeout else None)
        while True:
            codes = [p.poll() for p in procs]
            if all(c == 0 for c in codes):
                return True
            dead = [(i, c) for i, c in enumerate(codes)
                    if c not in (None, 0)]
            if dead:
                # co-dying workers get a short grace to exit on their
                # own before the reap: in one process group the first observed
                # death is usually a symptom, and a sibling's OWN exit
                # code + tail beats the -SIGKILL the reap would stamp
                # on it milliseconds later (also de-flakes the
                # both-die-instantly case: a worker still in
                # interpreter startup at the poll gets to finish
                # crashing)
                grace = time.monotonic() + max(self.poll_interval, 1.0)
                while (any(p.poll() is None for p in procs)
                       and time.monotonic() < grace):
                    time.sleep(min(0.05, self.poll_interval))
                dead = [(i, p.poll()) for i, p in enumerate(procs)
                        if p.poll() not in (None, 0)]
                # record only exits observed BEFORE the reap: workers
                # the supervisor kills below are victims, and their
                # -SIGKILL codes would bury the real tails
                workers = []
                for i, c in dead:
                    tail = self._log_tail(i)[-300:]
                    self.warning("worker %d died rc=%s: %s", i, c, tail)
                    workers.append({"process": i, "returncode": c,
                                    "log_tail": tail,
                                    "log": self._log_path(i)})
                self._reap(procs)
                self._record_failure("crash", workers)
                return False
            if deadline is not None and time.monotonic() > deadline:
                self.warning("fleet round timed out after %.0fs",
                             self.round_timeout)
                # snapshot BEFORE the reap: returncode None = "still
                # running at the deadline", which is the truth — the
                # kill signals the reap is about to deliver are the
                # supervisor's doing, not the workers' failure mode
                workers = [{"process": i, "returncode": p.poll(),
                            "log_tail": self._log_tail(i)[-300:],
                            "log": self._log_path(i)}
                           for i, p in enumerate(procs)]
                self._reap(procs)
                self._record_failure("timeout", workers)
                return False
            time.sleep(self.poll_interval)

    def backoff_s(self, restart_index: int) -> float:
        """Jittered, capped delay before restart ``restart_index``
        (1-based) — full-value sleeps would synchronize a multi-fleet
        host into restart storms against the shared coordinator."""
        return self._backoff.backoff_s(restart_index)

    def _aggregate_tails(self, n: int) -> str:
        """Human-readable digest of the last ``n`` failures — the
        fail-fast path must hand the operator every tail at once, not
        a log_dir to spelunk."""
        lines = []
        for rec in self.failures[-n:]:
            for w in rec["workers"]:
                lines.append(f"[round {rec['round']} {rec['kind']} "
                             f"worker {w['process']} "
                             f"rc={w['returncode']}] {w['log_tail']}")
        return "\n".join(lines)

    def _crash_looping(self) -> bool:
        if len(self.failures) < self.crash_loop_threshold:
            return False
        recent = self.failures[-self.crash_loop_threshold:]
        span = recent[-1]["monotonic"] - recent[0]["monotonic"]
        return span <= self.crash_loop_window_s

    # -- public ------------------------------------------------------------
    def status(self) -> dict:
        """Structured supervisor state for callers (CLI, health
        endpoints, tests): restart budget, phase, and the full record
        of the last failure including every dead worker's tail."""
        return {"state": self._state, "restarts": self.restarts,
                "max_restarts": self.max_restarts,
                "num_processes": self.num_processes,
                "failure_count": len(self.failures),
                "last_failure": self.last_failure,
                "log_dir": self.log_dir}

    def run(self) -> int:
        """Supervise until completion.  Returns the restart count;
        raises RuntimeError when ``max_restarts`` is exhausted or a
        crash loop is detected (``crash_loop_threshold`` failures
        within ``crash_loop_window_s``)."""
        while True:
            self._state = "running"
            procs = self._launch()
            try:
                if self._watch(procs):
                    self.info("training complete after %d restart(s)",
                              self.restarts)
                    self._state = "complete"
                    return self.restarts
            finally:
                self._reap(procs)
            if self._crash_looping():
                self._state = "crash_loop"
                raise RuntimeError(
                    f"crash loop: {self.crash_loop_threshold} fleet "
                    f"failures within {self.crash_loop_window_s:.0f}s "
                    f"— failing fast instead of burning the restart "
                    f"budget; last tails:\n"
                    + self._aggregate_tails(self.crash_loop_threshold))
            self.restarts += 1
            _restarts.inc()
            if self.restarts > self.max_restarts:
                self._state = "failed"
                raise RuntimeError(
                    f"fleet failed {self.restarts} times; giving up "
                    f"(max_restarts={self.max_restarts}); last "
                    f"failure tails:\n" + self._aggregate_tails(2))
            delay = self.backoff_s(self.restarts)
            _backoff_s.inc(delay)
            self._state = "backoff"
            self.info("restart %d/%d in %.2fs (%s)", self.restarts,
                      self.max_restarts, delay,
                      self.last_failure["kind"] if self.last_failure
                      else "unknown")
            self._sleep(delay)


def main(argv=None) -> int:
    """CLI: ``python -m znicz_tpu_torch.parallel.elastic -n N
    [--max-restarts R] -- worker.py ARGS...`` (or ``-- -m MODULE ARGS``)
    — the worker receives
    ``--coordinator HOST:PORT --process-id I --num-processes N``
    appended to its argv."""
    import argparse
    p = argparse.ArgumentParser(
        description="supervised coordinated-restart training fleet")
    p.add_argument("-n", "--num-processes", type=int, required=True)
    p.add_argument("--max-restarts", type=int, default=5)
    p.add_argument("--round-timeout", type=float, default=None)
    p.add_argument("--backoff-base-s", type=float, default=0.5)
    p.add_argument("--backoff-max-s", type=float, default=15.0)
    p.add_argument("--crash-loop-threshold", type=int, default=3)
    p.add_argument("--crash-loop-window-s", type=float, default=30.0)
    p.add_argument("worker", nargs=argparse.REMAINDER,
                   help="-- worker.py args...")
    args = p.parse_args(argv)
    worker = list(args.worker)
    if worker and worker[0] == "--":     # only the SEPARATOR; a later
        worker.pop(0)                    # literal -- belongs to the
    if not worker:                       # worker's own argv
        p.error("worker command required after --")

    def make_argv(coord, pid, nproc):
        return [sys.executable, *worker,
                "--coordinator", coord, "--process-id", str(pid),
                "--num-processes", str(nproc)]

    runner = ElasticRunner(make_argv, args.num_processes,
                           max_restarts=args.max_restarts,
                           round_timeout=args.round_timeout,
                           backoff_base_s=args.backoff_base_s,
                           backoff_max_s=args.backoff_max_s,
                           crash_loop_threshold=args.crash_loop_threshold,
                           crash_loop_window_s=args.crash_loop_window_s)
    runner.run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
