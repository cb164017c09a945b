"""Persisted promotion ledger: who was promoted, when, and why it was
rolled back — surviving controller restarts.

Append-only JSONL, one event object per line, fsync'd per append: the
ledger is the controller's *recovery log*, and a promotion decision
that evaporates with the process would let a restarted controller
re-promote the exact candidate it just rolled back.  On startup
:meth:`PromotionLedger.replay` folds the event stream back into the
little state the controller needs — which candidates were already
attempted, the last blessed artifact to roll back to, and how deep the
current failure streak is (the crash-loop counter must survive a
crash-looping controller's own restarts, or it never fires).

A crash mid-append can leave one torn final line; reads tolerate
exactly that (skip-with-warning), the same stance the durability layer
takes on torn blobs — everything *before* the tear is fsync'd history.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time

log = logging.getLogger("promotion")


@dataclasses.dataclass
class LedgerReplay:
    """What a restarted controller recovers from the event stream."""

    attempted: set
    promotions: int = 0
    consecutive_failures: int = 0
    last_promoted_path: str | None = None
    last_candidate: str | None = None
    last_outcome: str | None = None
    last_generation: int | None = None
    attempts: int = 0


class PromotionLedger:
    """Append/read/replay over one JSONL file (created on first
    append; a missing file is an empty history)."""

    def __init__(self, path: str):
        self.path = os.fspath(path)
        self._lock = threading.Lock()

    def append(self, event: str, **fields) -> dict:
        """Durably append one event line (``{"ts", "event", ...}``) and
        return it.  fsync per event: promotion decisions are rare and
        each one is exactly the record a post-crash replay needs."""
        entry = {"ts": time.time(), "event": event, **fields}
        line = json.dumps(entry, sort_keys=True, default=str) + "\n"
        with self._lock:
            os.makedirs(os.path.dirname(self.path) or ".",
                        exist_ok=True)
            with open(self.path, "a") as fh:
                fh.write(line)
                fh.flush()
                os.fsync(fh.fileno())
        return entry

    def entries(self) -> list:
        """Every parseable event, oldest first.  A torn FINAL line
        (crash mid-append) is skipped with a warning; a torn line
        anywhere else is corruption worth the same warning but never a
        crash — the ledger is an audit/recovery aid, and refusing to
        start the controller over one bad line would turn bookkeeping
        into an outage."""
        try:
            with open(self.path) as fh:
                lines = fh.read().splitlines()
        except FileNotFoundError:
            return []
        out = []
        for i, line in enumerate(lines, start=1):
            if not line.strip():
                continue
            try:
                entry = json.loads(line)
                if not isinstance(entry, dict):
                    raise ValueError("not an object")
            except ValueError:
                log.warning("%s:%d: skipping unparseable ledger line",
                            self.path, i)
                continue
            out.append(entry)
        return out

    def replay(self) -> LedgerReplay:
        """Fold the event stream into restart state.  The failure
        streak counts failed ``outcome`` events plus
        ``attempt_crashed`` events since the last ``promoted``
        (an ``aborted`` outcome — controller stopped mid-watch — is
        neither and leaves the streak alone); ``attempted`` collects
        every candidate name ever offered so the source can skip
        re-offering them."""
        rep = LedgerReplay(attempted=set())
        for entry in self.entries():
            kind = entry.get("event")
            if kind == "candidate":
                name = entry.get("candidate")
                if name:
                    rep.attempted.add(str(name))
                rep.attempts = max(rep.attempts,
                                   int(entry.get("attempt", 0) or 0))
            elif kind == "attempt_crashed":
                rep.consecutive_failures += 1
            elif kind == "outcome":
                rep.last_candidate = entry.get("candidate")
                rep.last_outcome = entry.get("outcome")
                if entry.get("outcome") == "promoted":
                    rep.promotions += 1
                    rep.consecutive_failures = 0
                    rep.last_promoted_path = entry.get("deployed")
                    gen = entry.get("generation")
                    rep.last_generation = (int(gen) if gen is not None
                                           else rep.last_generation)
                elif entry.get("outcome") != "aborted":
                    rep.consecutive_failures += 1
        return rep
