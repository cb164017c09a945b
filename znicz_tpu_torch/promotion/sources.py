"""Candidate sources: where freshly-trained models come from.

The controller is source-agnostic; a source answers two questions —
"is there a new candidate?" (:meth:`poll`) and "write its raw ``.znn``
bytes here" (:meth:`materialize`, the *export* step of the promotion
arc; the controller owns the atomic commit + manifest around it).

* :class:`DirectorySource` watches a directory a trainer exports
  ``.znn`` files into (``export_workflow`` commits atomically with a
  manifest, so a half-written candidate is never visible under its
  final name).
* :class:`CheckpointSource` watches a
  :class:`~znicz_tpu_torch.parallel.checkpoint.TrainerCheckpointer`
  directory for new blessed steps — integer-named step dirs whose
  durability manifest has landed — and turns one into a servable
  ``.znn`` through a caller-supplied ``exporter`` (only the trainer
  knows its model spec; see docs/promotion.md for the canonical
  restore→``export_workflow`` exporter).  The checkpointer's
  ``on_blessed`` callback is the push-channel twin of this poll.

Sources are single-consumer by design (the controller's one loop) and
keep no locks; a restarted controller re-arms them from the ledger via
:meth:`resume`.
"""

from __future__ import annotations

import dataclasses
import os
import shutil

from .. import durability


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One promotable artifact: a stable ``name`` (the ledger/dedup
    key), its ``path`` (a ``.znn`` file or a checkpoint step dir), and
    the source-local ordering ``key``."""

    name: str
    path: str
    key: tuple


class DirectorySource:
    """Newest-unseen ``.znn`` in a directory wins; older unseen
    candidates are marked seen and skipped — after controller downtime
    a backlog of stale exports must not be promoted one by one when a
    newer one already supersedes them (each skip is reported so the
    ledger can record it)."""

    def __init__(self, directory: str, suffix: str = ".znn"):
        self.directory = os.fspath(directory)
        self.suffix = suffix
        self._seen: set = set()

    def resume(self, attempted) -> None:
        """Never re-offer candidates the ledger already records."""
        self._seen.update(str(n) for n in attempted)

    def poll(self):
        """(candidate, skipped_names) — or ``(None, [])`` when nothing
        new; both the pick and the skipped backlog are marked seen."""
        found = []
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return None, []
        for name in names:
            if not name.endswith(self.suffix) or name in self._seen:
                continue
            path = os.path.join(self.directory, name)
            try:
                st = os.stat(path)
            except OSError:
                continue              # vanished mid-scan
            found.append(Candidate(name=name, path=path,
                                   key=(st.st_mtime_ns, name)))
        if not found:
            return None, []
        found.sort(key=lambda c: c.key)
        pick = found[-1]
        skipped = [c.name for c in found[:-1]]
        self._seen.update(c.name for c in found)
        return pick, skipped

    def materialize(self, candidate: Candidate, tmp_path: str) -> None:
        shutil.copyfile(candidate.path, tmp_path)


class CheckpointSource:
    """Watch a ``TrainerCheckpointer`` directory for new *blessed*
    steps: integer-named step dirs that pass durability verification
    (their per-blob manifest is written only after the async save
    finishes, so a verifiable manifest IS the bless mark).  Corrupt or
    still-writing steps are skipped read-only — quarantine/heal stay
    the training process's job, the same ownership rule the
    checkpointer itself follows."""

    def __init__(self, directory: str, exporter, last_step: int = -1):
        self.directory = os.fspath(directory)
        self.exporter = exporter
        self.last_step = int(last_step)

    def resume(self, attempted) -> None:
        for name in attempted:
            name = str(name)
            if name.startswith("step-"):
                try:
                    self.last_step = max(self.last_step,
                                         int(name[len("step-"):]))
                except ValueError:
                    pass

    def poll(self):
        steps = []
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return None, []
        for name in names:
            if not name.isdigit() or int(name) <= self.last_step:
                continue
            steps.append(int(name))
        skipped = []
        for step in sorted(steps, reverse=True):
            path = os.path.join(self.directory, str(step))
            try:
                if durability.read_manifest(path) is None:
                    # no manifest = not blessed yet (the async save's
                    # IO may still be in flight; a bare `verify` would
                    # wave the directory through as legacy) — not
                    # consumed either, so a save that finishes
                    # blessing later is picked up on a later poll
                    continue
                durability.verify(path)
            except durability.ArtifactCorrupt:
                continue              # rotten: skip read-only
            self.last_step = step
            skipped = [f"step-{s}" for s in steps if s < step]
            return Candidate(name=f"step-{step}", path=path,
                             key=(step,)), skipped
        return None, []

    def materialize(self, candidate: Candidate, tmp_path: str) -> None:
        self.exporter(candidate.path, tmp_path)
