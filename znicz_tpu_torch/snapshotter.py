"""Checkpoint/resume: snapshots of workflow state (port of
``znicz_tpu/snapshotter.py``, in the reference's file format).

A snapshot is data, not pickled objects: an ``.npz`` of every parameter
and optimizer array addressed ``"<unit.name>/<vector>"`` plus the host
counters (epoch, best error, decision state, PRNG stream positions) as
JSON inside the same ``.npz`` (``__meta_json__``), with a ``.json``
sidecar for people to read.  ``compression`` wraps a raw ``.npz`` in gz,
bz2 or xz.  The port's unit names are the reference's (``fwd{i}_{type}``,
``gd{i}_{type}``), so a snapshot written by either package loads into the
other, and each package's ``durability.verify`` accepts the other's.

On the card :func:`collect_state` reads each Vector back through its map
(``Vector.mem`` copies the current tensor to the host, waiting for the
stream that wrote it), so a snapshot never holds a stale host copy.

Where the unit graph saves: the port links the snapshotter after the
decision AND after the GD chain's last unit, so an epoch's snapshot
holds the update of its last train minibatch and resumes at the next
epoch (``Loader.resume_epoch``), which makes a resumed unit graph equal
the continuous one.  The reference's unit graph saves before that tick's
GD chain, at the finished epoch's number; its snapshots load here all the
same.  On the fused path ``run_fused`` saves between epochs (with the
deferred tail update, unless the epoch is the last)."""

from __future__ import annotations

import bz2
import glob
import gzip
import io
import json
import lzma
import os
import time

import numpy as np

from . import durability, prng
from .resilience import faults
from .units import Unit

#: external compressors (reference parity: gz/bz2/xz snapshot files);
#: the default .npz is already zip-deflated, so these wrap a RAW .npz
_OPENERS = {"gz": gzip.open, "bz2": bz2.open, "xz": lzma.open}

#: Vector attributes captured per unit, in precedence order.
_STATE_VECTORS = ("weights", "bias", "velocity_weights", "velocity_bias",
                  "gradient_weights", "gradient_bias")


def collect_state(workflow) -> tuple[dict[str, np.ndarray], dict]:
    """(arrays keyed unit/vector, host-side counters)."""
    arrays: dict[str, np.ndarray] = {}
    seen_vectors: set[int] = set()
    for unit in workflow.units:
        for attr in _STATE_VECTORS:
            vec = unit.__dict__.get(attr)   # skip link_attrs aliases
            if vec is None or not vec or id(vec) in seen_vectors:
                continue
            seen_vectors.add(id(vec))
            arrays[f"{unit.name}/{attr}"] = np.asarray(vec.mem)
    # stream positions make resume bit-reproducible (the loader's shuffle
    # stream continues instead of restarting from the seed)
    meta = {"time": time.time(), "prng_state": prng.state()}
    loader = getattr(workflow, "loader", None)
    if loader is not None:
        meta["epoch_number"] = loader.resume_epoch()
    decision = getattr(workflow, "decision", None)
    if decision is not None:
        meta["best_n_err"] = float(getattr(decision, "best_n_err", np.inf))
        meta["best_mse"] = float(getattr(decision, "best_mse", np.inf))
        meta["epoch_metrics"] = decision.epoch_metrics
        # early-stop state: a resume that reset the fail counter would
        # train past where the continuous run stopped
        meta["decision_fails"] = int(decision._fails)
    adj = getattr(workflow, "lr_adjuster", None)
    if adj is not None:
        # by_epoch=False schedules key on this counter
        meta["lr_adjust_minibatches"] = int(adj._minibatches)
    snap = getattr(workflow, "snapshotter", None)
    if snap is not None:
        # keeps the periodic cadence aligned with the continuous run
        meta["snapshotter_epochs_seen"] = snap._epochs_seen
    return arrays, meta


def restore_state(workflow, arrays: dict, meta: dict) -> None:
    """Load ``arrays`` into the units' Vectors (uploaded on a torch
    device) and ``meta`` into the loader, decision, adjuster, snapshotter
    and PRNG streams."""
    for unit in workflow.units:
        for attr in _STATE_VECTORS:
            key = f"{unit.name}/{attr}"
            vec = unit.__dict__.get(attr)
            if key in arrays and vec is not None:
                vec.mem = arrays[key]
                device = getattr(unit, "device", None)
                if device is not None and device.is_torch:
                    vec.unmap()
    if "prng_state" in meta:
        prng.set_state(meta["prng_state"])
    loader = getattr(workflow, "loader", None)
    if loader is not None and "epoch_number" in meta:
        loader.epoch_number = int(meta["epoch_number"])
        loader.reset_state()
    decision = getattr(workflow, "decision", None)
    if decision is not None:
        if "best_n_err" in meta and hasattr(decision, "best_n_err"):
            decision.best_n_err = meta["best_n_err"]
        if "best_mse" in meta and hasattr(decision, "best_mse"):
            decision.best_mse = meta["best_mse"]
        if "epoch_metrics" in meta:
            decision.epoch_metrics = list(meta["epoch_metrics"])
        if "decision_fails" in meta:
            decision._fails = int(meta["decision_fails"])
    adj = getattr(workflow, "lr_adjuster", None)
    if adj is not None and "lr_adjust_minibatches" in meta:
        adj._minibatches = int(meta["lr_adjust_minibatches"])
    snap = getattr(workflow, "snapshotter", None)
    if snap is not None and "snapshotter_epochs_seen" in meta:
        snap._epochs_seen = int(meta["snapshotter_epochs_seen"])


class SnapshotterBase(Unit):
    def __init__(self, workflow=None, name=None, prefix="snapshot",
                 directory="snapshots", interval=1, keep_best=True,
                 compression: str | None = None, **kwargs):
        super().__init__(workflow, name or "snapshotter", **kwargs)
        self.prefix = prefix
        self.directory = directory
        self.interval = interval
        self.keep_best = keep_best
        if compression not in (None, "none", *_OPENERS):
            raise ValueError(f"compression {compression!r}; pick one of "
                             f"{sorted(_OPENERS)} or None")
        self.compression = None if compression == "none" else compression
        self._epochs_seen = 0
        self.last_path: str | None = None
        self.best_path: str | None = None

    def epoch_end(self, improved: bool, before_save=None,
                  write: bool = True) -> None:
        """One epoch's snapshot cadence, shared by the unit graph's tick
        (:meth:`SnapshotterToFile.run`) and the fused epoch loop: save
        "current" every ``interval`` epochs and on improvement, plus
        "best" on improvement.  ``before_save`` runs only when a save will
        happen (the fused path syncs its weights there); ``write=False``
        runs it without saving (a mesh rank other than process 0)."""
        self._epochs_seen += 1
        if self._epochs_seen % self.interval == 0 or improved:
            if before_save is not None:
                before_save()
            if not write:
                return
            self.last_path = self.save("current")
            if improved and self.keep_best:
                self.best_path = self.save("best")


class SnapshotterToFile(SnapshotterBase):
    """Writes ``<dir>/<prefix>_current.npz`` every ``interval`` epochs and
    ``<prefix>_best.npz`` whenever the decision reports improvement."""

    def run(self) -> None:
        decision = self.workflow.decision
        if not bool(self.workflow.loader.last_minibatch):
            return
        improved = bool(decision.snapshot_suggested)
        if improved:
            decision.snapshot_suggested.set(False)
        self.epoch_end(improved)

    def save(self, tag: str) -> str:
        """Crash-safe save: arrays and counters commit in one
        ``os.replace`` (the meta rides inside the ``.npz``), so an
        unclean death can never pair one save's arrays with another's
        counters; the ``.json`` sidecar is for people and never read.

        The commit order is pinned (the reference's): invalidate the
        manifest, ``os.replace`` the blob, the ``checkpoint.write_torn``
        fault site, write the sha256 manifest, ``chaos_bitflip``, then the
        sidecar.  A crash anywhere in that window leaves a manifest-less
        blob (old or new, each self-consistent) that verify-on-load
        deep-parses, loads and re-blesses; never a live manifest over
        bytes it does not describe, so a digest mismatch always means rot.
        ``checkpoint.save`` fires before any filesystem change."""
        faults.inject("checkpoint.save")
        os.makedirs(self.directory, exist_ok=True)
        arrays, meta = collect_state(self.workflow)
        meta_blob = np.frombuffer(
            json.dumps(meta, default=float).encode(), dtype=np.uint8)
        base = os.path.join(self.directory, f"{self.prefix}_{tag}.npz")
        if self.compression:
            path = f"{base}.{self.compression}"
            buf = io.BytesIO()
            np.savez(buf, __meta_json__=meta_blob, **arrays)
            with _OPENERS[self.compression](path + ".tmp", "wb") as fh:
                fh.write(buf.getbuffer())
        else:
            path = base
            with open(path + ".tmp", "wb") as fh:
                np.savez_compressed(fh, __meta_json__=meta_blob, **arrays)
        with open(path + ".json.tmp", "w") as fh:
            json.dump(meta, fh, default=float)
        durability.invalidate_manifest(path)
        os.replace(path + ".tmp", path)
        faults.inject("checkpoint.write_torn")
        durability.write_manifest(path, kind="snapshot")
        durability.chaos_bitflip(path)
        os.replace(path + ".json.tmp", path + ".json")
        self.debug("snapshot → %s", path)
        return path

    @staticmethod
    def load(workflow, path: str, verify: bool = True) -> dict:
        """Restore a snapshot (either package's) into an *initialized*
        workflow; returns its meta.  The codec comes from the extension
        (``.npz[.gz|.bz2|.xz]``).  ``verify`` runs
        :func:`durability.verify_or_heal` first, so a truncated or
        bit-flipped file raises :class:`durability.ArtifactCorrupt`
        instead of a zip error mid-restore; :meth:`restore` passes False
        after its own scan."""
        faults.inject("checkpoint.load")
        if verify:
            durability.verify_or_heal(path)
        ext = path.rsplit(".", 1)[-1]
        if ext in _OPENERS:
            with _OPENERS[ext](path, "rb") as fh:
                buf = io.BytesIO(fh.read())
            arrays = dict(np.load(buf, allow_pickle=False))
        else:
            arrays = dict(np.load(path, allow_pickle=False))
        if "__meta_json__" in arrays:
            meta = json.loads(arrays.pop("__meta_json__").tobytes())
        else:                               # the reference's older files
            with open(path + ".json") as fh:
                meta = json.load(fh)
        restore_state(workflow, arrays, meta)
        return meta

    @classmethod
    def restore(cls, workflow, directory: str = "snapshots",
                prefix: str = "snapshot", owner: bool = True
                ) -> tuple[dict, str] | None:
        """Last-good resume: scan this prefix's snapshots newest first,
        quarantine the corrupt ones (``*.corrupt``) and restore the newest
        that verifies.  Returns ``(meta, path)``, or None when none does.
        ``owner=False`` verifies read-only (no quarantine, no heal)."""
        path = durability.newest_verified(
            snapshot_candidates(directory, prefix),
            on_corrupt="quarantine" if owner else "skip", heal=owner)
        if path is None:
            return None
        return cls.load(workflow, path, verify=False), path


def snapshot_candidates(directory: str, prefix: str = "snapshot"
                        ) -> list[str]:
    """This prefix's snapshot blobs under ``directory``, newest first
    (mtime); sidecars, temporaries and quarantined files left out."""
    out = []
    for path in glob.glob(os.path.join(
            directory, glob.escape(prefix) + "_*.npz*")):
        name = os.path.basename(path)
        if name.endswith((".json", ".tmp")) or ".corrupt" in name:
            continue
        if not (name.endswith(".npz")
                or name.rsplit(".", 1)[-1] in _OPENERS):
            continue
        try:
            out.append((os.path.getmtime(path), path))
        except OSError:          # raced a quarantine or a cleanup
            continue
    return [p for _, p in sorted(out, reverse=True)]
