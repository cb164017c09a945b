"""Checkpoints of the fused trainer's live device state (port of
``znicz_tpu/parallel/checkpoint.py``, which uses Orbax; this one writes
its own format).

``<directory>/<step>/`` holds ``state.npz`` (uncompressed: the params and
velocities of each spec row, keyed ``params/<row>/w``, ``params/<row>/b``,
``vels/<row>/w``, ``vels/<row>/b``, a ``None`` tensor as an absent key),
``meta.json`` (the step and the spec's fingerprint) and, once the bytes
are down, the durability manifest ``manifest.znicz.json``: a step with a
manifest is *blessed*.  A step is written into a hidden temporary
directory and renamed into place, so a crash leaves no half step under its
number.

``save(block=False)`` copies the device state into pinned host buffers on
a side stream and records an event; one writer thread waits for the event
and writes, commits the manifest, calls ``on_blessed`` and drops the
steps beyond ``max_to_keep``, while training goes on.  The next step is
ordered after the copy on the device, so it may update the parameters in
place at once.  :meth:`restore` copies into the trainer's own tensors in
place: the CUDA graphs of ``parallel/capture.py`` captured their
addresses, and a replay after a restore that rebound them would go on
training the old tensors.

Multi-process saving (sharded state, process 0 owning the manifests) is
ROADMAP.md queue 1 item 9."""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import logging
import os
import shutil

import numpy as np
import torch

from .. import durability
from ..resilience import faults

_log = logging.getLogger("TrainerCheckpointer")

STATE_FILE = "state.npz"
META_FILE = "meta.json"


def _spec_fingerprint(spec) -> str:
    return json.dumps(dataclasses.asdict(spec), sort_keys=True, default=str)


def _entries(trainer):
    """(key, tensor or None) for every slot of the trainer's state."""
    for group in ("params", "vels"):
        for row, pair in enumerate(getattr(trainer, group)):
            for part, t in zip("wb", pair):
                yield f"{group}/{row}/{part}", t


def _check_accumulators_zero(trainer) -> None:
    """Gradient sums (``accum_steps`` > 1) are zero between groups; a
    checkpoint holds none, so it may only be taken where they are zero."""
    acc = [a for pair in (trainer._acc or ()) if pair for a in pair
           if a is not None]
    if acc and any(bool(a.any()) for a in acc):
        raise RuntimeError(
            "the trainer holds a partial gradient accumulation; checkpoint "
            "it between accumulation groups (at an epoch boundary)")


class TrainerCheckpointer:
    """Save/restore a FusedTrainer's (params, vels).

    ``directory`` holds numbered steps (``<directory>/<step>/``); the
    newest ``max_to_keep`` stay (None: all).  ``on_blessed(step,
    step_dir)`` fires right after a step's manifest commits, on the writer
    thread; its exceptions are logged, never raised."""

    def __init__(self, directory: str, max_to_keep: int | None = 3,
                 on_blessed=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.on_blessed = on_blessed
        os.makedirs(self.directory, exist_ok=True)
        self._writer = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="checkpoint-writer")
        self._inflight: list[concurrent.futures.Future] = []

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def _steps(self) -> list[int]:
        """Committed step numbers, ascending (quarantined and temporary
        directories have other names)."""
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    # -- write ---------------------------------------------------------------
    def save(self, trainer, step: int, block: bool = True) -> None:
        """Checkpoint the trainer's state at ``step``.  The state is copied
        off the device before this returns (with ``block=False`` the copy
        is only ordered: the next step on the trainer's stream waits for
        it on the device); ``block=False`` leaves the file writes to the
        writer thread, whose failures raise at the next :meth:`wait`."""
        faults.inject("checkpoint.save")
        self._reap()
        _check_accumulators_zero(trainer)
        state = self._copy_off(trainer)
        meta = {"step": int(step), "spec": _spec_fingerprint(trainer.spec)}
        self._inflight.append(self._writer.submit(self._write, int(step),
                                                  state, meta))
        if block:
            self.wait()

    def _copy_off(self, trainer) -> tuple[dict, object]:
        """(host arrays by key, the event the writer waits for).  On the
        card the copies run on a side stream into pinned buffers, after
        everything queued so far on the current stream; the current stream
        then waits for the copies before its next kernel.  The step must
        wait for the copy and not for the write: once the bytes are in
        host memory the device tensors may change, and the disk write
        (seconds for AlexNet) reads the host buffers only."""
        entries = [(k, t) for k, t in _entries(trainer) if t is not None]
        if not entries or entries[0][1].device.type != "cuda":
            return {k: t.detach().to("cpu", copy=True)
                    for k, t in entries}, None
        current = torch.cuda.current_stream(entries[0][1].device)
        side = torch.cuda.Stream(entries[0][1].device)
        side.wait_stream(current)
        host = {}
        with torch.cuda.stream(side):
            for k, t in entries:
                host[k] = torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True)
                host[k].copy_(t, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(side)
        current.wait_event(copied)
        return host, copied

    def _write(self, step: int, state: tuple[dict, object],
               meta: dict) -> None:
        """The writer thread: wait for the copy, write the step into a
        temporary directory, rename it into place, commit its manifest,
        tell ``on_blessed``, drop the oldest steps."""
        host, copied = state
        if copied is not None:
            copied.synchronize()
        final = self._step_dir(step)
        tmp = os.path.join(self.directory, f".{step}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, STATE_FILE), "wb") as fh:
            np.savez(fh, **{k: t.numpy() for k, t in host.items()})
        with open(os.path.join(tmp, META_FILE), "w") as fh:
            json.dump(meta, fh)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        durability.write_manifest(final, kind="checkpoint")
        if self.on_blessed is not None:
            try:
                self.on_blessed(step, final)
            except Exception:
                _log.exception("on_blessed callback failed for step %d",
                               step)
        if self.max_to_keep is not None:
            for old in self._steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def _reap(self) -> None:
        """Drop finished writes, raising the first one's error."""
        done = [f for f in self._inflight if f.done()]
        self._inflight = [f for f in self._inflight if not f.done()]
        for f in done:
            f.result()

    def wait(self) -> None:
        """Wait for every write in flight (their manifests committed);
        raises the first write's error."""
        inflight, self._inflight = self._inflight, []
        for f in inflight:
            f.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._writer.shutdown(wait=True)

    # -- read ----------------------------------------------------------------
    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def latest_verified_step(self) -> int | None:
        """Newest step whose directory passes :func:`durability.verify`;
        corrupt steps are quarantined (renamed ``<step>.corrupt``) and the
        scan falls back to the next newest."""
        found = durability.newest_verified(
            self._step_dir(s) for s in reversed(self._steps()))
        return int(os.path.basename(found)) if found is not None else None

    def restore(self, trainer, step: int | None = None) -> int:
        """Restore into ``trainer``'s own tensors (``copy_``, addresses
        kept); returns the step.  ``step=None`` takes the newest verified
        step; an explicit step is verified first and raises
        :class:`durability.ArtifactCorrupt` when it fails.  The spec's
        fingerprint and every shape are checked before any tensor
        changes."""
        faults.inject("checkpoint.load")
        self.wait()
        if step is None:
            step = self.latest_verified_step()
            if step is None:
                raise FileNotFoundError(
                    f"no verifiable checkpoints under {self.directory}")
        else:
            durability.verify_or_heal(self._step_dir(step))
        d = self._step_dir(step)
        with open(os.path.join(d, META_FILE)) as fh:
            meta = json.load(fh)
        if meta.get("spec") != _spec_fingerprint(trainer.spec):
            raise ValueError(
                "checkpoint spec mismatch: the saved model differs from "
                "the trainer restoring it (layer kinds/dtypes/hypers)")
        with np.load(os.path.join(d, STATE_FILE), allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
        targets = list(_entries(trainer))
        want = {k for k, t in targets if t is not None}
        if set(arrays) != want:
            raise ValueError(f"checkpoint step {step} holds "
                             f"{sorted(set(arrays) ^ want)} other than the "
                             "trainer's state")
        for k, t in targets:
            if t is not None and tuple(arrays[k].shape) != tuple(t.shape):
                raise ValueError(f"checkpoint {k}: shape "
                                 f"{arrays[k].shape} != {tuple(t.shape)}")
        with torch.no_grad():
            for k, t in targets:
                if t is not None:
                    t.copy_(torch.from_numpy(arrays[k]))
            for pair in trainer._acc or ():
                for a in pair or ():
                    if a is not None:
                        a.zero_()
        return int(step)


def save_trainer(trainer, directory: str, step: int = 0,
                 block: bool = True) -> None:
    """One-shot save (a checkpointer of its own, closed after)."""
    ck = TrainerCheckpointer(directory, max_to_keep=None)
    try:
        ck.save(trainer, step, block=block)
    finally:
        ck.close()          # waits for the write


def restore_trainer(trainer, directory: str, step: int | None = None
                    ) -> int:
    """One-shot restore; returns the restored step."""
    ck = TrainerCheckpointer(directory)
    try:
        return ck.restore(trainer, step)
    finally:
        ck.close()
