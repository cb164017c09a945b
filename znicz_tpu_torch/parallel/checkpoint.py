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

Under a mesh (``TrainerCheckpointer(mesh=...)``) the ranks save together
and synchronously: the ranks of data index 0 each write the shares they
own into ``state.m<k>.npz`` (k their model index; the whole tensors go to
rank 0's file, a share with its ``index/<key>`` positions along the split
dim), process 0 writes ``meta.json`` with the layout, and after a barrier
renames the step into place and commits its manifest; it alone
quarantines.  A step restores at any layout, as the reference's Orbax
checkpoints do: the shares are put together whole and each restoring rank
takes its own, bit for bit."""

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


def _shard_file(m: int) -> str:
    return f"state.m{m}.npz"


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
                 on_blessed=None, mesh=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.on_blessed = on_blessed
        #: the ranks saving together (None: this process alone)
        self.mesh = mesh
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
        if self.mesh is not None:
            self._save_ranks(trainer, int(step))
            return
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

    def _save_ranks(self, trainer, step: int) -> None:
        """The mesh's save, on every rank, synchronous (its barriers are
        collectives of the calling thread)."""
        mesh = self.mesh
        final = self._step_dir(step)
        tmp = os.path.join(self.directory, f".{step}.tmp")
        if mesh.rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        mesh.barrier()
        shard = getattr(trainer, "shard", None)
        split, shapes = {}, {}
        whole = getattr(trainer, "_whole", None)
        if mesh.data_index == 0:
            arrays = {}
            for key, t in _entries(trainer):
                if t is None:
                    continue
                group, row, part = key.split("/")
                sel = (shard.select[int(row)] if shard is not None
                       and part == "w" else None)
                if sel is not None:
                    arrays[key] = t.detach().cpu().numpy()
                    arrays["index/" + key] = sel[1].numpy()
                elif mesh.model_index == 0:
                    arrays[key] = t.detach().cpu().numpy()
            with open(os.path.join(tmp, _shard_file(mesh.model_index)),
                      "wb") as fh:
                np.savez(fh, **arrays)
        for key, t in _entries(trainer):
            if t is None:
                continue
            group, row, part = key.split("/")
            row = int(row)
            if shard is not None and part == "w" \
                    and shard.select[row] is not None:
                split[key] = int(shard.select[row][0])
            shapes[key] = list(whole[row][0 if part == "w" else 1]
                               if whole is not None else t.shape)
        mesh.barrier()
        if mesh.rank == 0:
            meta = {"step": step, "spec": _spec_fingerprint(trainer.spec),
                    "layout": {"dp": mesh.dp, "tp": mesh.tp,
                               "files": [_shard_file(m)
                                         for m in range(mesh.tp)],
                               "split": split, "shapes": shapes}}
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
                    _log.exception("on_blessed callback failed for step "
                                   "%d", step)
            if self.max_to_keep is not None:
                for old in self._steps()[:-self.max_to_keep]:
                    shutil.rmtree(self._step_dir(old), ignore_errors=True)
        mesh.barrier()

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
        scan falls back to the next newest.  Under a mesh process 0 scans
        (and quarantines) first; the other ranks then scan read-only."""
        owner = self.mesh is None or self.mesh.rank == 0
        if self.mesh is not None and not owner:
            self.mesh.barrier()
        found = durability.newest_verified(
            (self._step_dir(s) for s in reversed(self._steps())),
            on_corrupt="quarantine" if owner else "skip", heal=owner)
        if self.mesh is not None and owner:
            self.mesh.barrier()
        return int(os.path.basename(found)) if found is not None else None

    def restore(self, trainer, step: int | None = None) -> int:
        """Restore into ``trainer``'s own tensors (``copy_``, addresses
        kept); returns the step.  ``step=None`` takes the newest verified
        step; an explicit step is verified first and raises
        :class:`durability.ArtifactCorrupt` when it fails.  The spec's
        fingerprint and every shape are checked before any tensor
        changes.  A step saved at any layout restores at the trainer's
        (its shares put together whole, the trainer's own taken)."""
        faults.inject("checkpoint.load")
        self.wait()
        if step is None:
            step = self.latest_verified_step()
            if step is None:
                raise FileNotFoundError(
                    f"no verifiable checkpoints under {self.directory}")
        else:
            durability.verify_or_heal(
                self._step_dir(step),
                heal=self.mesh is None or self.mesh.rank == 0)
        d = self._step_dir(step)
        with open(os.path.join(d, META_FILE)) as fh:
            meta = json.load(fh)
        if meta.get("spec") != _spec_fingerprint(trainer.spec):
            raise ValueError(
                "checkpoint spec mismatch: the saved model differs from "
                "the trainer restoring it (layer kinds/dtypes/hypers)")
        arrays = _take(trainer, _whole_arrays(d, meta))
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


def _whole_arrays(step_dir: str, meta: dict) -> dict:
    """The saved state by key, each tensor whole: one ``state.npz``, or a
    mesh's shares put together along their split dims."""
    layout = meta.get("layout")
    if layout is None:
        with np.load(os.path.join(step_dir, STATE_FILE),
                     allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    out = {}
    for name in layout["files"]:
        with np.load(os.path.join(step_dir, name), allow_pickle=False) as z:
            for k in z.files:
                if k.startswith("index/"):
                    continue
                dim = layout["split"].get(k)
                if dim is None:
                    out[k] = z[k]
                    continue
                if k not in out:
                    out[k] = np.zeros(layout["shapes"][k], z[k].dtype)
                idx = [slice(None)] * out[k].ndim
                idx[dim] = z["index/" + k]
                out[k][tuple(idx)] = z[k]
    return out


def _take(trainer, arrays: dict) -> dict:
    """``arrays`` (whole) cut to the trainer's shares under its mesh."""
    shard = getattr(trainer, "shard", None)
    if shard is None:
        return arrays
    out = dict(arrays)
    for k, a in arrays.items():
        group, row, part = k.split("/")
        if part == "w" and shard.select[int(row)] is not None:
            dim, index = shard.select[int(row)]
            out[k] = np.ascontiguousarray(np.take(a, index.numpy(),
                                                  axis=dim))
    return out


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
