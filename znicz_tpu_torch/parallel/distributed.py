"""Multi-process bootstrap, data distribution and failure recovery (port of
``znicz_tpu/parallel/distributed.py``).

Every process runs the same program.  ``torch.distributed`` takes the place
of the reference's ``jax.distributed`` coordination service; the
collectives of a step are the port's own (``parallel/mesh.py``,
``parallel/fused.py``).

* :func:`initialize` — process bootstrap (the master/slave handshake).
* :func:`global_mesh` — the (data, model) layout over every rank.
* :func:`process_shard` / :func:`shard_dataset` / :func:`distribute` —
  each process's contiguous rows of a dataset, published through the
  :class:`~znicz_tpu_torch.distributable.Distributable` hooks.  There is
  no global array to assemble: a trainer that needs the whole dataset on
  every rank gathers the shards once (``FusedTrainer``, as the reference's
  ``_mesh_place`` replicates it).
* :class:`CheckpointRecovery` — snapshot and resume after a crash: process
  0 saves, every process restores, and quarantine and heal writes are
  process 0's."""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from . import mesh as mesh_lib


def env_rendezvous() -> bool:
    """Whether torch's MASTER_ADDR/MASTER_PORT/RANK/WORLD_SIZE are set."""
    return all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT",
                                         "RANK", "WORLD_SIZE"))


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               retry: "RetryPolicy | None" = None, device=None,
               timeout_s: float = 300.0) -> None:
    """Bring up the process group (idempotent).  The rendezvous is the
    coordinator's ``host:port`` (``tcp://`` init, process ``process_id``
    of ``num_processes``), or torch's ``MASTER_ADDR``/``MASTER_PORT``/
    ``RANK``/``WORLD_SIZE`` as ``torchrun`` sets them.  With neither it is
    a no-op (a single process), and a process count or id other than the
    single process's raises.

    The backend follows from the layout (:func:`mesh.choose_backend` on
    ``device``, default CUDA, raising without a card); on CUDA the rank's
    card (``cuda:rank % device_count``) becomes the current device first.
    The handshake is the ``relay.connect`` fault site and retries under
    ``retry`` (default: 3 attempts, 0.5–5 s backoff): a coordinator often
    comes up seconds after its workers."""
    from ..resilience import faults
    from ..resilience.retry import RetryPolicy
    if dist.is_initialized():
        return
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id")
        init_method = f"tcp://{coordinator}"
        world, rank = int(num_processes), int(process_id)
    elif env_rendezvous():
        init_method = "env://"
        world = int(num_processes if num_processes is not None
                    else os.environ["WORLD_SIZE"])
        rank = int(process_id if process_id is not None
                   else os.environ["RANK"])
    else:
        if (num_processes or 1) != 1 or (process_id or 0) != 0:
            raise ValueError(
                f"num_processes={num_processes}, process_id={process_id} "
                f"without a rendezvous; {mesh_lib.START_HINT}")
        return            # single process: nothing to negotiate
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} outside 0..{world - 1}")
    if device is None:
        from ..backends import resolve
        device = resolve(None)
    backend = mesh_lib.choose_backend(device, world)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(mesh_lib.rank_device(device, rank))
    policy = retry if retry is not None else RetryPolicy(
        max_attempts=3, base_delay_s=0.5, max_delay_s=5.0)

    def _connect():
        faults.inject("relay.connect")
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))

    policy.call(_connect)


def shutdown() -> None:
    """Tear the process group down (a no-op without one), with the mesh
    sub-groups made over it."""
    if dist.is_initialized():
        dist.destroy_process_group()
    mesh_lib._GROUPS.clear()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_mesh(n_model: int = 1, device=None) -> mesh_lib.Mesh | None:
    """The (data, model) mesh over every rank: world // n_model data
    indices (None for a single process)."""
    world = process_count()
    if world % n_model:
        raise ValueError(f"{world} ranks do not split into model rows of "
                         f"{n_model}")
    return mesh_lib.resolve_mesh((world // n_model, n_model),
                                 device=device)


def process_shard(n: int) -> slice:
    """This process's contiguous row range of an n-sample dataset."""
    p, np_ = process_index(), process_count()
    per = -(-n // np_)
    return slice(min(p * per, n), min((p + 1) * per, n))


@dataclasses.dataclass(eq=False)
class RowShard:
    """This process's rows ``start .. start + len(rows)`` of a dataset of
    ``total`` rows, on the mesh's device."""

    rows: torch.Tensor
    start: int
    total: int

    @property
    def shape(self) -> tuple:
        return (self.total,) + tuple(self.rows.shape[1:])


def shard_dataset(local_rows, mesh, total_rows: int) -> RowShard:
    """This process's rows (``process_shard`` of the global set) and the
    global row count, on ``mesh``'s device."""
    rows = torch.as_tensor(np.ascontiguousarray(local_rows)
                           if isinstance(local_rows, np.ndarray)
                           else local_rows)
    device = mesh.device if mesh is not None else rows.device
    return RowShard(rows.to(device), process_shard(int(total_rows)).start,
                    int(total_rows))


def gather_rows(shard: RowShard, mesh) -> torch.Tensor:
    """The whole dataset on every rank from each process's
    :class:`RowShard`: each writes its rows into a zero tensor of the
    global shape and the sum over every rank is taken (exact: each row
    has one writer)."""
    full = torch.zeros(shard.shape, dtype=shard.rows.dtype,
                       device=shard.rows.device)
    full[shard.start:shard.start + shard.rows.shape[0]] = shard.rows
    if mesh is not None and mesh.world > 1:
        mesh.all_reduce(full, dist.group.WORLD, "data")
    return full


def distribute(workflow, mesh) -> dict:
    """Distribute an initialized workflow's per-shard state through the
    Distributable protocol: each unit's ``generate_data_for_slave()``
    (``{name: (local_rows, total_rows)}``, None for replicated state)
    becomes :class:`RowShard`\\ s that ``apply_data_from_master``
    installs.  The gradient fold stays inside the step (an all-reduce over
    the mesh's data axis).  Returns ``{unit_name: [names sharded]}``."""
    out = {}
    for unit in workflow.units:
        payload = unit.generate_data_for_slave()
        if not payload:
            continue
        installed = {name: shard_dataset(local, mesh, int(total))
                     for name, (local, total) in sorted(payload.items())}
        unit.apply_data_from_master(installed)
        out[unit.name] = sorted(installed)
    return out


class CheckpointRecovery:
    """Snapshot every ``interval`` epochs and resume after a crash (the
    reference's requeue of a lost slave's job becomes a restart of every
    process from the last snapshot).

    Save and resume retry under ``retry`` (default 3 attempts, short
    backoff): the save is one atomic rename, so a retry after a failed
    attempt never finds a torn snapshot."""

    def __init__(self, workflow, directory="snapshots",
                 prefix="recovery", interval=1,
                 retry: "RetryPolicy | None" = None):
        from ..resilience.retry import RetryPolicy
        from ..snapshotter import SnapshotterToFile
        self.workflow = workflow
        self.snap = SnapshotterToFile(workflow, prefix=prefix,
                                      directory=directory,
                                      interval=interval)
        self.retry = retry if retry is not None else RetryPolicy(
            max_attempts=3, base_delay_s=0.2, max_delay_s=2.0)
        # standalone use: not linked into the control graph
        if self.snap in workflow.units:
            workflow.units.remove(self.snap)

    @property
    def path(self) -> str:
        return os.path.join(self.snap.directory,
                            f"{self.snap.prefix}_current.npz")

    def save(self) -> str:
        """Checkpoint now (between epochs; process 0 writes)."""
        if process_index() != 0:
            return self.path
        return self.retry.call(self.snap.save, "current")

    def resume_if_found(self) -> dict | None:
        """Restore the newest verified snapshot into the (initialized)
        workflow; returns its meta, or None when starting fresh.  Corrupt
        entries are quarantined by process 0 (the other processes scan
        read-only and skip them) and the scan falls back to the next
        newest."""
        from ..snapshotter import SnapshotterToFile

        def _restore():
            found = SnapshotterToFile.restore(
                self.workflow, directory=self.snap.directory,
                prefix=self.snap.prefix, owner=process_index() == 0)
            return found[0] if found is not None else None

        return self.retry.call(_restore)
