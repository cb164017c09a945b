"""The (data, model) layout of a multi-process run and its collectives
(port of ``znicz_tpu/parallel/mesh.py``).

The reference lays one program over the devices of a ``jax.sharding.Mesh``
and lets XLA insert the collectives.  Here the mesh is a
``torch.distributed`` process group of dp·tp ranks, one process a rank:
rank r sits at data index r // tp and model index r % tp (the reference's
``devices.reshape(dp, tp)``), and the collectives are written into the
port's own forward and backward (``parallel/fused.py``).

* ``data`` — the batch axis: each data index takes its share of every
  global minibatch, and the gradients are all-reduced over the ranks of
  one model index (:attr:`Mesh.data_group`).
* ``model`` — Megatron tensor parallelism: :func:`plan_tp_sharding`
  alternates the parameterized layers between split-output (the last dim)
  and split-input (dim −2) so activations stay sharded across a pair;
  the partial sums of a split-input layer are all-reduced over the ranks
  of one data index (:attr:`Mesh.model_group`).

The backend follows from the layout, never from a failure: ``nccl`` where
the ranks run on CUDA and each has a card of its own (rank r on
``cuda:r % device_count``), ``gloo`` where ranks share a card or run on
the CPU.  On gloo a CUDA tensor's collective is staged through pinned host
memory by :meth:`Mesh.all_reduce`."""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

from ..telemetry.registry import REGISTRY


def _axis_size():
    """Which (dp, tp) layout the live trainer runs on (1 on both axes = the
    single-device path).  Registered at its first stamp, not at import:
    a serve process imports this package for its CUDA graphs and, as the
    reference's, exposes no mesh family."""
    return REGISTRY.gauge(
        "mesh_axis_size",
        "size of the live mesh axis, by axis (data | model) and site "
        "(train | serve); 1/1 means the degenerate single-device path")


#: this process's all-reduces since :func:`reset_comm`, by what they carry
#: (``grad``: the gradient buckets; ``tp``: the tensor-parallel sums and
#: gathers; ``metrics``; ``data``: a dataset gathered from row shards):
#: calls, bytes and host seconds (on gloo with CUDA tensors from the card's
#: last kernel to the copy back, the card synchronised first)
COMM: dict = {}


def reset_comm() -> None:
    COMM.clear()


#: how to bring up dp·tp ranks, named by every refusal of a mesh
START_HINT = (
    "start dp*tp ranks first: the launcher's --coordinator HOST:PORT "
    "--num-processes N --process-id I on each rank "
    "(parallel.distributed.initialize), torch's MASTER_ADDR/MASTER_PORT/"
    "RANK/WORLD_SIZE as torchrun sets them, or `python -m "
    "znicz_tpu_torch.parallel.elastic -n N -- WORKER ARGS`")


def parse_mesh_arg(arg: str) -> tuple[int, int]:
    """``--mesh dp,tp`` → (dp, tp).  A single number means pure data
    parallelism (``--mesh 8`` == ``--mesh 8,1``)."""
    parts = [p.strip() for p in str(arg).split(",") if p.strip()]
    if not 1 <= len(parts) <= 2:
        raise ValueError(f"--mesh expects 'dp' or 'dp,tp', got {arg!r}")
    try:
        dp = int(parts[0])
        tp = int(parts[1]) if len(parts) == 2 else 1
    except ValueError:
        raise ValueError(f"--mesh expects integers, got {arg!r}") from None
    if dp < 1 or tp < 1:
        raise ValueError(f"--mesh axes must be >= 1, got {arg!r}")
    return dp, tp


def choose_backend(device, world: int) -> str:
    """The backend of ``world`` ranks on ``device``: ``nccl`` when they run
    on CUDA and the host has a card for each, else ``gloo``."""
    device = torch.device(device)
    if device.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device, rank: int) -> torch.device:
    """The device of ``rank``: ``cuda:rank % device_count`` on CUDA (ranks
    share the cards round-robin), else ``device`` itself."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank's view of a (dp, tp) layout over the live process group.

    ``data_group`` holds the ranks of this rank's model index (its data
    column: the gradient all-reduce), ``model_group`` those of its data
    index (its model row: the tensor-parallel all-reduces); either is None
    when its axis has size 1.  ``control`` is a gloo group over every rank
    for barriers (the default group when the backend is gloo)."""

    dp: int
    tp: int
    rank: int
    world: int
    backend: str
    device: torch.device
    data_group: object = None
    model_group: object = None
    control: object = None
    #: pinned host buffers for gloo's staging, by (numel, dtype)
    _pinned: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def data_index(self) -> int:
        return self.rank // self.tp

    @property
    def model_index(self) -> int:
        return self.rank % self.tp

    @property
    def shape(self) -> dict:
        return {"data": self.dp, "model": self.tp}

    def all_reduce(self, t: torch.Tensor, group, what: str = "tp"
                   ) -> torch.Tensor:
        """Sum contiguous ``t`` in place over ``group`` (no-op for None: an
        axis of size 1), counted in :data:`COMM` under ``what``.  On gloo a
        CUDA tensor goes through a pinned host buffer (kept for the next
        call of its size)."""
        if group is None:
            return t
        staged = self.backend == "gloo" and t.device.type == "cuda"
        if staged:
            torch.cuda.synchronize(t.device)
        t0 = time.monotonic()
        if staged:
            key = (t.numel(), t.dtype)
            host = self._pinned.get(key)
            if host is None:
                host = self._pinned[key] = torch.empty(
                    t.numel(), dtype=t.dtype, pin_memory=True)
            host = host.view(t.shape)
            host.copy_(t)
            dist.all_reduce(host, group=group)
            t.copy_(host)
        else:
            dist.all_reduce(t, group=group)
        rec = COMM.setdefault(what, {"calls": 0, "bytes": 0, "seconds": 0.0})
        rec["calls"] += 1
        rec["bytes"] += t.numel() * t.element_size()
        rec["seconds"] += time.monotonic() - t0
        return t

    def barrier(self) -> None:
        dist.barrier(group=self.control)


#: groups made for a (dp, tp, world) layout: ``new_group`` is collective,
#: so every rank makes them once, in the same order
_GROUPS: dict = {}


def _groups(dp: int, tp: int, backend: str):
    key = (dp, tp, dist.get_world_size(), backend)
    found = _GROUPS.get(key)
    if found is not None:
        return found
    rank = dist.get_rank()
    data_group = model_group = None
    for m in range(tp):                    # data columns
        ranks = [d * tp + m for d in range(dp)]
        g = dist.new_group(ranks) if dp > 1 else None
        if rank in ranks:
            data_group = g
    for d in range(dp):                    # model rows
        ranks = [d * tp + m for m in range(tp)]
        g = dist.new_group(ranks) if tp > 1 else None
        if rank in ranks:
            model_group = g
    control = None if backend == "gloo" else dist.new_group(backend="gloo")
    _GROUPS[key] = found = (data_group, model_group, control)
    return found


def _stamp(dp: int, tp: int, site: str) -> None:
    gauge = _axis_size()
    gauge.set(dp, axis="data", site=site)
    gauge.set(tp, axis="model", site=site)


def resolve_mesh(mesh_shape, site: str = "train", device=None
                 ) -> Mesh | None:
    """A ``(dp, tp)`` shape (tuple/list or a ``"dp,tp"`` string) to the
    :class:`Mesh` the trainers run on — THE one mesh-adoption policy:

    * ``None`` / ``(1, 1)`` → ``None``: the single-device path, bit for
      bit what runs without a mesh;
    * anything else needs a live process group of exactly dp·tp ranks on
      the backend the layout calls for (:func:`choose_backend`), and
      raises otherwise — a silently shrunk mesh would train on another
      batch layout than the one asked for.

    ``device`` (default: CUDA, raising without a card) is the ranks'
    device type.  A :class:`Mesh` passes through.  Records
    ``mesh_axis_size{axis, site}``."""
    if isinstance(mesh_shape, Mesh):
        _stamp(mesh_shape.dp, mesh_shape.tp, site)
        return mesh_shape
    if mesh_shape is None:
        # restamp: the gauges answer "what layout is this process
        # RUNNING", and a meshless run must not report an earlier mesh
        _stamp(1, 1, site)
        return None
    if isinstance(mesh_shape, str):
        mesh_shape = parse_mesh_arg(mesh_shape)
    if not 1 <= len(mesh_shape) <= 2:
        raise ValueError(f"mesh_shape expects (dp,) or (dp, tp), got "
                         f"{tuple(mesh_shape)!r}")
    dp, tp = (int(mesh_shape[0]), int(mesh_shape[1])) \
        if len(mesh_shape) == 2 else (int(mesh_shape[0]), 1)
    if dp < 1 or tp < 1:
        raise ValueError(f"mesh axes must be >= 1, got {(dp, tp)}")
    if dp == tp == 1:
        _stamp(1, 1, site)
        return None
    # a refused mesh leaves the gauges alone: after the raise the caller
    # runs something else
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} ranks but no "
                         f"process group is up; {START_HINT}")
    world = dist.get_world_size()
    if world != dp * tp:
        raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} ranks but the "
                         f"process group has {world}; {START_HINT}")
    if device is None:
        from ..backends import resolve
        device = resolve(None)
    backend = str(dist.get_backend())
    want = choose_backend(device, world)
    if backend != want:
        raise ValueError(
            f"the process group runs {backend}, but {world} ranks on "
            f"{torch.device(device).type} with this host's cards take "
            f"{want} (parallel.distributed.initialize picks it)")
    rank = dist.get_rank()
    data_group, model_group, control = _groups(dp, tp, backend)
    _stamp(dp, tp, site)
    return Mesh(dp=dp, tp=tp, rank=rank, world=world, backend=backend,
                device=rank_device(device, rank), data_group=data_group,
                model_group=model_group, control=control)


def mesh_shape_of(mesh: Mesh | None) -> tuple[int, int]:
    """(dp, tp) of a mesh, (1, 1) for the single-device path."""
    if mesh is None:
        return (1, 1)
    return (mesh.dp, mesh.tp)


def _tp_of(mesh_or_tp) -> int:
    return mesh_or_tp if isinstance(mesh_or_tp, int) else mesh_or_tp.tp


def shard_params(mesh_or_tp, layer_index: int, ndim: int) -> int | None:
    """Tensor-parallel weight split: even layers split the output features
    (dim −1), odd layers the input features (dim −2) — Megatron pairing,
    so the activation stays sharded across a pair.  fc (in, out) and conv
    HWIO follow the same rule.  None (replicated) with a model axis of 1
    or a tensor of fewer than two dims."""
    if _tp_of(mesh_or_tp) == 1 or ndim < 2:
        return None
    return -1 if layer_index % 2 == 0 else -2


def plan_tp_sharding(mesh_or_tp, pidx: int, shape) -> tuple:
    """THE Megatron adoption step for one weight tensor: ``(dim,
    next_pidx)``, ``dim`` the split dim (−1 or −2, the reference's
    ``"model"`` entry of the tensor's PartitionSpec) or None for
    replication.  Splits at the current pair parity when tp divides the
    dim; otherwise replicates and breaks the pair, so the next layer
    restarts at split-output (its input was gathered at the replicated
    layer anyway)."""
    tp = _tp_of(mesh_or_tp)
    if len(shape) >= 2 and shape[-1 if pidx % 2 == 0 else -2] % tp == 0:
        return shard_params(tp, pidx, len(shape)), pidx + 1
    return None, pidx + pidx % 2


def shard_index(size: int, tp: int, m: int) -> slice:
    """Model index ``m``'s contiguous share of a dim of ``size``."""
    n = size // tp
    return slice(m * n, (m + 1) * n)
