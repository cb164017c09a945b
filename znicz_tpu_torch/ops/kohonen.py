"""Kohonen self-organizing-map ops: distances, winners, the neighborhood
pull (port of ``znicz_tpu/ops/kohonen.py``).

The (B, N) squared distances are ``‖x‖² − 2·x·Wᵀ + ‖w‖²``, the winner is
the row argmin (ties to the first neuron), and the neighborhood-decayed
pull is ``Δw = lr/B · (hᵀ·x − (Σ_b h)·w)``, so a step is matmul-shaped.
Products are full float32: the reference pins HIGHEST precision so that
near-tie winners do not flip, and the port keeps TF32 off
(``znicz_tpu_torch/__init__.py``).

``np_*`` are the numpy goldens the numpy device runs (the reference's
functions with ``xp=np``); the unprefixed functions are their torch
counterparts, which the unit graph runs on the CPU or the card.

``distance_argmin(x, w)`` is the fused trainer's winner search (the
reference's dispatching ``forward_winners``): on a CUDA tensor it launches
the hand-written kernel of ``csrc/kohonen.cu`` (the port of
``pallas_distance_argmin``), which keeps a running (min, argmin) and never
writes the (B, N) matrix; on a CPU tensor it runs
``plain_distance_argmin``.  A CUDA tensor never falls back.

The kernel launches under ``dist_argmin_plan``: a codebook that fits in
``SMALL_MAX_BYTES`` of shared memory takes the small form (staged once a
block, a group of lanes a row); a larger one the large form (register
tiles over rows and neurons, the features staged in chunks, the neurons
split across the blocks of a row tile, whose rows the last block to
finish merges in the same launch)."""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from . import count_launch

#: Launches of the distance→argmin kernel in this process (the CUDA branch
#: of ``distance_argmin`` adds one per launch, nowhere else).
distance_argmin_launches = 0

#: the kernel's forms, in the order ``csrc/kohonen.cu`` numbers them
FORMS = ("small", "large")
#: streaming multiprocessors of an H100 SXM
H100_SMS = 132
#: the small form's shared memory at most: the codebook, its squares and
#: the block's rows (the kernel's ``kSmallSmem``)
SMALL_MAX_BYTES = 48 * 1024
#: neurons a lane of the small form walks, about (its lanes a row are the
#: power of two up to 32 that brings a lane to this many)
SMALL_LANE_NEURONS = 8
#: threads a block of the small form: 256 staged (13, 150, 37)'s codebook
#: fastest of 32-256 on an H100, and at (100, 64, 2) 64-256 were within
#: 0.05 µs (``kohonen_probe``)
SMALL_THREADS = 256
#: the large form: features a staged chunk, chunks a step (``kSub``),
#: steps in its ring (``kStages``), rows and neurons a thread holds (the
#: register tile, ``kTm`` × ``kTn``), the tile widths, widest first, rows a
#: block (multiples of 8, so that each stage of the ring stays 1024-byte
#: aligned for the tensor memory accelerator's swizzle), threads a block
#: at most, blocks a row tile at most, and the feature groups, most first
CHUNK = 32
SUB = 2
STAGES = 4
TM = 4
TN = 4
TILE_NS = (64, 32)
LARGE_ROWS = (32, 16, 8)
LARGE_THREADS = 256
MAX_SPLITS = 32
KSPLITS = (8, 4, 2, 1)


class DistPlan(NamedTuple):
    """A launch of the winner search: its form, threads a block, lanes a
    row (``group``, small form; 0 in the large), rows a block, neurons a
    tile (0 in the small form), feature groups (``ksplit``), blocks of a
    row tile over the neurons (``splits``), copy width in floats (``vec``:
    4, the tensor maps; 1, 4-byte copies), blocks, and dynamic shared
    bytes."""
    form: str
    threads: int
    group: int
    rows: int
    tile_n: int
    ksplit: int
    splits: int
    vec: int
    blocks: int
    smem: int


def _pow2_ceil(v: int) -> int:
    return 1 << max(0, (int(v) - 1).bit_length())


def small_smem(n: int, f: int, rows: int) -> int:
    """Shared bytes of the small form: the codebook, its squares, the
    block's rows."""
    return (n * f + n + rows * f) * 4


def small_form(b: int, n: int, f: int, group: int,
               threads: int) -> DistPlan:
    """The small form at ``group`` lanes a row and ``threads`` a block."""
    rows = threads // group
    return DistPlan("small", threads, group, rows, 0, 1, 1, 1,
                    math.ceil(b / rows), small_smem(n, f, rows))


def small_plan(b: int, n: int, f: int) -> DistPlan:
    """The small form: the power of two up to 32 lanes a row that leaves a
    lane about ``SMALL_LANE_NEURONS`` neurons, ``SMALL_THREADS`` a
    block."""
    group = min(32, _pow2_ceil(math.ceil(n / SMALL_LANE_NEURONS)))
    return small_form(b, n, f, group, SMALL_THREADS)


def large_smem(rows: int, tile_n: int, ksplit: int) -> int:
    """Shared bytes of the large form (``csrc/kohonen.cu``
    ``large_smem_floats``): 1024 bytes to align the ring, the ring of
    steps of x and w chunks, the groups' partial sums, the partial
    squares, |w|², |x|², each row's best and the ring's barriers."""
    return 4 * (256 + STAGES * SUB * (rows + tile_n) * CHUNK
                + ksplit * rows * tile_n + (rows + tile_n) * 4 + tile_n
                + 3 * rows + 2 * STAGES)


def ksplit_for(rows: int, tile_n: int) -> int | None:
    """The most feature groups that keep a block of ``rows`` × ``tile_n``
    in ``TM`` × ``TN`` register tiles within ``LARGE_THREADS`` and a whole
    number of warps, or None."""
    for ks in KSPLITS:
        threads = rows // TM * (tile_n // TN) * ks
        if threads <= LARGE_THREADS and threads % 32 == 0:
            return ks
    return None


def large_form(b: int, n: int, f: int, rows: int, tile_n: int, splits: int,
               ksplit: int, vec: int) -> DistPlan:
    """The large form at ``rows`` a block, ``tile_n`` neurons a tile,
    ``splits`` blocks a row tile, ``ksplit`` feature groups and copies of
    ``vec`` floats."""
    return DistPlan("large", rows // TM * (tile_n // TN) * ksplit, 0, rows,
                    tile_n, ksplit, splits, vec,
                    math.ceil(b / rows) * splits,
                    large_smem(rows, tile_n, ksplit))


def large_plan(b: int, n: int, f: int, aligned: bool = True,
               n_sm: int = H100_SMS) -> DistPlan:
    """The large form: one tile of neurons a block (the splits as many as
    the tiles, at most ``MAX_SPLITS``), and of the rows a block
    (``LARGE_ROWS``) and tile widths (``TILE_NS``) the launch of the
    fewest blocks that still gives each of the ``n_sm`` SMs one (the most
    blocks where none does), then the fewest padded rows, the most rows,
    the widest tile; the feature groups are the most that fit
    (``ksplit_for``); 16-byte copies where f % 4 == 0 and the bases are
    aligned.  A block that walks several tiles, or a row tile merged from
    few blocks, ran slower at MNIST widths on an H100 than one tile a
    block (``kohonen_probe``)."""
    cands = []
    for tn in TILE_NS:
        s = min(math.ceil(n / tn), MAX_SPLITS)
        for r in LARGE_ROWS:
            ks = ksplit_for(r, tn)
            if ks is None:
                continue
            blocks = math.ceil(b / r) * s
            full = blocks >= n_sm
            cands.append((not full, blocks if full else -blocks,
                          math.ceil(b / r) * r - b, -r, -tn, s, ks))
    _, _, _, r, tn, s, ks = min(cands)
    return large_form(b, n, f, -r, -tn, s, ks,
                      4 if f % 4 == 0 and aligned else 1)


def dist_argmin_plan(b: int, n: int, f: int, aligned: bool = True,
                     n_sm: int = H100_SMS) -> DistPlan:
    """The launch of the winner search of b rows over an (n, f) codebook
    whose bases are 16-byte aligned or not, on a card of ``n_sm`` SMs: the
    small form where its shared memory fits ``SMALL_MAX_BYTES``, else the
    large form (tensor maps, ``vec`` 4, where f % 4 == 0 and the bases are
    aligned; the C entry point refuses them elsewhere)."""
    plan = small_plan(b, n, f)
    if plan.smem <= SMALL_MAX_BYTES:
        return plan
    return large_plan(b, n, f, aligned, n_sm)


class _Launch(ctypes.Structure):
    """A plan over B rows, N neurons and F features as the C entry point
    takes it (``csrc/kohonen.cu`` ``DistLaunch``)."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "b", "n", "f", "form", "threads", "group", "rows", "tile_n",
        "ksplit", "splits", "vec", "blocks", "smem")]


def launch_struct(b: int, n: int, f: int, plan: DistPlan) -> _Launch:
    """``plan`` over b rows, n neurons and f features as the C entry point
    takes it."""
    return _Launch(b, n, f, FORMS.index(plan.form), *plan[1:])


#: x, w, win, dmin, the merge's scratch and tickets, the launch, stream
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.POINTER(_Launch)]
             + [ctypes.c_void_p])
#: form, vec, then registers and local bytes written back
_ATTR_ARGTYPES = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=256)
def _launch_for(b: int, n: int, f: int, aligned: bool,
                index: int) -> tuple[DistPlan, _Launch]:
    """The plan on card ``index`` and its launch struct, made once a
    geometry: the SOM's step calls the kernel at one shape throughout."""
    plan = dist_argmin_plan(b, n, f, aligned, _sm_count(index))
    return plan, launch_struct(b, n, f, plan)


def _cuda_launch(x: torch.Tensor, w: torch.Tensor):
    return _launch_for(x.shape[0], w.shape[0], x.shape[1],
                       x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0,
                       x.get_device())


def plan_for(x: torch.Tensor, w: torch.Tensor) -> DistPlan:
    """The plan of a launch over CUDA tensors ``x`` and ``w`` on their
    card."""
    return _cuda_launch(x, w)[0]


def grid_coords(sy: int, sx: int) -> np.ndarray:
    """(N, 2) float32 grid coordinates of an sy×sx sheet, row-major
    (neuron n sits at (n // sx, n % sx))."""
    n = np.arange(sy * sx)
    return np.stack([n // sx, n % sx], axis=1).astype(np.float32)


# -- numpy goldens ------------------------------------------------------------
def np_distances(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Squared euclidean distances (B, N): x (B, F), w (N, F)."""
    x2 = (x * x).sum(axis=1, keepdims=True)
    w2 = (w * w).sum(axis=1)
    return x2 - 2.0 * (x @ w.T) + w2


def np_neighborhood(win, coords, sigma):
    """Gaussian sheet-distance weights (B, N):
    h[b, n] = exp(−‖c_n − c_win(b)‖² / (2σ²))."""
    cw = coords[win]
    d2 = ((coords[None, :, :] - cw[:, None, :]) ** 2).sum(axis=2)
    return np.exp(-d2 / (2.0 * sigma * sigma))


def np_som_update(w, x, win, coords, lr, sigma):
    """(w + Δw, mean |Δw|) with Δw_n = lr/B · Σ_b h[b,n]·(x_b − w_n)."""
    h = np_neighborhood(win, coords, sigma)
    delta = (lr / x.shape[0]) * (h.T @ x - h.sum(axis=0)[:, None] * w)
    return w + delta, np.abs(delta).mean()


def np_forward(x, w):
    """(winners int32 (B,), distances (B, N))."""
    d = np_distances(x, w)
    return np.argmin(d, axis=1).astype(np.int32), d


def np_train_step(w, x, coords, lr, sigma):
    win, _ = np_forward(x, w)
    return np_som_update(w, x, win, coords, lr, sigma)


def np_quantization_error(x, w) -> float:
    """Mean distance from each sample to its winner."""
    d = np_distances(x, w)
    return float(np.sqrt(np.maximum(d.min(axis=1), 0.0)).mean())


# -- torch --------------------------------------------------------------------
def distances(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`np_distances` on tensors (float32 product, TF32 off)."""
    x2 = (x * x).sum(dim=1, keepdim=True)
    w2 = (w * w).sum(dim=1)
    return x2 - 2.0 * (x @ w.T) + w2


def winners(d: torch.Tensor) -> torch.Tensor:
    """Row argmin → (B,) int32; ties keep the first index."""
    return torch.argmin(d, dim=1).to(torch.int32)


def neighborhood(win: torch.Tensor, coords: torch.Tensor,
                 sigma) -> torch.Tensor:
    """:func:`np_neighborhood` on tensors; ``sigma`` a host float or a
    float32 scalar tensor on the device (the fused trainer's, which a
    captured step reads there)."""
    cw = coords[win.long()]
    d2 = ((coords[None, :, :] - cw[:, None, :]) ** 2).sum(dim=2)
    return torch.exp(-d2 / (2.0 * sigma * sigma))


def som_delta(w, x, win, coords, lr, sigma) -> torch.Tensor:
    """Δw of one batch pull (no (B, N, F) intermediate); ``lr`` and
    ``sigma`` as :func:`neighborhood` takes ``sigma``."""
    h = neighborhood(win, coords, sigma)
    return (lr / x.shape[0]) * (h.T @ x - h.sum(dim=0)[:, None] * w)


def som_update(w, x, win, coords, lr: float, sigma: float):
    """(w + Δw, mean |Δw| as a device scalar)."""
    delta = som_delta(w, x, win, coords, lr, sigma)
    return w + delta, delta.abs().mean()


def quantization_error(x: torch.Tensor, w: torch.Tensor) -> float:
    d = distances(x, w)
    return float(torch.sqrt(torch.clamp(d.min(dim=1).values, min=0.0))
                 .mean())


def plain_distance_argmin(x: torch.Tensor, w: torch.Tensor):
    """(win int32 (B,), dmin f32 (B,)): :func:`distances`, its first-index
    argmin and its row minimum — the reference's XLA tier, and what the
    kernel is held against on the card."""
    d = distances(x, w)
    return winners(d), d.min(dim=1).values


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    """Refuse what the kernel does not take; the CPU branch is held to the
    same contract so both devices accept the same inputs."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"distance_argmin: unsupported device {x.device}")
    if w.device != x.device:
        raise ValueError(f"distance_argmin: x on {x.device}, w on "
                         f"{w.device}")
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.float32:
            raise TypeError(f"distance_argmin: {name} must be float32, got "
                            f"{t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"distance_argmin: {name} must be a contiguous "
                             f"matrix, got {tuple(t.shape)}")
    if x.shape[1] != w.shape[1]:
        raise ValueError(f"distance_argmin: x is {tuple(x.shape)}, w is "
                         f"{tuple(w.shape)}")
    if w.shape[0] == 0:
        raise ValueError("distance_argmin: no neurons")
    if max(x.numel(), w.numel()) >= 2 ** 31:
        raise ValueError("distance_argmin: 2^31 elements or more (the "
                         "kernel indexes in int32)")


#: (device, stream) → the large form's ticket counters, zero between
#: launches (the last block of a row tile resets its own)
_tickets: dict = {}


def tickets_for(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed ticket counters for a launch on ``device``'s
    current stream.  Launches on one stream take turns, so each stream
    reuses one buffer; launches on two streams may overlap, so they never
    share one.  A launch being captured into a CUDA graph gets counters of
    its own, zeroed in the graph and held by it, so that graphs replayed
    on other streams, or eager calls beside them, take no ticket of
    theirs."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros((n,), dtype=torch.int32, device=device)
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    held = _tickets.get(key)
    if held is None or held.numel() < n:
        held = _tickets[key] = torch.zeros((max(n, 4096),),
                                           dtype=torch.int32, device=device)
    return held


def launch_distance_argmin(x: torch.Tensor, w: torch.Tensor,
                           plan: DistPlan, args: _Launch | None = None):
    """(win, dmin) of CUDA tensors ``x`` (B > 0 rows) and ``w`` on the card
    by ``plan`` (and its launch struct ``args``, made here where not
    given), without counting a launch: ``distance_argmin``'s CUDA branch,
    and what a measurement that sets its own plan calls.  A plan that
    splits the neurons gets its merge's scratch (each block's rows' value
    and index) from ``torch.empty`` and its tickets from
    ``tickets_for``."""
    b = x.shape[0]
    if args is None:
        args = launch_struct(b, w.shape[0], x.shape[1], plan)
    win = torch.empty((b,), dtype=torch.int32, device=x.device)
    dmin = torch.empty((b,), dtype=torch.float32, device=x.device)
    scratch = tickets = None
    if plan.splits > 1:
        scratch = torch.empty((2 * plan.blocks * plan.rows,),
                              dtype=torch.int32, device=x.device)
        tickets = tickets_for(x.device, plan.blocks // plan.splits)
    from .. import cuda_build
    cuda_build.launch(
        cuda_build.kernel("kohonen", "znicz_distance_argmin_f32",
                          _ARGTYPES),
        x.device, x.data_ptr(), w.data_ptr(), win.data_ptr(),
        dmin.data_ptr(), scratch.data_ptr() if scratch is not None else None,
        tickets.data_ptr() if tickets is not None else None, args)
    return win, dmin


def kernel_attrs(plan: DistPlan) -> dict:
    """Registers a thread and local (spilled) bytes a thread of the
    instance ``plan`` runs, as the card's loader reports them."""
    from .. import cuda_build
    regs, local = ctypes.c_int(), ctypes.c_int()
    fn = cuda_build.kernel("kohonen", "znicz_distance_argmin_attrs",
                           _ATTR_ARGTYPES)
    status = fn(FORMS.index(plan.form), plan.vec, ctypes.addressof(regs),
                ctypes.addressof(local))
    if status != 0:
        raise RuntimeError(f"znicz_distance_argmin_attrs: CUDA error "
                           f"{status}")
    return {"registers": regs.value, "local_bytes": local.value}


def distance_argmin(x: torch.Tensor, w: torch.Tensor):
    """Fused winner search of (B, F) samples over an (N, F) codebook →
    ``(win int32 (B,), dmin f32 (B,))``, ties to the lowest neuron: the
    CUDA kernel for CUDA tensors (one launch, by ``plan_for``, the plan
    made once a geometry), the plain version for CPU tensors."""
    _check(x, w)
    if x.device.type == "cpu":
        return plain_distance_argmin(x, w)
    if x.shape[0] == 0:
        return (torch.empty((0,), dtype=torch.int32, device=x.device),
                torch.empty((0,), dtype=torch.float32, device=x.device))
    out = launch_distance_argmin(x, w, *_cuda_launch(x, w))
    count_launch(__name__, "distance_argmin_launches")
    return out
