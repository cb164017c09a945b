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
``plain_distance_argmin``.  A CUDA tensor never falls back."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

#: Launches of the distance→argmin kernel in this process (the CUDA branch
#: of ``distance_argmin`` adds one per launch, nowhere else).
distance_argmin_launches = 0

#: x, w, win, dmin, B, N, F, stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


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
                 sigma: float) -> torch.Tensor:
    """:func:`np_neighborhood` on tensors; ``sigma`` a host float."""
    cw = coords[win.long()]
    d2 = ((coords[None, :, :] - cw[:, None, :]) ** 2).sum(dim=2)
    return torch.exp(-d2 / (2.0 * sigma * sigma))


def som_delta(w, x, win, coords, lr: float, sigma: float) -> torch.Tensor:
    """Δw of one batch pull (no (B, N, F) intermediate)."""
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


def distance_argmin(x: torch.Tensor, w: torch.Tensor):
    """Fused winner search of (B, F) samples over an (N, F) codebook →
    ``(win int32 (B,), dmin f32 (B,))``, ties to the lowest neuron: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    global distance_argmin_launches
    _check(x, w)
    if x.device.type == "cpu":
        return plain_distance_argmin(x, w)
    b, f = x.shape
    n = w.shape[0]
    win = torch.empty((b,), dtype=torch.int32, device=x.device)
    dmin = torch.empty((b,), dtype=torch.float32, device=x.device)
    if b == 0:
        return win, dmin
    from .. import cuda_build
    cuda_build.launch(
        cuda_build.kernel("kohonen", "znicz_distance_argmin_f32",
                          _ARGTYPES),
        x.device, x.data_ptr(), w.data_ptr(), win.data_ptr(),
        dmin.data_ptr(), b, n, f)
    distance_argmin_launches += 1
    return win, dmin
