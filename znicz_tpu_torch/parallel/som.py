"""Fused SOM training: whole epochs on the device (port of
``znicz_tpu/parallel/som.py``).

The reference runs an epoch as one jitted ``lax.scan``.  Here the epoch is
a loop over its ``(steps, batch)`` index matrix, uploaded once: each step
gathers its rows of the resident dataset, finds the winners with
``ops.kohonen.distance_argmin`` (the hand-written kernel on the card) and
pulls the weights in place.  Each step's mean |Δw| stays on the device;
the host reads the epoch's mean once, at its end (``host_syncs`` counts
those reads).  The σ/lr schedules are per-epoch host floats."""

from __future__ import annotations

import numpy as np
import torch

from ..ops import kohonen as som_ops


class FusedSOMTrainer:
    """Device-resident SOM weights and the epoch loop, on the card unless
    the caller passes ``device="cpu"``."""

    def __init__(self, weights, grid_shape: tuple[int, int], device=None):
        if device is None:
            from ..backends import resolve
            device = resolve(None)
        self.grid_shape = grid_shape
        self.device = torch.device(device)
        self.weights = torch.tensor(np.asarray(weights, np.float32),
                                    device=self.device)
        self._coords = torch.from_numpy(
            som_ops.grid_coords(*grid_shape)).to(self.device)
        #: device → host reads so far (one an epoch)
        self.host_syncs = 0

    def train_epoch(self, data: torch.Tensor, indices: np.ndarray,
                    batch: int, lr: float, sigma: float) -> float:
        """One epoch over ``indices``, truncated to full batches as the
        reference's scan is; returns the mean of the steps' mean |Δw|."""
        steps = len(indices) // batch
        if steps == 0:
            raise ValueError("fewer samples than one batch")
        idx = torch.from_numpy(np.asarray(
            indices[:steps * batch], np.int64).reshape(steps, batch)).to(
                data.device)
        diffs = torch.empty((steps,), dtype=torch.float32,
                            device=data.device)
        w = self.weights
        for s in range(steps):
            x = data.index_select(0, idx[s]).reshape(batch, -1)
            win, _ = som_ops.distance_argmin(x, w)
            delta = som_ops.som_delta(w, x, win, self._coords, float(lr),
                                      float(sigma))
            w.add_(delta)
            diffs[s] = delta.abs().mean()
        self.host_syncs += 1
        return float(diffs.mean())

    def write_back(self, forward_unit) -> None:
        forward_unit.weights.mem = self.weights.detach().cpu().numpy().copy()
