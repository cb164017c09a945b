"""Fused SOM training: whole epochs on the device (port of
``znicz_tpu/parallel/som.py``).

The reference runs an epoch as one jitted ``lax.scan``.  Here a step
gathers its rows of the resident dataset, finds the winners with
``ops.kohonen.distance_argmin`` (the hand-written kernel on the card),
pulls the weights in place and records the step's mean |Δw| on the
device; the epoch's learning rate and σ are device float32 scalars,
refreshed once an epoch, as the reference passes traced scalars.  On the
card each step is a replay of a CUDA graph (``parallel.capture``) that
reads its indices from the epoch's plan at a device step counter; on the
CPU the same step runs directly.  The host reads the epoch's mean once,
at its end (``host_syncs`` counts those reads)."""

from __future__ import annotations

import numpy as np
import torch

from ..ops import kohonen as som_ops


class FusedSOMTrainer:
    """Device-resident SOM weights and the epoch loop, on the card unless
    the caller passes ``device="cpu"``; ``capture`` (default: on the card)
    replays the steps from a CUDA graph."""

    def __init__(self, weights, grid_shape: tuple[int, int], device=None,
                 capture: bool | None = None):
        if device is None:
            from ..backends import resolve
            device = resolve(None)
        self.grid_shape = grid_shape
        self.device = torch.device(device)
        if capture and self.device.type != "cuda":
            raise ValueError(f"capture=True: the {self.device.type} runs "
                             f"the step directly")
        #: whether the steps replay a CUDA graph
        self.captured = self.device.type == "cuda" and capture is not False
        self.weights = torch.tensor(np.asarray(weights, np.float32),
                                    device=self.device)
        self._coords = torch.from_numpy(
            som_ops.grid_coords(*grid_shape)).to(self.device)
        self._lr = torch.zeros((), dtype=torch.float32, device=self.device)
        self._sigma = torch.zeros_like(self._lr)
        self._plans: dict = {}          # (batch, dataset) → StepPlan
        #: device → host reads so far (one an epoch)
        self.host_syncs = 0

    def _step(self, x: torch.Tensor) -> torch.Tensor:
        """One batch pull of the weights, in place; its mean |Δw|."""
        win, _ = som_ops.distance_argmin(x, self.weights)
        delta = som_ops.som_delta(self.weights, x, win, self._coords,
                                  self._lr, self._sigma)
        self.weights.add_(delta)
        return delta.abs().mean()

    def _plan(self, data: torch.Tensor, batch: int, steps: int):
        from .capture import StepPlan
        key = (batch, data.data_ptr(), tuple(data.shape), data.dtype)
        plan = self._plans.get(key)
        if plan is None:
            if len(self._plans) >= 4:
                self._plans.pop(next(iter(self._plans)))
            plan = self._plans[key] = StepPlan(
                self.device, batch, max(steps, data.shape[0] // batch),
                {"diff": torch.float32})
        return plan

    @torch.no_grad()
    def train_epoch(self, data: torch.Tensor, indices: np.ndarray,
                    batch: int, lr: float, sigma: float) -> float:
        """One epoch over ``indices``, truncated to full batches as the
        reference's scan is; returns the mean of the steps' mean |Δw|."""
        steps = len(indices) // batch
        if steps == 0:
            raise ValueError("fewer samples than one batch")
        rows = np.asarray(indices[:steps * batch]).reshape(steps, batch)
        self._lr.fill_(float(lr))
        self._sigma.fill_(float(sigma))
        if self.captured:
            plan = self._plan(data, batch, steps)
            plan.load(rows)

            def step():
                x = data.index_select(0, plan.row()).reshape(batch, -1)
                plan.put("diff", self._step(x))
                plan.advance()
            for _ in range(steps):
                plan.run("train", step)
            diffs = plan.take(steps)["diff"]
        else:
            idx = torch.from_numpy(rows.astype(np.int64)).to(data.device)
            diffs = torch.stack([
                self._step(data.index_select(0, idx[s]).reshape(batch, -1))
                for s in range(steps)])
        self.host_syncs += 1
        return float(diffs.mean())

    def write_back(self, forward_unit) -> None:
        forward_unit.weights.mem = self.weights.detach().cpu().numpy().copy()
