"""Fused RBM training: whole CD-1 epochs on the device (port of
``znicz_tpu/parallel/rbm.py``).

The reference runs an epoch as one jitted ``lax.scan`` over
``ops.rbm.cd1_momentum_step``.  Here the dataset stays resident on the
device; a step gathers its rows, runs the CD-1 step with momentum and
decay, writes the parameters and velocities over the trainer's buffers
and records its reconstruction mse on the device.  On the card each step
is a replay of one CUDA graph (``parallel.capture``) that reads its row
of the epoch's plan at a device step counter: the minibatch's indices,
then the epoch and the counter, from which the step folds its Bernoulli
key on the device (``rngbits.fold_t``), so every replay draws its own
bits.  The counters equal the unit graph's (unit id, epoch, samples
consumed after the step), so the fused epochs sample the same states as
the tick loop.  The host reads the epoch's mean once, at its end
(``host_syncs`` counts those reads; ``epoch_timings`` keeps each
epoch's wall time up to that read).  ``capture=False`` and the CPU run
the same step directly, the key folded on the host."""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import rbm as rbm_ops


class FusedRBMTrainer:
    """Device-resident RBM parameters and the CD-1 epoch loop, on the card
    unless the caller passes ``device="cpu"``; ``capture`` (default: on
    the card) replays the steps from a CUDA graph.  ``unit_id``/``seed``
    must be the unit-graph trainer's for its draws (``RBMTrainer.unit_id``
    and the ``"rbm"`` stream's seed)."""

    def __init__(self, w, vbias, hbias, *, seed: int, unit_id: int,
                 learning_rate=0.1, momentum=0.0, weights_decay=0.0,
                 device=None, capture: bool | None = None):
        if device is None:
            from ..backends import resolve
            device = resolve(None)
        self.device = torch.device(device)
        if capture and self.device.type != "cuda":
            raise ValueError(f"capture=True: the {self.device.type} runs "
                             f"the step directly")
        #: whether the steps replay a CUDA graph
        self.captured = self.device.type == "cuda" and capture is not False

        def put(a):
            return torch.tensor(np.asarray(a, np.float32),
                                device=self.device)
        self.params = tuple(put(a) for a in (w, vbias, hbias))
        self.vels = tuple(torch.zeros_like(p) for p in self.params)
        self.seed = int(seed)
        self.unit_id = int(unit_id)
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.weights_decay = weights_decay
        self._plans: dict = {}          # (batch, dataset) → StepPlan
        #: device → host reads so far (one an epoch)
        self.host_syncs = 0
        #: {"epoch", "examples", "wall_s", "recon_mse"} of each epoch
        #: trained, the wall from the call to the host's read of its mean
        self.epoch_timings: list[dict] = []

    def _step(self, v0: torch.Tensor, epoch, ctr) -> torch.Tensor:
        """One CD-1 step over ``v0`` (batch, V), the parameters and
        velocities written over in place; its reconstruction mse."""
        params, vels, recon = rbm_ops.cd1_momentum_step(
            self.params, self.vels, v0, self.learning_rate, self.momentum,
            self.weights_decay, self.seed, (self.unit_id, epoch, ctr))
        for buf, t in zip(self.params + self.vels, params + vels):
            buf.copy_(t)
        return recon

    def _plan(self, data: torch.Tensor, batch: int, steps: int):
        from .capture import StepPlan
        key = (batch, data.data_ptr(), tuple(data.shape), data.dtype)
        plan = self._plans.get(key)
        if plan is None:
            if len(self._plans) >= 4:
                self._plans.pop(next(iter(self._plans)))
            plan = self._plans[key] = StepPlan(
                self.device, batch + 2, max(steps, data.shape[0] // batch),
                {"recon": torch.float32})
        return plan

    @torch.no_grad()
    def train_epoch(self, data: torch.Tensor, indices: np.ndarray,
                    batch: int, epoch: int) -> float:
        """One epoch over ``indices`` of the resident ``data``, truncated
        to full batches as the reference's scan is; returns the steps'
        mean reconstruction mse."""
        t0 = time.perf_counter()
        steps = len(indices) // batch
        if steps == 0:
            raise ValueError("fewer samples than one batch")
        rows = np.asarray(indices[:steps * batch]).reshape(steps, batch)
        # the counter is the samples consumed after each step (the unit
        # graph's minibatch_offset)
        ctrs = (np.arange(steps) + 1) * batch
        if self.captured:
            plan = self._plan(data, batch, steps)
            words = np.stack([np.full(steps, int(epoch) & 0xFFFF_FFFF),
                              ctrs], 1).astype(np.uint32).view(np.int32)
            plan.load(np.concatenate([rows.astype(np.int32), words], 1))

            def step():
                row = plan.row()
                v0 = data.index_select(0, row[:batch]).reshape(batch, -1)
                plan.put("recon", self._step(v0, row[batch:batch + 1],
                                             row[batch + 1:batch + 2]))
                plan.advance()
            for _ in range(steps):
                plan.run("train", step)
            recons = plan.take(steps)["recon"]
        else:
            idx = torch.from_numpy(rows.astype(np.int64)).to(data.device)
            recons = torch.stack([
                self._step(data.index_select(0, idx[s]).reshape(batch, -1),
                           int(epoch), int(ctrs[s]))
                for s in range(steps)])
        mean = float(recons.mean())
        self.host_syncs += 1
        self.epoch_timings.append({"epoch": int(epoch),
                                   "examples": steps * batch,
                                   "wall_s": time.perf_counter() - t0,
                                   "recon_mse": mean})
        return mean

    def write_back(self, rbm_unit, trainer_unit=None) -> None:
        """Install copies of the trained parameters (and velocities) into
        the unit graph's Vectors."""
        w, vb, hb = (p.detach().cpu().numpy().copy() for p in self.params)
        rbm_unit.weights.mem, rbm_unit.vbias.mem, rbm_unit.hbias.mem = \
            w, vb, hb
        if trainer_unit is not None:
            vw, vvb, vhb = (v.detach().cpu().numpy().copy()
                            for v in self.vels)
            trainer_unit.velocity_weights.mem = vw
            trainer_unit.velocity_vbias.mem = vvb
            trainer_unit.velocity_hbias.mem = vhb
