"""Kohonen self-organizing-map units, the non-gradient training path (port
of ``znicz_tpu/nn/kohonen.py``): ``KohonenForward`` (winner-take-all over
the distance matrix), ``KohonenTrainer`` (the neighborhood-decayed pull of
the weights toward each sample, no gradient chain) and ``KohonenDecision``
(the weight-change stop).

The trainer and the forward share one weights Vector.  The schedules
``σ(e) = max(σ₀·e^(−e/τ), σ_min)`` and ``lr(e) = lr₀·e^(−e/τ)`` are
computed in float64 on the host between steps.  On a torch device the
forward computes the full (B, N) distance matrix, as the reference's
``xla_run`` does, so the unit graph launches no ``distance_argmin``
kernel (only the fused trainer does); ``hits`` accumulates on the device,
masked to the real rows of the minibatch, and readers map it once an
epoch.  The trainer reads its mean |Δw| back every tick, as the
reference's does."""

from __future__ import annotations

import numpy as np
import torch

from ..accelerated_units import AcceleratedUnit
from ..loader.base import TRAIN
from ..memory import Vector
from ..mutable import Bool, DerivedBool
from ..ops import kohonen as som_ops
from ..units import Unit
from .nn_units import Forward


class KohonenForward(Forward):
    """Winner-take-all forward: ``output`` = (B,) int32 winners; also the
    (B, N) ``distances`` and a per-neuron ``hits`` histogram."""

    MAPPING = ("kohonen",)

    def __init__(self, workflow=None, name=None, shape=None, **kwargs):
        kwargs["include_bias"] = False
        kwargs.setdefault("weights_filling", "uniform")
        super().__init__(workflow, name, **kwargs)
        if shape is None:
            raise ValueError("shape=(sy, sx) is required")
        self.shape = (int(shape[0]), int(shape[1]))
        self.n_neurons = self.shape[0] * self.shape[1]
        self.distances = Vector()
        self.hits = Vector()

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device, **kwargs)
        n_features = int(np.prod(self.input.shape[1:]))
        self.create_weights((self.n_neurons, n_features), ())
        if not self.output:
            self.output.mem = np.zeros((self.input.shape[0],), np.int32)
        if not self.hits:
            self.hits.mem = np.zeros((self.n_neurons,), np.int64)
        self.init_vectors(self.weights, self.output, self.distances,
                          self.hits)

    def numpy_run(self) -> None:
        x = self.input.mem
        win, d = som_ops.np_forward(x.reshape(len(x), -1), self.weights.mem)
        self.output.mem, self.distances.mem = win, d
        self.hits.map_write()
        np.add.at(self.hits.mem, win[:self.current_batch_size], 1)

    def torch_run(self) -> None:
        x = self.input.devmem
        d = som_ops.distances(x.reshape(len(x), -1), self.weights.devmem)
        win = som_ops.winners(d)
        live = (torch.arange(len(win), device=win.device)
                < self.current_batch_size).to(torch.int64)
        self.output.devmem, self.distances.devmem = win, d
        self.hits.devmem = self.hits.devmem.index_add(0, win.long(), live)


class KohonenTrainer(AcceleratedUnit):
    """Neighborhood-decayed weight pull; publishes ``weights_diff`` (mean
    |Δw| of the last step) for KohonenDecision."""

    def __init__(self, workflow=None, name=None, learning_rate=0.5,
                 sigma0=None, sigma_min=0.5, decay_epochs=20.0, **kwargs):
        super().__init__(workflow, name, **kwargs)
        self.learning_rate = learning_rate
        self.sigma0 = sigma0          # default: the grid radius (below)
        self.sigma_min = sigma_min
        self.decay_epochs = decay_epochs
        self.weights_diff = np.inf
        self.forward_unit: KohonenForward | None = None

    def setup_from_forward(self, fwd: KohonenForward) -> "KohonenTrainer":
        self.forward_unit = fwd
        self.link_attrs(fwd, "weights", "input", ("winners", "output"))
        self.grid_shape = fwd.shape
        if self.sigma0 is None:
            self.sigma0 = max(fwd.shape) / 2.0
        return self

    def _epoch(self) -> int:
        loader = getattr(self.workflow, "loader", None)
        return loader.epoch_number if loader is not None else 0

    def schedules(self) -> tuple[float, float]:
        """(lr, σ) of the current epoch, in float64 on the host."""
        decay = np.exp(-self._epoch() / self.decay_epochs)
        return (self.learning_rate * decay,
                max(self.sigma0 * decay, self.sigma_min))

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device, **kwargs)
        self._coords = som_ops.grid_coords(*self.grid_shape)
        if device is not None and device.is_torch:
            self._coords_t = torch.from_numpy(self._coords).to(
                device.torch_device)

    def numpy_run(self) -> None:
        lr, sigma = self.schedules()
        x = self.input.mem.reshape(len(self.input.mem), -1)
        bs = self.current_batch_size
        w, diff = som_ops.np_som_update(
            self.weights.mem, x[:bs], self.winners.mem[:bs], self._coords,
            lr, sigma)
        self.weights.mem = w.astype(np.float32)
        self.weights_diff = float(diff)

    def torch_run(self) -> None:
        lr, sigma = self.schedules()
        bs = self.current_batch_size
        # a short final minibatch: the update sees its real rows only
        x = self.input.devmem[:bs]
        w, diff = som_ops.som_update(
            self.weights.devmem, x.reshape(bs, -1),
            self.winners.devmem[:bs], self._coords_t, float(lr),
            float(sigma))
        self.weights.devmem = w
        self.weights_diff = float(diff)


class KohonenDecision(Unit):
    """Stop when the epoch-mean weight change drops under ``epsilon`` or
    after ``max_epochs``."""

    def __init__(self, workflow=None, name=None, max_epochs=None,
                 epsilon=1e-4, **kwargs):
        super().__init__(workflow, name, **kwargs)
        self.max_epochs = max_epochs
        self.epsilon = epsilon
        self.complete = Bool(False)
        self.epoch_metrics: list[dict] = []
        self._diff_sum = 0.0
        self._diff_n = 0

    def link_loader(self, loader) -> None:
        self.loader = loader

    def link_trainer(self, trainer: KohonenTrainer) -> None:
        self.trainer = trainer

    def run(self) -> None:
        if self.loader.minibatch_class == TRAIN:
            # the trainer is gate-skipped off the train set: its stale
            # weights_diff must not enter the epoch mean
            self._diff_sum += self.trainer.weights_diff
            self._diff_n += 1
        if bool(self.loader.last_minibatch):
            mean_diff = self._diff_sum / max(self._diff_n, 1)
            self.epoch_metrics.append(
                {"epoch": self.loader.epoch_number,
                 "weights_diff": mean_diff})
            self._diff_sum, self._diff_n = 0.0, 0
            if (mean_diff < self.epsilon
                    or (self.max_epochs is not None
                        and self.loader.epoch_number + 1
                        >= self.max_epochs)):
                self.complete.set(True)
            writer = getattr(self.workflow, "metrics_writer", None)
            if writer is not None:
                writer.write(kind="epoch", **self.epoch_metrics[-1])


def make_train_only_gate(loader, decision) -> DerivedBool:
    """gate_skip predicate: run on train minibatches only, and not once
    training is complete (StandardWorkflow's GD gating)."""
    return DerivedBool(
        lambda: loader.minibatch_class != TRAIN
        or bool(decision.complete), ())
