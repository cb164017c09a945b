"""Decision units: stop/improvement logic across epochs (port of
``znicz_tpu/nn/decision.py``).

On the unit graph Decision runs after the evaluator on every tick:
``on_minibatch`` accumulates the evaluator's per-minibatch numbers by
class, and at the epoch's last minibatch ``on_epoch_end`` turns them into
the epoch's metrics dict, ``better_than_best`` tracks the best validation
(else train) result, and ``complete`` is set after ``max_epochs`` or
``fail_iterations`` epochs without improvement.  ``complete`` opens the
end point's gate and skips the GD chain; ``improved`` and
``snapshot_suggested`` are the snapshotter's triggers.  The fused loop
computes each epoch's metrics itself and uses ``better_than_best``,
``improved``, ``_fails`` and ``complete`` between epochs on the host."""

from __future__ import annotations

import numpy as np

from ..loader.base import CLASS_NAMES, TEST, TRAIN, VALID
from ..mutable import Bool
from ..units import Unit


class DecisionBase(Unit):
    def __init__(self, workflow=None, name=None, max_epochs=None,
                 fail_iterations=100, **kwargs):
        super().__init__(workflow, name, **kwargs)
        self.max_epochs = max_epochs
        self.fail_iterations = fail_iterations
        self.complete = Bool(False)
        self.improved = Bool(False)
        self.snapshot_suggested = Bool(False)
        self.epoch_metrics: list[dict] = []   # one dict per finished epoch
        self._fails = 0

    def link_loader(self, loader) -> None:
        self.loader = loader

    def link_evaluator(self, evaluator) -> None:
        self.evaluator = evaluator

    # -- per-minibatch hook ------------------------------------------------------
    def on_minibatch(self, klass: int) -> None:
        raise NotImplementedError

    def on_epoch_end(self) -> dict:
        raise NotImplementedError

    def better_than_best(self, metrics: dict) -> bool:
        raise NotImplementedError

    def run(self) -> None:
        klass = self.loader.minibatch_class
        self.on_minibatch(klass)
        if bool(self.loader.last_minibatch):
            metrics = self.on_epoch_end()
            metrics["epoch"] = self.loader.epoch_number
            self.epoch_metrics.append(metrics)
            self.improved.set(self.better_than_best(metrics))
            if bool(self.improved):
                self._fails = 0
                self.snapshot_suggested.set(True)
            else:
                self._fails += 1
            done = ((self.max_epochs is not None
                     and self.loader.epoch_number + 1 >= self.max_epochs)
                    or self._fails >= self.fail_iterations)
            if done:
                self.complete.set(True)


class DecisionGD(DecisionBase):
    """Classification decision: accumulates evaluator ``n_err``/loss per
    class; improvement = lower validation error count (train err if no
    validation set)."""

    def __init__(self, workflow=None, name=None, **kwargs):
        super().__init__(workflow, name, **kwargs)
        self.epoch_n_err = [0, 0, 0]
        self.epoch_samples = [0, 0, 0]
        self.epoch_loss = [0.0, 0.0, 0.0]
        self.best_n_err = np.inf
        self.minibatch_count = [0, 0, 0]

    def on_minibatch(self, klass: int) -> None:
        ev = self.evaluator
        self.epoch_n_err[klass] += ev.n_err
        self.epoch_samples[klass] += self.loader.minibatch_size
        self.epoch_loss[klass] += ev.mean_loss
        self.minibatch_count[klass] += 1

    def on_epoch_end(self) -> dict:
        metrics = {}
        for k in (TEST, VALID, TRAIN):
            if self.epoch_samples[k]:
                metrics[f"{CLASS_NAMES[k]}_n_err"] = self.epoch_n_err[k]
                metrics[f"{CLASS_NAMES[k]}_err_pct"] = (
                    100.0 * self.epoch_n_err[k] / self.epoch_samples[k])
                metrics[f"{CLASS_NAMES[k]}_loss"] = (
                    self.epoch_loss[k] / self.minibatch_count[k])
        self.epoch_n_err = [0, 0, 0]
        self.epoch_samples = [0, 0, 0]
        self.epoch_loss = [0.0, 0.0, 0.0]
        self.minibatch_count = [0, 0, 0]
        return metrics

    def better_than_best(self, metrics: dict) -> bool:
        key = ("validation_n_err" if "validation_n_err" in metrics
               else "train_n_err")
        value = metrics.get(key, np.inf)
        if value < self.best_n_err:
            self.best_n_err = value
            return True
        return False


class DecisionMSE(DecisionBase):
    """Regression decision: accumulates the evaluator's ``mse`` per class
    into ``*_mse`` metrics; improvement = lower validation (or train)
    MSE."""

    def __init__(self, workflow=None, name=None, **kwargs):
        super().__init__(workflow, name, **kwargs)
        self.epoch_mse = [0.0, 0.0, 0.0]
        self.minibatch_count = [0, 0, 0]
        self.best_mse = np.inf

    def on_minibatch(self, klass: int) -> None:
        self.epoch_mse[klass] += self.evaluator.mse
        self.minibatch_count[klass] += 1

    def on_epoch_end(self) -> dict:
        metrics = {}
        for k in (TEST, VALID, TRAIN):
            if self.minibatch_count[k]:
                metrics[f"{CLASS_NAMES[k]}_mse"] = (
                    self.epoch_mse[k] / self.minibatch_count[k])
        self.epoch_mse = [0.0, 0.0, 0.0]
        self.minibatch_count = [0, 0, 0]
        return metrics

    def better_than_best(self, metrics: dict) -> bool:
        key = "validation_mse" if "validation_mse" in metrics \
            else "train_mse"
        value = metrics.get(key, np.inf)
        if value < self.best_mse:
            self.best_mse = value
            return True
        return False
