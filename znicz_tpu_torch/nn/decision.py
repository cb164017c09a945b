"""Decision: stop/improvement state across epochs (port of
``znicz_tpu/nn/decision.py``, host side only).

The fused loop computes each epoch's metrics dict and hands it here:
``better_than_best`` tracks the best validation (else train) result,
``_fails`` counts epochs without improvement, and ``complete`` is set when
training ends.  The per-minibatch ``run`` of the reference's unit belongs
to the unit graph (ROADMAP.md queue 1 item 4)."""

from __future__ import annotations

import numpy as np


class DecisionBase:
    def __init__(self, max_epochs=None, fail_iterations=100):
        self.max_epochs = max_epochs
        self.fail_iterations = fail_iterations
        self.complete = False
        self.improved = False
        self.epoch_metrics: list[dict] = []   # one dict per finished epoch
        self._fails = 0

    def better_than_best(self, metrics: dict) -> bool:
        raise NotImplementedError


class DecisionGD(DecisionBase):
    """Classification: improvement = lower validation error count (train
    error count if there is no validation set)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.best_n_err = np.inf

    def better_than_best(self, metrics: dict) -> bool:
        key = ("validation_n_err" if "validation_n_err" in metrics
               else "train_n_err")
        value = metrics.get(key, np.inf)
        if value < self.best_n_err:
            self.best_n_err = value
            return True
        return False


class DecisionMSE(DecisionBase):
    """Regression: improvement = lower validation (or train) MSE."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.best_mse = np.inf

    def better_than_best(self, metrics: dict) -> bool:
        key = "validation_mse" if "validation_mse" in metrics \
            else "train_mse"
        value = metrics.get(key, np.inf)
        if value < self.best_mse:
            self.best_mse = value
            return True
        return False
