"""Loader base: minibatch scheduling over test/valid/train sets (port of
``znicz_tpu/loader/base.py``).

Class indices 0=test, 1=validation, 2=train; the resident dataset is laid
out ``[test | valid | train]``.  Each epoch's train order is a shuffle of
the global train indices drawn from the ``"loader"`` stream in the same
order as the reference, so both packages walk identical minibatches.

This is not a ``Unit``: the unit graph (``units``, ``workflow``,
``mutable``, ``memory``) is ROADMAP.md queue 1 item 4.  The fused path only
needs the epoch plan and the resident tensors."""

from __future__ import annotations

import numpy as np
import torch

from .. import prng

TEST, VALID, TRAIN = 0, 1, 2
CLASS_NAMES = ("test", "validation", "train")


class Loader:
    """Epoch planner; subclasses provide the data."""

    def __init__(self, name=None, minibatch_size=100, shuffle_limit=np.inf):
        self.name = name or "loader"
        self.max_minibatch_size = int(minibatch_size)
        self.class_lengths = [0, 0, 0]
        self.epoch_number = 0
        self.shuffle_limit = shuffle_limit
        self.device: torch.device | None = None
        self._shuffled: dict[int, np.ndarray] = {}
        self.prng = prng.get("loader")

    # -- subclass API --------------------------------------------------------
    def load_data(self) -> None:
        """Populate class_lengths + backing data.  Subclass hook."""
        raise NotImplementedError

    # -- scheduling ----------------------------------------------------------
    def initialize(self, device: torch.device) -> None:
        self.device = torch.device(device)
        self.load_data()
        self.total_samples = int(sum(self.class_lengths))
        if self.class_lengths[TRAIN] <= 0:
            raise ValueError("loader has no training samples")
        self._build_epoch_plan()

    def _class_indices(self, klass: int) -> np.ndarray:
        start = int(sum(self.class_lengths[:klass]))
        idx = np.arange(start, start + self.class_lengths[klass])
        if klass == TRAIN and self.epoch_number < self.shuffle_limit:
            idx = idx.copy()
            self.prng.shuffle(idx)
        return idx

    def _build_epoch_plan(self) -> None:
        """This epoch's index order per class (test, valid, train: the
        reference's draw order on the ``"loader"`` stream)."""
        self._shuffled = {}
        for klass in (TEST, VALID, TRAIN):
            if self.class_lengths[klass]:
                self._shuffled[klass] = self._class_indices(klass)
        self._plan_epoch = self.epoch_number

    def train_permutation(self, epoch: int) -> np.ndarray:
        """Shuffled global train indices for ``epoch``; rebuilds the plan
        when asked for an epoch the current plan doesn't cover."""
        if epoch != getattr(self, "_plan_epoch", None):
            self.epoch_number = epoch
            self._build_epoch_plan()
        return self._shuffled[TRAIN]
