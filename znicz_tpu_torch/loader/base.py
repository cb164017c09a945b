"""Loader base: minibatch scheduling over test/valid/train sets (port of
``znicz_tpu/loader/base.py``).

Class indices 0=test, 1=validation, 2=train; the resident dataset is laid
out ``[test | valid | train]``.  Each epoch's train order is a shuffle of
the global train indices drawn from the ``"loader"`` stream in the same
order as the reference, so both packages walk identical minibatches.

The loader is the unit graph's first unit: each ``run()`` serves the next
minibatch of the epoch plan (test → valid → train, the last minibatch of a
class possibly short) into the ``minibatch_data`` / ``minibatch_labels`` /
``minibatch_indices`` Vectors and sets ``minibatch_class``,
``minibatch_size``, ``last_minibatch`` and ``epoch_ended``, which the
evaluator and Decision read.  The fused path reads the epoch plan
(``_build_epoch_plan``, ``_shuffled``, ``train_permutation``) and the
resident tensors directly.  A snapshot stores :meth:`resume_epoch` and a
restore rebuilds that epoch's plan (:meth:`reset_state`) from the
restored ``"loader"`` stream, so the shuffles continue where the saved run
left them."""

from __future__ import annotations

import numpy as np

from .. import backends, prng
from ..memory import Vector
from ..mutable import Bool
from ..units import Unit

TEST, VALID, TRAIN = 0, 1, 2
CLASS_NAMES = ("test", "validation", "train")


class Loader(Unit):
    """Minibatch scheduler; subclasses provide the data and fill the
    minibatch."""

    def __init__(self, workflow=None, name=None, minibatch_size=100,
                 shuffle_limit=np.inf, **kwargs):
        super().__init__(workflow, name or "loader", **kwargs)
        self.max_minibatch_size = int(minibatch_size)
        self.minibatch_size = int(minibatch_size)
        self.class_lengths = [0, 0, 0]
        self.epoch_number = 0
        self.minibatch_class = TRAIN
        self.minibatch_offset = 0
        self.minibatch_data = Vector()
        self.minibatch_labels = Vector()
        self.minibatch_indices = Vector()
        self.last_minibatch = Bool(False)
        self.epoch_ended = Bool(False)
        self.shuffle_limit = shuffle_limit
        self.device: backends.Device | None = None
        self._order: list[tuple[int, int]] = []   # (class, offset) queue
        self._pos = 0
        self._shuffled: dict[int, np.ndarray] = {}
        self.prng = prng.get("loader")

    # -- subclass API ----------------------------------------------------------
    def load_data(self) -> None:
        """Populate class_lengths + backing data.  Subclass hook."""
        raise NotImplementedError

    def fill_minibatch(self, indices: np.ndarray, klass: int) -> None:
        """Copy rows ``indices`` into minibatch_data/labels.  Subclass
        hook."""
        raise NotImplementedError

    # -- scheduling ------------------------------------------------------------
    def initialize(self, device=None, **kwargs) -> None:
        """Load the data for ``device`` (a backend name, ``torch.device``
        or :class:`~znicz_tpu_torch.backends.Device`) and plan epoch 0."""
        super().initialize(backends.get(device), **kwargs)
        self.load_data()
        self.total_samples = int(sum(self.class_lengths))
        if self.class_lengths[TRAIN] <= 0:
            raise ValueError("loader has no training samples")
        for v in (self.minibatch_data, self.minibatch_labels,
                  self.minibatch_indices):
            v.initialize(self.device)
        self._build_epoch_plan()

    def _class_indices(self, klass: int) -> np.ndarray:
        start = int(sum(self.class_lengths[:klass]))
        idx = np.arange(start, start + self.class_lengths[klass])
        if klass == TRAIN and self.epoch_number < self.shuffle_limit:
            idx = idx.copy()
            self.prng.shuffle(idx)
        return idx

    def _build_epoch_plan(self) -> None:
        """This epoch's index order per class and its minibatch queue
        (test, valid, train: the reference's draw order on the
        ``"loader"`` stream)."""
        self._order = []
        self._shuffled = {}
        for klass in (TEST, VALID, TRAIN):
            n = self.class_lengths[klass]
            if n == 0:
                continue
            self._shuffled[klass] = self._class_indices(klass)
            for off in range(0, n, self.max_minibatch_size):
                self._order.append((klass, off))
        self._pos = 0
        self._plan_epoch = self.epoch_number

    def train_permutation(self, epoch: int) -> np.ndarray:
        """Shuffled global train indices for ``epoch``; rebuilds the plan
        when asked for an epoch the current plan doesn't cover."""
        if epoch != getattr(self, "_plan_epoch", None):
            self.epoch_number = epoch
            self._build_epoch_plan()
        return self._shuffled[TRAIN]

    def resume_epoch(self) -> int:
        """The epoch a run restored from this state starts: this one, or
        the next once this epoch's plan has been served (the unit graph's
        last tick of an epoch; the fused loop moves ``epoch_number`` on
        itself)."""
        served = bool(self._order) and self._pos >= len(self._order)
        return self.epoch_number + int(served)

    def reset_state(self) -> None:
        """For a resume: rebuild the plan at the stored ``epoch_number``,
        drawing its shuffle from the (restored) ``"loader"`` stream."""
        self._build_epoch_plan()

    def run(self) -> None:
        """Serve the next minibatch of the plan (a new epoch's plan after
        the last one)."""
        if self._pos >= len(self._order):          # new epoch
            self.epoch_number += 1
            self._build_epoch_plan()
        klass, off = self._order[self._pos]
        n = self.class_lengths[klass]
        size = min(self.max_minibatch_size, n - off)
        indices = self._shuffled[klass][off:off + size]
        self.minibatch_class = klass
        self.minibatch_offset = off + size
        self.minibatch_size = int(size)
        self.fill_minibatch(indices, klass)
        self.minibatch_indices.mem = indices
        self._pos += 1
        self.last_minibatch.set(self._pos >= len(self._order))
        self.epoch_ended.set(bool(self.last_minibatch))
