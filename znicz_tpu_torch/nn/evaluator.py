"""Evaluators: loss + error statistics at the end of the forward chain
(port of ``znicz_tpu/nn/evaluator.py``).

``EvaluatorSoftmax`` scores All2AllSoftmax's probabilities: the
cross-entropy from the probabilities (``−log(max(p, 1e-30))``, not the
fused path's log-softmax), the minibatch's error count, a per-epoch
confusion matrix and ``err_output = (y − onehot)/batch`` with the padded
rows of a short minibatch zeroed, which the last GD unit consumes.

``EvaluatorMSE`` scores a regression output against ``target``:
``err_output = (y − target)/batch`` (padded rows zeroed) and the
minibatch's mean squared error.

Their metrics are host scalars that Decision reads on every tick, so they
run on the host on every device, as the reference's ``xla_run`` does:
they map ``output`` and the labels or targets down and ``err_output`` is
uploaded when the GD unit reads it."""

from __future__ import annotations

import numpy as np

from ..accelerated_units import AcceleratedUnit
from ..memory import Vector
from ..ops import softmax as softmax_ops


class EvaluatorBase(AcceleratedUnit):
    def __init__(self, workflow=None, name=None, **kwargs):
        super().__init__(workflow, name, **kwargs)
        self.err_output = Vector()
        self.mean_loss = 0.0

    @property
    def batch_size(self) -> int:
        return self.loader.minibatch_size

    def link_loader(self, loader) -> None:
        self.loader = loader


class EvaluatorSoftmax(EvaluatorBase):
    """Cross-entropy evaluator over All2AllSoftmax output.

    Inputs (linked): ``output`` (softmax probs), ``max_idx``, ``labels``.
    Outputs: ``err_output`` = (y − onehot)/batch (padded rows zeroed),
    ``n_err`` (this minibatch's miss count), ``confusion_matrix``,
    ``max_err_output_sum``."""

    def __init__(self, workflow=None, name=None, compute_confusion=True,
                 **kwargs):
        super().__init__(workflow, name, **kwargs)
        self.n_err = 0
        self.compute_confusion = compute_confusion
        self.confusion_matrix = Vector()
        self.max_err_output_sum = 0.0

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device, **kwargs)
        n_classes = self.output.shape[1]
        if self.compute_confusion and not self.confusion_matrix:
            self.confusion_matrix.mem = np.zeros((n_classes, n_classes),
                                                 np.int64)
        self.init_vectors(self.err_output, self.confusion_matrix)
        self._confusion_epoch = -1

    def numpy_run(self) -> None:
        bs = self.batch_size
        y = self.output.mem
        labels = self.labels.mem.astype(np.int64)
        loss, err = softmax_ops.np_softmax_ce(y[:bs], labels[:bs])
        full = np.zeros(y.shape, np.float32)
        full[:bs] = err / bs
        self.err_output.mem = full
        pred = self.max_idx.mem[:bs]
        self.n_err = int(np.sum(pred != labels[:bs]))
        self.mean_loss = float(loss.mean())
        self.max_err_output_sum = float(np.abs(full).sum(axis=1).max())
        if self.compute_confusion:
            epoch = getattr(self.loader, "epoch_number", 0)
            self.confusion_matrix.map_write()
            if epoch != self._confusion_epoch:   # fresh matrix per epoch
                self.confusion_matrix.mem[...] = 0
                self._confusion_epoch = epoch
            np.add.at(self.confusion_matrix.mem, (labels[:bs], pred), 1)


class EvaluatorMSE(EvaluatorBase):
    """Mean-squared-error evaluator: ``err_output`` = (y − target)/batch
    (padded rows zeroed), ``mse`` the minibatch's mean over samples of
    the mean over features of (y − target)²."""

    def __init__(self, workflow=None, name=None, **kwargs):
        super().__init__(workflow, name, **kwargs)
        self.mse = 0.0
        self.n_err = 0   # uniform Decision interface: the rows scored

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device, **kwargs)
        self.init_vectors(self.err_output)

    def numpy_run(self) -> None:
        bs = self.batch_size
        y = self.output.mem.reshape(len(self.output.mem), -1)
        t = self.target.mem.reshape(y.shape)
        diff = y[:bs] - t[:bs]
        err = np.zeros(y.shape, np.float32)
        err[:bs] = diff / bs
        self.err_output.mem = err.reshape(self.output.shape)
        self.mse = float((diff ** 2).mean(axis=1).mean())
        self.mean_loss = self.mse
        self.n_err = int(bs)
