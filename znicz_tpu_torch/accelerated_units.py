"""AcceleratedUnit: backend-dispatching compute units (port of
``znicz_tpu/accelerated_units.py``).

``run()`` dispatches on the bound device:

* ``numpy_run`` — the golden host implementation, on the numpy device;
* ``torch_run`` — the counterpart of the reference's ``xla_run``: the
  same math on the unit's tensors, on the CPU or the CUDA card, where the
  ops with hand-written kernels (``ops.matmul``, ``ops.update``,
  ``ops.softmax``) launch them.

The reference's ``jit`` cache has no counterpart: PyTorch runs eagerly.
``AcceleratedWorkflow`` records each epoch's wall time of the tick loop in
``epoch_timings``."""

from __future__ import annotations

import time

from .loader.base import TRAIN
from .memory import Vector
from .units import Unit
from .workflow import Workflow


class AcceleratedUnit(Unit):
    """A unit whose ``run()`` dispatches on the bound device backend."""

    def run(self) -> None:
        device = getattr(self, "device", None)
        if device is not None and device.is_torch:
            self.torch_run()
        else:
            self.numpy_run()

    def numpy_run(self) -> None:
        raise NotImplementedError(
            f"{type(self).__name__} must implement numpy_run")

    def torch_run(self) -> None:
        """Default accelerated path: the golden path, for units whose work
        is host-side by design."""
        self.numpy_run()

    @property
    def current_batch_size(self) -> int:
        """Rows of the minibatch that are real (the loader pads short
        ones); falls back to the unit's own tensors outside a workflow."""
        wf = self.workflow
        loader = getattr(wf, "loader", None) if wf is not None else None
        if loader is not None:
            return loader.minibatch_size
        for attr in ("input", "output"):
            try:
                v = getattr(self, attr)
            except AttributeError:
                continue
            if v:
                return len(v)
        raise AttributeError(f"{self.name}: no loader/input/output to "
                             "infer the batch size from")

    # -- Vector helpers --------------------------------------------------------
    def init_vectors(self, *vectors: Vector) -> None:
        for v in vectors:
            v.initialize(self.device)


class AcceleratedWorkflow(Workflow):
    """Workflow whose units share one accelerated device (reference
    parity; the device is bound in initialize)."""

    def __init__(self, workflow=None, name=None, **kwargs):
        super().__init__(workflow, name, **kwargs)
        #: per-epoch throughput of the tick loop (a fused loop appends its
        #: own); kept out of the metrics dicts so those stay comparable
        #: with the reference
        self.epoch_timings: list[dict] = []

    def run(self, max_ticks: int | None = None) -> None:
        """The tick loop (:meth:`Workflow.run`), recording each epoch's
        wall time in ``epoch_timings``."""
        self._epoch_t0 = time.monotonic()
        super().run(max_ticks)

    def run_tick(self):
        fired = super().run_tick()
        loader = getattr(self, "loader", None)
        if loader is not None and loader in fired \
                and bool(loader.epoch_ended):
            now = time.monotonic()
            wall, self._epoch_t0 = now - self._epoch_t0, now
            ticks = len(loader._order)
            self.epoch_timings.append({
                "epoch": loader.epoch_number, "wall_s": wall,
                "ticks": ticks, "tick_ms": wall / ticks * 1e3,
                "train_examples_per_sec":
                    loader.class_lengths[TRAIN] / wall})
        return fired
