"""AcceleratedUnit: backend-dispatching compute units (port of
``znicz_tpu/accelerated_units.py``).

``run()`` dispatches on the bound device:

* ``numpy_run`` — the golden host implementation, on the numpy device;
* ``torch_run`` — the counterpart of the reference's ``xla_run``: the
  same math on the unit's tensors, on the CPU or the CUDA card, where the
  ops with hand-written kernels (``ops.matmul``, ``ops.update``,
  ``ops.softmax``) launch them.

The reference's ``jit`` cache has no counterpart: PyTorch runs eagerly."""

from __future__ import annotations

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
