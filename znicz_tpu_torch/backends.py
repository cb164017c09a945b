"""Device selection (port of ``znicz_tpu/backends.py``).

``Device.create("auto"|"cuda"|"cpu"|"numpy")`` mirrors the reference's
backend flag.  ``"auto"`` means the card: the port runs on CUDA unless the
caller asks for the CPU, and without a CUDA device it raises instead of
carrying on quietly on the host.

* ``"cuda"`` / ``"cpu"`` — torch devices; the unit graph runs each unit's
  ``torch_run`` on tensors there (the reference's ``xla_run``), and the
  fused path trains there.
* ``"numpy"`` — the reference's golden ``NumpyDevice``: units run
  ``numpy_run`` on host arrays.  It is taken only when asked for; the
  loader's resident tensors then stay on the CPU."""

from __future__ import annotations

import torch


class Device:
    """A ``torch.device`` the port's entry points run on."""

    #: True when units run ``torch_run`` (the accelerated path).
    is_torch = True

    def __init__(self, device: torch.device):
        self.torch_device = torch.device(device)

    @staticmethod
    def create(backend: str = "auto") -> "Device":
        if backend in ("auto", "cuda"):
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"Device.create({backend!r}) needs a CUDA device and "
                    "this host has none; pass device=\"cpu\" (CLI: "
                    "--device cpu) to run on the CPU")
            return Device(torch.device("cuda", torch.cuda.current_device()))
        if backend == "cpu":
            return Device(torch.device("cpu"))
        if backend == "numpy":
            return NumpyDevice()
        raise ValueError(f"unknown backend {backend!r}; known: auto, cuda, "
                         "cpu, numpy")

    def __repr__(self):
        return f"{type(self).__name__}({self.torch_device})"


class NumpyDevice(Device):
    """Host numpy execution — the reference's golden path.  Its
    ``torch_device`` (the CPU) is where the loader keeps its resident
    tensors."""

    is_torch = False

    def __init__(self):
        super().__init__(torch.device("cpu"))


def get(device=None) -> Device:
    """The :class:`Device` for an entry point's ``device`` argument:
    ``None``/``"auto"`` mean CUDA (raising without it), a string is a
    backend name or a torch device spec, a :class:`Device` passes
    through, a ``torch.device`` is wrapped."""
    if isinstance(device, Device):
        return device
    if isinstance(device, torch.device):
        if device.type == "cuda" and not torch.cuda.is_available():
            return Device.create("cuda")   # raises
        return Device(device)
    if device is None or device in ("auto", "cuda", "cpu", "numpy"):
        return Device.create(device or "auto")
    return get(torch.device(device))


def resolve(device=None) -> torch.device:
    """The ``torch.device`` of :func:`get`'s device."""
    return get(device).torch_device
