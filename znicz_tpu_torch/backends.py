"""Device selection (port of ``znicz_tpu/backends.py``).

``Device.create("auto"|"cuda"|"cpu")`` mirrors the reference's backend
flag.  ``"auto"`` means the card: the port runs on CUDA unless the caller
asks for the CPU, and without a CUDA device it raises instead of carrying
on quietly on the host."""

from __future__ import annotations

import torch


class Device:
    """A ``torch.device`` the port's entry points run on."""

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
        raise ValueError(f"unknown backend {backend!r}; known: auto, cuda, "
                         "cpu")

    def __repr__(self):
        return f"Device({self.torch_device})"


def resolve(device=None) -> torch.device:
    """The ``torch.device`` for an entry point's ``device`` argument:
    ``None``/``"auto"`` mean CUDA (raising without it), a string is a
    backend name or a torch device spec, a :class:`Device` or
    ``torch.device`` passes through."""
    if isinstance(device, Device):
        return device.torch_device
    if isinstance(device, torch.device):
        if device.type == "cuda" and not torch.cuda.is_available():
            return Device.create("cuda").torch_device   # raises
        return device
    if device is None or device in ("auto", "cuda", "cpu"):
        return Device.create(device or "auto").torch_device
    return resolve(torch.device(device))
