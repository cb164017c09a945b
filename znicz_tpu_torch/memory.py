"""``Vector``: the unit graph's tensor buffer (port of
``znicz_tpu/memory.py``).

A host numpy array paired with a ``torch.Tensor`` on the workflow's
device, with the reference's ``map_read / map_write / map_invalidate /
unmap`` coherence protocol and ``initialize(device)``.  Ownership is a
two-state flag, as in the reference:

* host-owned: ``mem`` (numpy) is authoritative; the tensor is stale or
  absent;
* device-owned: ``devmem`` (a tensor) is authoritative.

The host array and the tensor never share storage.  On the CPU,
``tensor.numpy()`` and ``torch.from_numpy`` alias their memory, so a host
write through ``.mem`` would silently change a tensor that other units
(or the fused trainer) still hold, and a device-side update would change
host memory behind the flag.  So every transfer copies: ``map_read`` hands
out a host copy, ``map_write`` drops the tensor before the host mutates,
and ``unmap`` uploads a copy.

On the numpy device (``backends.NumpyDevice``, or no device) the tensor
is never made: ``devmem`` is the host array itself."""

from __future__ import annotations

import numpy as np
import torch

from .backends import Device


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` that shares no storage with it."""
    return t.detach().to("cpu", copy=True).numpy()


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype."""
    return torch.empty((), dtype=dtype).numpy().dtype


class Vector:
    """Host+device tensor with explicit (but safe) coherence."""

    def __init__(self, data=None, dtype=None):
        self._mem: np.ndarray | None = None
        self._devmem: torch.Tensor | None = None
        self._device: Device | None = None
        self._host_owned = True
        if data is not None:
            self._mem = np.asarray(data, dtype=dtype)

    def initialize(self, device: Device | None) -> "Vector":
        """Bind to a device; upload if it is a torch device."""
        self._device = device
        if self._mem is not None and self._on_torch:
            self.unmap()
        return self

    @property
    def _on_torch(self) -> bool:
        return self._device is not None and self._device.is_torch

    # -- properties ------------------------------------------------------------
    @property
    def mem(self) -> np.ndarray:
        """Host view; implicitly maps for read."""
        if self._mem is None or not self._host_owned:
            self.map_read()
        return self._mem

    @mem.setter
    def mem(self, value):
        self._mem = None if value is None else np.asarray(value)
        self._devmem = None
        self._host_owned = True

    @property
    def devmem(self):
        """The device tensor (the host array on the numpy device);
        implicitly unmaps."""
        self.unmap()
        return self._devmem if self._devmem is not None else self._mem

    @devmem.setter
    def devmem(self, value: torch.Tensor):
        """Direct device-side store (the units' ``torch_run`` bodies)."""
        self._devmem = value
        self._host_owned = False

    def _src(self):
        return self._mem if self._host_owned or self._devmem is None \
            else self._devmem

    @property
    def shape(self):
        src = self._src()
        return tuple(src.shape) if src is not None else None

    @property
    def dtype(self) -> np.dtype | None:
        """numpy dtype of the contents, wherever they live."""
        src = self._src()
        if src is None:
            return None
        if isinstance(src, torch.Tensor):
            return numpy_dtype(src.dtype)
        return src.dtype

    def __bool__(self) -> bool:
        return self._mem is not None or self._devmem is not None

    def __len__(self) -> int:
        sh = self.shape
        if sh is None:
            return 0
        if len(sh) == 0:
            raise TypeError("len() of a scalar Vector")
        return sh[0]

    # -- coherence protocol (reference API) ------------------------------------
    def map_read(self) -> "Vector":
        if not self._host_owned and self._devmem is not None:
            self._mem = _to_host(self._devmem)
            self._host_owned = True   # device copy still valid until write
        return self

    def map_write(self) -> "Vector":
        self.map_read()
        if self._mem is not None and not self._mem.flags.writeable:
            self._mem = self._mem.copy()
        self._devmem = None           # host will mutate: drop the tensor
        return self

    def map_invalidate(self) -> "Vector":
        """Host will overwrite entirely — skip the device→host copy."""
        if self._mem is None and self._devmem is not None:
            self._mem = np.empty(tuple(self._devmem.shape),
                                 self.dtype)
        self._devmem = None
        self._host_owned = True
        return self

    def unmap(self) -> "Vector":
        """Upload a copy of the host data (no-op when the tensor is still
        valid, e.g. after a pure map_read, or on the numpy device)."""
        if self._host_owned and self._mem is not None:
            if self._devmem is None and self._on_torch:
                host = torch.from_numpy(np.array(self._mem, order="C",
                                                 copy=True))
                self._devmem = host.to(self._device.torch_device)
            self._host_owned = self._devmem is None
        return self

    def __repr__(self):
        own = "host" if self._host_owned else "device"
        return f"Vector(shape={self.shape}, dtype={self.dtype}, owner={own})"
