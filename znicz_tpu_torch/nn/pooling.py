"""Pooling forward units (port of ``znicz_tpu/nn/pooling.py``).

``MaxPooling`` and ``MaxAbsPooling`` record in ``input_offset`` the
winner's dense window slot ``t = i·kw + j`` per output element, which
``GDMaxPooling`` and a tied ``Depooling`` consume; ``AvgPooling`` records
nothing.  ``torch_run`` selects through ``ops.pooling`` (the pool-select
kernel on the card); average pooling stays plain PyTorch, as XLA runs it
in the reference.  Stochastic pooling is not ported yet (ROADMAP.md queue
1 item 5a): its layer types have no unit here."""

from __future__ import annotations

import numpy as np

from ..memory import Vector
from ..ops import pooling as pool_ops
from ..ops.geometry import norm2
from .nn_units import Forward


class Pooling(Forward):
    """Shared geometry: kx/ky window, sliding (default: the window),
    padding; no parameters."""

    MAPPING: tuple[str, ...] = ()

    def __init__(self, workflow=None, name=None, kx=None, ky=None,
                 sliding=None, padding=0, **kwargs):
        kwargs["include_bias"] = False
        super().__init__(workflow, name, **kwargs)
        if kx is None:
            raise ValueError("kx is required")
        self.kx = int(kx)
        self.ky = int(ky if ky is not None else kx)
        self.ksize = (self.ky, self.kx)
        self.sliding = norm2(sliding) if sliding is not None else self.ksize
        self.padding = norm2(padding)

    def output_shape_for(self, x_shape) -> tuple[int, ...]:
        return pool_ops.pool_out_shape(x_shape, self.ksize, self.sliding,
                                       self.padding)

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device, **kwargs)
        if len(self.input.shape) != 4:
            raise ValueError(f"{self.name}: pooling expects NHWC input, "
                             f"got {self.input.shape}")
        if not self.output:
            self.output.mem = np.zeros(
                self.output_shape_for(self.input.shape), np.float32)
        self.init_vectors(self.output)


class MaxPooling(Pooling):
    """Max pooling; ``input_offset`` holds each window's winner slot."""

    MAPPING = ("max_pooling",)
    USE_ABS = False

    def __init__(self, workflow=None, name=None, **kwargs):
        super().__init__(workflow, name, **kwargs)
        self.input_offset = Vector()

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device, **kwargs)
        if not self.input_offset:
            self.input_offset.mem = np.zeros(self.output.shape, np.int32)
        self.init_vectors(self.input_offset)

    def numpy_run(self) -> None:
        fn = (pool_ops.np_maxabs_pooling if self.USE_ABS
              else pool_ops.np_max_pooling)
        self.output.mem, self.input_offset.mem = fn(
            self.input.mem, self.ksize, self.sliding, self.padding)

    def torch_run(self) -> None:
        fn = (pool_ops.maxabs_pooling if self.USE_ABS
              else pool_ops.max_pooling)
        self.output.devmem, self.input_offset.devmem = fn(
            self.input.devmem, self.ksize, self.sliding, self.padding)


class MaxAbsPooling(MaxPooling):
    """Winner is the max |value|; the output keeps its sign."""

    MAPPING = ("maxabs_pooling",)
    USE_ABS = True


class AvgPooling(Pooling):
    MAPPING = ("avg_pooling",)

    def numpy_run(self) -> None:
        self.output.mem = pool_ops.np_avg_pooling(
            self.input.mem, self.ksize, self.sliding, self.padding)

    def torch_run(self) -> None:
        self.output.devmem = pool_ops.avg_pooling(
            self.input.devmem, self.ksize, self.sliding, self.padding)
