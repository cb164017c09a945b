"""Pooling forward units (port of ``znicz_tpu/nn/pooling.py``).

``MaxPooling``, ``MaxAbsPooling`` and the stochastic pools record in
``input_offset`` the winner's dense window slot ``t = i·kw + j`` per
output element, which ``GDMaxPooling`` and a tied ``Depooling`` consume;
``AvgPooling`` records nothing.  ``torch_run`` selects through
``ops.pooling`` (the pool-select kernel on the card); average pooling and
the stochastic pools' draw stay plain PyTorch, as XLA runs them in the
reference.  A stochastic pool draws its uniforms from the counter RNG of
the ``"pooling"`` stream at (crc32 of the unit's name, the loader's
epoch, its minibatch offset), so every tier picks the same taps, and
takes the deterministic weighted mean on validation and test
minibatches."""

from __future__ import annotations

import zlib

import numpy as np

from .. import prng
from ..loader.base import TRAIN
from ..memory import Vector
from ..ops import pooling as pool_ops
from ..ops.geometry import norm2
from .nn_units import Forward, loader_counters, unit_loader


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


class _OffsetPooling(Pooling):
    """Pooling that records each window's winner slot for the backward
    scatter."""

    USE_ABS = False

    def __init__(self, workflow=None, name=None, **kwargs):
        super().__init__(workflow, name, **kwargs)
        self.input_offset = Vector()

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device, **kwargs)
        if not self.input_offset:
            self.input_offset.mem = np.zeros(self.output.shape, np.int32)
        self.init_vectors(self.input_offset)


class MaxPooling(_OffsetPooling):
    """Max pooling; ``input_offset`` holds each window's winner slot."""

    MAPPING = ("max_pooling",)

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


class StochasticPooling(_OffsetPooling):
    """Zeiler–Fergus stochastic pooling: on a train minibatch a window
    element drawn in proportion to max(x, 0), on the others the
    probability-weighted mean (the reference's semantics)."""

    MAPPING = ("stochastic_pooling",)

    def __init__(self, workflow=None, name=None, **kwargs):
        super().__init__(workflow, name, **kwargs)
        self.rng = prng.get("pooling")
        # the full name's hash: distinct units draw distinct streams
        self.unit_id = zlib.crc32((self.name or "pool").encode())

    def _is_training(self) -> bool:
        loader = unit_loader(self)
        return loader is None or loader.minibatch_class == TRAIN

    def numpy_run(self) -> None:
        det = not self._is_training()
        u = None if det else pool_ops.stochastic_uniform(
            self.rng.stream_seed, loader_counters(self),
            self.output.shape).numpy()
        self.output.mem, self.input_offset.mem = \
            pool_ops.np_stochastic_pooling(
                self.input.mem, self.ksize, self.sliding, self.padding, u,
                use_abs=self.USE_ABS, deterministic=det)

    def torch_run(self) -> None:
        det = not self._is_training()
        x = self.input.devmem
        u = None if det else pool_ops.stochastic_uniform(
            self.rng.stream_seed, loader_counters(self), self.output.shape,
            x.device)
        self.output.devmem, self.input_offset.devmem = \
            pool_ops.stochastic_pooling(
                x, self.ksize, self.sliding, self.padding, u,
                use_abs=self.USE_ABS, deterministic=det)


class StochasticAbsPooling(StochasticPooling):
    """Stochastic pooling in proportion to |x|."""

    MAPPING = ("stochastic_abs_pooling",)
    USE_ABS = True
