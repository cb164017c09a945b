"""Depooling (unpooling) forward and gradient units, the decoder's (port of
``znicz_tpu/nn/depooling.py``).

``Depooling.tie(pool)`` links the max pool's ``input_offset`` Vector
itself (the same object, so each tick's winners are the pool's of that
tick) and its geometry; ``run`` scatters each input value back to its
winner slot, restoring the pool's input shape (the pool-scatter kernel on
the card, as the reference's depooling runs ``pallas_pool_scatter``).
``GDDepooling`` gathers ``err_output`` back through the same offsets (the
pool-gather kernel on the card)."""

from __future__ import annotations

import numpy as np

from ..ops import pooling as pool_ops
from .nn_units import Forward, GradientDescentBase


class Depooling(Forward):
    """Scatter the input through the tied pooling unit's winner slots;
    the output has the tied pool's input shape."""

    MAPPING = ("depooling",)

    def __init__(self, workflow=None, name=None, **kwargs):
        kwargs["include_bias"] = False
        super().__init__(workflow, name, **kwargs)
        self.pool_unit = None

    def tie(self, pool) -> "Depooling":
        if not hasattr(pool, "input_offset"):
            raise ValueError(f"{self.name}: tied unit {pool.name} records "
                             "no winner offsets (avg pooling cannot be "
                             "depooled)")
        self.pool_unit = pool
        self.link_attrs(pool, "input_offset")
        self.ksize, self.sliding, self.padding = (pool.ksize, pool.sliding,
                                                  pool.padding)
        return self

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device, **kwargs)
        if self.pool_unit is None:
            raise ValueError(f"{self.name}: Depooling requires tie(pool)")
        if tuple(self.input.shape) != tuple(self.pool_unit.output.shape):
            raise ValueError(
                f"{self.name}: input shape {tuple(self.input.shape)} != "
                f"tied pool output {tuple(self.pool_unit.output.shape)}")
        if not self.output:
            self.output.mem = np.zeros(self.pool_unit.input.shape,
                                       np.float32)
        self.init_vectors(self.output)

    def numpy_run(self) -> None:
        out_shape = (len(self.input.mem),) + tuple(self.output.shape[1:])
        self.output.mem = pool_ops.np_depooling(
            self.input.mem, self.input_offset.mem, out_shape, self.ksize,
            self.sliding, self.padding)

    def torch_run(self) -> None:
        self.output.devmem = pool_ops.depooling(
            self.input.devmem, self.input_offset.devmem, self.output.shape,
            self.ksize, self.sliding, self.padding)


class GDDepooling(GradientDescentBase):
    """Gather err_output back through the winner slots (the adjoint of
    the depooling scatter); no parameters."""

    MAPPING = ("depooling",)

    def setup_from_forward(self, fwd) -> "GDDepooling":
        super().setup_from_forward(fwd)
        self.link_attrs(fwd, "input_offset")
        self.ksize, self.sliding, self.padding = (fwd.ksize, fwd.sliding,
                                                  fwd.padding)
        self.include_bias = False
        return self

    def numpy_run(self) -> None:
        if self.need_err_input:
            self.err_input.mem = pool_ops.np_gd_depooling(
                self.err_output.mem.reshape(self.output.shape),
                self.input_offset.mem, self.ksize, self.sliding,
                self.padding)

    def torch_run(self) -> None:
        if self.need_err_input:
            self.err_input.devmem = pool_ops.gd_depooling(
                self.err_output.devmem.reshape(self.output.shape),
                self.input_offset.devmem, self.ksize, self.sliding,
                self.padding)
