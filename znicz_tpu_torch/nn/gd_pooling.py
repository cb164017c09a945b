"""Pooling backprop units (port of ``znicz_tpu/nn/gd_pooling.py``).

``GDMaxPooling`` adds ``err_output`` at each window's recorded winner slot
(the pool-scatter kernel on the card); ``GDAvgPooling`` spreads it evenly
over each window (plain PyTorch, as XLA runs it in the reference).  They
have no parameters: each only produces ``err_input``, and not even that
without ``need_err_input``."""

from __future__ import annotations

from ..ops import pooling as pool_ops
from .nn_units import GradientDescentBase


class GDPoolingBase(GradientDescentBase):
    """The forward's geometry; no weights to update."""

    def setup_from_forward(self, fwd) -> "GDPoolingBase":
        super().setup_from_forward(fwd)
        self.ksize, self.sliding, self.padding = (fwd.ksize, fwd.sliding,
                                                  fwd.padding)
        self.include_bias = False
        return self


class GDMaxPooling(GDPoolingBase):
    """Scatter to the stored winner slot (max and max-abs pooling)."""

    MAPPING = ("max_pooling",)

    def setup_from_forward(self, fwd) -> "GDMaxPooling":
        super().setup_from_forward(fwd)
        self.link_attrs(fwd, "input_offset")
        return self

    def numpy_run(self) -> None:
        if self.need_err_input:
            self.err_input.mem = pool_ops.np_gd_max_pooling(
                self.err_output.mem.reshape(self.output.shape),
                self.input_offset.mem, self.input.shape, self.ksize,
                self.sliding, self.padding)

    def torch_run(self) -> None:
        if self.need_err_input:
            self.err_input.devmem = pool_ops.gd_max_pooling(
                self.err_output.devmem.reshape(self.output.shape),
                self.input_offset.devmem, self.input.shape, self.ksize,
                self.sliding, self.padding)


class GDMaxAbsPooling(GDMaxPooling):
    MAPPING = ("maxabs_pooling",)


class GDAvgPooling(GDPoolingBase):
    MAPPING = ("avg_pooling",)

    def numpy_run(self) -> None:
        if self.need_err_input:
            self.err_input.mem = pool_ops.np_gd_avg_pooling(
                self.err_output.mem.reshape(self.output.shape),
                self.input.shape, self.ksize, self.sliding, self.padding)

    def torch_run(self) -> None:
        if self.need_err_input:
            self.err_input.devmem = pool_ops.gd_avg_pooling(
                self.err_output.devmem.reshape(self.output.shape),
                self.input.shape, self.ksize, self.sliding, self.padding)
