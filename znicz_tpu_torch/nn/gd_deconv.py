"""Backprop units for the transposed convolution (port of
``znicz_tpu/nn/gd_deconv.py``).

By the adjoint relation the gradients are conv ops (``ops.deconv``):
``err_input`` is the conv of err_y with the weights, ``∇W`` the conv
weight gradient with err_y and the deconv input in swapped roles.  W (the
encoder conv's own Vector when the deconv is tied; this unit keeps its
own velocity) and b update through ``ops.update.sgd_update`` (the fused
update kernel on the card)."""

from __future__ import annotations

from ..ops import activations, deconv as deconv_ops
from .nn_units import GradientDescentBase


class GDDeconv(GradientDescentBase):
    """Gradient unit for Deconv (linear activation)."""

    MAPPING = ("deconv",)
    ACTIVATION = activations.Activation

    def setup_from_forward(self, fwd) -> "GDDeconv":
        super().setup_from_forward(fwd)
        self.sliding, self.padding = fwd.sliding, fwd.padding
        return self

    def numpy_run(self) -> None:
        y = self.output.mem
        err_y = activations.NUMPY[self.ACTIVATION.name][1](
            self.err_output.mem.reshape(y.shape), y)
        gw = deconv_ops.np_deconv2d_grad_weights(
            err_y, self.input.mem, self.weights.shape, self.sliding,
            self.padding)
        gb = err_y.sum(axis=(0, 1, 2)) if self.include_bias else None
        if self.need_err_input:
            self.err_input.mem = deconv_ops.np_deconv2d_grad_input(
                err_y, self.weights.mem, self.sliding, self.padding)
        self._apply_numpy(gw, gb)

    def torch_run(self) -> None:
        x, y = self.input.devmem, self.output.devmem
        err_y = self.ACTIVATION.bwd(
            self.err_output.devmem.reshape(y.shape), y,
            x if self.ACTIVATION.needs_input else None)
        w = self.weights.devmem
        gw = deconv_ops.deconv2d_grad_weights(err_y, x, tuple(w.shape),
                                              self.sliding, self.padding)
        gb = err_y.sum(dim=(0, 1, 2)) if self.include_bias else None
        if self.need_err_input:
            self.err_input.devmem = deconv_ops.deconv2d_grad_input(
                err_y, w, self.sliding, self.padding)
        self._apply_torch(gw, gb)


class GDDeconvTanh(GDDeconv):
    MAPPING = ("deconv_tanh",)
    ACTIVATION = activations.Tanh


class GDDeconvSigmoid(GDDeconv):
    MAPPING = ("deconv_sigmoid",)
    ACTIVATION = activations.Sigmoid
