"""Backprop units for convolution layers (port of
``znicz_tpu/nn/gd_conv.py``).

``err_y = act.bwd(err_output, y)``; ``∇W`` = the conv weight gradient of
x and err_y; ``∇b = Σ err_y`` over batch and positions; ``err_input`` =
the conv input gradient (only when ``need_err_input``: the first layer's
is never read, so no data-gradient conv runs there), then the
momentum-SGD update of W and b in one ``ops.update.sgd_update_many`` call
(one launch of the fused update kernel on the card).  ``torch_run`` takes
the gradients from ``ops.conv`` (its tier: cuDNN on the card, or the
implicit-GEMM kernels under ``ZNICZ_TPU_CONV=pallas``) and err_y from
``ops.activations.apply_bwd`` (the elementwise kernel on the card, none
for the linear one); ``numpy_run`` is the im2col/col2im golden."""

from __future__ import annotations

from ..ops import activations, conv as conv_ops
from .nn_units import GradientDescentBase


class GradientDescentConv(GradientDescentBase):
    """Gradient unit for Conv (linear activation)."""

    MAPPING = ("conv",)
    ACTIVATION = activations.Activation

    def setup_from_forward(self, fwd) -> "GradientDescentConv":
        super().setup_from_forward(fwd)
        self.sliding, self.padding = fwd.sliding, fwd.padding
        return self

    def numpy_run(self) -> None:
        y = self.output.mem
        err_y = activations.NUMPY[self.ACTIVATION.name][1](
            self.err_output.mem.reshape(y.shape), y)
        x = self.input.mem
        gw = conv_ops.np_conv2d_grad_weights(
            x, err_y, self.weights.shape, self.sliding, self.padding)
        gb = err_y.sum(axis=(0, 1, 2)) if self.include_bias else None
        if self.need_err_input:
            self.err_input.mem = conv_ops.np_conv2d_grad_input(
                err_y, self.weights.mem, x.shape, self.sliding,
                self.padding)
        self._apply_numpy(gw, gb)

    def torch_run(self) -> None:
        x, y = self.input.devmem, self.output.devmem
        err_y = activations.apply_bwd(
            self.ACTIVATION, self.err_output.devmem.reshape(y.shape), y)
        w = self.weights.devmem
        gw = conv_ops.conv2d_grad_weights(x, err_y, tuple(w.shape),
                                          self.sliding, self.padding)
        gb = err_y.sum(dim=(0, 1, 2)) if self.include_bias else None
        if self.need_err_input:
            self.err_input.devmem = conv_ops.conv2d_grad_input(
                err_y, w, tuple(x.shape), self.sliding, self.padding)
        self._apply_torch(gw, gb)


class GDTanhConv(GradientDescentConv):
    MAPPING = ("conv_tanh",)
    ACTIVATION = activations.Tanh


class GDRELUConv(GradientDescentConv):
    MAPPING = ("conv_relu",)
    ACTIVATION = activations.Relu


class GDStrictRELUConv(GradientDescentConv):
    MAPPING = ("conv_str",)
    ACTIVATION = activations.StrictRelu


class GDSigmoidConv(GradientDescentConv):
    MAPPING = ("conv_sigmoid",)
    ACTIVATION = activations.Sigmoid
