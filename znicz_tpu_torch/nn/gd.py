"""Backprop units for fully-connected layers (port of
``znicz_tpu/nn/gd.py``).

Math (per activation variant): ``err_y = act.bwd(err_output, y)``;
``∇W = xᵀ·err_y``; ``∇b = Σ err_y``; ``err_input = err_y·Wᵀ`` (only when
``need_err_input``), then the momentum-SGD update of W and b.  The
evaluator already scales err_output by 1/batch and zeroes padded rows, so
no batch normalization happens here.

``torch_run`` multiplies through ``ops.matmul`` with xᵀ and Wᵀ passed as
views (the kernel reads their strides; no transposed copy) and updates W
and b in one ``ops.update.sgd_update_many`` call (one launch of the fused
update kernel on the card); the activation derivative goes through
``ops.activations.apply_bwd`` (the elementwise kernel on the card, none
for the linear one); the bias sum stays plain torch.
``numpy_run`` is the golden path."""

from __future__ import annotations

from ..ops import activations, matmul
from .nn_units import GradientDescentBase


class GradientDescent(GradientDescentBase):
    """Gradient unit for All2All (linear activation)."""

    MAPPING = ("all2all",)
    ACTIVATION = activations.Activation

    def numpy_run(self) -> None:
        y = self.output.mem
        y2 = y.reshape(len(y), -1)
        err_y = activations.NUMPY[self.ACTIVATION.name][1](
            self.err_output.mem.reshape(y2.shape), y2)
        x = self.input.mem.reshape(len(self.input.mem), -1)
        gw = matmul.np_matmul(x.T, err_y)
        gb = err_y.sum(axis=0) if self.include_bias else None
        if self.need_err_input:
            self.err_input.mem = matmul.np_matmul(
                err_y, self.weights.mem.T).reshape(self.input.shape)
        self._apply_numpy(gw, gb)

    def torch_run(self) -> None:
        x = self.input.devmem
        x2 = x.reshape(x.shape[0], -1)
        y2 = self.output.devmem.reshape(x.shape[0], -1)
        err_y = activations.apply_bwd(
            self.ACTIVATION, self.err_output.devmem.reshape(y2.shape), y2)
        gw = matmul.matmul(x2.T, err_y)
        gb = err_y.sum(dim=0) if self.include_bias else None
        if self.need_err_input:
            self.err_input.devmem = matmul.matmul(
                err_y, self.weights.devmem.T).reshape(x.shape)
        self._apply_torch(gw, gb)


class GDTanh(GradientDescent):
    MAPPING = ("all2all_tanh",)
    ACTIVATION = activations.Tanh


class GDRELU(GradientDescent):
    MAPPING = ("all2all_relu",)
    ACTIVATION = activations.Relu


class GDStrictRELU(GradientDescent):
    MAPPING = ("all2all_str",)
    ACTIVATION = activations.StrictRelu


class GDSigmoid(GradientDescent):
    MAPPING = ("all2all_sigmoid",)
    ACTIVATION = activations.Sigmoid


class GDSoftmax(GradientDescent):
    """Softmax layer backprop: EvaluatorSoftmax supplies the error already
    w.r.t. the *logits* (y − onehot), so the activation pass-through is the
    identity."""

    MAPPING = ("softmax",)
    ACTIVATION = activations.Activation

