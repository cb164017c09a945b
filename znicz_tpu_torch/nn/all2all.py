"""Fully-connected forward units (port of ``znicz_tpu/nn/all2all.py``).

``All2All`` and its activation variants compute y = act(x·W + b), and
``All2AllSoftmax`` the row softmax of x·W + b with its ``max_idx`` argmax
output.  ``torch_run`` takes the product through ``ops.matmul`` (the
hand-written SGEMM on the card) and the softmax through ``ops.softmax``
(the row softmax + argmax kernel), the activation through
``ops.activations.apply_fwd`` (the elementwise kernel on the card, none
for the linear one); the bias add stays plain torch, as XLA does it
inside the reference's jitted unit body.  ``numpy_run`` is the golden
path."""

from __future__ import annotations

import numpy as np

from ..memory import Vector
from ..ops import activations, matmul, softmax
from .nn_units import Forward


class All2All(Forward):
    """y = act(x·W + b), x flattened to (batch, features)."""

    MAPPING = ("all2all",)
    ACTIVATION = activations.Activation

    def __init__(self, workflow=None, name=None, output_sample_shape=None,
                 output_samples_number=None, **kwargs):
        super().__init__(workflow, name, **kwargs)
        if output_sample_shape is None:
            raise ValueError("output_sample_shape is required")
        self.output_sample_shape = (
            (output_sample_shape,) if isinstance(output_sample_shape, int)
            else tuple(output_sample_shape))
        self.neurons = int(np.prod(self.output_sample_shape))
        del output_samples_number  # reference alias, shape comes from input

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device, **kwargs)
        n_in = int(np.prod(self.input.shape[1:]))
        self.create_weights((n_in, self.neurons), (self.neurons,))
        if not self.output:   # static output shape → downstream units chain
            self.output.mem = np.zeros((self.input.shape[0], self.neurons),
                                       np.float32)
        self.init_vectors(self.weights, self.bias, self.output)

    def _logits_np(self) -> np.ndarray:
        x = self.input.mem.reshape(len(self.input.mem), -1)
        y = matmul.np_matmul(x, self.weights.mem)
        return y + self.bias.mem if self.include_bias else y

    def _logits(self):
        x = self.input.devmem
        y = matmul.matmul(x.reshape(x.shape[0], -1), self.weights.devmem)
        return y + self.bias.devmem if self.include_bias else y

    def numpy_run(self) -> None:
        self.output.mem = activations.NUMPY[self.ACTIVATION.name][0](
            self._logits_np())

    def torch_run(self) -> None:
        self.output.devmem = activations.apply_fwd(self.ACTIVATION,
                                                    self._logits())


class All2AllTanh(All2All):
    MAPPING = ("all2all_tanh",)
    ACTIVATION = activations.Tanh


class All2AllRELU(All2All):
    """Smooth relu log(1+eˣ) — the reference's RELU."""

    MAPPING = ("all2all_relu",)
    ACTIVATION = activations.Relu


class All2AllStrictRELU(All2All):
    MAPPING = ("all2all_str",)
    ACTIVATION = activations.StrictRelu


class All2AllSigmoid(All2All):
    MAPPING = ("all2all_sigmoid",)
    ACTIVATION = activations.Sigmoid


class All2AllSoftmax(All2All):
    """FC + row softmax; also emits ``max_idx`` (the int32 argmax of the
    logits)."""

    MAPPING = ("softmax",)

    def __init__(self, workflow=None, name=None, **kwargs):
        super().__init__(workflow, name, **kwargs)
        self.max_idx = Vector()

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device, **kwargs)
        self.init_vectors(self.max_idx)

    def numpy_run(self) -> None:
        y, idx = softmax.np_softmax(self._logits_np())
        self.output.mem = y
        self.max_idx.mem = idx.astype(np.int32)

    def torch_run(self) -> None:
        y, idx = softmax.softmax(self._logits())
        self.output.devmem = y
        self.max_idx.devmem = idx
