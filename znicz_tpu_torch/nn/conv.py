"""2-D convolution forward units (port of ``znicz_tpu/nn/conv.py``).

``Conv`` and its activation variants compute y = act(conv2d(x, W) + b) on
NHWC input with HWIO weights ``(ky, kx, C, n_kernels)``, gaussian-filled
by default with fan-in ky·kx·C from the ``"weights"`` stream, in the
reference's draw order (W, then the bias).  ``padding`` is symmetric, an
int or ``(pad_h, pad_w)``.  ``torch_run`` convolves through
``ops.conv.conv2d``: cuDNN on the card (TF32 off) as the reference leaves
its convs to XLA, or under ``ZNICZ_TPU_CONV=pallas`` the implicit-GEMM
kernels as its Pallas tier, and applies the activation through
``ops.activations.apply_fwd`` (the elementwise kernel on the card, none
for the linear one); ``numpy_run`` is the im2col golden."""

from __future__ import annotations

import numpy as np

from ..ops import activations, conv as conv_ops
from ..ops.geometry import norm2, out_size
from .nn_units import Forward


class Conv(Forward):
    """y = act(conv2d(x, W) + b); x is (B, H, W, C), W (ky, kx, C, OC)."""

    MAPPING = ("conv",)
    ACTIVATION = activations.Activation

    def __init__(self, workflow=None, name=None, n_kernels=None, kx=None,
                 ky=None, sliding=1, padding=0, **kwargs):
        kwargs.setdefault("weights_filling", "gaussian")
        super().__init__(workflow, name, **kwargs)
        if n_kernels is None or kx is None:
            raise ValueError("n_kernels and kx are required")
        self.n_kernels = int(n_kernels)
        self.kx = int(kx)
        self.ky = int(ky if ky is not None else kx)
        self.sliding = norm2(sliding)
        self.padding = norm2(padding)

    def output_shape_for(self, x_shape) -> tuple[int, ...]:
        b, h, w, _ = x_shape
        return (b, out_size(h, self.ky, self.sliding[0], self.padding[0]),
                out_size(w, self.kx, self.sliding[1], self.padding[1]),
                self.n_kernels)

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device, **kwargs)
        if len(self.input.shape) != 4:
            raise ValueError(f"{self.name}: Conv expects NHWC input, got "
                             f"shape {self.input.shape}")
        self.create_weights(
            (self.ky, self.kx, self.input.shape[3], self.n_kernels),
            (self.n_kernels,))
        if not self.output:
            self.output.mem = np.zeros(
                self.output_shape_for(self.input.shape), np.float32)
        self.init_vectors(self.weights, self.bias, self.output)

    def numpy_run(self) -> None:
        y = conv_ops.np_conv2d(self.input.mem, self.weights.mem,
                               self.sliding, self.padding)
        if self.include_bias:
            y = y + self.bias.mem
        self.output.mem = activations.NUMPY[self.ACTIVATION.name][0](y)

    def torch_run(self) -> None:
        y = conv_ops.conv2d(self.input.devmem, self.weights.devmem,
                            self.sliding, self.padding)
        if self.include_bias:
            y = y + self.bias.devmem
        self.output.devmem = activations.apply_fwd(self.ACTIVATION, y)


class ConvTanh(Conv):
    MAPPING = ("conv_tanh",)
    ACTIVATION = activations.Tanh


class ConvRELU(Conv):
    """Smooth relu log(1+eˣ) — the reference's RELU."""

    MAPPING = ("conv_relu",)
    ACTIVATION = activations.Relu


class ConvStrictRELU(Conv):
    MAPPING = ("conv_str",)
    ACTIVATION = activations.StrictRelu


class ConvSigmoid(Conv):
    MAPPING = ("conv_sigmoid",)
    ACTIVATION = activations.Sigmoid
