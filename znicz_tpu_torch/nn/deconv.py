"""Transposed-convolution forward units, the autoencoder's decoder (port
of ``znicz_tpu/nn/deconv.py``).

``Deconv`` computes y = act(deconv2d(x, W) [+ b]) with W in the paired
conv's HWIO layout ``(ky, kx, n_channels, n_kernels)``.  ``tie(conv)``
links the encoder conv's weight Vector itself (both GD units then update
the same tensor) and its geometry.  An untied deconv is gaussian-filled
with the true forward fan-in, ``1/√(ky·kx·n_kernels)``, as the reference
sets it.  ``include_bias`` defaults to False (the reference's decoder is
linear).  ``torch_run`` goes through ``ops.deconv`` (cuDNN on the card);
``numpy_run`` is the col2im golden.  ``compute_padding`` is the
reference's geometry helper."""

from __future__ import annotations

import numpy as np

from ..ops import activations, deconv as deconv_ops
from ..ops.geometry import norm2
from .nn_units import Forward


def compute_padding(h: int, w: int, ky: int, kx: int, sliding
                    ) -> tuple[int, int]:
    """Symmetric padding that makes a conv over (h, w) exactly invertible
    by a deconv of the same geometry; raises if the window does not tile
    (h, w) evenly with it."""
    sh, sw = norm2(sliding)
    ph, pw = (ky - sh) // 2, (kx - sw) // 2
    if (h + 2 * ph - ky) % sh or (w + 2 * pw - kx) % sw:
        raise ValueError(
            f"window {ky}x{kx} sliding {sh}x{sw} does not tile "
            f"({h}, {w}) evenly with padding ({ph}, {pw})")
    return (ph, pw)


class Deconv(Forward):
    """x is (B, OH, OW, n_kernels), W (ky, kx, n_channels, n_kernels), y
    (B, H, W, n_channels)."""

    MAPPING = ("deconv",)
    ACTIVATION = activations.Activation

    def __init__(self, workflow=None, name=None, n_kernels=None, kx=None,
                 ky=None, sliding=1, padding=0, n_channels=None, **kwargs):
        kwargs.setdefault("weights_filling", "gaussian")
        kwargs.setdefault("include_bias", False)
        super().__init__(workflow, name, **kwargs)
        # the geometry may come from tie(conv) instead; checked at
        # initialize
        self.n_kernels = None if n_kernels is None else int(n_kernels)
        self.kx = None if kx is None else int(kx)
        self.ky = (int(ky if ky is not None else kx) if kx is not None
                   else None)
        self.sliding = norm2(sliding)
        self.padding = norm2(padding)
        self.n_channels = n_channels
        self.conv_unit = None

    def tie(self, conv) -> "Deconv":
        """Share the encoder conv's weight Vector and geometry."""
        self.conv_unit = conv
        self.link_attrs(conv, "weights")
        self.n_kernels = conv.n_kernels
        self.kx, self.ky = conv.kx, conv.ky
        self.sliding, self.padding = conv.sliding, conv.padding
        return self

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device, **kwargs)
        if self.n_kernels is None or self.kx is None:
            raise ValueError(f"{self.name}: n_kernels and kx are required "
                             "(directly or via tie(conv))")
        if len(self.input.shape) != 4:
            raise ValueError(f"{self.name}: Deconv expects NHWC input, got "
                             f"shape {self.input.shape}")
        if self.input.shape[3] != self.n_kernels:
            raise ValueError(f"{self.name}: input has {self.input.shape[3]} "
                             f"channels, n_kernels={self.n_kernels}")
        if self.n_channels is None:
            if self.conv_unit is None:
                raise ValueError(f"{self.name}: n_channels is required for "
                                 "an untied Deconv")
            self.n_channels = int(self.conv_unit.input.shape[3])
        if self.weights_stddev is None:
            # the HWIO layout puts the deconv's INPUT channels last, so
            # the fill's prod(shape[:-1]) fan-in would count its outputs
            self.weights_stddev = 1.0 / np.sqrt(
                self.ky * self.kx * self.n_kernels)
        w_shape = (self.ky, self.kx, self.n_channels, self.n_kernels)
        self.create_weights(w_shape, (self.n_channels,))
        if not self.output:
            self.output.mem = np.zeros(deconv_ops.deconv_out_shape(
                self.input.shape, w_shape, self.sliding, self.padding),
                np.float32)
        self.init_vectors(self.weights, self.bias, self.output)

    def numpy_run(self) -> None:
        y = deconv_ops.np_deconv2d(self.input.mem, self.weights.mem,
                                   self.sliding, self.padding)
        if self.include_bias:
            y = y + self.bias.mem
        self.output.mem = activations.NUMPY[self.ACTIVATION.name][0](y)

    def torch_run(self) -> None:
        y = deconv_ops.deconv2d(self.input.devmem, self.weights.devmem,
                                self.sliding, self.padding)
        if self.include_bias:
            y = y + self.bias.devmem
        self.output.devmem = self.ACTIVATION.fwd(y)


class DeconvTanh(Deconv):
    MAPPING = ("deconv_tanh",)
    ACTIVATION = activations.Tanh


class DeconvSigmoid(Deconv):
    MAPPING = ("deconv_sigmoid",)
    ACTIVATION = activations.Sigmoid
