"""Local-response normalization units (port of
``znicz_tpu/nn/normalization.py``).

``LRNormalizerForward`` normalizes across the channel window (reference
defaults n=5, α=1e-4, β=0.75, k=2) and caches the denominator in
``denom``; ``LRNormalizerBackward`` computes ``err_input`` from it.  On
the card they launch the cached-denominator LRN kernels of
``csrc/lrn.cu`` (``ops.normalization.lrn``/``gd_lrn``); the fused path
uses the recompute forms instead."""

from __future__ import annotations

import numpy as np

from ..memory import Vector
from ..ops import normalization as lrn_ops
from .nn_units import Forward, GradientDescentBase


class LRNormalizerForward(Forward):
    MAPPING = ("norm", "lrn")

    def __init__(self, workflow=None, name=None, n=5, alpha=1e-4,
                 beta=0.75, k=2.0, **kwargs):
        kwargs["include_bias"] = False
        super().__init__(workflow, name, **kwargs)
        self.n, self.alpha, self.beta, self.k = int(n), alpha, beta, k
        self.denom = Vector()

    @property
    def lrn_args(self) -> tuple:
        """(n, alpha, beta, k), the ops' trailing arguments."""
        return (self.n, self.alpha, self.beta, self.k)

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device, **kwargs)
        if not self.output:
            self.output.mem = np.zeros(self.input.shape, np.float32)
        if not self.denom:
            self.denom.mem = np.zeros(self.input.shape, np.float32)
        self.init_vectors(self.output, self.denom)

    def numpy_run(self) -> None:
        self.output.mem, self.denom.mem = lrn_ops.np_lrn(self.input.mem,
                                                         *self.lrn_args)

    def torch_run(self) -> None:
        self.output.devmem, self.denom.devmem = lrn_ops.lrn(
            self.input.devmem, *self.lrn_args)


class LRNormalizerBackward(GradientDescentBase):
    """No parameters: only err_input, from the cached denominator."""

    MAPPING = ("norm", "lrn")

    def setup_from_forward(self, fwd) -> "LRNormalizerBackward":
        super().setup_from_forward(fwd)
        self.link_attrs(fwd, "denom", "lrn_args")
        self.include_bias = False
        return self

    def numpy_run(self) -> None:
        if self.need_err_input:
            self.err_input.mem = lrn_ops.np_gd_lrn(
                self.err_output.mem.reshape(self.output.shape),
                self.input.mem, self.denom.mem, *self.lrn_args)

    def torch_run(self) -> None:
        if self.need_err_input:
            self.err_input.devmem = lrn_ops.gd_lrn(
                self.err_output.devmem.reshape(self.output.shape),
                self.input.devmem, self.denom.devmem, *self.lrn_args)
