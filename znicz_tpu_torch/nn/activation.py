"""Standalone activation forward/backward unit pairs (port of
``znicz_tpu/nn/activation.py``): ``ActivationForward`` /
``ActivationBackward`` × {Tanh, RELU, StrictRELU, Sigmoid, Log, SinCos,
Mul, TanhLog} as separate graph units, the layer types
``activation_<name>`` (beside the activations built into All2All* and
Conv*).  ``torch_run`` goes through ``ops.activations.act_fwd`` /
``act_bwd``, the hand-written elementwise kernels of
``csrc/activation.cu`` on the card, the same kernels the weighted units
and every activation of the fused step launch (``apply_fwd`` /
``apply_bwd``); ``numpy_run`` is the golden path."""

from __future__ import annotations

import numpy as np

from ..ops import activations
from .nn_units import Forward, GradientDescentBase


class ActivationForward(Forward):
    """y = act(x), shape-preserving, no parameters."""

    MAPPING: tuple[str, ...] = ()
    ACTIVATION = activations.Activation

    def __init__(self, workflow=None, name=None, **kwargs):
        kwargs["include_bias"] = False
        super().__init__(workflow, name, **kwargs)

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device, **kwargs)
        if not self.output:
            self.output.mem = np.zeros(self.input.shape, np.float32)
        self.init_vectors(self.output)

    def numpy_run(self) -> None:
        self.output.mem = activations.NUMPY[self.ACTIVATION.name][0](
            self.input.mem)

    def torch_run(self) -> None:
        self.output.devmem = activations.act_fwd(self.ACTIVATION.name,
                                                 self.input.devmem)


class ActivationBackward(GradientDescentBase):
    """err_input = act′(err_output, output[, input]); no parameters."""

    MAPPING: tuple[str, ...] = ()
    ACTIVATION = activations.Activation

    def setup_from_forward(self, fwd) -> "ActivationBackward":
        super().setup_from_forward(fwd)
        self.include_bias = False
        return self

    def numpy_run(self) -> None:
        if not self.need_err_input:
            return
        act = self.ACTIVATION
        y = self.output.mem
        self.err_input.mem = activations.NUMPY[act.name][1](
            self.err_output.mem.reshape(y.shape), y,
            self.input.mem if act.needs_input else None)

    def torch_run(self) -> None:
        if not self.need_err_input:
            return
        act = self.ACTIVATION
        y = self.output.devmem
        self.err_input.devmem = activations.act_bwd(
            act.name, self.err_output.devmem.reshape(y.shape), y,
            self.input.devmem if act.needs_input else None)


def _make_pairs() -> dict:
    """Forward and backward classes for every activation."""
    out = {}
    for act, suffix in ((activations.Tanh, "Tanh"),
                        (activations.Relu, "RELU"),
                        (activations.StrictRelu, "StrictRELU"),
                        (activations.Sigmoid, "Sigmoid"),
                        (activations.Log, "Log"),
                        (activations.SinCos, "SinCos"),
                        (activations.Mul, "Mul"),
                        (activations.TanhLog, "TanhLog")):
        key = (f"activation_{act.name}",)
        for cls in (type(f"Activation{suffix}", (ActivationForward,),
                         {"MAPPING": key, "ACTIVATION": act}),
                    type(f"GDActivation{suffix}", (ActivationBackward,),
                         {"MAPPING": key, "ACTIVATION": act})):
            out[cls.__name__] = cls
    return out


globals().update(_make_pairs())
