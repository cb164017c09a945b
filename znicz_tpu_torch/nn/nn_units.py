"""Shared forward/gradient unit bases (port of
``znicz_tpu/nn/nn_units.py``).

``Forward`` owns the weights/bias Vectors and fills them from the seeded
``"weights"`` stream; ``GradientDescentBase`` holds learning_rate,
weights_decay, l1_vs_l2, gradient_moment (momentum), gradient accumulation
and the separate bias hyperparameters, and shares its forward unit's
weight Vectors.

The fill (:func:`fill` and :func:`fill_bias`) is the one implementation
both paths use: ``Forward.create_weights`` for the unit graph and
:func:`create_weights` for ``StandardWorkflow``'s layers that have no unit
yet, so a seed gives the same initial weights everywhere and in the
reference.

Layout: weights are (n_input, n_output), so the forward product is
``x @ W`` with no transpose, as in the reference."""

from __future__ import annotations

import numpy as np

from .. import prng
from ..accelerated_units import AcceleratedUnit
from ..memory import Vector
from ..ops import activations, update


def unit_loader(unit):
    """The loader of ``unit``'s workflow, or None (a unit used alone)."""
    wf = unit.workflow
    return None if wf is None else getattr(wf, "loader", None)


def loader_counters(unit, step: int = 0) -> tuple[int, int, int]:
    """(unit id, loader epoch, minibatch offset): the counters that key a
    unit's random draws this tick; (unit id, 0, ``step``) with no
    loader."""
    loader = unit_loader(unit)
    if loader is None:
        return (unit.unit_id, 0, step)
    return (unit.unit_id, loader.epoch_number, loader.minibatch_offset)


def fill(gen, shape: tuple[int, ...], filling: str,
         stddev: float | None) -> np.ndarray:
    """The reference's ``Forward._fill``: uniform ±stddev (default
    1/sqrt(fan_in)), gaussian or constant, from ``gen``."""
    fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else shape[0]
    stddev = stddev if stddev is not None else 1.0 / max(
        np.sqrt(fan_in), 1.0)
    if filling == "uniform":
        return gen.uniform(-stddev, stddev, shape)
    if filling == "gaussian":
        return gen.normal(0.0, stddev, shape)
    if filling == "constant":
        return np.full(shape, stddev, np.float32)
    raise ValueError(f"unknown filling {filling!r}")


def fill_bias(gen, b_shape: tuple[int, ...], bias_filling="uniform",
              bias_stddev=None) -> np.ndarray:
    """The bias draw: the default uniform fill draws the bias shape (the
    draw still advances the stream) and then discards it for zeros."""
    b = fill(gen, b_shape, bias_filling,
             bias_stddev if bias_stddev is not None else 0.0)
    if bias_filling == "uniform" and bias_stddev is None:
        b = np.zeros(b_shape, np.float32)
    return b


def create_weights(gen, w_shape: tuple[int, ...], b_shape: tuple[int, ...],
                   weights_filling="uniform", weights_stddev=None,
                   bias_filling="uniform", bias_stddev=None,
                   include_bias=True) -> tuple[np.ndarray, np.ndarray | None]:
    """(W, b or None) in the reference's draw order: W, then the bias."""
    w = fill(gen, w_shape, weights_filling, weights_stddev)
    b = (fill_bias(gen, b_shape, bias_filling, bias_stddev)
         if include_bias else None)
    return w, b


class Forward(AcceleratedUnit):
    """Forward-propagation base unit."""

    #: StandardWorkflow layer-type names this class serves.
    MAPPING: tuple[str, ...] = ()
    ACTIVATION = activations.Activation

    def __init__(self, workflow=None, name=None, weights_filling="uniform",
                 weights_stddev=None, bias_filling="uniform",
                 bias_stddev=None, include_bias=True, **kwargs):
        super().__init__(workflow, name, **kwargs)
        self.weights_filling = weights_filling
        self.weights_stddev = weights_stddev
        self.bias_filling = bias_filling
        self.bias_stddev = bias_stddev
        self.include_bias = include_bias
        self.output = Vector()
        self.weights = Vector()
        self.bias = Vector()
        self.prng = prng.get("weights")

    def create_weights(self, w_shape: tuple[int, ...],
                       b_shape: tuple[int, ...]) -> None:
        """Fill the weights, then the bias, unless already set."""
        if not self.weights:
            self.weights.mem = fill(self.prng, w_shape, self.weights_filling,
                                    self.weights_stddev)
        if self.include_bias and not self.bias:
            self.bias.mem = fill_bias(self.prng, b_shape, self.bias_filling,
                                      self.bias_stddev)


class GradientDescentBase(AcceleratedUnit):
    """Backprop base unit (the reference's hand-written gradient units).

    Wired to its paired Forward via ``setup_from_forward``: shares the
    *same* weights/bias Vectors (updates are visible to the forward unit),
    links input/output, and produces ``err_input`` for the previous GD unit
    from ``err_output`` supplied by the next one (or the evaluator)."""

    MAPPING: tuple[str, ...] = ()
    ACTIVATION = activations.Activation

    def __init__(self, workflow=None, name=None, learning_rate=0.01,
                 learning_rate_bias=None, weights_decay=0.0,
                 weights_decay_bias=0.0, l1_vs_l2=0.0, l1_vs_l2_bias=0.0,
                 gradient_moment=0.0, gradient_moment_bias=None,
                 apply_gradient=True, need_err_input=True,
                 accumulate_gradient=False, **kwargs):
        super().__init__(workflow, name, **kwargs)
        self.learning_rate = learning_rate
        self.learning_rate_bias = (learning_rate_bias
                                   if learning_rate_bias is not None
                                   else learning_rate)
        self.weights_decay = weights_decay
        self.weights_decay_bias = weights_decay_bias
        self.l1_vs_l2 = l1_vs_l2
        self.l1_vs_l2_bias = l1_vs_l2_bias
        self.gradient_moment = gradient_moment
        self.gradient_moment_bias = (gradient_moment_bias
                                     if gradient_moment_bias is not None
                                     else gradient_moment)
        self.apply_gradient = apply_gradient
        self.need_err_input = need_err_input
        self.accumulate_gradient = accumulate_gradient
        self.err_input = Vector()
        self.gradient_weights = Vector()
        self.gradient_bias = Vector()
        self.velocity_weights = Vector()
        self.velocity_bias = Vector()
        self.forward_unit: Forward | None = None

    def setup_from_forward(self, fwd: Forward) -> "GradientDescentBase":
        self.forward_unit = fwd
        self.link_attrs(fwd, "weights", "bias", "input", "output")
        self.include_bias = fwd.include_bias
        return self

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device, **kwargs)
        if self.weights and not self.velocity_weights:
            self.velocity_weights.mem = np.zeros(self.weights.shape,
                                                 np.float32)
        if self.include_bias and self.bias and not self.velocity_bias:
            self.velocity_bias.mem = np.zeros(self.bias.shape, np.float32)
        self.init_vectors(self.err_input, self.gradient_weights,
                          self.gradient_bias, self.velocity_weights,
                          self.velocity_bias)

    def _hypers(self):
        return (self.learning_rate, self.weights_decay, self.l1_vs_l2,
                self.gradient_moment)

    def _hypers_bias(self):
        return (self.learning_rate_bias, self.weights_decay_bias,
                self.l1_vs_l2_bias, self.gradient_moment_bias)

    def _apply_numpy(self, gw, gb) -> None:
        """Store (and with ``accumulate_gradient`` add to) the gradients,
        then the numpy momentum-SGD update of W and b (the golden path of
        every parameter-bearing GD unit)."""
        if self.accumulate_gradient and self.gradient_weights:
            gw = gw + self.gradient_weights.mem
            if gb is not None:
                gb = gb + self.gradient_bias.mem
        self.gradient_weights.mem = gw
        if gb is not None:
            self.gradient_bias.mem = gb
        if not self.apply_gradient:
            return
        w, vw = update.np_sgd_update(self.weights.mem, gw,
                                     self.velocity_weights.mem,
                                     *self._hypers())
        self.weights.mem, self.velocity_weights.mem = w, vw
        if self.include_bias:
            b, vb = update.np_sgd_update(self.bias.mem, gb,
                                         self.velocity_bias.mem,
                                         *self._hypers_bias())
            self.bias.mem, self.velocity_bias.mem = b, vb

    def _apply_torch(self, gw, gb) -> None:
        """:meth:`_apply_numpy` on the unit's tensors, W and b updated in
        one ``ops.update.sgd_update_many`` call (one launch of the fused
        update kernel on the card)."""
        if self.accumulate_gradient and self.gradient_weights:
            gw = gw + self.gradient_weights.devmem
            if gb is not None:
                gb = gb + self.gradient_bias.devmem
        self.gradient_weights.devmem = gw
        if gb is not None:
            self.gradient_bias.devmem = gb
        if not self.apply_gradient:
            return
        entries = [(self.weights.devmem, gw, self.velocity_weights.devmem,
                    update.unit_constants(self._hypers()))]
        if self.include_bias:
            entries.append((self.bias.devmem, gb, self.velocity_bias.devmem,
                            update.unit_constants(self._hypers_bias())))
        outs = update.sgd_update_many(entries)
        self.weights.devmem, self.velocity_weights.devmem = outs[0]
        if self.include_bias:
            self.bias.devmem, self.velocity_bias.devmem = outs[1]
