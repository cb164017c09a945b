"""Restricted Boltzmann machine units, CD-1 training (port of
``znicz_tpu/nn/rbm_units.py``).

``Binarization`` draws 0/1 inputs from probabilities, ``RBM`` computes
the hidden probabilities, and ``RBMTrainer`` updates the linked RBM's
weights and biases by CD-1 with momentum and L2 decay: a training path of
its own, no gradient chain, like the Kohonen pair.  Each Bernoulli draw
comes from the counter RNG of the ``"rbm"`` stream at (crc32 of the
unit's name, the loader's epoch, its minibatch offset), so every tier
samples the same states (``ops.rbm``)."""

from __future__ import annotations

import zlib

import numpy as np

from .. import prng
from ..accelerated_units import AcceleratedUnit
from ..memory import Vector
from ..ops import rbm as rbm_ops
from .nn_units import Forward, loader_counters


class Binarization(Forward):
    """Stochastic 0/1 binarization of input probabilities (the unit that
    feeds binary RBMs)."""

    MAPPING = ("binarization",)

    def __init__(self, workflow=None, name=None, **kwargs):
        kwargs["include_bias"] = False
        super().__init__(workflow, name, **kwargs)
        self.rng = prng.get("rbm")
        self.unit_id = zlib.crc32((self.name or "bin").encode())

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device, **kwargs)
        if not self.output:
            self.output.mem = np.zeros(self.input.shape, np.float32)
        self.init_vectors(self.output)

    def numpy_run(self) -> None:
        self.output.mem = rbm_ops.np_sample_bernoulli(
            self.input.mem, self.rng.stream_seed, loader_counters(self))

    def torch_run(self) -> None:
        self.output.devmem = rbm_ops.sample_bernoulli(
            self.input.devmem, self.rng.stream_seed, loader_counters(self))


class RBM(Forward):
    """Hidden-probability forward: output = σ(input·W + hbias).  Owns the
    whole RBM parameter set (W, vbias, hbias); the trainer links the same
    Vectors."""

    MAPPING = ("rbm",)

    def __init__(self, workflow=None, name=None, n_hidden=None, **kwargs):
        kwargs["include_bias"] = False
        kwargs.setdefault("weights_filling", "gaussian")
        kwargs.setdefault("weights_stddev", 0.01)
        super().__init__(workflow, name, **kwargs)
        if n_hidden is None:
            raise ValueError("n_hidden is required")
        self.n_hidden = int(n_hidden)
        self.vbias = Vector()
        self.hbias = Vector()

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device, **kwargs)
        n_visible = int(np.prod(self.input.shape[1:]))
        self.n_visible = n_visible
        self.create_weights((n_visible, self.n_hidden), ())
        if not self.vbias:
            self.vbias.mem = np.zeros(n_visible, np.float32)
        if not self.hbias:
            self.hbias.mem = np.zeros(self.n_hidden, np.float32)
        if not self.output:
            self.output.mem = np.zeros((self.input.shape[0],
                                        self.n_hidden), np.float32)
        self.init_vectors(self.weights, self.vbias, self.hbias,
                          self.output)

    def numpy_run(self) -> None:
        v = self.input.mem
        self.output.mem = rbm_ops.np_hidden_probs(
            v.reshape(len(v), -1), self.weights.mem, self.hbias.mem)

    def torch_run(self) -> None:
        v = self.input.devmem
        self.output.devmem = rbm_ops.hidden_probs(
            v.reshape(len(v), -1), self.weights.devmem, self.hbias.devmem)


class RBMTrainer(AcceleratedUnit):
    """CD-1 update of the linked RBM's parameters with momentum and L2
    weight decay; publishes ``recon_err`` (the minibatch's mean
    reconstruction mse, read to the host every tick, as the reference's
    unit does)."""

    def __init__(self, workflow=None, name=None, learning_rate=0.1,
                 momentum=0.0, weights_decay=0.0, **kwargs):
        super().__init__(workflow, name, **kwargs)
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.weights_decay = weights_decay
        self.recon_err = np.inf
        self.rng = prng.get("rbm")
        self.unit_id = zlib.crc32((self.name or "rbm_tr").encode())
        self._step = 0
        self.velocity_weights = Vector()
        self.velocity_vbias = Vector()
        self.velocity_hbias = Vector()

    def setup_from_forward(self, fwd: RBM) -> "RBMTrainer":
        self.forward_unit = fwd
        self.link_attrs(fwd, "weights", "vbias", "hbias", "input")
        return self

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device, **kwargs)
        if not self.velocity_weights:
            self.velocity_weights.mem = np.zeros(self.weights.shape,
                                                 np.float32)
            self.velocity_vbias.mem = np.zeros(self.vbias.shape, np.float32)
            self.velocity_hbias.mem = np.zeros(self.hbias.shape, np.float32)
        self.init_vectors(self.velocity_weights, self.velocity_vbias,
                          self.velocity_hbias)

    def _counters(self):
        # standalone use: a step counter keeps successive Gibbs samples
        # apart
        self._step += 1
        return loader_counters(self, self._step)

    def _vectors(self):
        return ((self.weights, self.vbias, self.hbias),
                (self.velocity_weights, self.velocity_vbias,
                 self.velocity_hbias))

    def numpy_run(self) -> None:
        bs = self.current_batch_size
        v0 = self.input.mem.reshape(len(self.input.mem), -1)[:bs]
        params, vels = self._vectors()
        new_p, new_v, recon = rbm_ops.np_cd1_momentum_step(
            tuple(p.mem for p in params), tuple(v.mem for v in vels), v0,
            self.learning_rate, self.momentum, self.weights_decay,
            self.rng.stream_seed, self._counters())
        for vec, a in zip(params + vels, new_p + new_v):
            vec.mem = a.astype(np.float32)
        self.recon_err = float(recon)

    def torch_run(self) -> None:
        bs = self.current_batch_size
        x = self.input.devmem
        v0 = x.reshape(len(x), -1)[:bs]
        params, vels = self._vectors()
        new_p, new_v, recon = rbm_ops.cd1_momentum_step(
            tuple(p.devmem for p in params), tuple(v.devmem for v in vels),
            v0, self.learning_rate, self.momentum, self.weights_decay,
            self.rng.stream_seed, self._counters())
        for vec, t in zip(params + vels, new_p + new_v):
            vec.devmem = t
        self.recon_err = float(recon)
