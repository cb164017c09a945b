"""Dropout units (port of ``znicz_tpu/nn/dropout.py``): ``DropoutForward``
applies an inverted-dropout keep mask on train minibatches (kept elements
× 1/(1−ratio), so evaluation is the identity), ``DropoutBackward`` scales
the error by the same mask.

The mask is the counter RNG's, keyed by ``(stream seed, crc32(unit
name), epoch, minibatch offset)``, so every device draws the JAX
package's mask bit for bit.  On a torch device the units follow the
reference's Pallas-mode contract: the forward goes through
``ops.dropout.dropout`` (the hand-written kernel on the card, the mask
multiply on the CPU), the ``mask`` Vector stays empty, and the backward
regenerates the same stream from the same key.  On the numpy device the
mask is materialised, as the reference's numpy tier does."""

from __future__ import annotations

import zlib

import numpy as np

from .. import prng
from ..loader.base import TRAIN
from ..memory import Vector
from ..ops import dropout as drop_ops
from ..ops import rngbits
from .nn_units import (Forward, GradientDescentBase, loader_counters,
                       unit_loader)


class DropoutForward(Forward):
    MAPPING = ("dropout",)

    def __init__(self, workflow=None, name=None, dropout_ratio=0.5,
                 **kwargs):
        kwargs["include_bias"] = False
        super().__init__(workflow, name, **kwargs)
        self.dropout_ratio = float(dropout_ratio)
        self.mask = Vector()
        self.rng = prng.get("dropout")
        # full-name hash: distinct units draw distinct streams
        self.unit_id = zlib.crc32((self.name or "dropout").encode())
        self.training = True   # loader-less default
        #: the folded key of the last forward's mask on a torch device,
        #: which the backward regenerates it from (None: the identity)
        self.last_key: int | None = None

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device, **kwargs)
        if not self.output:
            self.output.mem = np.zeros(self.input.shape, np.float32)
        if device is not None and device.is_torch:
            # the mask is never materialised here: the Vector stays empty
            # rather than holding an all-ones buffer a reader could
            # mistake for the real thing
            self.init_vectors(self.output)
            return
        if not self.mask:
            self.mask.mem = np.ones(self.input.shape, np.float32)
        self.init_vectors(self.output, self.mask)

    def counters(self) -> tuple[int, int, int]:
        """(unit id, epoch, minibatch offset) keying this tick's mask."""
        return loader_counters(self)

    def is_training(self) -> bool:
        loader = unit_loader(self)
        return self.training if loader is None \
            else loader.minibatch_class == TRAIN

    def numpy_run(self) -> None:
        x = self.input.mem
        if not self.is_training():
            self.mask.mem = np.ones(x.shape, np.float32)
            self.output.mem = x.copy()
            return
        mask = drop_ops.plain_make_mask(self.rng.stream_seed,
                                        self.counters(), x.shape,
                                        self.dropout_ratio).numpy()
        self.mask.mem = mask
        self.output.mem = x * mask

    def torch_run(self) -> None:
        if not self.is_training():
            self.last_key = None
            self.output.devmem = self.input.devmem
            return
        self.last_key = rngbits.fold(self.rng.stream_seed, *self.counters())
        self.output.devmem = drop_ops.dropout(self.input.devmem,
                                              self.last_key,
                                              self.dropout_ratio)


class DropoutBackward(GradientDescentBase):
    """err_input = err_output ⊙ mask; no parameters."""

    MAPPING = ("dropout",)

    def setup_from_forward(self, fwd) -> "DropoutBackward":
        super().setup_from_forward(fwd)
        self.link_attrs(fwd, "mask")
        self.forward_unit = fwd
        self.include_bias = False
        return self

    def numpy_run(self) -> None:
        if self.need_err_input:
            self.err_input.mem = self.err_output.mem.reshape(
                self.mask.shape) * self.mask.mem

    def torch_run(self) -> None:
        if not self.need_err_input:
            return
        fwd = self.forward_unit
        err = self.err_output.devmem.reshape(self.input.shape)
        self.err_input.devmem = err if fwd.last_key is None else \
            drop_ops.dropout(err, fwd.last_key, fwd.dropout_ratio)
